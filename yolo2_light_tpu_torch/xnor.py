"""XNOR (BIT1) weight binarization and bit packing, in NumPy.

Counterpart of ``yolo2_light_tpu/xnor.py``. The reference represents binary
weights as +-mean(|w|) per filter (binarize_weights,
src/additionally.c:113-126); the per-filter mean is factored out of the
product into ``mean_arr`` and applied in the conv epilogue. The JAX
package's ``binarize_params`` also packs the bits for its Pallas kernel in
the TPU's ``[M_pad128, F_pad128]`` layout, through a module that imports
Pallas; the port packs them in a layout of its own instead
(:func:`pack_sign_weights`), chosen for its kernels.
"""

from __future__ import annotations

import numpy as np

from .cfg import ConvSpec, ModelSpec

#: one int32 word holds the signs of 32 channels of one tap
BITS = 32


def binarize_params(spec: ModelSpec, params: list) -> list:
    """Add ``sign_weights`` (HWIO int8 +-1) and ``mean_arr`` [n] to the xnor
    conv layers (reference: calculate_binary_weights,
    src/additionally.c:306-345)."""
    out: list = []
    for i, l in enumerate(spec.layers):
        p = params[i]
        if p is None or not isinstance(l, ConvSpec) or not l.xnor:
            out.append(p)
            continue
        q = dict(p)
        w = np.asarray(p["weights"], np.float32)          # HWIO
        # per-filter mean of |w| over H, W, I (reference: binarize_weights)
        q["mean_arr"] = np.mean(np.abs(w), axis=(0, 1, 2)).astype(np.float32)
        q["sign_weights"] = np.where(w > 0, 1, -1).astype(np.int8)
        out.append(q)
    return out


def has_xnor(spec: ModelSpec) -> bool:
    return any(isinstance(l, ConvSpec) and l.xnor for l in spec.layers)


def words_for(channels: int) -> int:
    """int32 words per tap for ``channels`` channels (C32)."""
    return -(-channels // BITS)


def pack_sign_weights(sign_hwio) -> np.ndarray:
    """HWIO +-1 weights ``[kh, kw, C, M]`` -> ``[M, kh, kw, C32]`` int32, the
    layout the port's bit kernels reduce along (tap-major, like the int8
    kernel's ``[M, ks, ks, C]``, so one weight word lines up with one word
    of a packed NHWC activation map). Bit b of word j is channel
    ``32*j + b``, set iff the weight is +1; channel-pad bits are 0."""
    s = np.asarray(sign_hwio)
    kh, kw, c, m = s.shape
    c32 = words_for(c)
    bits = np.zeros((m, kh, kw, c32 * BITS), np.uint64)
    bits[..., :c] = np.transpose(s > 0, (3, 0, 1, 2))
    shifts = np.uint64(1) << np.arange(BITS, dtype=np.uint64)
    words = (bits.reshape(m, kh, kw, c32, BITS) * shifts).sum(-1)
    return words.astype(np.uint32).view(np.int32)
