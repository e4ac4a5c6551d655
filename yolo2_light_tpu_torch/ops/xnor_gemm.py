"""XNOR (BIT1) convolution on bit-packed operands: two hand-written Hopper
kernels and their plain PyTorch twins.

Counterparts of the Pallas kernels of ``yolo2_light_tpu/ops/pallas_xnor.py``:

* ``csrc/xnor_gemm.cu`` replaces ``xnor_gemm`` (the popcount engine,
  ``-xnor_kernel pallas``)::

      cnt = sum_f popcount(~(x_bits[p, f] ^ w_bits[m, f]))
      y   = (2 * cnt - adjust) * mean[m] + bias[m],  adjust = 2 * F*32 - K

* ``csrc/xnor_gemm_mxu.cu`` replaces ``xnor_gemm_mxu`` (the bit-packed int8
  engine, ``-xnor_kernel pallas_mxu``): both operands' bits are unpacked to
  +-1 int8 inside the kernel and contracted on the int8 tensor cores::

      y   = (dot_pm1 - pad_bits) * mean[m] + bias[m]

Both then apply ``y > 0 ? y : 0.1 * y`` (leaky; the XNOR path's slope is
0.1*y, not the int8 path's y/10) or nothing (linear). The two formulations
give the same integer, ``2*matches - K`` over the K = ks*ks*C real bits, so
they agree bit for bit with each other and with the dense +-1 engine
(``models/layers.conv2d_xnor``): channel-pad bits are 0 in both operands
and count as matches, which ``adjust`` and ``pad_bits`` remove; taps outside
the image read as 0 bits, i.e. -1 activations, the reference's bit-path
border (see ``layers.conv2d_xnor``).

Layouts: activations ``[B, H, W, C32]`` int32 (:func:`pack_activations`, bit
b of word j is channel 32*j + b set iff x > 0), weights ``[M, ks, ks, C32]``
int32 (``xnor.pack_sign_weights``). The kernels are implicit GEMMs: they
gather their taps from the packed map, so no patch matrix is written to
device memory. The plain versions build the patch matrix instead.

Dispatch: :func:`xnor_gemm` and :func:`xnor_gemm_mxu` launch the kernel for
a CUDA tensor and run the plain version for a CPU tensor; the CUDA path
never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..xnor import BITS, words_for
from .int8_conv import LAUNCH_COUNTS

_POPCOUNT = "xnor_gemm"
_MXU = "xnor_gemm_mxu"
_EPILOGUES = ("leaky", "linear")

#: Largest GEMM M = batch * out_h * out_w at which ``xnor_impl="auto"``
#: takes the bit-packed int8 engine (K4) over the dense +-1 conv. On an
#: H100 (chip_smoke.py phase 7, PERF.md section 6) K4 with its input packing
#: beat the dense engine at all seven XNOR convs of tiny-yolo-obj_xnor-416
#: at b=1, from M = 169 (13x13) to M = 43,264 (208x208), by 1.8x to 3.1x;
#: the threshold is the largest M measured. Above it the dense engine runs.
AUTO_MXU_MAX_PIXELS = 43264


def auto_prefers_mxu(total_out_pixels: int) -> bool:
    """True where the bit-packed int8 engine measured faster than the dense
    +-1 conv at this GEMM M = batch*oh*ow (see AUTO_MXU_MAX_PIXELS)."""
    return total_out_pixels <= AUTO_MXU_MAX_PIXELS


def _check_epilogue(activation: str) -> None:
    if activation not in _EPILOGUES:
        raise ValueError(f"XNOR bit-kernel epilogue must be one of "
                         f"{_EPILOGUES}, got {activation!r}")


def pack_activations(x: torch.Tensor, c_real: int) -> torch.Tensor:
    """``[B, H, W, C]`` float -> ``[B, H, W, C32]`` int32, bit set iff
    x > 0; channel-pad bits 0. Each bit position appears once, so the sum
    is a bitwise or (bit 31 is the int32 sign)."""
    b, h, w, c = x.shape
    padded = words_for(c_real) * BITS
    bits = (x > 0).to(torch.int32)
    if padded != c:
        bits = F.pad(bits, (0, padded - c))
    shifts = torch.arange(BITS, dtype=torch.int32, device=x.device)
    words = (bits.reshape(b, h, w, -1, BITS) << shifts).sum(-1,
                                                            dtype=torch.int32)
    return words.contiguous()


def _out_hw(h: int, w: int, ks: int, stride: int, pad: int):
    return (h + 2 * pad - ks) // stride + 1, (w + 2 * pad - ks) // stride + 1


def _constants(ks: int, c32: int, c_real: int):
    """(adjust, pad_bits) of the two epilogues: K3's 2*cnt - adjust and K4's
    dot - pad_bits both equal 2*matches - K over the real bits."""
    total, k_real = ks * ks * c32 * BITS, ks * ks * c_real
    return 2 * total - k_real, total - k_real


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors on the main path; the reference on the card)
# ---------------------------------------------------------------------------


def im2col_bits(xp: torch.Tensor, ks: int, stride: int, pad: int):
    """Packed map ``[B, H, W, C32]`` -> patch matrix ``[B*OH*OW, ks*ks*C32]``
    in the weights' (tap, word) order; taps outside the image are 0 words."""
    b, h, w, c32 = xp.shape
    oh, ow = _out_hw(h, w, ks, stride, pad)
    xpad = F.pad(xp, (0, 0, pad, pad, pad, pad))
    taps = [xpad[:, ky: ky + (oh - 1) * stride + 1: stride,
                 kx: kx + (ow - 1) * stride + 1: stride]
            for ky in range(ks) for kx in range(ks)]
    return torch.stack(taps, dim=3).reshape(b * oh * ow, ks * ks * c32)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word of an int64 tensor holding [0, 2**32)
    (SWAR: PyTorch has no popcount op)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _unpack_pm1(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[R, K]`` -> +-1 float64 ``[R, K*32]`` (bit b of word k
    at column 32*k + b)."""
    shifts = torch.arange(BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return (2 * bits - 1).reshape(words.shape[0], -1).to(torch.float64)


def epilogue_plain(dot: torch.Tensor, mean, bias, activation: str):
    """``dot * mean + bias`` with two roundings, then the 0.1*y leaky."""
    y = dot.to(torch.float32) * mean + bias
    if activation == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    return y


def xnor_gemm_plain(xp, wp, mean, bias, c_real: int, stride: int, pad: int,
                    activation: str = "leaky"):
    """K3's function: xnor + popcount over the patch matrix, computed on
    int64 words in chunks of filters."""
    _check_epilogue(activation)
    b, h, w, c32 = xp.shape
    m, ks = wp.shape[0], wp.shape[1]
    oh, ow = _out_hw(h, w, ks, stride, pad)
    pt = im2col_bits(xp, ks, stride, pad)
    wf = wp.reshape(m, -1)
    n, k = pt.shape
    cnt = torch.empty((n, m), dtype=torch.int64, device=xp.device)
    step = max(1, (1 << 22) // max(1, n * k))
    for m0 in range(0, m, step):
        xnor = ~(pt[:, None, :] ^ wf[None, m0:m0 + step, :])
        cnt[:, m0:m0 + step] = _popcount32(
            xnor.to(torch.int64) & 0xFFFFFFFF).sum(-1)
    adjust, _ = _constants(ks, c32, c_real)
    return epilogue_plain(2 * cnt - adjust, mean, bias,
                          activation).reshape(b, oh, ow, m)


def xnor_gemm_mxu_plain(xp, wp, mean, bias, c_real: int, stride: int,
                        pad: int, activation: str = "leaky"):
    """K4's function: both operands unpacked to +-1 and multiplied in
    float64, exact (every partial sum is an integer below 2**53)."""
    _check_epilogue(activation)
    b, h, w, c32 = xp.shape
    m, ks = wp.shape[0], wp.shape[1]
    oh, ow = _out_hw(h, w, ks, stride, pad)
    pt = im2col_bits(xp, ks, stride, pad)
    dot = _unpack_pm1(pt) @ _unpack_pm1(wp.reshape(m, -1)).T
    _, pad_bits = _constants(ks, c32, c_real)
    return epilogue_plain(dot - pad_bits, mean, bias,
                          activation).reshape(b, oh, ow, m)


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel(name: str):
    """Build (first use) and load ``csrc/<name>.cu`` (``xnor_gemm`` or
    ``xnor_gemm_mxu``); returns its bound entry point, once per process."""
    from . import _build
    fn = getattr(_build.load(name), f"{name}_nhwc")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                   + [ctypes.c_void_p])
    return fn


def _launch(name: str, xp, wp, mean, bias, c_real: int, stride: int,
            pad: int, activation: str):
    """Check the operands, then launch kernel ``name`` on the current
    stream of ``xp``'s device."""
    _check_epilogue(activation)
    if not (xp.is_cuda and all(t.device == xp.device
                               for t in (wp, mean, bias))):
        raise ValueError(f"{name}: x, w, mean and bias must lie on one CUDA "
                         "device")
    if xp.dtype != torch.int32 or wp.dtype != torch.int32:
        raise TypeError(f"{name}: packed x and w must be int32, got "
                        f"{xp.dtype} and {wp.dtype}")
    if mean.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name}: mean and bias must be float32, got "
                        f"{mean.dtype} and {bias.dtype}")
    if xp.dim() != 4 or wp.dim() != 4:
        raise ValueError(f"{name}: x must be [B,H,W,C32] and w [M,ks,ks,C32]")
    b, h, w, c32 = xp.shape
    m, ks, ks2, wc32 = wp.shape
    if (ks != ks2 or wc32 != c32 or words_for(c_real) != c32
            or tuple(mean.shape) != (m,) or tuple(bias.shape) != (m,)):
        raise ValueError(f"{name}: shapes do not match: x {tuple(xp.shape)}, "
                         f"w {tuple(wp.shape)}, mean {tuple(mean.shape)}, "
                         f"bias {tuple(bias.shape)}, C={c_real}")
    if stride < 1 or pad < 0:
        raise ValueError(f"{name}: bad stride {stride} / pad {pad}")
    if not all(t.is_contiguous() for t in (xp, wp, mean, bias)):
        raise ValueError(f"{name}: x, w, mean and bias must be contiguous")
    oh, ow = _out_hw(h, w, ks, stride, pad)
    if b * oh * ow >= 2 ** 31:
        raise ValueError(f"{name}: B*OH*OW must stay below 2**31")
    adjust, pad_bits = _constants(ks, c32, c_real)
    out = torch.empty((b, oh, ow, m), dtype=torch.float32, device=xp.device)
    kernel = load_kernel(name)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    LAUNCH_COUNTS[name] += 1
    rc = kernel(xp.data_ptr(), wp.data_ptr(), mean.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, h, w, c32, m, oh, ow, ks,
                stride, pad, adjust if name == _POPCOUNT else pad_bits,
                int(activation == "leaky"), xp.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def xnor_gemm_cuda(xp, wp, mean, bias, c_real: int, stride: int, pad: int,
                   activation: str = "leaky"):
    """Launch K3, the popcount kernel."""
    return _launch(_POPCOUNT, xp, wp, mean, bias, c_real, stride, pad,
                   activation)


def xnor_gemm_mxu_cuda(xp, wp, mean, bias, c_real: int, stride: int,
                       pad: int, activation: str = "leaky"):
    """Launch K4, the bit-packed int8 tensor-core kernel."""
    return _launch(_MXU, xp, wp, mean, bias, c_real, stride, pad, activation)


def _dispatch(cuda_fn, plain_fn, xp, *args):
    if xp.is_cuda:
        return cuda_fn(xp, *args)
    if xp.device.type != "cpu":
        raise ValueError(f"xnor conv: unsupported device {xp.device}")
    return plain_fn(xp, *args)


def xnor_gemm(xp, wp, mean, bias, c_real: int, stride: int, pad: int,
              activation: str = "leaky"):
    """Packed ``[B,H,W,C32]`` x ``[M,ks,ks,C32]`` -> f32 ``[B,OH,OW,M]``
    with the popcount engine: K3 for a CUDA tensor, its plain version for a
    CPU tensor."""
    return _dispatch(xnor_gemm_cuda, xnor_gemm_plain, xp, wp, mean, bias,
                     c_real, stride, pad, activation)


def xnor_gemm_mxu(xp, wp, mean, bias, c_real: int, stride: int, pad: int,
                  activation: str = "leaky"):
    """As :func:`xnor_gemm`, with the bit-packed int8 engine (K4)."""
    return _dispatch(xnor_gemm_mxu_cuda, xnor_gemm_mxu_plain, xp, wp, mean,
                     bias, c_real, stride, pad, activation)


_ENGINES = {("popcount", False): xnor_gemm, ("mxu", False): xnor_gemm_mxu,
            ("popcount", True): xnor_gemm_plain,
            ("mxu", True): xnor_gemm_mxu_plain}


def conv2d_xnor_bits(x, wp, mean, bias, *, c_real: int, stride: int,
                     pad: int, activation: str = "leaky",
                     engine: str = "popcount", plain: bool = False):
    """Full BIT1 conv, the counterpart of ``conv2d_xnor_pallas``: pack the
    input's bits, then one launch of the bit kernel of ``engine``
    ("popcount": K3, "mxu": K4). ``plain=True`` runs the engine's plain
    version on any device. Borders are 0 bits (-1), so the network calls it
    only where the reference takes its bit path (stride 1, pad 1).
    ``x``: [B,H,W,C] f32 -> [B,OH,OW,M] f32."""
    fn = _ENGINES.get((engine, plain))
    if fn is None:
        raise ValueError(f"unknown XNOR engine {engine!r} (expected popcount "
                         "or mxu)")
    return fn(pack_activations(x, c_real), wp, mean, bias, c_real, stride,
              pad, activation)
