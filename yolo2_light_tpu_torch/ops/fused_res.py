"""Fused darknet53 residual block: the hand-written Hopper kernel and its plain
PyTorch twin.

``csrc/fused_res.cu`` is the counterpart of the Pallas kernels
``yolo2_light_tpu/ops/pallas_fused.py`` ``fused_res_stage`` (K chained blocks
with the trunk VMEM-resident) and ``fused_res_stage_strips`` (one block over
row strips). One launch computes one residual block, out of place:

    t1  = conv1x1_int8(quantize(x, m1))    leaky, alpha1, b1   (C -> C2)
    y   = conv3x3_int8(quantize(t1, m2))   leaky, alpha2, b2   (C2 -> C)
    out = x + y

with the int8-"cpu" requant epilogue of ``ops/int8_conv`` on both convs. A
K-block stage is K launches alternating between two buffers.

Dispatch: :func:`fused_res_block` launches the kernel for a CUDA tensor and
runs :func:`res_block_plain` for a CPU tensor; the CUDA path never falls back
to the plain version or to two ``int8_conv`` launches. Weights are the int8
layout ``params.layer_to_torch`` gives every int8 conv: ``w1`` ``[C2,1,1,C]``,
``w2`` ``[C,3,3,C2]``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..quant import R_MULT
from . import int8_conv
from .int8_conv import LAUNCH_COUNTS, alpha_f32, quantize_i8, relayout_hwio

_KERNEL = "fused_res"
_COUNT = "fused_res_block"   # its key in int8_conv.LAUNCH_COUNTS
_SHIFT = int8_conv._shift_of(R_MULT)


# ---------------------------------------------------------------------------
# Plain version (CPU tensors on the main path; the reference on the card)
# ---------------------------------------------------------------------------


def res_block_plain(x, w1, b1, m1: float, alpha1: float, w2, b2, m2: float,
                    alpha2: float):
    """The composition the unfused int8 path runs: quantize, 1x1 int8 conv,
    quantize, 3x3/pad-1 int8 conv (both leaky), then the shortcut add."""
    t1 = int8_conv.conv2d_int8_plain(quantize_i8(x, m1), w1, b1, alpha1, 1, 0,
                                     "leaky", R_MULT)
    y = int8_conv.conv2d_int8_plain(quantize_i8(t1, m2), w2, b2, alpha2, 1, 1,
                                    "leaky", R_MULT)
    return x + y


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel():
    """Build (first use) and load ``csrc/fused_res.cu``; returns its bound
    entry point, once per process."""
    from . import _build
    fn = _build.load(_KERNEL).fused_res_block_nhwc
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return fn


@functools.cache
def _load_occupancy():
    from . import _build
    fn = _build.load(_KERNEL).fused_res_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    return fn


def occupancy(c: int, c2: int, device: int = 0) -> dict:
    """What the kernel launches for a block of widths ``c -> c2 -> c`` on
    CUDA device ``device``: the cluster size, the dynamic shared memory per
    block, how many such clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``), the two phases' ring depths and
    the halo rows per phase-1 pass."""
    info = (ctypes.c_int * 6)()
    rc = _load_occupancy()(c, c2, device, info)
    if rc != 0:
        raise RuntimeError(f"fused_res occupancy query failed: cudaError {rc}")
    keys = ("cluster", "smem_bytes", "max_active_clusters", "stages1",
            "stages2", "halo_rows_per_pass")
    return dict(zip(keys, info))


def _check_cuda_operands(x, w1, b1, w2, b2, out):
    tensors = (x, w1, b1, w2, b2) + (() if out is None else (out,))
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("fused_res_block_cuda: x, the weights, the biases "
                         "and out must lie on one CUDA device")
    if x.dtype != torch.float32 or b1.dtype != torch.float32 \
            or b2.dtype != torch.float32:
        raise TypeError(f"fused_res_block_cuda: x, b1 and b2 must be float32, "
                        f"got {x.dtype}, {b1.dtype} and {b2.dtype}")
    if w1.dtype != torch.int8 or w2.dtype != torch.int8:
        raise TypeError(f"fused_res_block_cuda: w1 and w2 must be int8, got "
                        f"{w1.dtype} and {w2.dtype}")
    if x.dim() != 4 or w1.dim() != 4 or w2.dim() != 4:
        raise ValueError("fused_res_block_cuda: x must be [B,H,W,C], w1 "
                         "[C2,1,1,C] and w2 [C,3,3,C2]")
    b, h, w, c = x.shape
    c2 = w1.shape[0]
    if (tuple(w1.shape) != (c2, 1, 1, c) or tuple(w2.shape) != (c, 3, 3, c2)
            or tuple(b1.shape) != (c2,) or tuple(b2.shape) != (c,)):
        raise ValueError(f"fused_res_block_cuda: shapes do not match: x "
                         f"{tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
                         f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 "
                         f"{tuple(b2.shape)}")
    if c % 4 or c2 % 4 or c2 == 0:
        raise ValueError(f"fused_res_block_cuda: the kernel needs C % 4 == 0 "
                         f"and C2 % 4 == 0, got C={c}, C2={c2}")
    if c2 > 2048:
        raise ValueError(f"fused_res_block_cuda: the t1 tile of C2={c2} "
                         "channels does not fit in shared memory (C2 <= 2048)")
    if b > 65535 or -(-h // 8) * -(-w // 8) > 65535:
        raise ValueError("fused_res_block_cuda: B and ceil(H/8)*ceil(W/8) "
                         "must stay at or below 65535")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_res_block_cuda: every tensor must be "
                         "contiguous")
    if x.data_ptr() % 16 or w1.data_ptr() % 4 or w2.data_ptr() % 4:
        raise ValueError("fused_res_block_cuda: x must be 16-byte aligned "
                         "and w1, w2 4-byte aligned")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.data_ptr() == x.data_ptr()):
        raise ValueError("fused_res_block_cuda: out must be a separate "
                         "float32 buffer of x's shape")


def fused_res_block_cuda(x, w1, b1, m1: float, alpha1: float, w2, b2,
                         m2: float, alpha2: float, out=None):
    """Launch the kernel on the current stream of ``x``'s device; writes into
    ``out`` (a new tensor when None), never into ``x``."""
    _check_cuda_operands(x, w1, b1, w2, b2, out)
    b, h, w, c = x.shape
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    kernel = load_kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCH_COUNTS[_COUNT] += 1
    rc = kernel(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), b, h, w, c, w1.shape[0], m1, alpha1,
        m2, alpha2, _SHIFT, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fused_res kernel launch failed: cudaError {rc}")
    return out


def fused_res_block(x, w1, b1, m1: float, alpha1: float, w2, b2, m2: float,
                    alpha2: float, out=None):
    """One residual block of the f32 NHWC trunk ``x``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor. ``m1``/``m2``: the convs'
    input multipliers; ``alpha1``/``alpha2``: their float32 requant scales
    (:func:`int8_conv.alpha_f32`)."""
    if x.is_cuda:
        return fused_res_block_cuda(x, w1, b1, m1, alpha1, w2, b2, m2, alpha2,
                                    out)
    if x.device.type != "cpu":
        raise ValueError(f"fused_res_block: unsupported device {x.device}")
    return res_block_plain(x, w1, b1, m1, alpha1, w2, b2, m2, alpha2)


def run_blocks(x, blocks: list, plain: bool = False):
    """Chain residual blocks given as dicts of ``fused_res_block``'s
    arguments (``w1 b1 m1 alpha1 w2 b2 m2 alpha2``). On the card the K
    launches alternate between two buffers; ``x`` itself is never written.
    ``plain=True`` runs :func:`res_block_plain` on any device (the
    reference the kernel path is checked against)."""
    if plain:
        for blk in blocks:
            x = res_block_plain(x, **blk)
        return x
    bufs = [None, None]
    if x.is_cuda and len(blocks) > 1:
        bufs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                for _ in bufs]
    cur = x
    for k, blk in enumerate(blocks):
        cur = fused_res_block(cur, out=bufs[k % 2], **blk)
    return cur


# ---------------------------------------------------------------------------
# The Pallas kernels' signatures
# ---------------------------------------------------------------------------


def _torch_block(blk: dict, device) -> dict:
    """A JAX-package block dict (HWIO NumPy weights, multipliers) laid out
    as :func:`fused_res_block`'s arguments."""
    w1 = np.asarray(blk["w1"], np.int8)
    w1 = w1.reshape(1, 1, -1, w1.shape[-1])

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32)).to(device)

    return dict(
        w1=relayout_hwio(w1).to(device), b1=f32(blk["b1"]),
        m1=float(np.float32(blk["m1"])),
        alpha1=alpha_f32(blk["m1"], blk["wm1"], R_MULT),
        w2=relayout_hwio(blk["w2"]).to(device), b2=f32(blk["b2"]),
        m2=float(np.float32(blk["m2"])),
        alpha2=alpha_f32(blk["m2"], blk["wm2"], R_MULT))


def fused_res_stage(x, blocks: list):
    """The function of the Pallas ``fused_res_stage``: K chained residual
    blocks over the f32 NHWC trunk ``x``. ``blocks``: dicts of ``w1``
    ([C, C2] or HWIO [1,1,C,C2] int8), ``b1``, ``m1``, ``wm1``, ``w2`` (HWIO
    [3,3,C2,C] int8), ``b2``, ``m2``, ``wm2``. The weights are re-laid on
    every call; the network path lays them out once, at load time."""
    x = torch.as_tensor(x)
    return run_blocks(x, [_torch_block(b, x.device) for b in blocks])


def fused_res_stage_strips(x, blocks: list, n_strips: int = 4):
    """The function of the Pallas ``fused_res_stage_strips``: one residual
    block (K=1). The kernel tiles the image itself, so the result does not
    depend on ``n_strips``."""
    assert len(blocks) == 1, "strip variant fuses exactly one residual block"
    return fused_res_stage(x, blocks)
