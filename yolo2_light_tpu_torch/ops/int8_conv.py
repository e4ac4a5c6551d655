"""INT8 convolution: the hand-written Hopper kernel and its plain PyTorch twin.

``csrc/int8_conv.cu`` is the counterpart of the Pallas kernels
``yolo2_light_tpu/ops/pallas_int8.py`` (``conv3x3_int8_fused``, v1, and
``conv3x3_int8_tiled``, v2): an int8 implicit-GEMM convolution on the tensor
cores, accumulated in int32, with the reference's int8-"cpu" input quantize
and epilogue fused (reference: forward_convolutional_layer_q,
src/yolov2_forward_network_quantized.c:527-631):

    xq = clamp(trunc(x * input_mult), +-127)       (the f32-input entry)
    q = clamp(trunc_div(acc, R_MULT), +-32767)
    y = q * alpha + bias,   alpha = R_MULT / (input_mult * weights_mult)
    y = y > 0 ? y : y / 10          (leaky; linear skips it)

It takes every int8-eligible conv of a darknet net (size 1 or 3, stride 1
or 2; sizes up to 5 where the tiles fit), not only the 3x3/s1/p1 case the
Pallas kernels cover. Two entries launch the same kernel: the f32-input one
(:func:`conv2d_int8_f32`, the network's path: one launch per int8 conv,
quantize included) and the int8-input one (:func:`conv2d_int8`, the Pallas
signatures' pre-quantized input). :func:`plan_launch` picks each launch's
tiles, its copy-ring depth and its split of K across a thread-block cluster.

Dispatch: :func:`conv2d_int8` and :func:`conv2d_int8_f32` run the kernel for
a CUDA tensor and the plain version for a CPU tensor. The CUDA path launches
the kernel or raises; it never falls back. PyTorch has no usable int8
convolution of its own (``F.conv2d`` on int8 returns int8 and wraps, and
int32 ``matmul`` is not implemented on CUDA), so the plain version computes
the accumulator as an exact float64 convolution: every partial sum is an
integer of magnitude below 127 * 127 * ks * ks * C < 2**53.

Weights are ``[M, ks, ks, C]`` int8 (:func:`relayout_hwio` turns the JAX
package's HWIO layout into it once, at load time).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

# launches of each hand kernel, counted where the wrapper launches it
LAUNCH_COUNTS: collections.Counter = collections.Counter()
# PyTorch launches in front of an int8 conv on the card: "quantize"
# (quantize_i8 of a CUDA tensor) and "input_copy" (a non-contiguous input
# made dense); the network's kernel path makes neither
PRE_LAUNCHES: collections.Counter = collections.Counter()

_KERNEL = "int8_conv"
_EPILOGUES = ("leaky", "linear")

# the kernel's fixed geometry (csrc/int8_conv.cu)
SM_COUNT = 132           # H100 SXM
TILE_PIXELS = 64         # output pixels per block
TILE_CHANNELS = 64       # output channels per block
SLAB = 32                # channels per K slab
MAX_SPLIT = 8            # blocks per cluster (portable size)
MAX_SMEM = 232448        # shared memory a block may use
SM_SMEM = 233472         # shared memory of an SM (1 KiB of it per block
                         # reserved)
MAX_BLOCKS_PER_SM = 3    # the kernel's register budget (kMinBlocks)
STAGES = (4, 3, 2)       # ring depths the planner tries, deepest first
_A_ROW = SLAB + 16       # bytes per staged int8 row
_F_ROW = SLAB * 4        # bytes per staged f32 row
_TILE_LD = 72            # int32 words per row of the epilogue tile
_SPATIAL_TILES = ((8, 8), (4, 8), (4, 4))


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    PRE_LAUNCHES.clear()


def quantize_i8(x, mult: float):
    """Input quantization of the int8 path: ``clamp(trunc(x * mult), +-127)``
    (the C float->int16 cast truncates toward zero; reference:
    src/yolov2_forward_network_quantized.c:545-552). Counts its launches on
    the card in ``PRE_LAUNCHES["quantize"]``."""
    if x.is_cuda:
        PRE_LAUNCHES["quantize"] += 1
    return torch.clamp(torch.trunc(x * mult), -127, 127).to(torch.int8)


class Plan(NamedTuple):
    """One launch of the kernel: ``tile_h`` x ``tile_w`` output tiles (0 x 0:
    flat 64-pixel tiles of a 1x1/s1/p0 conv), ``split`` blocks per cluster
    sharing the K slabs, ``stages`` slabs in the copy ring, and what follows
    from them."""
    tile_h: int
    tile_w: int
    split: int
    stages: int
    halo_rows: int
    tiles: int          # pixel tiles over the batch
    m_tiles: int
    slabs: int
    blocks: int         # tiles * m_tiles * split
    smem: int           # dynamic shared memory of one block, bytes


def _smem_bytes(halo_rows: int, taps: int, f32_input: bool,
                stages: int) -> int:
    """The kernel's shared memory: halo table, int8 A rows (a ring, or a
    double buffer for the f32 entry), weight stages and the f32 entry's
    halo stages, or the epilogue tile if larger."""
    tab = -(-halo_rows * 4 // 16) * 16
    a = (2 if f32_input else stages) * halo_rows * _A_ROW
    w = stages * TILE_CHANNELS * (taps * SLAB + 16)
    f = stages * halo_rows * _F_ROW if f32_input else 0
    return tab + max(a + w + f, TILE_PIXELS * _TILE_LD * 4)


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel that shared memory and the register budget let
    one SM hold."""
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def _fit(rows: int, taps: int, f32_input: bool):
    """The ring depth that lets the most blocks share an SM (the deeper
    of equals): (blocks per SM, stages, smem), or None where no depth
    fits."""
    fits = [(blocks_per_sm(smem), st, smem) for st in STAGES
            if (smem := _smem_bytes(rows, taps, f32_input, st)) <= MAX_SMEM]
    return max(fits, default=None)


def plan_launch(b: int, h: int, w: int, c: int, m: int, ks: int, stride: int,
                pad: int, f32_input: bool = True) -> Plan:
    """Tiles, ring depth and cluster split of one launch. The kernel is
    bound by latency, so what counts is how many blocks share an SM: the
    largest tile at which two blocks fit (else the largest that fits one),
    at the ring depth that fits the most; then, where the tiles give fewer
    blocks than the card has SMs, the fewest cluster blocks (at most 8, at
    most the number of slabs) that make the grid cover them. Raises
    ValueError where no tile fits (sizes above 5)."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    flat = ks == 1 and stride == 1 and pad == 0
    shapes = [(0, 0)] if flat else list(_SPATIAL_TILES)
    fits = []
    for th, tw in shapes:
        rows = (TILE_PIXELS if flat
                else ((th - 1) * stride + ks) * ((tw - 1) * stride + ks))
        fit = _fit(rows, ks * ks, f32_input)
        if fit is not None:
            fits.append((th, tw, rows) + fit)
    if not fits:
        raise ValueError(f"int8 conv: no tile of the kernel fits a {ks}x{ks}"
                         f"/s{stride} conv in shared memory")
    th, tw, rows, _, stages, smem = next(
        (f for f in fits if f[3] >= 2), fits[0])
    tiles = (-(-b * oh * ow // TILE_PIXELS) if flat
             else b * -(-oh // th) * -(-ow // tw))
    m_tiles = -(-m // TILE_CHANNELS)
    slabs = -(-c // SLAB)
    split = 1
    while tiles * m_tiles * split < SM_COUNT and split < min(MAX_SPLIT,
                                                             slabs):
        split += 1
    return Plan(th, tw, split, stages, rows, tiles, m_tiles, slabs,
                tiles * m_tiles * split, smem)


def slab_ranges(slabs: int, split: int) -> list:
    """The K slabs ``[lo, hi)`` each block of a cluster of ``split`` sums, as
    the kernel divides them."""
    return [(r * slabs // split, (r + 1) * slabs // split)
            for r in range(split)]


def relayout_hwio(weights_int8) -> torch.Tensor:
    """HWIO ``[ks, ks, C, M]`` int8 (JAX package layout) -> ``[M, ks, ks, C]``
    contiguous int8, the layout the kernel reduces along."""
    w = torch.as_tensor(np.asarray(weights_int8, np.int8))
    return w.permute(3, 0, 1, 2).contiguous()


def alpha_f32(input_mult, weights_mult, r_mult: int = 32) -> float:
    """``R_MULT / (input_mult * weights_mult)`` rounded as float32 arithmetic
    rounds it (the JAX package computes it on float32 device scalars); the
    returned Python float holds that float32 value exactly."""
    return float(np.float32(r_mult)
                 / (np.float32(input_mult) * np.float32(weights_mult)))


def _shift_of(r_mult: int) -> int:
    if r_mult <= 0 or r_mult & (r_mult - 1):
        raise ValueError(f"r_mult must be a power of two, got {r_mult}")
    return r_mult.bit_length() - 1


def _check_epilogue(activation: str) -> None:
    if activation not in _EPILOGUES:
        raise ValueError(f"int8 conv epilogue must be one of {_EPILOGUES}, "
                         f"got {activation!r}")


# ---------------------------------------------------------------------------
# Plain version (CPU tensors on the main path; the reference on the card)
# ---------------------------------------------------------------------------


def int8_conv_acc_plain(x_int8: torch.Tensor, w: torch.Tensor, stride: int,
                        pad: int) -> torch.Tensor:
    """Exact int32 accumulator ``[B, OH, OW, M]`` of the int8 convolution,
    computed as a float64 convolution (exact: see the module docstring).
    cuDNN is kept out: its algorithm choice may include FFT or Winograd
    transforms, which round even in float64; PyTorch's own im2col + GEMM
    does not."""
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x_int8.permute(0, 3, 1, 2).to(torch.float64),
                       w.permute(0, 3, 1, 2).to(torch.float64),
                       stride=stride, padding=pad)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def requantize(acc: torch.Tensor, r_mult: int = 32) -> torch.Tensor:
    """``clamp(trunc_div(acc, r_mult), +-32767)`` as the C int math does it:
    sign-fix then arithmetic shift (r_mult is a power of two)."""
    shift = _shift_of(r_mult)
    q = (acc + ((acc >> 31) & (r_mult - 1))) >> shift
    return q.clamp(-32767, 32767)


def epilogue_plain(q: torch.Tensor, bias: torch.Tensor, alpha: float,
                   activation: str) -> torch.Tensor:
    """``q * alpha + bias`` with two roundings, then the x/10 leaky. The
    divisor is a tensor on ``q``'s device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which is not IEEE ``/ 10``."""
    y = q.to(torch.float32) * alpha + bias
    if activation == "leaky":
        ten = torch.tensor(10.0, dtype=torch.float32, device=y.device)
        y = torch.where(y > 0, y, y / ten)
    return y


def conv2d_int8_plain(x_int8, w, bias, alpha: float, stride: int, pad: int,
                      activation: str = "leaky", r_mult: int = 32):
    _check_epilogue(activation)
    acc = int8_conv_acc_plain(x_int8, w, stride, pad)
    return epilogue_plain(requantize(acc, r_mult), bias, alpha, activation)


def conv2d_int8_f32_plain(x, w, bias, input_mult: float, alpha: float,
                          stride: int, pad: int, activation: str = "leaky",
                          r_mult: int = 32):
    """The f32-input entry's plain version: :func:`quantize_i8`, then
    :func:`conv2d_int8_plain`."""
    return conv2d_int8_plain(quantize_i8(x, input_mult), w, bias, alpha,
                             stride, pad, activation, r_mult)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel():
    """Build (first use) and load ``csrc/int8_conv.cu``; returns its bound
    entry point, once per process."""
    from . import _build
    fn = _build.load(_KERNEL).int8_conv_nhwc
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_float] + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    return fn


def _launch(name: str, x, w, bias, input_mult, alpha: float, stride: int,
            pad: int, activation: str, r_mult: int, plan: Plan | None):
    """Check the operands of either entry and launch the kernel on the
    current stream of ``x``'s device."""
    _check_epilogue(activation)
    f32_input = input_mult is not None
    if not (x.is_cuda and w.device == x.device and bias.device == x.device):
        raise ValueError(f"{name}: x, w and bias must lie on one CUDA device")
    x_dtype = torch.float32 if f32_input else torch.int8
    if x.dtype != x_dtype or w.dtype != torch.int8:
        raise TypeError(f"{name}: x must be {x_dtype} and w int8, got "
                        f"{x.dtype} and {w.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name}: bias must be float32, got {bias.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"{name}: x must be [B,H,W,C] and w [M,ks,ks,C]")
    b, h, wd, c = x.shape
    m, ks, ks2, wc = w.shape
    if ks != ks2 or wc != c or tuple(bias.shape) != (m,):
        raise ValueError(f"{name}: shapes do not match: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, bias {tuple(bias.shape)}")
    if c % 4:
        raise ValueError(f"{name}: the kernel needs C % 4 == 0, got C={c}")
    if stride < 1 or pad < 0:
        raise ValueError(f"{name}: bad stride {stride} / pad {pad}")
    if not (x.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError(f"{name}: x, w and bias must be contiguous")
    if x.data_ptr() % (16 if f32_input else 4) or w.data_ptr() % 4:
        raise ValueError(f"{name}: x must be {16 if f32_input else 4}-byte "
                         "aligned and w 4-byte aligned")
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (wd + 2 * pad - ks) // stride + 1
    if b * oh * ow >= 2 ** 31 or b * h * wd >= 2 ** 31:
        raise ValueError(f"{name}: B*H*W and B*OH*OW must stay below 2**31")
    if plan is None:
        plan = plan_launch(b, h, wd, c, m, ks, stride, pad, f32_input)
    shift = _shift_of(r_mult)
    out = torch.empty((b, oh, ow, m), dtype=torch.float32, device=x.device)
    kernel = load_kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    rc = kernel(
        x.data_ptr(), int(f32_input),
        1.0 if input_mult is None else float(input_mult), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, h, wd, c, m, oh, ow, ks, stride,
        pad, alpha, shift, int(activation == "leaky"), plan.tile_h,
        plan.tile_w, plan.split, plan.stages, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {rc}")
    return out


def conv2d_int8_cuda(x_int8, w, bias, alpha: float, stride: int, pad: int,
                     activation: str = "leaky", r_mult: int = 32, *,
                     plan: Plan | None = None):
    """Launch the kernel's int8-input entry (pre-quantized ``x_int8``) on
    the current stream of its device. ``plan``: :func:`plan_launch`'s by
    default; a test may force another split."""
    return _launch("conv2d_int8_cuda", x_int8, w, bias, None, alpha, stride,
                   pad, activation, r_mult, plan)


def conv2d_int8_f32_cuda(x, w, bias, input_mult: float, alpha: float,
                         stride: int, pad: int, activation: str = "leaky",
                         r_mult: int = 32, *, plan: Plan | None = None):
    """Launch the kernel's f32-input entry, which quantizes ``x`` at
    ``input_mult`` as it stages it: one launch for the whole int8 conv."""
    return _launch("conv2d_int8_f32_cuda", x, w, bias, input_mult, alpha,
                   stride, pad, activation, r_mult, plan)


def conv2d_int8(x_int8, w, bias, alpha: float, stride: int, pad: int,
                activation: str = "leaky", r_mult: int = 32):
    """int8 NHWC ``x_int8`` * ``[M,ks,ks,C]`` int8 ``w`` -> f32 NHWC with the
    requant epilogue. The kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x_int8.is_cuda:
        return conv2d_int8_cuda(x_int8, w, bias, alpha, stride, pad,
                                activation, r_mult)
    if x_int8.device.type != "cpu":
        raise ValueError(f"conv2d_int8: unsupported device {x_int8.device}")
    return conv2d_int8_plain(x_int8, w, bias, alpha, stride, pad, activation,
                             r_mult)


def conv2d_int8_f32(x, w, bias, input_mult: float, alpha: float, stride: int,
                    pad: int, activation: str = "leaky", r_mult: int = 32):
    """f32 NHWC ``x`` quantized at ``input_mult``, then the int8 conv with
    the requant epilogue: the kernel's f32-input entry for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.is_cuda:
        return conv2d_int8_f32_cuda(x, w, bias, input_mult, alpha, stride,
                                    pad, activation, r_mult)
    if x.device.type != "cpu":
        raise ValueError(f"conv2d_int8_f32: unsupported device {x.device}")
    return conv2d_int8_f32_plain(x, w, bias, input_mult, alpha, stride, pad,
                                 activation, r_mult)


def conv3x3_int8_fused(x_int8, weights_int8, biases, input_mult, weights_mult,
                       *, activation: str = "leaky", r_mult: int = 32):
    """The function of the Pallas ``conv3x3_int8_fused`` (v1), which is also
    that of ``conv3x3_int8_tiled`` (v2): 3x3/stride-1/pad-1 int8 conv of a
    pre-quantized ``[B,H,W,C]`` int8 tensor with HWIO ``[3,3,C,M]`` int8
    weights (NumPy), returning f32 ``[B,H,W,M]`` through the same kernel.
    The weights are re-laid on every call, so the network path uses
    :func:`conv2d_int8` with weights laid out at load time instead."""
    x = torch.as_tensor(x_int8)
    w = relayout_hwio(weights_int8).to(x.device)
    bias = torch.as_tensor(np.asarray(biases, np.float32)).to(x.device)
    return conv2d_int8(x, w, bias, alpha_f32(input_mult, weights_mult, r_mult),
                       1, 1, activation, r_mult)
