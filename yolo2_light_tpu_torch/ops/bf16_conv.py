"""bfloat16 convolution with a float32 sum: the hand-written Hopper kernel
(K6) and its plain PyTorch twin.

``csrc/bf16_conv.cu`` computes the float convs of ``-bf16`` as the JAX
package does (``yolo2_light_tpu/models/layers.py`` ``conv2d_fp32`` with
``compute_dtype=bfloat16``: ``lax.conv_general_dilated`` of the bfloat16
operands with ``preferred_element_type=float32``)::

    y[b,oy,ox,m] = sum_{ky,kx,c} bf16(x[b, oy*s-pad+ky, ox*s-pad+kx, c])
                                 * w[m, ky, kx, c]        (float32 sum)

It is not a TPU kernel (JAX leaves this conv to XLA): it exists because
PyTorch has no convolution that takes bfloat16 operands and returns their
float32 sum. cuDNN's bfloat16 convolution rounds its sum to bfloat16, and
the rounding it picks follows the batch, so detections changed with the
batch size. The kernel sums each output in one order fixed by C and ks
(no split of K, no atomics): an image's outputs are bit-identical at any
batch.

Dispatch: :func:`conv2d_bf16` launches the kernel for a CUDA tensor and
runs the plain twin for a CPU tensor; the CUDA path launches or raises and
never falls back. The plain twin is the float32 convolution of the
bfloat16-rounded operands (the products are exact in float32), so it
differs from the kernel only by the order of the float32 sums.

Weights are ``[M, ks, ks, C]`` bfloat16 (K contiguous per output channel):
``params.layer_to_torch`` keeps ``-bf16``'s float weights as PyTorch's
``[O, I, kh, kw]`` shape in channels-last memory, whose ``permute(0, 2, 3,
1)`` is this layout without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .int8_conv import LAUNCH_COUNTS, SM_SMEM

_KERNEL = "bf16_conv"

# the kernel's fixed geometry (csrc/bf16_conv.cu)
TILE_PIXELS = 64         # output pixels per block
TILE_CHANNELS = 64       # output channels per block
SLAB = 16                # channels per K slab (32 bytes of bfloat16)
MAX_SMEM = 232448        # shared memory a block may use
MAX_BLOCKS_PER_SM = 3    # the kernel's register budget (kMinBlocks)
STAGES = (4, 3, 2)       # ring depths the planner tries, deepest first
_A_ROW = 48              # bytes per staged bfloat16 row (32 + 16 pad)
_F_ROW = SLAB * 4        # bytes per staged float32 row
_SPATIAL_TILES = ((8, 8), (4, 8), (4, 4))


class Plan(NamedTuple):
    """One launch: ``tile_h`` x ``tile_w`` output tiles (0 x 0: flat
    64-pixel tiles of a 1x1/s1/p0 conv), ``stages`` slabs in the copy ring,
    and what follows from them. No plan splits K: the sum order of an
    output depends on C and ks alone."""
    tile_h: int
    tile_w: int
    stages: int
    halo_rows: int
    tiles: int          # pixel tiles over the batch
    m_tiles: int
    slabs: int
    blocks: int         # tiles * m_tiles
    smem: int           # dynamic shared memory of one block, bytes


def _smem_bytes(halo_rows: int, taps: int, stages: int) -> int:
    """The kernel's shared memory: halo table, a double buffer of bfloat16
    A rows, weight stages and float32 halo stages."""
    tab = -(-halo_rows * 4 // 16) * 16
    a = 2 * halo_rows * _A_ROW
    w = stages * TILE_CHANNELS * (taps * 32 + 16)
    f = stages * halo_rows * _F_ROW
    return tab + a + w + f


def blocks_per_sm(smem: int) -> int:
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def plan_launch(b: int, h: int, w: int, c: int, m: int, ks: int, stride: int,
                pad: int) -> Plan:
    """Tiles and ring depth of one launch, K1's rule without its K split:
    the largest tile at which two blocks share an SM (else the largest that
    fits), at the ring depth that lets the most blocks share one (the deeper
    of equals). The tile depends on ks and stride only, never on the batch.
    Raises ValueError where no tile fits."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    flat = ks == 1 and stride == 1 and pad == 0
    fits = []
    for th, tw in [(0, 0)] if flat else _SPATIAL_TILES:
        rows = (TILE_PIXELS if flat
                else ((th - 1) * stride + ks) * ((tw - 1) * stride + ks))
        depth = [(blocks_per_sm(smem), st, smem) for st in STAGES
                 if (smem := _smem_bytes(rows, ks * ks, st)) <= MAX_SMEM]
        if depth:
            fits.append((th, tw, rows) + max(depth))
    if not fits:
        raise ValueError(f"bf16 conv: no tile of the kernel fits a {ks}x{ks}"
                         f"/s{stride} conv in shared memory")
    th, tw, rows, _, stages, smem = next((f for f in fits if f[3] >= 2),
                                         fits[0])
    tiles = (-(-b * oh * ow // TILE_PIXELS) if flat
             else b * -(-oh // th) * -(-ow // tw))
    m_tiles = -(-m // TILE_CHANNELS)
    return Plan(th, tw, stages, rows, tiles, m_tiles, -(-c // SLAB),
                tiles * m_tiles, smem)


def kernel_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """``[O, I, kh, kw]`` weights as the kernel's ``[M, ks, ks, C]``
    bfloat16: a view where ``w_oihw`` is bfloat16 in channels-last memory
    (the network's), else a copy."""
    return w_oihw.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def conv2d_bf16_plain(x: torch.Tensor, w: torch.Tensor, stride: int,
                      pad: int) -> torch.Tensor:
    """The float32 convolution of the bfloat16-rounded operands, NHWC in and
    out (``w``: ``[M, ks, ks, C]``). TF32 and cuDNN's nondeterministic
    algorithms are off on the card (``layers.set_fp32_precision``)."""
    xc = x.permute(0, 3, 1, 2).to(torch.bfloat16).to(torch.float32)
    wc = w.permute(0, 3, 1, 2).to(torch.bfloat16).to(torch.float32)
    y = F.conv2d(xc, wc, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def sum_bound(x: torch.Tensor, w: torch.Tensor, stride: int,
              pad: int) -> torch.Tensor:
    """How far the kernel's output may lie from the plain twin's, per
    output: ``K * 2**-23 * sum |x * w|`` over its K = ks*ks*C bfloat16
    products (``x`` NHWC, ``w`` ``[M,ks,ks,C]``). Two float32 sums of the
    same K exact products, in two orders, each lie within ``(K - 1) *
    2**-24`` of that sum of magnitudes from the exact sum. The magnitudes
    are summed exactly, in float64 with cuDNN off. A yardstick for checks;
    the forward never calls it."""
    _, ks, _, c = w.shape
    with torch.backends.cudnn.flags(enabled=False):
        mag = F.conv2d(x.to(torch.bfloat16).abs().permute(0, 3, 1, 2).double(),
                       w.to(torch.bfloat16).abs().permute(0, 3, 1, 2).double(),
                       stride=stride, padding=pad)
    return mag.permute(0, 2, 3, 1) * (ks * ks * c * 2.0 ** -23)


# Head maps of two -bf16 forwards that sum the same bfloat16 products in
# other orders (the kernel and its twin, or XLA's conv): a sum within an ULP
# of a bfloat16 boundary of the next conv's input rounds the other way, and
# that step (2**-8 of the value) travels downstream. An entry is "within"
# at rtol and atol HEADS_TOL; the mean difference stays below HEADS_MEAN.
HEADS_TOL = 0.1
HEADS_MEAN = 2e-2


class HeadsGap(NamedTuple):
    within: float       # share of the entries within HEADS_TOL
    mean: float         # mean absolute difference
    max: float          # largest absolute difference


def heads_gap(got: torch.Tensor, want: torch.Tensor) -> HeadsGap:
    """How far one head map of a -bf16 forward lies from another's."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    d = (got.double() - want.double()).abs()
    within = d <= HEADS_TOL + HEADS_TOL * want.double().abs()
    return HeadsGap(float(within.double().mean()), float(d.mean()),
                    float(d.max()))


@functools.cache
def load_kernel():
    """Build (first use) and load ``csrc/bf16_conv.cu``; returns its bound
    entry point, once per process."""
    from . import _build
    fn = _build.load(_KERNEL).bf16_conv_nhwc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    return fn


def conv2d_bf16_cuda(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
                     *, plan: Plan | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s device: ``x``
    ``[B,H,W,C]`` float32, ``w`` ``[M,ks,ks,C]`` bfloat16, both contiguous;
    returns ``[B,OH,OW,M]`` float32. ``plan``: :func:`plan_launch`'s by
    default; a test may force another."""
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("conv2d_bf16_cuda: x and w must lie on one CUDA "
                         "device")
    if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise TypeError("conv2d_bf16_cuda: x must be float32 and w bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("conv2d_bf16_cuda: x must be [B,H,W,C] and w "
                         "[M,ks,ks,C]")
    b, h, wd, c = x.shape
    m, ks, ks2, wc = w.shape
    if ks != ks2 or wc != c:
        raise ValueError(f"conv2d_bf16_cuda: shapes do not match: x "
                         f"{tuple(x.shape)}, w {tuple(w.shape)}")
    if stride < 1 or pad < 0:
        raise ValueError(f"conv2d_bf16_cuda: bad stride {stride} / pad {pad}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_bf16_cuda: x and w must be contiguous")
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (wd + 2 * pad - ks) // stride + 1
    if b * oh * ow >= 2 ** 31 or b * h * wd >= 2 ** 31:
        raise ValueError("conv2d_bf16_cuda: B*H*W and B*OH*OW must stay "
                         "below 2**31")
    if plan is None:
        plan = plan_launch(b, h, wd, c, m, ks, stride, pad)
    out = torch.empty((b, oh, ow, m), dtype=torch.float32, device=x.device)
    kernel = load_kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    rc = kernel(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, m,
                oh, ow, ks, stride, pad, plan.tile_h, plan.tile_w,
                plan.stages, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"bf16_conv kernel launch failed: cudaError {rc}")
    return out


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, stride: int,
                pad: int) -> torch.Tensor:
    """NHWC float32 ``x`` * ``[M,ks,ks,C]`` bfloat16 ``w`` -> NHWC float32,
    each sum over the bfloat16-rounded operands taken in float32: the kernel
    for a CUDA tensor, the plain twin for a CPU tensor."""
    if x.is_cuda:
        return conv2d_bf16_cuda(x, w, stride, pad)
    if x.device.type != "cpu":
        raise ValueError(f"conv2d_bf16: unsupported device {x.device}")
    return conv2d_bf16_plain(x, w, stride, pad)
