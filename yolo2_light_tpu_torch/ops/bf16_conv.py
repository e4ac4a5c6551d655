"""bfloat16 convolution with a float32 sum, bias and leaky: the
hand-written Hopper kernel (K6) and its plain PyTorch twin.

``csrc/bf16_conv.cu`` computes the float convs of ``-bf16`` as the JAX
package does (``yolo2_light_tpu/models/layers.py`` ``conv2d_fp32`` with
``compute_dtype=bfloat16``: ``lax.conv_general_dilated`` of the bfloat16
operands with ``preferred_element_type=float32``, then BN, bias and the
activation in float32)::

    y[b,oy,ox,m] = sum_{ky,kx,c} bf16(x[b, oy*s-pad+ky, ox*s-pad+kx, c])
                                 * w[m, ky, kx, c]        (float32 sum)

and, in its store, ``models/layers.conv2d_fp32``'s epilogue: ``+ bias``,
then leaky or linear, each step one rounded float32 operation as the
PyTorch ops take it (:func:`epilogue_plain` is that chain). BN is folded
into the weights and the bias before the forward
(``weights.fuse_conv_batchnorm``, on every app path); an unfused BN runs
as PyTorch ops after the bare conv (``models/layers.conv2d_fp32``).

It is not a TPU kernel (JAX leaves this conv to XLA): it exists because
PyTorch has no convolution that takes bfloat16 operands and returns their
float32 sum. cuDNN's bfloat16 convolution rounds its sum to bfloat16, and
the rounding it picks follows the batch, so detections changed with the
batch size. The kernel sums each output in one order fixed by C, ks and
the split of K across a cluster, and :func:`plan_launch` picks the split
from one image's shape, never from the batch: an image's outputs are
bit-identical at any batch.

Dispatch: :func:`conv2d_bf16` launches the kernel for a CUDA tensor and
runs the plain twin for a CPU tensor (or with ``plain=True``); the CUDA
path launches or raises and never falls back. The plain twin is the float32
convolution of the bfloat16-rounded operands (the products are exact in
float32), then :func:`epilogue_plain`, so it differs from the kernel only
by the order of the float32 sums.

Weights are ``[M, ks, ks, C]`` bfloat16 (K contiguous per output channel):
``params.layer_to_torch`` keeps ``-bf16``'s float weights as PyTorch's
``[O, I, kh, kw]`` shape in channels-last memory, whose ``permute(0, 2, 3,
1)`` is this layout without a copy. The first conv (C = 3) reads them as
``[M, 32]`` (:func:`pad_k32`), made once by ``params`` and required by
the kernel's wrapper.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .int8_conv import LAUNCH_COUNTS, MAX_SPLIT, SM_COUNT, SM_SMEM

_KERNEL = "bf16_conv"
# the kernel's launches by plan, "<form>/kc<kc>/split<split>"
PLAN_LAUNCHES: collections.Counter = collections.Counter()

# the kernel's fixed geometry (csrc/bf16_conv.cu)
TILE_PIXELS = 64         # output pixels per block
TILE_CHANNELS = 64       # output channels per block
SLABS = (16, 32)         # channels per K slab (plan_launch picks one)
C3_K = 32                # the c3 form's K: ks*ks*3 <= 27 products, padded
MAX_SMEM = 232448        # shared memory a block may use
MAX_BLOCKS_PER_SM = 3    # the kernel's register budget (kMinBlocks)
STAGES = (4, 3, 2)       # ring depths the planner tries, deepest first
_TILE_LD = 72            # floats per row of the partial tile
_TILE_BYTES = TILE_PIXELS * _TILE_LD * 4
_C3_ROW = C3_K * 2 + 16  # bytes per c3 A or B row
# the c3 kernel's static shared memory: A rows, B rows, the partial tile
C3_SMEM = 2 * TILE_PIXELS * _C3_ROW + _TILE_BYTES
_SPATIAL_TILES = ((8, 8), (4, 8), (4, 4))
FORMS = {"halo": 0, "flat": 1, "c3": 2}
# activations the kernel applies in its store; any other is the caller's
STORE_ACTIVATIONS = {"linear": 0, "leaky": 1}


def reset_plan_launches() -> None:
    PLAN_LAUNCHES.clear()


class Plan(NamedTuple):
    """One launch. ``form``: "halo" (``tile_h`` x ``tile_w`` output tiles
    over a staged input halo), "flat" (64-pixel tiles of a 1x1/s1/p0 conv
    over the batch's pixels) or "c3" (the first conv, C = 3: flat tiles,
    one k32 step). ``kc`` channels per K slab, ``split`` blocks of a
    cluster (1, 2, 4 or 8) sharing an output tile's K (rank r sums the
    slabs of :func:`slab_ranges`), ``stages`` slabs in the copy ring.
    Every field but ``tiles`` and ``blocks`` depends on one image's shape
    alone."""
    form: str
    tile_h: int
    tile_w: int
    kc: int
    split: int
    stages: int
    halo_rows: int
    tiles: int          # pixel tiles over the batch
    m_tiles: int
    slabs: int
    blocks: int         # tiles * m_tiles * split
    smem: int           # shared memory of one block, bytes


def c3_form(c: int, ks: int) -> bool:
    """Whether a conv runs the c3 form: C = 3 and its ks*ks*3 products fit
    one k32 step (ks <= 3)."""
    return c == 3 and ks * ks * c <= C3_K


def _smem_bytes(halo_rows: int, taps: int, stages: int, kc: int) -> int:
    """The kernel's shared memory: halo table, then either the pipeline (a
    double buffer of bfloat16 A rows, weight stages, float32 halo stages)
    or, after the main loop, the partial tile it is reused for."""
    tab = -(-halo_rows * 4 // 16) * 16
    a = 2 * halo_rows * (kc * 2 + 16)
    w = stages * TILE_CHANNELS * (taps * kc * 2 + 16)
    f = stages * halo_rows * kc * 4
    return tab + max(a + w + f, _TILE_BYTES)


def blocks_per_sm(smem: int) -> int:
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def plan_launch(b: int, h: int, w: int, c: int, m: int, ks: int, stride: int,
                pad: int) -> Plan:
    """Form, tile, slab width, split and ring depth of one launch, all from
    one image's shape (``b`` only counts the tiles). The rules, each chosen
    by ``scripts/trace_bf16_conv.py --plans`` on an H100 at yolov3-416's 23
    shapes (PERF.md):

    * C = 3 with ks <= 3: the c3 form;
    * ``kc`` 32 where C % 32 == 0 at a 1x1/s1/p0 conv and where C >= 512,
      else 16: at a 3x3 conv the 32-channel weight ring leaves one block an
      SM where 16 channels leave three, which pays only where a block walks
      many slabs;
    * the tile: the largest that fits, at the ring depth that lets the most
      blocks share an SM (the deeper of equals);
    * ``split``: the smallest power of two at which one image's tiles x
      m-tiles x split reach half the card's block slots (132 SMs x the
      blocks an SM holds at this plan's shared memory), capped at 8 and at
      half the slab count (a block sums at least two slabs); so one image
      never takes a second wave of those slots. Splits of 3, 5 and 6
      (ranges of uneven length) and a second wave both measured slower.

    Raises ValueError where no tile fits."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    m_tiles = -(-m // TILE_CHANNELS)
    if c3_form(c, ks):
        tiles = -(-b * oh * ow // TILE_PIXELS)
        return Plan("c3", 0, 0, C3_K, 1, 1, 0, tiles, m_tiles, 1,
                    tiles * m_tiles, C3_SMEM)
    flat = ks == 1 and stride == 1 and pad == 0
    kc = SLABS[1] if c % SLABS[1] == 0 and (flat or c >= 512) else SLABS[0]
    fits = []
    for th, tw in [(0, 0)] if flat else _SPATIAL_TILES:
        rows = (TILE_PIXELS if flat
                else ((th - 1) * stride + ks) * ((tw - 1) * stride + ks))
        depth = [(blocks_per_sm(smem), st, smem) for st in STAGES
                 if (smem := _smem_bytes(rows, ks * ks, st, kc)) <= MAX_SMEM]
        if depth:
            fits.append((th, tw, rows) + max(depth))
    if not fits:
        raise ValueError(f"bf16 conv: no tile of the kernel fits a {ks}x{ks}"
                         f"/s{stride} conv in shared memory")
    th, tw, rows, per_sm, stages, smem = fits[0]
    one = m_tiles * (-(-oh * ow // TILE_PIXELS) if flat
                     else -(-oh // th) * -(-ow // tw))
    slabs = -(-c // kc)
    slots = SM_COUNT * per_sm
    cap = min(MAX_SPLIT, max(1, slabs // 2))
    split = 1
    while 2 * split <= cap and 2 * one * split < slots:
        split *= 2
    tiles = (-(-b * oh * ow // TILE_PIXELS) if flat
             else b * -(-oh // th) * -(-ow // tw))
    return Plan("flat" if flat else "halo", th, tw, kc, split, stages, rows,
                tiles, m_tiles, slabs, tiles * m_tiles * split, smem)


def slab_ranges(slabs: int, split: int) -> list:
    """The K slabs ``[lo, hi)`` each block of a cluster of ``split`` sums, as
    the kernel divides them; the combine adds the ranks' partials in this
    order."""
    return [(r * slabs // split, (r + 1) * slabs // split)
            for r in range(split)]


def kernel_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """``[O, I, kh, kw]`` weights as the kernel's ``[M, ks, ks, C]``
    bfloat16: a view where ``w_oihw`` is bfloat16 in channels-last memory
    (the network's), else a copy."""
    return w_oihw.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def pad_k32(w: torch.Tensor) -> torch.Tensor:
    """The c3 form's weights: ``[M, ks, ks, 3]`` bfloat16 as ``[M, 32]``,
    each row's ks*ks*3 values in their order, then zeros."""
    mrows = w.reshape(w.shape[0], -1).to(torch.bfloat16)
    if mrows.shape[1] > C3_K:
        raise ValueError(f"pad_k32: {mrows.shape[1]} K values do not fit "
                         f"{C3_K}")
    return F.pad(mrows, (0, C3_K - mrows.shape[1])).contiguous()


def epilogue_plain(y: torch.Tensor, biases=None,
                   activation: str = "linear") -> torch.Tensor:
    """The kernel's store as PyTorch ops, the chain ``layers.conv2d_fp32``
    runs after its conv: ``+ biases`` where given, then leaky or linear;
    any other activation is left to the caller."""
    if biases is not None:
        y = y + biases
    if activation == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    return y


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
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 18 + [
        ctypes.c_void_p]
    return fn


def conv2d_bf16_cuda(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
                     *, w_k32: torch.Tensor | None = None, biases=None,
                     activation: str = "linear",
                     plan: Plan | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s device: ``x``
    ``[B,H,W,C]`` float32, ``w`` ``[M,ks,ks,C]`` bfloat16, both contiguous;
    returns ``[B,OH,OW,M]`` float32. With no ``biases`` and ``linear`` the
    bare conv; else :func:`epilogue_plain`'s chain in the store
    (``activation`` applied where the kernel has it,
    :data:`STORE_ACTIVATIONS`). ``w_k32``: the c3 form's weights,
    :func:`pad_k32` of ``w`` (``params`` keeps them as ``weights_k32``);
    the c3 form requires them. ``plan``: :func:`plan_launch`'s by default;
    a test may force another."""
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
    if plan.form == "c3":
        if not c3_form(c, ks):
            raise ValueError(f"conv2d_bf16_cuda: the c3 form takes C = 3 and "
                             f"ks <= 3, got C = {c}, ks = {ks}")
        if not (isinstance(w_k32, torch.Tensor)
                and w_k32.device == x.device and w_k32.dtype == torch.bfloat16
                and tuple(w_k32.shape) == (m, C3_K)
                and w_k32.is_contiguous()):
            raise ValueError(f"conv2d_bf16_cuda: w_k32 must be a contiguous "
                             f"bfloat16 [{m}, {C3_K}] tensor on {x.device}")
        w = w_k32
    if biases is not None and not (
            biases.device == x.device and biases.dtype == torch.float32
            and tuple(biases.shape) == (m,) and biases.is_contiguous()):
        raise ValueError(f"conv2d_bf16_cuda: biases must be a contiguous "
                         f"float32 [{m}] tensor on {x.device}")
    out = torch.empty((b, oh, ow, m), dtype=torch.float32, device=x.device)
    kernel = load_kernel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    PLAN_LAUNCHES[f"{plan.form}/kc{plan.kc}/split{plan.split}"] += 1

    rc = kernel(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                None if biases is None else biases.data_ptr(),
                STORE_ACTIVATIONS.get(activation, 0), b, h, wd, c, m, oh, ow,
                ks, stride, pad, FORMS[plan.form], plan.tile_h, plan.tile_w,
                plan.kc, plan.split, plan.stages, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"bf16_conv kernel launch failed: cudaError {rc}")
    return out


def conv2d_bf16(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int, *,
                w_k32: torch.Tensor | None = None, biases=None,
                activation: str = "linear",
                plain: bool = False) -> torch.Tensor:
    """NHWC float32 ``x`` * ``[M,ks,ks,C]`` bfloat16 ``w`` -> NHWC float32,
    each sum over the bfloat16-rounded operands taken in float32, then the
    epilogue (:func:`conv2d_bf16_cuda`'s arguments): the kernel for a CUDA
    tensor, the plain twin (:func:`conv2d_bf16_plain`, then
    :func:`epilogue_plain`) for a CPU tensor or with ``plain=True``."""
    if x.is_cuda and not plain:
        return conv2d_bf16_cuda(x, w, stride, pad, w_k32=w_k32,
                                biases=biases, activation=activation)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv2d_bf16: unsupported device {x.device}")
    return epilogue_plain(conv2d_bf16_plain(x, w, stride, pad), biases,
                          activation)
