"""XNOR (BIT1) convolution on bit-packed operands: two hand-written Hopper
kernels and their plain PyTorch twins.

Counterparts of the Pallas kernels of ``yolo2_light_tpu/ops/pallas_xnor.py``:

* ``csrc/xnor_gemm.cu`` replaces ``xnor_gemm`` (the popcount engine,
  ``-xnor_kernel pallas``)::

      cnt = sum_f popcount(~(x_bits[p, f] ^ w_bits[m, f]))
      y   = (2 * cnt - adjust) * mean[m] + bias[m],  adjust = 2 * F*32 - K

* ``csrc/xnor_gemm_mxu.cu`` replaces ``xnor_gemm_mxu`` (the bit-packed
  tensor-core engine, ``-xnor_kernel pallas_mxu``): the packed words are
  contracted on the binary tensor cores, and the +-1 dot is recovered from
  and-popcounts::

      dot = 4*popc(x & w) - 2*popc(x) - 2*popc(w) + ks*ks*C32*32
      y   = (dot - pad_bits) * mean[m] + bias[m]

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
device memory. The plain versions build the patch matrix instead. K4 runs
on the binary tensor cores (``mma .b1 .and.popc``) and recovers the +-1 dot
from and-popcounts. :func:`plan_launch` gives each
conv its launch geometry (tile, K step, ring depth, and the splits of K
across a block's warps and across a cluster).

Dispatch: :func:`xnor_gemm` and :func:`xnor_gemm_mxu` launch the kernel for
a CUDA tensor and run the plain version for a CPU tensor; the CUDA path
never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..xnor import BITS, words_for
from .int8_conv import LAUNCH_COUNTS

_POPCOUNT = "xnor_gemm"
_MXU = "xnor_gemm_mxu"
_EPILOGUES = ("leaky", "linear")

#: Largest GEMM M = batch * out_h * out_w at which ``xnor_impl="auto"``
#: takes the bit-packed tensor-core engine (K4) over the dense +-1 conv. On an
#: H100 (chip_smoke.py phase 7, PERF.md section 6) K4 with its input packing
#: beat the dense engine at all seven XNOR convs of tiny-yolo-obj_xnor-416
#: at b=1, from M = 169 (13x13) to M = 43,264 (208x208), by 2.3x to 5.9x
#: (on the binary tensor cores; 1.8x to 3.1x when it unpacked to int8); the
#: threshold is the largest M measured. Above it the dense engine runs.
AUTO_MXU_MAX_PIXELS = 43264


def auto_prefers_mxu(total_out_pixels: int) -> bool:
    """True where the bit-packed tensor-core engine measured faster than the dense
    +-1 conv at this GEMM M = batch*oh*ow (see AUTO_MXU_MAX_PIXELS)."""
    return total_out_pixels <= AUTO_MXU_MAX_PIXELS


# the kernels' geometry (csrc/xnor_common.cuh)
SM_COUNT = 132            # H100 SXM
THREADS = 128             # threads a block
TILE_AREA = 4096          # outputs of a block whose warps split the tile
# (pixels, filters) a block: the tiles whose four warps each take a 32x32
# part, in order of preference at equal padding, then the 32x32 tile whose
# warps each take a quarter of every K step (the warp split)
TILES = ((64, 64), (128, 32))
WARP_SPLIT_TILE = (32, 32)
KSTEPS = (8, 16, 32)      # K step in words (K4: whole 256-bit MMA steps)
MAX_STAGES = 4
MAX_SPLIT = 8             # blocks per cluster (portable size)
MAX_SMEM = 232448         # shared memory a block may use
_ROW_PAD = 4              # words of padding per shared row
_ENGINE_NAMES = ("popcount", "mxu")
# How the planner splits K (scripts/trace_xnor_gemm.py --plans on an H100,
# PERF.md section 6): only where the 4096-output tiles leave SMs idle and
# the window has at least WARP_SPLIT_MIN_WORDS words, and then always with
# the 32x32 tile of the warp split, which also takes a split across a
# cluster: K4, bound by latency, 32-word steps (each warp a 256-bit slice)
# and a cluster split where a block would have more than K4_BLOCK_WORDS
# words; K3, bound by popcount issue, the cluster split and K step (16 or
# 32 words) that load the busiest SM least, a block costing about as much
# as K3_BLOCK_WORDS more words there (its set-up and epilogue) and a split
# K3_SPLIT_WORDS (its barrier and pushes).
WARP_SPLIT_MIN_WORDS = 16
K4_BLOCK_WORDS = 160
K3_BLOCK_WORDS = 16
K3_SPLIT_WORDS = 24


class Plan(NamedTuple):
    """One launch of a bit kernel: ``tile_p`` x ``tile_m`` outputs a block,
    K in steps of ``kstep`` words through a ring of ``stages``, ``split``
    blocks of a cluster sharing a tile's steps, and what follows."""
    tile_p: int
    tile_m: int
    kstep: int
    stages: int
    split: int
    p_tiles: int
    m_tiles: int
    steps: int          # K steps over the window's words
    blocks: int         # p_tiles * m_tiles * split
    smem: int           # dynamic shared memory of one block, bytes

    @property
    def warp_split(self) -> bool:
        """Whether the block's warps share each K step (the 32x32 tile; only
    such a plan may also split K across a cluster)."""
        return self.tile_p * self.tile_m < TILE_AREA


def smem_bytes(tile_p: int, tile_m: int, kstep: int, stages: int,
               split: int) -> int:
    """The kernels' shared memory: the pixel table (16 bytes a pixel), the
    tile's mean and bias (8 bytes a filter), the ring of ``stages`` steps
    of (tile_p + tile_m) rows of kstep + 4 words, then, with the warp
    split, the partial tiles: one per warp, and for a cluster split a slot
    per cluster block of ceil(tile_p / split) rows, each row tile_m + 4
    int32 sums."""
    ring = stages * (tile_p + tile_m) * (kstep + _ROW_PAD) * 4
    rows = 0
    if tile_p * tile_m < TILE_AREA:
        rows = THREADS // 32 * tile_p
        if split > 1:
            rows += split * -(-tile_p // split)
    return tile_p * 16 + tile_m * 8 + ring + rows * (tile_m + 4) * 4


def make_plan(p: int, m: int, kwords: int, tile: tuple, kstep: int,
              split: int) -> Plan:
    """The plan of one launch at a tile, K step and split, with the ring
    that holds each block's steps (2 to 4)."""
    tile_p, tile_m = tile
    p_tiles, m_tiles = -(-p // tile_p), -(-m // tile_m)
    steps = -(-kwords // kstep)
    stages = min(MAX_STAGES, max(2, -(-steps // split)))
    return Plan(tile_p, tile_m, kstep, stages, split, p_tiles, m_tiles, steps,
                p_tiles * m_tiles * split,
                smem_bytes(tile_p, tile_m, kstep, stages, split))


def _busiest_sm_words(tiles: int, kwords: int, kstep: int,
                      split: int) -> int:
    """Window words the busiest SM reduces, when blocks are dealt evenly
    over the SMs and the first rank of a cluster has the most steps, each
    block charged K3_BLOCK_WORDS more."""
    first = -(-(-(-kwords // kstep)) // split) * kstep
    return -(-tiles * split // SM_COUNT) * (min(kwords, first)
                                            + K3_BLOCK_WORDS)





def plan_launch(b: int, h: int, w: int, c32: int, m: int, ks: int,
                stride: int, pad: int, engine: str = "popcount") -> Plan:
    """Geometry of one launch of ``engine``'s kernel ("popcount": K3,
    "mxu": K4): the 4096-output tile that pads P and M least (64x64 among
    equals) with the smallest K step that holds the window (at most 32
    words); or, as set out at ``WARP_SPLIT_MIN_WORDS``, the warp split's
    32x32 tile with its K step and cluster split."""
    if engine not in _ENGINE_NAMES:
        raise ValueError(f"unknown XNOR engine {engine!r} (expected popcount "
                         "or mxu)")
    oh, ow = _out_hw(h, w, ks, stride, pad)
    p, kwords = b * oh * ow, ks * ks * c32
    if p < 1 or m < 1 or kwords < 1:
        raise ValueError(f"xnor plan: empty conv (P={p}, M={m}, "
                         f"kwords={kwords})")

    def padded(tile: tuple) -> int:
        return -(-p // tile[0]) * tile[0] * -(-m // tile[1]) * tile[1]

    tile = min(TILES, key=padded)
    if (-(-p // tile[0]) * -(-m // tile[1]) >= SM_COUNT
            or kwords < WARP_SPLIT_MIN_WORDS):
        kstep = next((k for k in KSTEPS if k >= kwords), KSTEPS[-1])
        return make_plan(p, m, kwords, tile, kstep, 1)
    if engine == "mxu":
        split = min(MAX_SPLIT, -(-kwords // K4_BLOCK_WORDS))
        return make_plan(p, m, kwords, WARP_SPLIT_TILE, KSTEPS[-1], split)
    ws_tiles = -(-p // WARP_SPLIT_TILE[0]) * -(-m // WARP_SPLIT_TILE[1])
    kstep, split = min(
        ((k, s) for k in KSTEPS[1:]
         for s in range(1, min(MAX_SPLIT, -(-kwords // k)) + 1)),
        key=lambda ks: (_busiest_sm_words(ws_tiles, kwords, *ks)
                        + (ks[1] > 1) * K3_SPLIT_WORDS, ks[1], -ks[0]))
    return make_plan(p, m, kwords, WARP_SPLIT_TILE, kstep, split)


def _check_epilogue(activation: str) -> None:
    if activation not in _EPILOGUES:
        raise ValueError(f"XNOR bit-kernel epilogue must be one of "
                         f"{_EPILOGUES}, got {activation!r}")


def pack_activations(x: torch.Tensor, c_real: int) -> torch.Tensor:
    """``[B, H, W, C]`` float (float32, or bfloat16 under ``-turbo``: x > 0
    on a bfloat16 value is x > 0 on its float32 upcast) -> ``[B, H, W, C32]``
    int32, bit set iff x > 0; channel-pad bits 0. Each bit position appears once, so the sum
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 18
                   + [ctypes.c_void_p])
    return fn


def _launch(name: str, xp, wp, mean, bias, c_real: int, stride: int,
            pad: int, activation: str, plan: Plan | None):
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
    if b * oh * ow >= 2 ** 31 or xp.numel() >= 2 ** 31:
        raise ValueError(f"{name}: B*OH*OW and B*H*W*C32 must stay below "
                         "2**31")
    if plan is None:
        plan = plan_launch(b, h, w, c32, m, ks, stride, pad,
                           "popcount" if name == _POPCOUNT else "mxu")
    adjust, pad_bits = _constants(ks, c32, c_real)
    out = torch.empty((b, oh, ow, m), dtype=torch.float32, device=xp.device)
    kernel = load_kernel(name)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    LAUNCH_COUNTS[name] += 1
    rc = kernel(xp.data_ptr(), wp.data_ptr(), mean.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, h, w, c32, m, oh, ow, ks,
                stride, pad, adjust if name == _POPCOUNT else pad_bits,
                int(activation == "leaky"), plan.tile_p, plan.tile_m,
                plan.kstep, plan.stages, plan.split, xp.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def xnor_gemm_cuda(xp, wp, mean, bias, c_real: int, stride: int, pad: int,
                   activation: str = "leaky", *, plan: Plan | None = None):
    """Launch K3, the popcount kernel. ``plan``: :func:`plan_launch`'s by
    default; a test may force another."""
    return _launch(_POPCOUNT, xp, wp, mean, bias, c_real, stride, pad,
                   activation, plan)


def xnor_gemm_mxu_cuda(xp, wp, mean, bias, c_real: int, stride: int,
                       pad: int, activation: str = "leaky", *,
                       plan: Plan | None = None):
    """Launch K4, the binary tensor-core kernel (``plan`` as for
    :func:`xnor_gemm_cuda`)."""
    return _launch(_MXU, xp, wp, mean, bias, c_real, stride, pad, activation,
                   plan)


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
    """As :func:`xnor_gemm`, with the bit-packed tensor-core engine (K4)."""
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
    ``x``: [B,H,W,C] float32 or bfloat16 -> [B,OH,OW,M] float32."""
    fn = _ENGINES.get((engine, plain))
    if fn is None:
        raise ValueError(f"unknown XNOR engine {engine!r} (expected popcount "
                         "or mxu)")
    return fn(pack_activations(x, c_real), wp, mean, bias, c_real, stride,
              pad, activation)
