"""INT8 convolution: the hand-written Hopper kernel and its plain PyTorch twin.

``csrc/int8_conv.cu`` is the counterpart of the Pallas kernels
``yolo2_light_tpu/ops/pallas_int8.py`` (``conv3x3_int8_fused``, v1, and
``conv3x3_int8_tiled``, v2): an int8 implicit-GEMM convolution on the tensor
cores, accumulated in int32, with the reference's input quantize and
either of its int8 epilogues fused. ``semantics="cpu"`` (the Pallas kernels'
function; reference: forward_convolutional_layer_q,
src/yolov2_forward_network_quantized.c:527-631):

    xq = clamp(trunc(x * input_mult), +-127)       (the float-input entry)
    q = clamp(trunc_div(acc, R_MULT), +-32767)
    y = q * alpha + bias,   alpha = R_MULT / (input_mult * weights_mult)
    y = y > 0 ? y : y / 10          (leaky; linear skips it)
    y = y * tanh(log1p(exp(y)))     (mish, yolov4's; PyTorch's F.mish)

``semantics="gpu"`` (``-int8_policy gpu``, the reference's cuDNN INT8x4
path, forward_convolutional_layer_gpu_cudnn_quantized,
src/yolov2_forward_network_gpu.cu:143-315): no requant,

    y = acc * inv + bias,   inv = 1 / (input_mult * weights_mult)
    y = y > 0 ? y : 0.1 * y         (leaky)

``semantics="old"`` (``-int8_policy cpu_old``, the reference's legacy
all-int8 chain, forward_convolutional_layer_q_old,
src/yolov2_forward_network_quantized.c:636-801; ``alpha`` is the layer's
``output_multipler``, ``bias`` its ``biases_quant``):

    q = clamp(trunc_div(acc, R_MULT), +-32767)
    q = trunc(trunc(q * output_multipler) + biases_quant)
    q = q > 0 ? q : trunc(q / 10)   (leaky; linear skips it)

Each step rounds on its own, in every epilogue. The store is float32,
bfloat16 (``out_dtype``, round to nearest even: the turbo modes' narrowed
activations) or int8 at ``out_mult`` (``clamp(trunc(y * out_mult), +-127)``,
the int8 residual trunk's quantize). The "old" epilogue stores ``q / 16``
as float32, ``clamp(q, +-127)`` as int8, or both in one launch
(``out_dtype=OLD_BOTH``): the consumer decides which it reads.

It takes every int8-eligible conv of a darknet net (size 1 or 3, stride 1
or 2; sizes up to 5 where the tiles fit), not only the 3x3/s1/p1 case the
Pallas kernels cover. Two entries launch the same kernel: the float-input
one (:func:`conv2d_int8_f32`, float32 or bfloat16 input quantized in the
kernel's loader: one launch per int8 conv) and the int8-input one
(:func:`conv2d_int8`, a pre-quantized input: the Pallas signatures' and the
int8 chain's). :func:`plan_launch` picks each launch's tiles, its copy-ring
depth and its split of K across a thread-block cluster.

Mish is the kernel's third activation, a form of its own (``csrc/
int8_conv_mish.cu``, a separate library whose kernel the device trace names
``int8_conv_mish_kernel``), taken where the network's int8 path meets it:
a float32 input stored as float32 under the "cpu" or "gpu" epilogue
(:func:`fuses`). Its plain twin is the linear epilogue's, then ``F.mish``.

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
# the kernel's launches by form, "<input>/<semantics>/<store>", such as
# "f32/cpu/f32" (the network's int8 path) or "bf16/cpu/bf16" (-turbo), with
# "/mish" after the mish form's ("f32/cpu/f32/mish")
FORM_LAUNCHES: collections.Counter = collections.Counter()

_KERNEL = "int8_conv"
_MISH_KERNEL = "int8_conv_mish"
# the epilogue's activations, by the kernel's code (csrc/int8_conv.cuh)
_EPILOGUES = ("linear", "leaky", "mish")
SEMANTICS = ("cpu", "gpu", "old")
# the "old" epilogue's two stores in one launch: (float32 q / 16, int8 q)
OLD_BOTH = (torch.float32, torch.int8)
# the kernel's input forms and stores (csrc/int8_conv.cuh's enums)
_X_FORMS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_STORES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, OLD_BOTH: 3}
_DTYPE_NAMES = {torch.int8: "int8", torch.float32: "f32",
                torch.bfloat16: "bf16", OLD_BOTH: "f32+int8"}

# the kernel's fixed geometry (csrc/int8_conv.cuh)
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
# bytes per staged float row of each input form (the int8 form stages none)
_FLOAT_ROW = {"f32": SLAB * 4, "bf16": SLAB * 2, "int8": 0}
_TILE_LD = 72            # int32 words per row of the epilogue tile
_SPATIAL_TILES = ((8, 8), (4, 8), (4, 4))


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()
    PRE_LAUNCHES.clear()
    FORM_LAUNCHES.clear()


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


def _x_form(x_form) -> str:
    """An input form: "f32", "bf16" or "int8"; True and False name the f32
    and the int8 form."""
    if isinstance(x_form, bool):
        return "f32" if x_form else "int8"
    if x_form not in _FLOAT_ROW:
        raise ValueError(f"unknown input form {x_form!r} (expected f32, bf16 "
                         "or int8)")
    return x_form


def _smem_bytes(halo_rows: int, taps: int, x_form, stages: int) -> int:
    """The kernel's shared memory: halo table, int8 A rows (a ring, or a
    double buffer for a float form), weight stages and a float form's halo
    stages, or the epilogue tile if larger."""
    x_form = _x_form(x_form)
    tab = -(-halo_rows * 4 // 16) * 16
    a = (stages if x_form == "int8" else 2) * halo_rows * _A_ROW
    w = stages * TILE_CHANNELS * (taps * SLAB + 16)
    f = stages * halo_rows * _FLOAT_ROW[x_form]
    return tab + max(a + w + f, TILE_PIXELS * _TILE_LD * 4)


def blocks_per_sm(smem: int) -> int:
    """Blocks of the kernel that shared memory and the register budget let
    one SM hold."""
    return min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))


def _fit(rows: int, taps: int, x_form):
    """The ring depth that lets the most blocks share an SM (the deeper
    of equals): (blocks per SM, stages, smem), or None where no depth
    fits."""
    fits = [(blocks_per_sm(smem), st, smem) for st in STAGES
            if (smem := _smem_bytes(rows, taps, x_form, st)) <= MAX_SMEM]
    return max(fits, default=None)


def plan_launch(b: int, h: int, w: int, c: int, m: int, ks: int, stride: int,
                pad: int, x_form="f32") -> Plan:
    """Tiles, ring depth and cluster split of one launch. The kernel is
    bound by latency, so what counts is how many blocks share an SM: the
    largest tile at which two blocks fit (else the largest that fits one),
    at the ring depth that fits the most; then, where the tiles give fewer
    blocks than the card has SMs, the fewest cluster blocks (at most 8, at
    most the number of slabs) that make the grid cover them. ``x_form``:
    the input form, "f32", "bf16" or "int8" (True / False: f32 / int8).
    Raises ValueError where no tile fits (sizes above 5)."""
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (w + 2 * pad - ks) // stride + 1
    flat = ks == 1 and stride == 1 and pad == 0
    shapes = [(0, 0)] if flat else list(_SPATIAL_TILES)
    fits = []
    for th, tw in shapes:
        rows = (TILE_PIXELS if flat
                else ((th - 1) * stride + ks) * ((tw - 1) * stride + ks))
        fit = _fit(rows, ks * ks, x_form)
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


def fuses(activation: str, x_dtype, out_dtype=None,
          semantics: str = "cpu") -> bool:
    """Whether the kernel's epilogue takes ``activation`` whole at this
    input type and store (None: float32): leaky and linear always, mish on
    a float32 input stored as float32 under the "cpu" or "gpu" epilogue
    (its form's only instantiation)."""
    if activation in ("leaky", "linear"):
        return True
    return (activation == "mish" and x_dtype == torch.float32
            and out_dtype in (None, torch.float32) and semantics != "old")


def _check_epilogue(activation: str, semantics: str = "cpu") -> None:
    if activation not in _EPILOGUES:
        raise ValueError(f"int8 conv epilogue must be one of {_EPILOGUES}, "
                         f"got {activation!r}")
    if semantics not in SEMANTICS:
        raise ValueError(f"int8 conv semantics must be one of {SEMANTICS}, "
                         f"got {semantics!r}")
    if activation == "mish" and semantics == "old":
        raise ValueError("the old epilogue is leaky or linear: it takes no "
                         "mish")


def _check_store(out_dtype, out_mult, semantics: str = "cpu") -> None:
    if semantics == "old":
        if out_dtype not in (torch.float32, torch.int8, OLD_BOTH):
            raise TypeError("the old epilogue stores float32, int8 or both "
                            f"(OLD_BOTH), got {out_dtype}")
        if out_mult is not None:
            raise ValueError("the old epilogue's int8 store is clamp(q): it "
                             "takes no out_mult")
        return
    if out_dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"int8 conv store must be float32, bfloat16 or int8, "
                        f"got {out_dtype}")
    if (out_dtype == torch.int8) != (out_mult is not None):
        raise ValueError("out_mult is the int8 store's multiplier: give it "
                         "with out_dtype=torch.int8 and only then")


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


def mish_plain(y: torch.Tensor) -> torch.Tensor:
    """Mish of the float32 ``y``: ``y * tanh(log1p(exp(y)))``, PyTorch's
    ``F.mish``, which the kernel's mish epilogue computes with the same
    CUDA math functions. AlexeyAB/darknet's activate_array_mish takes the
    softplus as ``y`` above 20 and as ``exp(y)`` below -20: there
    ``log1p(exp(y))`` differs from those by under 2**-28 of their value,
    below half an ulp, and tanh is 1 (above 20) or its argument (below -20)
    in float32, so the threshold changes no float32 result. Between them
    darknet writes ``logf(expf(y) + 1)`` and ``2 / (1 + expf(-2 t)) - 1``
    for the tanh: a few ulps from these where ``y`` is near 0 or above,
    more the further ``y`` lies below 0, where ``expf(y) + 1`` rounds away
    a growing share of ``expf(y)``."""
    return F.mish(y)


def epilogue_plain(q: torch.Tensor, bias: torch.Tensor, alpha: float,
                   activation: str) -> torch.Tensor:
    """``q * alpha + bias`` with two roundings, then the x/10 leaky or
    mish. The divisor is a tensor on ``q``'s device: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, which is not
    IEEE ``/ 10``."""
    y = q.to(torch.float32) * alpha + bias
    if activation == "leaky":
        ten = torch.tensor(10.0, dtype=torch.float32, device=y.device)
        y = torch.where(y > 0, y, y / ten)
    elif activation == "mish":
        y = mish_plain(y)
    return y


def gpu_epilogue_plain(acc: torch.Tensor, bias: torch.Tensor, inv: float,
                       activation: str) -> torch.Tensor:
    """The "gpu" flavor: ``acc * inv + bias`` with two roundings, then the
    0.1 * y leaky (the product with a float32 0.1, as JAX's weak-typed
    ``0.1 * x`` rounds it) or mish."""
    y = acc.to(torch.float32) * inv + bias
    if activation == "leaky":
        tenth = torch.tensor(0.1, dtype=torch.float32, device=y.device)
        y = torch.where(y > 0, y, y * tenth)
    elif activation == "mish":
        y = mish_plain(y)
    return y


def old_epilogue_plain(acc: torch.Tensor, bias: torch.Tensor, mult: float,
                       activation: str, r_mult: int = 32) -> torch.Tensor:
    """The "old" flavor: requant, then ``trunc(q * mult)``, ``trunc(q +
    bias)`` and the ``trunc(q / 10)`` leaky, each rounded on its own
    (``mult``: the layer's output_multipler, ``bias`` its biases_quant);
    returns q, integers held in float32."""
    q = requantize(acc, r_mult).to(torch.float32)
    q = torch.trunc(q * mult)
    q = torch.trunc(q + bias)
    if activation == "leaky":
        ten = torch.tensor(10.0, dtype=torch.float32, device=q.device)
        q = torch.where(q > 0, q, torch.trunc(q / ten))
    return q


def old_store_plain(q: torch.Tensor, out_dtype=torch.float32):
    """The "old" epilogue's stores of q: float32 ``q / 16``, int8
    ``clamp(q, +-127)``, or both (``OLD_BOTH``) as a tuple."""
    f = q / 16.0 if out_dtype != torch.int8 else None
    i8 = (torch.clamp(q, -127, 127).to(torch.int8)
          if out_dtype != torch.float32 else None)
    if out_dtype == OLD_BOTH:
        return f, i8
    return f if out_dtype == torch.float32 else i8


def store_plain(y: torch.Tensor, out_dtype=torch.float32,
                out_mult: float | None = None) -> torch.Tensor:
    """The kernel's store: float32 as is, bfloat16 rounded to nearest even,
    int8 as ``clamp(trunc(y * out_mult), +-127)``."""
    if out_dtype == torch.int8:
        return torch.clamp(torch.trunc(y * out_mult), -127, 127).to(
            torch.int8)
    return y.to(out_dtype)


def conv2d_int8_plain(x_int8, w, bias, alpha: float, stride: int, pad: int,
                      activation: str = "leaky", r_mult: int = 32, *,
                      semantics: str = "cpu", out_dtype=torch.float32,
                      out_mult: float | None = None):
    """``alpha``: the epilogue's scale, R_MULT / (input_mult * weights_mult)
    under ``semantics="cpu"``, 1 / (input_mult * weights_mult) under
    ``"gpu"``, the layer's output_multipler under ``"old"`` (whose ``bias``
    is its biases_quant and whose ``out_dtype`` may be ``OLD_BOTH``, a
    (float32, int8) pair of outputs)."""
    _check_epilogue(activation, semantics)
    _check_store(out_dtype, out_mult, semantics)
    acc = int8_conv_acc_plain(x_int8, w, stride, pad)
    if semantics == "old":
        return old_store_plain(
            old_epilogue_plain(acc, bias, alpha, activation, r_mult),
            out_dtype)
    if semantics == "gpu":
        y = gpu_epilogue_plain(acc, bias, alpha, activation)
    else:
        y = epilogue_plain(requantize(acc, r_mult), bias, alpha, activation)
    return store_plain(y, out_dtype, out_mult)


def conv2d_int8_f32_plain(x, w, bias, input_mult: float, alpha: float,
                          stride: int, pad: int, activation: str = "leaky",
                          r_mult: int = 32, **store):
    """The float-input entry's plain version: :func:`quantize_i8` of ``x``
    (a bfloat16 ``x`` upcast first, exactly), then
    :func:`conv2d_int8_plain` (``store``: its keywords)."""
    return conv2d_int8_plain(quantize_i8(x.to(torch.float32), input_mult), w,
                             bias, alpha, stride, pad, activation, r_mult,
                             **store)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.cache
def load_kernel(mish: bool = False):
    """Build (first use) and load ``csrc/int8_conv.cu`` (the leaky and
    linear forms) or, with ``mish``, ``csrc/int8_conv_mish.cu``; returns its
    bound entry point, once per process."""
    from . import _build
    lib = _build.load(_MISH_KERNEL if mish else _KERNEL)
    fn = lib.int8_conv_mish_nhwc if mish else lib.int8_conv_nhwc
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    return fn


def _launch(name: str, x, w, bias, input_mult, alpha: float, stride: int,
            pad: int, activation: str, r_mult: int, plan: Plan | None,
            semantics: str, out_dtype, out_mult):
    """Check the operands of either entry and launch the kernel on the
    current stream of ``x``'s device."""
    _check_epilogue(activation, semantics)
    _check_store(out_dtype, out_mult, semantics)
    float_input = input_mult is not None
    if not (x.is_cuda and w.device == x.device and bias.device == x.device):
        raise ValueError(f"{name}: x, w and bias must lie on one CUDA device")
    x_dtypes = ((torch.float32, torch.bfloat16) if float_input
                else (torch.int8,))
    if x.dtype not in x_dtypes or w.dtype != torch.int8:
        raise TypeError(f"{name}: x must be {' or '.join(map(str, x_dtypes))}"
                        f" and w int8, got {x.dtype} and {w.dtype}")
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
    x_align = 4 * x.element_size() if float_input else 4
    if x.data_ptr() % x_align or w.data_ptr() % 4:
        raise ValueError(f"{name}: x must be {x_align}-byte aligned and w "
                         "4-byte aligned")
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (wd + 2 * pad - ks) // stride + 1
    if b * oh * ow >= 2 ** 31 or b * h * wd >= 2 ** 31:
        raise ValueError(f"{name}: B*H*W and B*OH*OW must stay below 2**31")
    x_form = _DTYPE_NAMES[x.dtype]
    mish = activation == "mish"
    if mish and not fuses(activation, x.dtype, out_dtype, semantics):
        raise ValueError(f"{name}: the mish form takes a float32 input and "
                         f"stores float32, got {x.dtype} and {out_dtype}")
    if plan is None:
        plan = plan_launch(b, h, wd, c, m, ks, stride, pad, x_form)
    shift = _shift_of(r_mult)
    both = out_dtype == OLD_BOTH
    out = torch.empty((b, oh, ow, m), dtype=torch.float32 if both
                      else out_dtype, device=x.device)
    out2 = (torch.empty((b, oh, ow, m), dtype=torch.int8, device=x.device)
            if both else None)
    kernel = load_kernel(mish)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    FORM_LAUNCHES[f"{x_form}/{semantics}/{_DTYPE_NAMES[out_dtype]}"
                  + ("/mish" if mish else "")] += 1
    rc = kernel(
        x.data_ptr(), _X_FORMS[x.dtype],
        1.0 if input_mult is None else float(input_mult), w.data_ptr(),
        bias.data_ptr(), out.data_ptr(), None if out2 is None
        else out2.data_ptr(), b, h, wd, c, m, oh, ow, ks, stride, pad, alpha,
        shift, _EPILOGUES.index(activation), SEMANTICS.index(semantics),
        _STORES[out_dtype],
        1.0 if out_mult is None else float(out_mult), plan.tile_h,
        plan.tile_w, plan.split, plan.stages, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {rc}")
    return (out, out2) if both else out


def conv2d_int8_cuda(x_int8, w, bias, alpha: float, stride: int, pad: int,
                     activation: str = "leaky", r_mult: int = 32, *,
                     plan: Plan | None = None, semantics: str = "cpu",
                     out_dtype=torch.float32, out_mult: float | None = None):
    """Launch the kernel's int8-input entry (pre-quantized ``x_int8``) on
    the current stream of its device. ``plan``: :func:`plan_launch`'s by
    default; a test may force another split. ``alpha`` is the epilogue's
    scale of ``semantics`` (see :func:`conv2d_int8_plain`)."""
    return _launch("conv2d_int8_cuda", x_int8, w, bias, None, alpha, stride,
                   pad, activation, r_mult, plan, semantics, out_dtype,
                   out_mult)


def conv2d_int8_f32_cuda(x, w, bias, input_mult: float, alpha: float,
                         stride: int, pad: int, activation: str = "leaky",
                         r_mult: int = 32, *, plan: Plan | None = None,
                         semantics: str = "cpu", out_dtype=torch.float32,
                         out_mult: float | None = None):
    """Launch the kernel's float-input entry (``x`` float32 or bfloat16),
    which quantizes ``x`` at ``input_mult`` as it stages it: one launch for
    the whole int8 conv."""
    return _launch("conv2d_int8_f32_cuda", x, w, bias, input_mult, alpha,
                   stride, pad, activation, r_mult, plan, semantics,
                   out_dtype, out_mult)


def conv2d_int8(x_int8, w, bias, alpha: float, stride: int, pad: int,
                activation: str = "leaky", r_mult: int = 32, **store):
    """int8 NHWC ``x_int8`` * ``[M,ks,ks,C]`` int8 ``w`` -> NHWC with the
    epilogue and store ``store`` names (``semantics``, ``out_dtype``,
    ``out_mult``; by default the requant epilogue and a float32 store). The
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x_int8.is_cuda:
        return conv2d_int8_cuda(x_int8, w, bias, alpha, stride, pad,
                                activation, r_mult, **store)
    if x_int8.device.type != "cpu":
        raise ValueError(f"conv2d_int8: unsupported device {x_int8.device}")
    return conv2d_int8_plain(x_int8, w, bias, alpha, stride, pad, activation,
                             r_mult, **store)


def conv2d_int8_f32(x, w, bias, input_mult: float, alpha: float, stride: int,
                    pad: int, activation: str = "leaky", r_mult: int = 32,
                    **store):
    """Float NHWC ``x`` (float32 or bfloat16) quantized at ``input_mult``,
    then the int8 conv with the epilogue and store ``store`` names: the
    kernel's float-input entry for a CUDA tensor, the plain version for a
    CPU tensor."""
    if x.is_cuda:
        return conv2d_int8_f32_cuda(x, w, bias, input_mult, alpha, stride,
                                    pad, activation, r_mult, **store)
    if x.device.type != "cpu":
        raise ValueError(f"conv2d_int8_f32: unsupported device {x.device}")
    return conv2d_int8_f32_plain(x, w, bias, input_mult, alpha, stride, pad,
                                 activation, r_mult, **store)


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
