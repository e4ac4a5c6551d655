"""INT8 convolution: the hand-written Hopper kernel and its plain PyTorch twin.

``csrc/int8_conv.cu`` is the counterpart of the Pallas kernels
``yolo2_light_tpu/ops/pallas_int8.py`` (``conv3x3_int8_fused``, v1, and
``conv3x3_int8_tiled``, v2): an int8 implicit-GEMM convolution accumulated in
int32 with the reference's int8-"cpu" epilogue fused (reference:
forward_convolutional_layer_q, src/yolov2_forward_network_quantized.c:527-631):

    q = clamp(trunc_div(acc, R_MULT), +-32767)
    y = q * alpha + bias,   alpha = R_MULT / (input_mult * weights_mult)
    y = y > 0 ? y : y / 10          (leaky; linear skips it)

It takes every int8-eligible conv of a darknet net (size 1 or 3, stride 1
or 2), not only the 3x3/s1/p1 case the Pallas kernels cover.

Dispatch: :func:`conv2d_int8` runs the kernel for a CUDA tensor and the plain
version for a CPU tensor. The CUDA path launches the kernel or raises; it
never falls back. PyTorch has no usable int8 convolution of its own
(``F.conv2d`` on int8 returns int8 and wraps, and int32 ``matmul`` is not
implemented on CUDA), so the plain version computes the accumulator as an
exact float64 convolution: every partial sum is an integer of magnitude
below 127 * 127 * ks * ks * C < 2**53.

Weights are ``[M, ks, ks, C]`` int8 (:func:`relayout_hwio` turns the JAX
package's HWIO layout into it once, at load time).
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

# launches of each hand kernel, counted where the wrapper launches it
LAUNCH_COUNTS: collections.Counter = collections.Counter()

_KERNEL = "int8_conv"
_EPILOGUES = ("leaky", "linear")


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return fn


def conv2d_int8_cuda(x_int8, w, bias, alpha: float, stride: int, pad: int,
                     activation: str = "leaky", r_mult: int = 32):
    """Launch the kernel on the current stream of ``x_int8``'s device."""
    _check_epilogue(activation)
    if not (x_int8.is_cuda and w.device == x_int8.device
            and bias.device == x_int8.device):
        raise ValueError("conv2d_int8_cuda: x, w and bias must lie on one "
                         "CUDA device")
    if x_int8.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv2d_int8_cuda: x and w must be int8, got "
                        f"{x_int8.dtype} and {w.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"conv2d_int8_cuda: bias must be float32, got "
                        f"{bias.dtype}")
    if x_int8.dim() != 4 or w.dim() != 4:
        raise ValueError("conv2d_int8_cuda: x must be [B,H,W,C] and w "
                         "[M,ks,ks,C]")
    b, h, wd, c = x_int8.shape
    m, ks, ks2, wc = w.shape
    if ks != ks2 or wc != c or tuple(bias.shape) != (m,):
        raise ValueError(f"conv2d_int8_cuda: shapes do not match: x "
                         f"{tuple(x_int8.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)}")
    if c % 4:
        raise ValueError(f"conv2d_int8_cuda: the kernel needs C % 4 == 0, "
                         f"got C={c}")
    if stride < 1 or pad < 0:
        raise ValueError(f"conv2d_int8_cuda: bad stride {stride} / pad {pad}")
    if not (x_int8.is_contiguous() and w.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("conv2d_int8_cuda: x, w and bias must be contiguous")
    if x_int8.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError("conv2d_int8_cuda: x and w must be 4-byte aligned")
    oh = (h + 2 * pad - ks) // stride + 1
    ow = (wd + 2 * pad - ks) // stride + 1
    if b * oh * ow >= 2 ** 31:
        raise ValueError("conv2d_int8_cuda: B*OH*OW must stay below 2**31")
    shift = _shift_of(r_mult)
    out = torch.empty((b, oh, ow, m), dtype=torch.float32,
                      device=x_int8.device)
    kernel = load_kernel()
    stream = torch.cuda.current_stream(x_int8.device).cuda_stream
    LAUNCH_COUNTS[_KERNEL] += 1
    rc = kernel(
        x_int8.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, h, wd, c, m, oh, ow, ks, stride, pad, alpha, shift,
        int(activation == "leaky"), x_int8.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: cudaError {rc}")
    return out


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
