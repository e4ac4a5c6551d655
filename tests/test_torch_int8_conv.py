"""The port's int8 conv (ops/int8_conv) against the JAX package's int8 convs.

On the CPU the port runs the kernel's plain PyTorch version; the JAX side
runs the Pallas kernels in interpret mode (as tests/test_pallas_int8.py does)
and its XLA conv2d_int8, the network's default int8 engine. The integer
stages (int32 accumulator, requantized q) must be bit-exact, and so must the
f32 output against XLA's conv2d_int8, which rounds q * alpha and + bias
separately as the port does. Against the interpret-mode Pallas kernels the
f32 output is held to rtol=atol=1e-5, the bound tests/test_pallas_int8.py
uses between those kernels and XLA: their epilogue lands up to 1 ULP off
XLA's (F7: q * alpha + bias contracted into one FMA rounds once, not twice).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.ops.pallas_int8 import (conv3x3_int8_fused as jax_fused,
                                             conv3x3_int8_tiled as jax_tiled)
from yolo2_light_tpu_torch.ops import int8_conv as K

IN_MULT, W_MULT = np.float32(11.0), np.float32(40.0)


def _inputs(seed, b, h, w, c, m, ks):
    rng = np.random.RandomState(seed)
    xi = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    w8 = rng.randint(-127, 128, (ks, ks, c, m)).astype(np.int8)   # HWIO
    bias = rng.randn(m).astype(np.float32)
    return xi, w8, bias


def _jax_acc(xi, w8, stride, pad):
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(xi), jnp.asarray(w8), (stride, stride),
        [(pad, pad), (pad, pad)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("ks,stride,pad", [(3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_plain_accumulator_and_requant_bit_exact(ks, stride, pad):
    xi, w8, _ = _inputs(ks * 10 + stride, 2, 6, 6, 32, 64, ks)
    acc = K.int8_conv_acc_plain(torch.from_numpy(xi), K.relayout_hwio(w8),
                                stride, pad)
    ref = _jax_acc(xi, w8, stride, pad)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref)
    q = K.requantize(acc, 32).numpy()
    q_ref = np.asarray(jnp.clip(JL._trunc_div_pow2(jnp.asarray(ref), 32),
                                -32767, 32767))
    np.testing.assert_array_equal(q, q_ref)


def test_requant_saturates_and_truncates_toward_zero():
    acc = torch.tensor([-(2 ** 31) + 5, -1_048_607, -33, -32, -31, -1, 0, 1,
                        31, 32, 33, 1_048_607, 2 ** 31 - 1], dtype=torch.int32)
    expect = [-32767, -32767, -1, -1, 0, 0, 0, 0, 0, 1, 1, 32767, 32767]
    assert K.requantize(acc, 32).tolist() == expect


@pytest.mark.parametrize("jax_fn", [jax_tiled, jax_fused],
                         ids=["tiled_v2", "fused_v1"])
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_plain_matches_pallas_kernels(jax_fn, activation):
    xi, w8, bias = _inputs(5, 2, 6, 6, 32, 64, 3)
    ref = np.asarray(jax_fn(jnp.asarray(xi), jnp.asarray(w8), bias, IN_MULT,
                            W_MULT, activation=activation, interpret=True))
    out = K.conv3x3_int8_fused(torch.from_numpy(xi), w8, bias, IN_MULT,
                               W_MULT, activation=activation)
    assert out.shape == (2, 6, 6, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ks,stride,pad,hw", [(1, 1, 0, 6), (3, 2, 1, 7),
                                              (3, 2, 1, 6), (1, 2, 0, 5),
                                              (3, 1, 1, 6)])
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_plain_bit_exact_to_jax_xla_layer(ks, stride, pad, hw, activation):
    """1x1, 3x3/s2 and 3x3/s1 convs against layers.conv2d_int8."""
    xi, w8, bias = _inputs(hw + ks, 2, hw, hw, 32, 64, ks)
    ref = np.asarray(JL.conv2d_int8(
        jnp.zeros(xi.shape, jnp.float32), jnp.asarray(w8), jnp.asarray(bias),
        stride, pad, activation, jnp.float32(IN_MULT), jnp.float32(W_MULT),
        x_int8=jnp.asarray(xi)))
    out = K.conv2d_int8(torch.from_numpy(xi), K.relayout_hwio(w8),
                        torch.from_numpy(bias), K.alpha_f32(IN_MULT, W_MULT),
                        stride, pad, activation)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("in_mult,w_mult", [(40.0, 16.0), (11.0, 40.0),
                                            (37.123, 5.77), (8.0, 0.3)])
def test_alpha_rounds_as_float32(in_mult, w_mult):
    """alpha = 32 / (in * w) rounded as the JAX path's float32 device
    scalars round it, not as a float64 division cast to float32."""
    ref = np.asarray(32 / (jnp.float32(in_mult) * jnp.float32(w_mult)))
    assert ref.dtype == np.float32
    alpha = K.alpha_f32(in_mult, w_mult)
    assert np.float32(alpha) == ref and float(np.float32(alpha)) == alpha


def test_relayout_hwio_to_kernel_layout():
    w8 = np.arange(3 * 3 * 8 * 5, dtype=np.int64).reshape(3, 3, 8, 5) % 251
    w8 = (w8 - 125).astype(np.int8)
    out = K.relayout_hwio(w8)
    assert out.shape == (5, 3, 3, 8) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), w8.transpose(3, 0, 1, 2))


def test_cpu_dispatch_runs_plain_and_launches_nothing():
    xi, w8, bias = _inputs(1, 1, 5, 5, 8, 12, 3)
    K.reset_launch_counts()
    out = K.conv2d_int8(torch.from_numpy(xi), K.relayout_hwio(w8),
                        torch.from_numpy(bias), 0.05, 1, 1)
    plain = K.conv2d_int8_plain(torch.from_numpy(xi), K.relayout_hwio(w8),
                                torch.from_numpy(bias), 0.05, 1, 1)
    assert torch.equal(out, plain)
    assert K.LAUNCH_COUNTS["int8_conv"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never takes a CPU detour: a CPU tensor is refused
    before anything is built or launched."""
    xi, w8, bias = _inputs(2, 1, 4, 4, 8, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        K.conv2d_int8_cuda(torch.from_numpy(xi), K.relayout_hwio(w8),
                           torch.from_numpy(bias), 0.05, 1, 0)


def test_unknown_epilogue_is_refused():
    xi, w8, bias = _inputs(3, 1, 4, 4, 8, 4, 1)
    with pytest.raises(ValueError, match="epilogue"):
        K.conv2d_int8(torch.from_numpy(xi), K.relayout_hwio(w8),
                      torch.from_numpy(bias), 0.05, 1, 0, "logistic")
