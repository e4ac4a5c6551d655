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

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.ops.pallas_int8 import (conv3x3_int8_fused as jax_fused,
                                             conv3x3_int8_tiled as jax_tiled)
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.models import network as TN
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


# ---------------------------------------------------------------------------
# The f32-input entry (input quantize fused into the kernel's loader) and the
# launch planner
# ---------------------------------------------------------------------------

YOLOV3 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "yolov3.cfg")
# (b, h, w, c, m, ks, stride, pad): 1x1, 3x3/s1 and 3x3/s2 with C, P and M
# that fill no tile and no 32-channel slab
RAGGED_SHAPES = [
    (2, 7, 5, 36, 70, 1, 1, 0),
    (1, 6, 6, 12, 65, 3, 1, 1),
    (2, 7, 5, 4, 3, 3, 1, 1),
    (3, 11, 9, 36, 70, 3, 2, 1),
    (2, 8, 7, 20, 9, 3, 2, 1),
]


def _f32_input(seed, b, h, w, c):
    """An f32 map whose quantized values cover the int8 range and saturate,
    with exact zeros and values that land on a bin edge at IN_MULT."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 4).astype(np.float32)
    flat = x.reshape(-1)
    flat[::7] = 0.0
    # n / 8 * 11 is exact in f32, and an integer where 8 divides n
    flat[1::5] = rng.randint(-110, 111, flat[1::5].shape) / np.float32(8)
    return x


@pytest.mark.parametrize("shape", RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_f32_entry_plain_bit_exact(shape, activation):
    """The f32-input entry's plain version equals quantize_i8 followed by
    the int8 plain entry, and the JAX package's XLA conv2d_int8 (cpu
    semantics), which quantizes the f32 input itself."""
    b, h, w, c, m, ks, stride, pad = shape
    x = _f32_input(h * c + m, b, h, w, c)
    _, w8, bias = _inputs(m + ks, b, h, w, c, m, ks)
    alpha = K.alpha_f32(IN_MULT, W_MULT)
    xt, wt, bt = (torch.from_numpy(x), K.relayout_hwio(w8),
                  torch.from_numpy(bias))
    K.reset_launch_counts()
    out = K.conv2d_int8_f32(xt, wt, bt, float(IN_MULT), alpha, stride, pad,
                            activation)
    assert sum(K.LAUNCH_COUNTS.values()) == sum(K.PRE_LAUNCHES.values()) == 0
    two_step = K.conv2d_int8_plain(K.quantize_i8(xt, float(IN_MULT)), wt, bt,
                                   alpha, stride, pad, activation)
    assert torch.equal(out, two_step)
    ref = np.asarray(JL.conv2d_int8(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(bias), stride, pad,
        activation, jnp.float32(IN_MULT), jnp.float32(W_MULT)))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_f32_kernel_wrapper_refuses_cpu_tensors():
    x = torch.from_numpy(_f32_input(0, 1, 4, 4, 8))
    _, w8, bias = _inputs(2, 1, 4, 4, 8, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        K.conv2d_int8_f32_cuda(x, K.relayout_hwio(w8), torch.from_numpy(bias),
                               40.0, 0.05, 1, 0)


def _yolov3_int8_convs():
    spec = TC.parse_network_cfg(YOLOV3, batch=1)
    return [spec.layers[i] for i in sorted(TN._int8_layer_set(spec, "cpu"))]


@pytest.mark.parametrize("f32_input", [True, False], ids=["f32", "int8"])
def test_planner_fills_the_card_at_every_yolov3_int8_conv(f32_input):
    """At each of yolov3-416's 71 int8 convs the plan puts at least one block
    on every SM, or has split K as far as it goes; its tiles fit."""
    convs = _yolov3_int8_convs()
    assert len(convs) == 71
    splits = set()
    for l in convs:
        p = K.plan_launch(1, l.h, l.w, l.c, l.n, l.size, l.stride, l.pad,
                          f32_input)
        assert p.blocks == p.tiles * p.m_tiles * p.split
        assert p.blocks >= K.SM_COUNT or p.split == min(K.MAX_SPLIT,
                                                        p.slabs), (l.index, p)
        assert p.smem <= K.MAX_SMEM and p.stages in K.STAGES
        flat = (l.size, l.stride, l.pad) == (1, 1, 0)
        assert (p.tile_h == 0) == flat
        splits.add(p.split)
    # the 13x13 and 26x26 convs need the split; the large maps do not
    assert 1 in splits and max(splits) > 1


@pytest.mark.parametrize("shape,expect", [
    ((1, 13, 13, 1024, 512, 1, 1, 0), (0, 0, 6, 24)),
    ((1, 13, 13, 512, 1024, 3, 1, 1), (8, 8, 3, 64)),
    ((1, 26, 26, 512, 1024, 3, 2, 1), (4, 8, 2, 128)),
    ((1, 208, 208, 32, 64, 3, 1, 1), (8, 8, 1, 676)),
])
def test_planner_tiles_and_split(shape, expect):
    """The tile, the split and the tiles x filter tiles of four launches of
    the f32-input entry: 3x3/s2 takes 4x8 tiles so that two blocks share an
    SM; the split is the fewest cluster blocks that reach 132."""
    p = K.plan_launch(*shape)
    assert (p.tile_h, p.tile_w, p.split, p.tiles * p.m_tiles) == expect
    assert p.blocks >= K.SM_COUNT


def test_planner_refuses_a_conv_whose_tiles_do_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        K.plan_launch(1, 20, 20, 64, 64, 7, 1, 3)


@pytest.mark.parametrize("slabs", [1, 2, 3, 5, 8, 9, 16, 32])
def test_cluster_split_divides_k_into_non_empty_slabs(slabs):
    """Every block of a cluster of 1 to 8 gets a non-empty, contiguous run
    of slabs, and together they cover K once."""
    for split in range(1, min(K.MAX_SPLIT, slabs) + 1):
        ranges = K.slab_ranges(slabs, split)
        assert len(ranges) == split
        assert ranges[0][0] == 0 and ranges[-1][1] == slabs
        assert all(lo < hi for lo, hi in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
