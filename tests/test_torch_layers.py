"""Each ported layer op (yolo2_light_tpu_torch/models/layers.py) against its
JAX op on the same NumPy inputs.

Tolerances: memory movement and piecewise-linear math (route, reorg,
upsample, shortcut, maxpool, the non-transcendental activations, input
quantization) are exact. Ops that call exp (logistic, loggy, elu, selu,
tanh, sigmoid, softmax) are held to rtol=1e-5/atol=1e-6: XLA's and
PyTorch's float32 exp differ by a few ULP. Float convs are held to
rtol=1e-4/atol=1e-5: both sides sum the same float32 products in a
different order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu_torch.models import layers as TL

EXACT_ACTS = ["linear", "relu", "relie", "ramp", "leaky", "plse", "stair",
              "hardtan", "lhtan"]
EXP_ACTS = ["logistic", "loggy", "elu", "selu", "tanh"]
# what the port adds to the JAX package's activations: yolov4's mish, held
# to the benchmark's plain yolov4 reference in tests/test_torch_yolov4.py
PORT_ONLY_ACTS = {"mish"}


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def test_every_activation_is_ported():
    assert set(TL.ACTIVATION_FNS) == set(JL.ACTIVATION_FNS) | PORT_ONLY_ACTS
    assert sorted(EXACT_ACTS + EXP_ACTS) == sorted(JL.ACTIVATION_FNS)


def _act_input():
    x = _rand(0, 4, 5, 6, 7, scale=4.0)
    edges = np.array([-4, 4, 0, -0.0, 1, -1, 2.5, -2.5, 3.0, 0.5],
                     np.float32)
    x.reshape(-1)[:edges.size] = edges
    return x


@pytest.mark.parametrize("name", EXACT_ACTS)
def test_activation_exact(name):
    x = _act_input()
    ref = np.asarray(JL.activate(jnp.asarray(x), name))
    out = TL.activate(torch.from_numpy(x), name).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", EXP_ACTS)
def test_activation_exp(name):
    x = _act_input()
    ref = np.asarray(JL.activate(jnp.asarray(x), name))
    out = TL.activate(torch.from_numpy(x), name).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,size,stride,pad", [
    (13, 2, 2, 1),    # yolov2-style downsample (pad = size-1)
    (13, 2, 1, 1),    # yolov3-tiny stride-1 pool
    (12, 3, 2, 2),
    (13, 5, 1, 4),    # SPP-style large window
    (9, 3, 1, 2),
    (8, 2, 2, 0),
])
def test_maxpool_offsets_exact(hw, size, stride, pad):
    out_hw = (hw + pad - size) // stride + 1
    x = _rand(hw + size, 2, hw, hw, 5)
    ref = np.asarray(JL.maxpool(jnp.asarray(x), size, stride, pad, out_hw,
                                out_hw))
    out = TL.maxpool(torch.from_numpy(x), size, stride, pad, out_hw,
                     out_hw).numpy()
    assert out.shape == ref.shape == (2, out_hw, out_hw, 5)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shapes", [
    [(2, 4, 4, 3), (2, 4, 4, 5)],
    [(2, 4, 4, 3)],
    [(2, 4, 4, 3), (2, 2, 2, 6), (2, 4, 4, 1)],   # flat CHW concat
])
def test_route_exact(shapes):
    xs = [_rand(i, *s) for i, s in enumerate(shapes)]
    ref = np.asarray(JL.route([jnp.asarray(x) for x in xs]))
    out = TL.route([torch.from_numpy(x) for x in xs]).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("stride", [2, 3])
def test_reorg_exact(stride, reverse):
    c = 4 * stride * stride if reverse else 4
    x = _rand(stride, 2, 6, 6, c)
    ref = np.asarray(JL.reorg(jnp.asarray(x), stride, reverse))
    out = TL.reorg(torch.from_numpy(x), stride, reverse).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("stride,scale", [(2, 1.0), (3, 1.0), (2, 0.5),
                                          (2, 0.1)])
def test_upsample_exact(stride, scale):
    x = _rand(1, 2, 3, 4, 5)
    ref = np.asarray(JL.upsample(jnp.asarray(x), stride, scale))
    out = TL.upsample(torch.from_numpy(x), stride, scale).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("x_shape,from_shape,act", [
    ((2, 8, 8, 6), (2, 8, 8, 6), "linear"),
    ((2, 8, 8, 6), (2, 8, 8, 6), "leaky"),
    ((2, 4, 4, 6), (2, 8, 8, 6), "linear"),    # strided source
    ((2, 8, 8, 6), (2, 4, 4, 6), "linear"),    # sampled destination
    ((2, 8, 8, 6), (2, 8, 8, 4), "leaky"),     # channel mismatch
])
def test_shortcut_exact(x_shape, from_shape, act):
    x, f = _rand(1, *x_shape), _rand(2, *from_shape)
    ref = np.asarray(JL.shortcut(jnp.asarray(x), jnp.asarray(f), act))
    xt = torch.from_numpy(x)
    out = TL.shortcut(xt, torch.from_numpy(f), act).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(xt.numpy(), x)   # input left unchanged


def test_yolo_head():
    x = _rand(3, 2, 4, 5, 3 * (5 + 7), scale=3.0)
    ref = np.asarray(JL.yolo_head(jnp.asarray(x), 3, 7))
    out = TL.yolo_head(torch.from_numpy(x), 3, 7).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("do_softmax", [True, False])
def test_region_head(do_softmax):
    x = _rand(4, 2, 4, 5, 5 * (4 + 1 + 6), scale=3.0)
    ref = np.asarray(JL.region_head(jnp.asarray(x), 5, 6, 4, do_softmax))
    out = TL.region_head(torch.from_numpy(x), 5, 6, 4, do_softmax).numpy()
    assert out.shape == ref.shape == (2, 4, 5, 5, 11)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_softmax_tree_and_softmax_layer_not_yet_ported():
    """Once refused by the port, now ported: the region head over softmax
    tree groups and the [softmax] layer equal JAX's (the exp tolerance;
    tests/test_torch_tree.py holds them at more shapes)."""
    x = _rand(9, 1, 2, 2, 2 * 9, scale=3.0)
    ref = np.asarray(JL.region_head(jnp.asarray(x), 2, 4, 4, True,
                                    softmax_tree_groups=[2, 2]))
    out = TL.region_head(torch.from_numpy(x), 2, 4, 4, True,
                         softmax_tree_groups=[2, 2]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    flat = x.reshape(1, -1)
    ref = np.asarray(JL.softmax_layer(jnp.asarray(flat), 1, 1.0))
    out = TL.softmax_layer(torch.from_numpy(flat), 1, 1.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ks,stride,pad,bn,act", [
    (3, 1, 1, False, "leaky"),
    (3, 2, 1, True, "leaky"),
    (1, 1, 0, True, "linear"),
    (3, 1, 1, True, "logistic"),
])
def test_conv2d_fp32(ks, stride, pad, bn, act):
    c, m = 6, 10
    x = np.random.RandomState(ks + stride).rand(2, 9, 9, c).astype(np.float32)
    w = _rand(5, ks, ks, c, m, scale=0.3)             # HWIO
    b = _rand(6, m)
    bnp = None
    if bn:
        bnp = (np.random.RandomState(7).uniform(0.5, 1.5, m).astype(np.float32),
               _rand(8, m, scale=0.3),
               np.random.RandomState(9).uniform(0.2, 1.5, m).astype(np.float32))
    ref = np.asarray(JL.conv2d_fp32(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, pad, act,
        bn=None if bnp is None else tuple(jnp.asarray(v) for v in bnp)))
    out = TL.conv2d_fp32(
        torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
        torch.from_numpy(b), stride, pad, act,
        bn=None if bnp is None else tuple(torch.from_numpy(v) for v in bnp))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_quantize_i8_exact():
    x = _rand(11, 3, 5, 5, 8, scale=2.0)
    x.reshape(-1)[:6] = [3.2, -3.2, 0.0249, -0.0249, 100.0, -100.0]
    mult = np.float32(40.0)
    ref = np.asarray(jnp.clip(jnp.trunc(jnp.asarray(x) * jnp.float32(mult)),
                              -127, 127).astype(jnp.int8))
    out = TL.quantize_i8(torch.from_numpy(x), float(mult))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("ks,stride,pad,act", [
    (3, 1, 1, "leaky"), (3, 2, 1, "leaky"), (1, 1, 0, "linear"),
    (3, 1, 1, "relu"),
])
def test_conv2d_int8_layer_bit_exact(ks, stride, pad, act):
    """Quantize + int8 conv + epilogue against the JAX cpu-semantics layer
    (its default XLA engine): the same integer and float32 steps, so the
    result is bit-exact."""
    from yolo2_light_tpu_torch.ops.int8_conv import alpha_f32, relayout_hwio
    c, m = 16, 24
    x = np.random.RandomState(ks).rand(2, 7, 7, c).astype(np.float32) * 3
    rng = np.random.RandomState(ks + 1)
    w8 = rng.randint(-127, 128, (ks, ks, c, m)).astype(np.int8)
    b = rng.randn(m).astype(np.float32)
    in_mult, w_mult = np.float32(40.0), np.float32(8.0)
    ref = np.asarray(JL.conv2d_int8(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(b), stride, pad, act,
        jnp.float32(in_mult), jnp.float32(w_mult)))
    out = TL.conv2d_int8(torch.from_numpy(x), relayout_hwio(w8),
                         torch.from_numpy(b), stride, pad, act,
                         float(in_mult), alpha_f32(in_mult, w_mult))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_conv2d_int8_hands_the_kernel_dense_nhwc(monkeypatch):
    """A conv output seen through its NHWC permute may be strided; the int8
    layer must pass the kernel a dense NHWC tensor (the kernel refuses any
    other)."""
    from yolo2_light_tpu_torch.ops import int8_conv
    seen = []

    def record(xf, *args, **store):
        seen.append(xf.is_contiguous())
        return int8_conv.conv2d_int8_f32_plain(xf, *args, **store)

    monkeypatch.setattr(int8_conv, "conv2d_int8_f32", record)
    x = torch.rand(1, 8, 6, 5).permute(0, 2, 3, 1)      # NHWC view of NCHW
    assert not x.is_contiguous()
    w = torch.randint(-127, 128, (4, 3, 3, 8), dtype=torch.int8)
    TL.conv2d_int8(x, w, torch.zeros(4), 1, 1, "leaky", 40.0, 0.05)
    assert seen == [True]
