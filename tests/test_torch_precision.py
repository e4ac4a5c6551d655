"""The port's precision modes against the JAX package's, on the CPU:
``-int8_policy gpu``, ``-turbo`` (bfloat16 residuals), ``-turbo_int8`` (an
int8 residual trunk) and ``-bf16`` (bfloat16 float convs).

What is integer math or memory movement in JAX is held bit for bit: the
chain and trunk scale analyses, and the int8 conv layer in every epilogue,
input form and store against eager ``L.conv2d_int8``. The forwards are held
to the jitted JAX ``Predictor`` at tolerances stated per mode below, and the
``-turbo`` forwards also to the eager JAX forward, bit for bit up to float32
summation order.

Why ``-turbo`` needs the eager forward: XLA's CPU compiler keeps excess
precision across a float32 -> bfloat16 -> float32 pair of converts inside a
fusion (``xla_allow_excess_precision``, on by default), so the jitted JAX
forward does not round every materialized activation to bfloat16, where
its eager forward and the port (the int8 kernel's bfloat16 store, on the
card too) do. Against the jitted forward the turbo heads then differ as
turbo differs from exact: bfloat16 steps, and a value on an int8 bin
boundary moving one bin. They are held there to the bound the JAX package's
own turbo tests use (tests/test_int8_chain.py, tests/test_fused_network.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_network import _params, _specs
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models import network as JN
from yolo2_light_tpu.xnor import binarize_params
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.models import layers as TL
from yolo2_light_tpu_torch.models import network as TN
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.ops import int8_conv as K

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MINI = ("mini-yolo3", "mini-yolo2", "mini-res", "mini-routeflat",
        "mini-dontload", "mini-xnor")


# ---------------------------------------------------------------------------
# the scale analyses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["cpu", "gpu"])
@pytest.mark.parametrize("name", MINI + ("yolov3",))
def test_chain_and_trunk_targets_match_jax(name, policy):
    spec, tspec = _specs(os.path.join(DATA, f"{name}.cfg"), quantized=True)
    iset = JN._int8_layer_set(spec, policy)
    assert TN._int8_layer_set(tspec, policy) == iset
    assert (TN._int8_chain_targets(tspec, iset)
            == JN._int8_chain_targets(spec, iset))
    assert TN._trunk_targets(tspec, iset) == JN._trunk_targets(spec, iset)


def test_yolov3_gpu_set_is_the_3x3_s1_convs_and_conv_1():
    """Under the gpu policy 26 of yolov3's 75 convs are int8: conv 1 (the
    first 3x3/s2) and 25 3x3/s1 convs; every one takes the int8 kernel
    (C % 4 == 0). The other 49 run the float path."""
    tspec = TC.parse_network_cfg(os.path.join(DATA, "yolov3.cfg"), batch=1,
                                 quantized=True)
    gpu = TN._int8_layer_set(tspec, "gpu")
    assert len(gpu) == 26 and 1 in gpu
    assert all((tspec.layers[i].size, tspec.layers[i].stride) == (3, 1)
               for i in gpu - {1})
    assert all(tspec.layers[i].c % 4 == 0 for i in gpu)


def test_resolve_residual_dtype_is_jaxs():
    assert TN.resolve_residual_dtype(False) is None
    assert TN.resolve_residual_dtype(True) is torch.bfloat16
    assert TN.resolve_residual_dtype("bf16") is torch.bfloat16
    assert TN.resolve_residual_dtype("int8") == "int8"
    with pytest.raises(ValueError, match="unknown turbo mode"):
        TN.resolve_residual_dtype("fp8")


# ---------------------------------------------------------------------------
# the int8 conv layer: every epilogue, input form and store, bit for bit
# ---------------------------------------------------------------------------

IN_MULT, W_MULT, OUT_MULT = np.float32(24.0), np.float32(96.0), np.float32(
    11.5)


def _conv_operands(seed, c=16, m=20, ks=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 9, 9, c) * 2).astype(np.float32)
    w8 = rng.randint(-127, 128, (ks, ks, c, m)).astype(np.int8)
    b = rng.randn(m).astype(np.float32)
    return x, w8, b


def _scale(semantics):
    return K.alpha_f32(IN_MULT, W_MULT, 32 if semantics == "cpu" else 1)


@pytest.mark.parametrize("x_form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("out_dtype", [None, "bf16"])
@pytest.mark.parametrize("semantics", ["cpu", "gpu"])
@pytest.mark.parametrize("act,stride", [("leaky", 1), ("linear", 2),
                                        ("relu", 1)])
def test_conv2d_int8_matches_jax_bit_for_bit(semantics, out_dtype, x_form,
                                             act, stride):
    x, w8, b = _conv_operands(stride + len(act))
    xj = jnp.asarray(x)
    if x_form == "bf16":
        xj = xj.astype(jnp.bfloat16)
    xi8 = JN._quantize_i8(xj, jnp.float32(IN_MULT))
    ref = JL.conv2d_int8(
        xj, jnp.asarray(w8), jnp.asarray(b), stride, 1, act,
        jnp.float32(IN_MULT), jnp.float32(W_MULT), semantics=semantics,
        x_int8=xi8 if x_form == "int8" else None,
        out_dtype=jnp.bfloat16 if out_dtype else None)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if x_form == "bf16":
        xt = xt.to(torch.bfloat16)
    out = TL.conv2d_int8(
        xt, K.relayout_hwio(w8), torch.from_numpy(b), stride, 1, act,
        float(IN_MULT), _scale(semantics), semantics=semantics,
        x_int8=(torch.from_numpy(np.array(xi8)) if x_form == "int8"
                else None),
        out_dtype=torch.bfloat16 if out_dtype else None)
    assert out.dtype == (torch.bfloat16 if out_dtype else torch.float32)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("semantics", ["cpu", "gpu"])
@pytest.mark.parametrize("act", ["leaky", "linear", "relu"])
def test_int8_store_is_the_trunk_quantize(semantics, act):
    """The int8 store at ``out_mult`` equals JAX's ``_quantize_i8`` of the
    float32 conv output (turbo_int8's ``resid_q``), bit for bit."""
    x, w8, b = _conv_operands(3)
    ref = JN._quantize_i8(JL.conv2d_int8(
        jnp.asarray(x), jnp.asarray(w8), jnp.asarray(b), 1, 1, act,
        jnp.float32(IN_MULT), jnp.float32(W_MULT), semantics=semantics),
        jnp.float32(OUT_MULT))
    out = TL.conv2d_int8(torch.from_numpy(x), K.relayout_hwio(w8),
                         torch.from_numpy(b), 1, 1, act, float(IN_MULT),
                         _scale(semantics), semantics=semantics,
                         out_dtype=torch.int8, out_mult=float(OUT_MULT))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gpu_leaky_is_a_tenth_times_y():
    """F3's gpu half: the gpu flavor's leaky is float32 0.1 * y (JAX's
    ``0.1 * x``), where the cpu flavor divides by 10; the two differ."""
    acc = torch.arange(-40000, 0, 7, dtype=torch.int32)
    bias = torch.zeros(acc.shape)
    inv = K.alpha_f32(IN_MULT, W_MULT, 1)
    y = (acc.numpy().astype(np.float32) * np.float32(inv)).astype(np.float32)
    gpu = K.gpu_epilogue_plain(acc, bias, inv, "leaky").numpy()
    np.testing.assert_array_equal(gpu, np.float32(0.1) * y)
    np.testing.assert_array_equal(
        gpu, np.asarray(JL.activate(jnp.asarray(y), "leaky")))
    assert (gpu != y / np.float32(10)).any()


def test_kernel_refuses_an_int8_store_without_its_multiplier():
    x, w8, b = _conv_operands(5)
    with pytest.raises(ValueError, match="out_mult"):
        K.conv2d_int8_f32_plain(torch.from_numpy(x), K.relayout_hwio(w8),
                                torch.from_numpy(b), 24.0, 0.01, 1, 1,
                                out_dtype=torch.int8)
    with pytest.raises(ValueError, match="semantics"):
        K.conv2d_int8_f32_plain(torch.from_numpy(x), K.relayout_hwio(w8),
                                torch.from_numpy(b), 24.0, 0.01, 1, 1,
                                semantics="tpu")


def test_int8_maxpool_pads_with_iinfo_min():
    """An int8 map pools with out-of-bounds cells at -128 and equals the
    quantized float pool (quantize commutes with max)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 7, 7, 5) * 30).astype(np.float32)
    q = TL.quantize_i8(torch.from_numpy(x), 1.0)
    for size, stride, pad in ((2, 2, 1), (2, 1, 1), (3, 2, 2)):
        oh = (7 + pad - size) // stride + 1
        pooled = TL.maxpool(q, size, stride, pad, oh, oh)
        assert pooled.dtype == torch.int8
        np.testing.assert_array_equal(
            pooled.numpy(), np.asarray(JL.maxpool(jnp.asarray(q.numpy()),
                                                  size, stride, pad, oh, oh)))
        np.testing.assert_array_equal(
            pooled.numpy(),
            TL.quantize_i8(TL.maxpool(torch.from_numpy(x), size, stride, pad,
                                      oh, oh), 1.0).numpy())


# ---------------------------------------------------------------------------
# the forwards against the JAX Predictor
# ---------------------------------------------------------------------------

# name: (mode, keywords, how the heads are held to JAX's):
# * (rtol, atol): to the jitted JAX Predictor, every entry;
# * "exact": to the eager JAX forward at 1e-4 / 1e-5, every entry, and to
#   the jitted Predictor at the bound of the JAX package's turbo tests: the
#   jitted forward contracts turbo_int8's dequantize (q * 1/m) into the
#   next add as an FMA (ROADMAP F7), which moves int8 bins downstream;
# * "bf16": the eager forward at 1e-4 / 1e-5 on all but 0.1% of the
#   entries, the rest and the jitted Predictor at the turbo bound: a
#   float32 sum summed in another order than XLA's, lying within an ULP of
#   a bfloat16 rounding boundary, rounds the other way (one bfloat16 step,
#   2**-8 relative), and the step travels downstream;
# * "bf16_deep": the jitted Predictor at the turbo bound only. With every
#   conv in bfloat16 (-bf16 in fp32 mode) such steps compound over
#   yolov3's 75 convs (about half the entries move by more than 1e-4);
#   test_bf16_convs_match_jax_conv_by_conv holds each conv to 1e-5.
MODES = {
    # the gpu epilogue is bit-exact; the float32 convs (layer 0, the heads)
    # sum in another order than XLA: test_torch_network.py's tolerance
    "gpu": ("int8", dict(int8_policy="gpu"), (1e-4, 1e-5)),
    "turbo_fp32": ("fp32", dict(turbo=True), "bf16"),
    "turbo_int8_mode": ("int8", dict(turbo=True), "bf16"),
    "turbo_int8_xla": ("int8", dict(turbo="int8"), "exact"),
    "turbo_int8_fused": ("int8", dict(turbo="int8", int8_impl="fused"),
                         "exact"),
    "bf16_fp32": ("fp32", dict(compute_dtype="bf16"), "bf16_deep"),
    # in int8 mode only layer 0 and the heads are bfloat16 convs
    "bf16_int8": ("int8", dict(compute_dtype="bf16"), (1e-4, 1e-5)),
}


def _odd_multipliers(params):
    """The int8 convs' input multipliers moved off the powers of two the
    test cfgs calibrate to: at a power of two the turbo_int8 view
    q * (1/m) always quantizes back to q, which would hide the chain's
    hand-over of q. At 1.0346517 times a power of two, 98 of the 255 int8
    values do not come back."""
    for p in params:
        if p is not None and "input_quant_multipler" in p:
            p["input_quant_multipler"] = np.float32(
                p["input_quant_multipler"] * np.float32(1.0346517))
    return params


def _jax_eager_heads(spec, params, mode, kw, x):
    """The JAX forward op by op (no jit: no excess precision, no FMA)."""
    fwd = JN.build_forward(spec, mode, int8_chain=kw.get("int8_chain", True),
                           residual_dtype=JN.resolve_residual_dtype(
                               kw.get("turbo", False)),
                           int8_policy=kw.get("int8_policy", "cpu"),
                           int8_impl=kw.get("int8_impl", "xla"))
    with jax.disable_jit():
        heads, _ = fwd(JN.params_to_device(params), jnp.asarray(x))
    return [np.asarray(h.data) for h in heads]


def _check_turbo_bound(out, ref):
    """tests/test_int8_chain.py's bound on turbo against exact."""
    np.testing.assert_allclose(out, ref, rtol=0.1, atol=0.1)
    assert np.mean(np.abs(out - ref)) < 2e-2


def _compare_modes(spec, tspec, params, mode, kw, tol, x, **port_kw):
    """The port's heads in mode ``kw`` (``port_kw``: the port's other
    keywords) held to JAX's as ``tol`` says (see MODES); returns them."""
    jkw, tkw = dict(kw), dict(kw, **port_kw)
    if kw.get("compute_dtype") == "bf16":
        jkw["compute_dtype"], tkw["compute_dtype"] = jnp.bfloat16, \
            torch.bfloat16
    ref = JN.Predictor(spec, params, mode, **jkw)(x)
    out = Predictor(tspec, params, mode, device="cpu", **tkw)(x)
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        assert (o.index, o.kind) == (r.index, r.kind)
        assert o.data.dtype == torch.float32
        if isinstance(tol, tuple):
            np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                       rtol=tol[0], atol=tol[1])
        else:
            _check_turbo_bound(o.data.numpy(), np.asarray(r.data))
    if tol in ("exact", "bf16"):
        for o, e in zip(out, _jax_eager_heads(spec, params, mode, kw, x)):
            close = np.isclose(o.data.numpy(), e, rtol=1e-4, atol=1e-5)
            assert close.mean() >= (1.0 if tol == "exact" else 0.999), \
                close.mean()
            _check_turbo_bound(o.data.numpy(), e)
    return out


def compare_in_mode(cfg, mode_name):
    """The port's Predictor against JAX's on ``cfg`` in ``MODES[mode_name]``
    (random weights, seed 3; two random images, seed 7)."""
    mode, kw, tol = MODES[mode_name]
    spec, tspec = _specs(cfg)
    params = _params(spec, mode)
    if kw.get("turbo") == "int8":
        params = _odd_multipliers(params)
    x = np.random.RandomState(7).rand(2, spec.net.h, spec.net.w,
                                      spec.net.c).astype(np.float32)
    _compare_modes(spec, tspec, params, mode, kw, tol, x)


@pytest.mark.parametrize("mode_name", list(MODES))
@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2", "mini-res"])
def test_predictor_matches_jax_in_every_mode(name, mode_name):
    """Shrunk yolov3: tests/test_torch_precision_yolov3.py."""
    compare_in_mode(os.path.join(DATA, f"{name}.cfg"), mode_name)


@pytest.mark.parametrize("engine", ["int8", "pallas", "pallas_mxu"])
def test_xnor_net_under_turbo_matches_jax(engine):
    """mini-xnor under -turbo: the XNOR convs read bfloat16 maps (their
    packing and the dense engine binarize x > 0, equal on bfloat16 and on
    its float32 upcast) and store float32, as in JAX."""
    spec, tspec = _specs(os.path.join(DATA, "mini-xnor.cfg"))
    params = binarize_params(spec, _params(spec, "fp32"))
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    for h in _compare_modes(spec, tspec, params, "fp32", dict(turbo=True),
                            "bf16", x, xnor_impl=engine):
        assert h.data.dtype == torch.float32


def test_turbo_int8_feeds_the_producers_q():
    """Under turbo_int8 the chain hands a conv its producer's q where the
    chain and trunk targets agree, not a quantize of the dequantized view
    (which need not round-trip): with and without the chain the port
    matches the eager JAX forward, and the two differ on this net."""
    spec, tspec = _specs(os.path.join(DATA, "mini-yolo3.cfg"))
    params = _odd_multipliers(_params(spec, "int8"))
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    chained = Predictor(tspec, params, "int8", device="cpu", turbo="int8")(x)
    unchained = Predictor(tspec, params, "int8", device="cpu", turbo="int8",
                          int8_chain=False)(x)
    ref = _jax_eager_heads(spec, params, "int8", dict(turbo="int8"), x)
    ref_unchained = _jax_eager_heads(
        spec, params, "int8", dict(turbo="int8", int8_chain=False), x)
    for c, u, r, ru in zip(chained, unchained, ref, ref_unchained):
        np.testing.assert_allclose(c.data.numpy(), r, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(u.data.numpy(), ru, rtol=1e-4, atol=1e-5)
    assert any(not torch.equal(c.data, u.data)
               for c, u in zip(chained, unchained))


def test_gpu_policy_forward_launches_only_the_gpu_set(monkeypatch):
    """Under the gpu policy exactly the gpu set's convs take the int8 layer,
    with the gpu epilogue and each conv's ``inv``."""
    seen = []
    real = TL.conv2d_int8

    def record(*args, **kw):
        seen.append((kw["semantics"], args[7]))
        return real(*args, **kw)

    monkeypatch.setattr(TL, "conv2d_int8", record)
    spec, tspec = _specs(os.path.join(DATA, "mini-yolo3.cfg"))
    params = _params(spec, "int8")
    pred = Predictor(tspec, params, "int8", device="cpu", int8_policy="gpu")
    pred(np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32))
    gpu = sorted(TN._int8_layer_set(tspec, "gpu"))
    layer = pred.layer_params()
    assert seen == [("gpu", layer[i]["inv"]) for i in gpu]
    assert all(layer[i]["inv"] == K.alpha_f32(
        params[i]["input_quant_multipler"],
        params[i]["weights_quant_multipler"], 1) for i in gpu)


def test_bf16_predictor_keeps_bf16_float_weights():
    """-bf16 casts the float convs' weights once, at load time."""
    spec, tspec = _specs(os.path.join(DATA, "mini-yolo3.cfg"))
    pred = Predictor(tspec, _params(spec, "int8"), "int8", device="cpu",
                     compute_dtype=torch.bfloat16)
    bufs = dict(pred.named_buffers())
    assert bufs["l0_weights"].dtype == torch.bfloat16
    assert bufs["l2_weights_int8"].dtype == torch.int8



def test_fused_plain_engine_keeps_the_fused_structure():
    """``fused_plain`` (the plain twin of the fused engine on the card) is
    the fused engine's function: under turbo_int8 a fused run's interior
    trunk stays float32, so it parts from the unfused ``plain`` engine."""
    spec, tspec = _specs(os.path.join(DATA, "mini-res.cfg"))
    params = _odd_multipliers(_params(spec, "int8"))
    x = np.random.RandomState(3).rand(1, 32, 32, 3).astype(np.float32)
    heads = {impl: Predictor(tspec, params, "int8", device="cpu",
                             turbo="int8", int8_impl=impl)(x)
             for impl in ("fused", "fused_plain", "plain")}
    for f, fp, p in zip(heads["fused"], heads["fused_plain"],
                        heads["plain"]):
        assert torch.equal(f.data, fp.data)
        assert not torch.equal(f.data, p.data)
