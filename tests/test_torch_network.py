"""The port's Predictor against the JAX Predictor, head map for head map, and
the yolov3-416 cfg the port's chip check runs.

Tolerance rtol=1e-4/atol=1e-5 (as tests/test_parallel.py uses between two
float32 programs): the float32 convs (every conv in fp32 mode; layer 0 and
the LINEAR head convs in int8 mode) sum the same products in another order
than XLA, and sigmoid/exp differ by a few ULP. The int8 convs themselves are
bit-exact (tests/test_torch_int8_conv.py). A quantization-bin flip would
show here as an error far above the tolerance and is classified as F7
(ROADMAP), never hidden by widening it.
"""

import os
import re

import numpy as np
import pytest
import torch

from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu.models.network import Predictor as JaxPredictor
from yolo2_light_tpu.quant import quantize_params
from yolo2_light_tpu.weights import fuse_conv_batchnorm, random_params
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.models import network as TN
from yolo2_light_tpu_torch.models.network import Predictor

DATA = os.path.join(os.path.dirname(__file__), "data")
YOLOV3 = os.path.join(DATA, "yolov3.cfg")


def shrunk_yolov3(tmp_path, size=64, div=8):
    """yolov3.cfg at ``size`` x ``size`` with every non-head ``filters=``
    divided by ``div`` (the 255-filter detector convs keep their width)."""
    with open(YOLOV3) as f:
        text = f.read()
    text = text.replace("width=416", f"width={size}").replace(
        "height=416", f"height={size}")
    text = re.sub(r"filters=(\d+)", lambda m: m.group(0) if m.group(1) == "255"
                  else f"filters={int(m.group(1)) // div}", text)
    p = tmp_path / "yolov3-shrunk.cfg"
    p.write_text(text)
    return str(p)


def _params(spec, mode, seed=3):
    params = fuse_conv_batchnorm(spec, random_params(spec, seed=seed))
    return quantize_params(spec, params) if mode == "int8" else params


def _specs(cfg, **kwargs):
    """``cfg`` parsed by each side: the JAX package's spec for its own code
    (params included), the port's for the port, whose layer dispatch checks
    its own spec classes."""
    return (parse_network_cfg(cfg, batch=1, **kwargs),
            TC.parse_network_cfg(cfg, batch=1, **kwargs))


def _compare(cfg, mode):
    spec, tspec = _specs(cfg)
    params = _params(spec, mode)
    x = np.random.RandomState(7).rand(2, spec.net.h, spec.net.w,
                                      spec.net.c).astype(np.float32)
    ref = JaxPredictor(spec, params, mode)(x)
    out = Predictor(tspec, params, mode, device="cpu")(x)
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        assert (o.index, o.kind) == (r.index, r.kind)
        assert o.data.dtype == torch.float32
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2", "mini-res"])
def test_predictor_matches_jax(name, mode):
    _compare(os.path.join(DATA, f"{name}.cfg"), mode)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_shrunk_yolov3_matches_jax(tmp_path, mode):
    _compare(shrunk_yolov3(tmp_path), mode)


def test_yolov3_cfg_topology():
    """tests/data/yolov3.cfg (scripts/gen_yolov3_cfg.py) is darknet's
    yolov3-416: the counts test_cfg.py expects of the reference file."""
    spec = TC.parse_network_cfg(YOLOV3, batch=1)
    assert spec.n == 107
    assert len(spec.conv_layers()) == 75
    assert sum(isinstance(l, TC.ShortcutSpec) for l in spec.layers) == 23
    assert spec.head_indices() == [82, 94, 106]
    heads = [spec.layers[i] for i in spec.head_indices()]
    assert [(l.w, l.h, l.c) for l in heads] == [(13, 13, 255), (26, 26, 255),
                                                (52, 52, 255)]
    assert [tuple(l.mask) for l in heads] == [(6, 7, 8), (3, 4, 5), (0, 1, 2)]
    assert all(l.classes == 80 and l.total == 9 for l in heads)
    assert list(heads[0].anchors) == [10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                                      59, 119, 116, 90, 156, 198, 373, 326]
    # the int8 set of the chip check: 75 convs minus layer 0 minus the 3
    # linear detector convs
    int8_set = TN._int8_layer_set(spec, "cpu")
    assert len(int8_set) == 71
    assert {l.index for l in spec.conv_layers()} - int8_set == {0, 81, 93,
                                                                105}
    classes = {(l.size, l.stride) for l in spec.conv_layers()
               if l.index in int8_set}
    assert classes == {(3, 1), (3, 2), (1, 1)}
    assert all(spec.layers[i].c % 4 == 0 for i in int8_set)


def test_yolov3_cfg_is_generated_by_script(tmp_path):
    import importlib.util
    path = os.path.join(os.path.dirname(DATA), os.pardir, "scripts",
                        "gen_yolov3_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_yolov3_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "y.cfg"
    assert mod.main([str(out)]) == 0
    with open(YOLOV3) as f:
        assert out.read_text() == f.read()


def test_int8_layer_set_and_consumers_match_jax():
    from yolo2_light_tpu.models import network as JN
    for name in ("mini-yolo3", "mini-yolo2", "mini-res", "mini-routeflat",
                 "mini-dontload"):
        spec, tspec = _specs(os.path.join(DATA, f"{name}.cfg"),
                             quantized=True)
        for policy in ("cpu", "gpu"):
            assert (TN._int8_layer_set(tspec, policy)
                    == JN._int8_layer_set(spec, policy))
        assert TN._consumers(tspec) == JN._consumers(spec)


_OLD_YOLO = ("YoloSpec is not supported by the reference's old INT8 "
             "pipeline")


@pytest.mark.parametrize("kwargs,error,match", [
    (dict(mode="int8", int8_impl="fused", int8_policy="cpu_old"),
     NotImplementedError, _OLD_YOLO),
    (dict(mode="int8", turbo="int4"), ValueError, "unknown turbo mode"),
    (dict(mode="int8", int8_policy="cpu_old"), NotImplementedError,
     _OLD_YOLO),
    (dict(mode="fp32", turbo="fp8"), ValueError, "unknown turbo mode"),
    (dict(mode="fp32", turbo="int8"), ValueError, "requires int8 mode"),
    (dict(mode="fp32", compute_dtype=torch.float16), ValueError,
     "compute dtype"),
])
def test_unported_modes_raise(kwargs, error, match):
    """``cpu_old`` on a yolov3-style net raises as JAX does: the reference's
    old INT8 pipeline runs conv, maxpool, route, reorg and region layers
    only, whatever ``int8_impl`` says (JAX ignores it there, and so does the
    port); the port raises when the forward is built, JAX at the first such
    layer of a forward, with the same message. The other cases are the JAX
    package's mode gates (tests/test_turbo_int8.py::test_mode_gates): an
    unknown turbo mode, turbo_int8 outside int8 mode, a compute dtype other
    than float32 and bfloat16."""
    cfg = os.path.join(DATA, "mini-yolo3.cfg")
    spec = TC.parse_network_cfg(cfg, batch=1)
    with pytest.raises(error, match=match):
        TN.build_forward(spec, **kwargs)
    if kwargs.get("int8_policy") == "cpu_old":
        from yolo2_light_tpu.models import network as JN
        jspec = parse_network_cfg(cfg, batch=1)
        fwd = JN.build_forward(jspec, **kwargs)
        x = np.zeros((1, jspec.net.h, jspec.net.w, 3), np.float32)
        with pytest.raises(error, match=match):
            fwd(JN.params_to_device(_params(jspec, "int8")), x)


def test_unknown_engine_and_policy_are_value_errors():
    spec = TC.parse_network_cfg(os.path.join(DATA, "mini-yolo3.cfg"), batch=1)
    with pytest.raises(ValueError, match="int8_impl"):
        TN.build_forward(spec, "int8", int8_impl="triton")
    with pytest.raises(ValueError, match="policy"):
        TN.build_forward(spec, "int8", int8_policy="tpu")


def test_xnor_conv_not_yet_ported():
    """Nothing of an XNOR cfg is refused: mini-xnor builds in fp32 on every
    engine, and its default engine matches the JAX Predictor
    (tests/test_torch_xnor.py holds every engine to it)."""
    from yolo2_light_tpu.xnor import binarize_params
    spec, tspec = _specs(os.path.join(DATA, "mini-xnor.cfg"))
    for engine in TN.XNOR_IMPLS:
        TN.build_forward(tspec, "fp32", xnor_impl=engine)
    params = binarize_params(spec, _params(spec, "fp32"))
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    ref = JaxPredictor(spec, params)(x)
    out = Predictor(tspec, params, device="cpu")(x)
    np.testing.assert_allclose(out[0].data.numpy(), np.asarray(ref[0].data),
                               rtol=1e-4, atol=1e-5)


def test_xnor_cfg_int8_runs_int8_path_like_jax():
    """Under -quantized every xnor=1 conv of mini-xnor is int8-eligible, and
    an int8-eligible conv runs the int8 path whatever its xnor flag (JAX
    network.py dispatch precedence): nothing unported is reached."""
    _compare(os.path.join(DATA, "mini-xnor.cfg"), "int8")


def test_softmax_layer_cfg_not_yet_ported(tmp_path):
    """Once refused by the port, now ported: a cfg ending in [softmax] runs
    through the forward, whose final output equals the JAX forward's."""
    from yolo2_light_tpu.models import network as JN
    cfg = tmp_path / "sm.cfg"
    cfg.write_text("[net]\nwidth=8\nheight=8\nchannels=3\n\n"
                   "[convolutional]\nfilters=4\nsize=1\nstride=1\n"
                   "activation=leaky\n\n[softmax]\ngroups=1\n")
    spec = TC.parse_network_cfg(str(cfg), batch=1)
    jspec = parse_network_cfg(str(cfg), batch=1)
    params = fuse_conv_batchnorm(jspec, random_params(jspec, seed=2))
    x = np.random.RandomState(3).rand(2, 8, 8, 3).astype(np.float32)
    _, aux = TN.build_forward(spec, "fp32")(
        TN.device_params(spec, params, "fp32", "cpu"), torch.from_numpy(x))
    _, jaux = JN.build_forward(jspec, "fp32")(JN.params_to_device(params), x)
    assert aux["final"].shape == (2, 8 * 8 * 4)
    np.testing.assert_allclose(aux["final"].numpy(), np.asarray(jaux["final"]),
                               rtol=1e-4, atol=1e-5)


def test_predictor_holds_params_as_buffers_on_its_device():
    spec, tspec = _specs(os.path.join(DATA, "mini-yolo3.cfg"))
    pred = Predictor(tspec, _params(spec, "int8"), "int8", device="cpu")
    names = dict(pred.named_buffers())
    assert names and all(t.device.type == "cpu" for t in names.values())
    # int8 convs keep only their int8 weights; float convs their f32 weights
    assert "l2_weights_int8" in names and "l2_weights" not in names
    assert "l0_weights" in names and "l0_weights_int8" not in names
    assert names["l2_weights_int8"].shape == (32, 3, 3, 16)
    p = pred.layer_params()[2]
    assert isinstance(p["alpha"], float)
    assert isinstance(p["input_quant_multipler"], float)


def test_cuda_predictor_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")
    spec, tspec = _specs(os.path.join(DATA, "mini-yolo3.cfg"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(tspec, _params(spec, "int8"), "int8", device="cuda")


def test_plain_engine_equals_default_on_cpu():
    spec, tspec = _specs(os.path.join(DATA, "mini-res.cfg"))
    params = _params(spec, "int8")
    x = np.random.RandomState(2).rand(1, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    a = Predictor(tspec, params, "int8", device="cpu")(x)
    b = Predictor(tspec, params, "int8", device="cpu", int8_impl="plain")(x)
    for ha, hb in zip(a, b):
        assert torch.equal(ha.data, hb.data)
