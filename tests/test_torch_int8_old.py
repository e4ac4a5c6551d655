"""The port's ``-int8_policy cpu_old`` (the reference's legacy all-int8 chain)
against the JAX package's, on the CPU.

The int8 chain is integer math and memory movement, held bit for bit: the
layer functions ``conv2d_int8_old`` (both outputs, every store) and
``maxpool_int8_old`` (window origin ``-pad``, ROADMAP F4), the int8
kernel's "old" plain twin, and every int8 and float output of the forward
against the EAGER JAX forward (each op rounded on its own). Two things are
float and held to a tolerance: the float32 convs of layer 0 and of the
LINEAR head conv (another summation order than XLA's, rtol=1e-5 /
atol=1e-6 as in tests/test_torch_layers.py), and the region head (sigmoid
and softmax, rtol=1e-5, atol=1e-6). The jitted JAX forward may differ from
the eager one by XLA's rewrites (F7: ``q / 10`` as ``q * 0.1``, FMAs); the
old chain truncates every product to an integer, which those rewrites do
not move for the values a trunc follows, so the CLI diffs below run the
jitted JAX CLI.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_map import _block, _progress
from tests.util_parity import assert_streams_match, parse_detection_lines
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models import network as JN
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.cfg import parse_network_cfg
from yolo2_light_tpu_torch.models import layers as TL
from yolo2_light_tpu_torch.models import network as TN
from yolo2_light_tpu_torch.ops import int8_conv as K
from yolo2_light_tpu_torch.pipeline import DetectionPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MINI_CALIB = os.path.join(DATA, "mini-calib.cfg")
IMAGE = os.path.join(DATA, "dog160.png")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)

# a conv whose float AND int8 outputs are both read: conv 2 feeds the
# LINEAR conv 3 (float) and the route at layer 4 (int8)
BOTH_CFG = """[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[convolutional]
filters=8
size=1
stride=1
pad=1
activation=linear

[route]
layers=-2

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=40
size=1
stride=1
pad=1
activation=linear

[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38,  9.42,5.11,  16.62,10.52
classes=3
coords=4
num=5
softmax=1
"""


def _gen_voc():
    path = os.path.join(REPO, "scripts", "gen_yolov2_voc_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_yolov2_voc_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def narrow_yolov2_voc(tmp_path, size=64, width_div=8):
    """The yolov2-voc topology of scripts/gen_yolov2_voc_cfg.py at
    ``size`` x ``size`` with its widths divided by ``width_div`` (the
    125-filter detector conv keeps its width)."""
    p = tmp_path / f"yolov2-voc-{size}-div{width_div}.cfg"
    p.write_text(_gen_voc().render(size, width_div))
    return str(p)


def _cfg(name, tmp_path):
    if name == "mini-calib":
        return MINI_CALIB
    if name == "both-stores":
        p = tmp_path / "both-stores.cfg"
        p.write_text(BOTH_CFG)
        return str(p)
    return narrow_yolov2_voc(tmp_path)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


def _operands(seed, b, h, w, c, m, ks):
    rng = np.random.RandomState(seed)
    x8 = rng.randint(-127, 128, (b, h, w, c)).astype(np.int8)
    w_hwio = rng.randint(-127, 128, (ks, ks, c, m)).astype(np.int8)
    # biases_quant and output_multipler at the scales quantize_params gives
    bq = (rng.randn(m) * 300).astype(np.float32)
    mult = np.float32(rng.uniform(0.05, 0.4))
    return x8, w_hwio, bq, mult


CONV_CASES = [(1, 6, 7, 12, 10, 1, 1, 0), (2, 9, 8, 8, 16, 3, 1, 1),
              (1, 11, 10, 20, 12, 3, 2, 1)]


@pytest.mark.parametrize("activation", ["leaky", "linear"])
@pytest.mark.parametrize("case", CONV_CASES, ids=["1x1", "3x3s1", "3x3s2"])
def test_conv2d_int8_old_matches_jax_both_outputs(case, activation):
    b, h, w, c, m, ks, s, pad = case
    x8, w_hwio, bq, mult = _operands(7, b, h, w, c, m, ks)
    jf, ji = JL.conv2d_int8_old(jnp.asarray(x8), jnp.asarray(w_hwio),
                                jnp.asarray(bq), mult, s, pad, activation)
    args = (torch.from_numpy(x8), K.relayout_hwio(w_hwio),
            torch.from_numpy(bq), float(mult), s, pad, activation)
    tf, ti = TL.conv2d_int8_old(*args)
    assert tf.dtype == torch.float32 and ti.dtype == torch.int8
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the single stores give the same outputs, the other one left out
    assert TL.conv2d_int8_old(*args, store=torch.float32)[1] is None
    assert torch.equal(TL.conv2d_int8_old(*args, store=torch.float32)[0], tf)
    assert TL.conv2d_int8_old(*args, store=torch.int8)[0] is None
    assert torch.equal(TL.conv2d_int8_old(*args, store=torch.int8)[1], ti)
    # the values the chain carries: both signs, leaky's trunc(q/10) included
    assert (ti < 0).any() and (ti > 0).any()


@pytest.mark.parametrize("case", [(2, 2, 1, 16, 16), (2, 2, 1, 7, 9),
                                  (3, 1, 2, 8, 8), (3, 2, 2, 9, 10)],
                         ids=["2s2p1", "2s2p1-odd", "3s1p2", "3s2p2"])
def test_maxpool_int8_old_matches_jax(case):
    size, stride, pad, h, w = case
    out_h = (h + pad - size) // stride + 1
    out_w = (w + pad - size) // stride + 1
    x8 = np.random.RandomState(h * w).randint(-128, 128, (2, h, w, 5)).astype(
        np.int8)
    want = JL.maxpool_int8_old(jnp.asarray(x8), size, stride, pad, out_w,
                               out_h)
    got = TL.maxpool_int8_old(torch.from_numpy(x8), size, stride, pad, out_w,
                              out_h)
    assert got.dtype == torch.int8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_f4_old_maxpool_origin_is_minus_pad():
    """F4: the legacy int8 maxpool's window starts at -pad, the float one's
    at -pad//2. On yolov2-voc's 2x2/s2 pools (pad 1) they pool different
    pixel pairs: output (0, 0) is x[0, 0] alone under -pad (the rest of its
    window lies outside, at -128), max(x[0:2, 0:2]) under -pad//2."""
    x8 = np.full((1, 4, 4, 1), -50, np.int8)
    x8[0, 1, 1, 0] = 90          # inside the -pad//2 window of output (0, 0)
    t = torch.from_numpy(x8)
    old = TL.maxpool_int8_old(t, 2, 2, 1, 2, 2)
    float_path = TL.maxpool(t, 2, 2, 1, 2, 2)
    assert old[0, 0, 0, 0] == -50 and float_path[0, 0, 0, 0] == 90
    assert not torch.equal(old, float_path)
    np.testing.assert_array_equal(
        old.numpy(), np.asarray(JL.maxpool_int8_old(jnp.asarray(x8), 2, 2, 1,
                                                    2, 2)))


@pytest.mark.parametrize("store", ["f32", "int8", "both"])
@pytest.mark.parametrize("case", CONV_CASES + [(1, 5, 5, 36, 70, 3, 1, 1)],
                         ids=["1x1", "3x3s1", "3x3s2", "ragged"])
def test_k1_old_plain_twin_matches_jax(case, store):
    """K1's "old" form, plain twin (what runs on a CPU tensor and what the
    card's kernel is held to), every store, leaky."""
    b, h, w, c, m, ks, s, pad = case
    x8, w_hwio, bq, mult = _operands(11, b, h, w, c, m, ks)
    jf, ji = JL.conv2d_int8_old(jnp.asarray(x8), jnp.asarray(w_hwio),
                                jnp.asarray(bq), mult, s, pad, "leaky")
    out_dtype = {"f32": torch.float32, "int8": torch.int8,
                 "both": K.OLD_BOTH}[store]
    got = K.conv2d_int8_plain(torch.from_numpy(x8), K.relayout_hwio(w_hwio),
                              torch.from_numpy(bq), float(mult), s, pad,
                              "leaky", semantics="old", out_dtype=out_dtype)
    want = {"f32": np.asarray(jf), "int8": np.asarray(ji)}
    if store == "both":
        assert isinstance(got, tuple) and len(got) == 2
        np.testing.assert_array_equal(got[0].numpy(), want["f32"])
        np.testing.assert_array_equal(got[1].numpy(), want["int8"])
    else:
        np.testing.assert_array_equal(got.numpy(), want[store])


def test_k1_old_form_refuses_other_stores():
    x8, w_hwio, bq, mult = _operands(1, *CONV_CASES[0][:5], 1)
    args = (torch.from_numpy(x8), K.relayout_hwio(w_hwio),
            torch.from_numpy(bq), float(mult), 1, 0, "leaky")
    with pytest.raises(TypeError, match="old epilogue stores"):
        K.conv2d_int8(*args, semantics="old", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no out_mult"):
        K.conv2d_int8(*args, semantics="old", out_dtype=torch.int8,
                      out_mult=2.0)
    with pytest.raises(TypeError, match="store must be"):
        K.conv2d_int8(*args, semantics="cpu", out_dtype=K.OLD_BOTH)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _record(monkeypatch, module, names):
    """Wrap ``names`` of a layers module so each call's output is recorded,
    in call order (the network calls them through the module)."""
    calls = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            calls.append((_name, out))
            return out
        monkeypatch.setattr(module, name, wrapped)
    return calls


_RECORDED = ["conv2d_int8_old", "maxpool_int8_old", "reorg", "conv2d_fp32",
             "region_head"]


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("name", ["mini-calib", "narrow-yolov2-voc",
                                  "both-stores"])
def test_old_forward_every_layer_matches_eager_jax(name, tmp_path,
                                                   monkeypatch):
    cfg = _cfg(name, tmp_path)
    jspec, jparams, _ = jax_build_params(cfg, None, quantized=True, seed=5,
                                         echo=False)
    tspec, tparams, _ = build_params(cfg, None, quantized=True, seed=5,
                                     echo=False)
    x = np.random.RandomState(4).rand(1, tspec.net.h, tspec.net.w,
                                      3).astype(np.float32)
    jcalls = _record(monkeypatch, JL, _RECORDED)
    tcalls = _record(monkeypatch, TL, _RECORDED)
    jheads, jaux = JN.build_forward(jspec, "int8", int8_policy="cpu_old")(
        JN.params_to_device(jparams), x)
    fwd = TN.build_forward(tspec, "int8", int8_policy="cpu_old",
                           int8_impl="plain")
    dp = TN.device_params(tspec, tparams, "int8", "cpu",
                          int8_policy="cpu_old")
    theads, taux = fwd(dp, torch.from_numpy(x))
    assert [n for n, _ in tcalls] == [n for n, _ in jcalls]
    n_int8 = n_both = 0
    for (kind, j), (_, t) in zip(jcalls, tcalls):
        if kind == "conv2d_int8_old":
            assert t[0] is not None or t[1] is not None
            n_both += t[0] is not None and t[1] is not None
            for jo, to in zip(j, t):
                if to is not None:
                    np.testing.assert_array_equal(to.numpy(), _np(jo))
            n_int8 += 1
        elif kind in ("maxpool_int8_old", "reorg"):
            np.testing.assert_array_equal(t.numpy(), _np(j))
        else:   # float32 convs and the region head
            np.testing.assert_allclose(t.numpy(), _np(j), **FLOAT_TOL)
    int8_set = TN._int8_layer_set(tspec, "cpu_old")
    assert n_int8 == len(int8_set) > 0
    assert n_both == (1 if name == "both-stores" else 0)
    assert len(theads) == len(jheads) == 1
    np.testing.assert_allclose(theads[0].data.numpy(),
                               _np(jheads[0].data), **FLOAT_TOL)
    np.testing.assert_allclose(taux["final"].numpy(), _np(jaux["final"]),
                               **FLOAT_TOL)


def test_old_stores_on_yolov2_voc(tmp_path):
    """Under cpu_old 21 of yolov2-voc's 23 convs run int8 (not conv 0 and
    not the linear head conv 30): 20 store int8 only, conv 29 (read by the
    linear head conv) float32 only."""
    spec = parse_network_cfg(os.path.join(DATA, "yolov2-voc.cfg"), batch=1)
    int8_set = TN._int8_layer_set(spec, "cpu_old")
    assert len(spec.conv_layers()) == 23
    assert int8_set == {l.index for l in spec.conv_layers()} - {0, 30}
    stores = TN._old_stores(spec, int8_set)
    assert stores.pop(29) == torch.float32
    assert set(stores.values()) == {torch.int8} and len(stores) == 20
    both = parse_network_cfg(_cfg("both-stores", tmp_path), batch=1,
                             echo_table=False)
    assert TN._old_stores(both, TN._int8_layer_set(both, "cpu_old")) == {
        2: K.OLD_BOTH, 5: torch.float32}


def test_old_params_carry_output_multipler_and_biases_quant():
    """Each int8 conv of the old chain reaches the device with its int8
    weights, biases_quant (float32) and output_multipler (a float holding
    the float32 value); the float convs keep their float32 weights even when
    a bfloat16 compute dtype is asked for (the chain ignores it, as in
    JAX)."""
    spec, params, _ = build_params(MINI_CALIB, None, quantized=True, seed=2,
                                   echo=False)
    dp = TN.device_params(spec, params, "int8", "cpu", int8_policy="cpu_old",
                          compute_dtype=torch.bfloat16)
    for l in spec.conv_layers():
        p = dp[l.index]
        if l.index in TN._int8_layer_set(spec, "cpu_old"):
            assert "weights" not in p and "biases" not in p
            assert p["biases_quant"].dtype == torch.float32
            np.testing.assert_array_equal(p["biases_quant"].numpy(),
                                          params[l.index]["biases_quant"])
            assert p["output_multipler"] == float(
                params[l.index]["output_multipler"])
        else:
            assert p["weights"].dtype == torch.float32
            assert "weights_int8" not in p and "biases_quant" not in p
    # the other policies leave biases_quant on the host
    for policy in ("cpu", "gpu"):
        dp = TN.device_params(spec, params, "int8", "cpu",
                              int8_policy=policy)
        assert all("biases_quant" not in p for p in dp if p)


# ---------------------------------------------------------------------------
# the apps
# ---------------------------------------------------------------------------


def _run(main, capsys, args):
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("name,thresh", [("mini-calib", "0.1"),
                                         ("narrow-yolov2-voc", "0.05")])
def test_detector_test_cpu_old_streams_match_jax_cli(name, thresh, tmp_path,
                                                     capsys):
    cfg = _cfg(name, tmp_path)
    spec = parse_network_cfg(cfg, batch=1, echo_table=False)
    from yolo2_light_tpu.cfg import parse_network_cfg as jparse
    weights = str(tmp_path / "w.weights")
    save_weights(jparse(cfg, batch=1), random_params(jparse(cfg, batch=1),
                                                     seed=41), weights)
    names = tmp_path / "n.names"
    classes = spec.layers[-1].classes
    names.write_text("".join(f"c{i}\n" for i in range(classes)))
    args = ["detector", "test", str(names), cfg, weights, IMAGE, "-thresh",
            thresh, "-dont_show", "-quantized", "-int8_policy", "cpu_old"]
    rc_j, out_j, err_j = _run(jax_main, capsys,
                              args + ["-save", str(tmp_path / "jax")])
    rc_t, out_t, err_t = _run(torch_main, capsys,
                              args + ["-save", str(tmp_path / "torch"),
                                      "-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    boxes, _ = parse_detection_lines(out_t)
    assert len(boxes) >= 3           # the comparison covers real detections
    assert_streams_match(out_t, out_j, drop=("Predicted in",),
                         context=f"{name} stdout")
    assert_streams_match(err_t, err_j, context=f"{name} stderr")


@pytest.fixture(scope="module")
def calib_map_dataset(tmp_path_factory):
    """6 random PNGs with 1-3 random labels each (as tests/test_torch_map.py
    builds its dataset) and random mini-calib weights."""
    from PIL import Image

    from yolo2_light_tpu.cfg import parse_network_cfg as jparse
    root = tmp_path_factory.mktemp("oldmap")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        p = root / "images" / f"im{i}.png"
        Image.fromarray((rng.rand(96, 128, 3) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
        with open(root / "labels" / f"im{i}.txt", "w") as f:
            for _ in range(rng.randint(1, 4)):
                x, y = rng.uniform(0.2, 0.8, 2)
                w, h = rng.uniform(0.1, 0.4, 2)
                f.write(f"{rng.randint(0, 3)} {x:.6f} {y:.6f} {w:.6f} "
                        f"{h:.6f}\n")
    (root / "valid.txt").write_text("\n".join(paths) + "\n")
    (root / "mini.names").write_text("aaa\nbbb\nccc\n")
    data = root / "mini.data"
    data.write_text(f"classes=3\nvalid={root / 'valid.txt'}\n"
                    f"names={root / 'mini.names'}\n")
    weights = str(root / "w.weights")
    spec = jparse(MINI_CALIB, batch=1)
    save_weights(spec, random_params(spec, seed=11), weights)
    return {"data": str(data), "weights": weights}


@pytest.mark.parametrize("extra", [[], ["-device_nms"]],
                         ids=["host_nms", "device_nms"])
def test_map_cpu_old_report_matches_jax_cli(calib_map_dataset, capsys,
                                            extra):
    d = calib_map_dataset
    args = ["detector", "map", d["data"], MINI_CALIB, d["weights"], "-thresh",
            "0.24", "-batch", "3", "-k", "4096", "-quantized",
            "-int8_policy", "cpu_old"] + extra
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    block = _block(out_t)
    assert block and block == _block(out_j)
    assert int(block[0].split("detections_count = ")[1].split(",")[0]) > 100
    assert _progress(err_t) == _progress(err_j) == ["4", "8"]


def test_pipeline_cpu_old_matches_jax(tmp_path):
    """DetectionPipeline in cpu_old on uint8 source frames, host and device
    NMS, against the JAX pipeline: identical printed detections."""
    from tests.test_torch_pipeline import _frames
    from yolo2_light_tpu_torch.post import boxes as TB
    names = [f"c{i}" for i in range(20)]
    cfg = narrow_yolov2_voc(tmp_path)
    jspec, jparams, jmode = jax_build_params(cfg, None, quantized=True,
                                             seed=3, echo=False)
    spec, params, mode = build_params(cfg, None, quantized=True, seed=3,
                                      echo=False)
    x = _frames(1, 3)
    for device_nms in (False, True):
        args = dict(thresh=0.05, nms=0.45, k=256, int8_policy="cpu_old",
                    device_nms=device_nms)
        jp = JaxPipeline(jspec, jparams, jmode, **args)
        tp = DetectionPipeline(spec, params, mode, device="cpu", **args)
        ours, theirs = tp(x), jp(x)
        assert len(ours) == len(theirs) == 3
        n = 0
        for a, b in zip(ours, theirs):
            la = TB.format_detections(a, names, 0.05, 128, 96)
            assert la == TB.format_detections(b, names, 0.05, 128, 96)
            n += len(la.splitlines())
        assert n > 0                # the comparison covers real detections
