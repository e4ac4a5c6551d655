"""The port's serving pipeline against the JAX package's, on the CPU: the
on-device resize and YUV ingest, decode + top-k compaction, exact greedy NMS
(the rank walk's plain twin) and ``DetectionPipeline`` end to end — host
and device NMS, b=1 and b=3, uint8 source-size and YUV ingest, ``stream``,
``serve_scan`` and auto-grow — in fp32, ``-quantized`` (``xla`` and
``fused``) and on an XNOR net.

The JAX side runs as its own tests run it (jitted on the CPU). Its jitted
decode divides by the grid and net sizes as multiplications by their
reciprocals and takes XLA's exp, where the port divides (ROADMAP F9) and
takes PyTorch's: decoded values may differ by an ULP or two (F7), the
selected rows and their order may not. Detections are compared as the
printed detection lines; a difference that is only F7 noise is classified by
``tests/fuzz_cfgs._ulp_class_only`` and never absorbed by a tolerance.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo2_light_tpu import cfg as JC
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.io.image import resize_image
from yolo2_light_tpu.ops.resize import device_resize_image as jax_resize
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu.pipeline import yuv420_to_rgb as jax_yuv
from yolo2_light_tpu.post import device_decode as JDD
from yolo2_light_tpu.post import device_nms as JDN
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.ops import nms_walk as NW
from yolo2_light_tpu_torch.ops.resize import device_resize_image
from yolo2_light_tpu_torch.pipeline import DetectionPipeline, yuv420_to_rgb
from yolo2_light_tpu_torch.post import boxes as TB
from yolo2_light_tpu_torch.post import device_decode as TDD
from yolo2_light_tpu_torch.post import device_nms as TDN

TESTS = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(TESTS, "data")
NAMES = ["aaa", "bbb", "ccc"]


# ---------------------------------------------------------------------------
# resize and YUV ingest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (416, 416)),   # camera downsize (the demo's shape)
    ((96, 128), (416, 416)),    # upsize
    ((416, 416), (96, 160)),    # anisotropic downsize
    ((33, 47), (32, 32)),       # off-by-one fractional scales
    ((7, 5), (13, 13)),         # tiny
    ((1, 9), (8, 8)),           # degenerate in_h == 1 (no second tap ever)
    ((9, 1), (8, 8)),           # degenerate in_w == 1 (edge copy every col)
])
def test_device_resize_matches_jax(src, dst):
    """At most 1 ULP from the JAX version (its XLA CPU backend contracts the
    lerp into an FMA), and within tests/test_device_resize.py's bound (one
    ULP at 1.0, the pixel domain's top) of the host resize, whose native
    build contracts it too."""
    im = np.random.RandomState(7).rand(2, *src, 3).astype(np.float32)
    ours = device_resize_image(torch.from_numpy(im), dst[1], dst[0]).numpy()
    theirs = np.asarray(jax_resize(jnp.asarray(im), dst[1], dst[0]))
    assert ours.shape == theirs.shape == (2, dst[0], dst[1], 3)
    np.testing.assert_array_max_ulp(ours, theirs, maxulp=1)
    host = resize_image(im[1], dst[1], dst[0])
    np.testing.assert_allclose(ours[1], host, rtol=0, atol=1.3e-7)


def test_device_resize_endpoint_rules():
    """Darknet endpoint rule: corners copy through exactly; identity dims
    return the input untouched."""
    im = np.random.RandomState(8).rand(1, 10, 12, 3).astype(np.float32)
    up = device_resize_image(torch.from_numpy(im), 24, 20).numpy()[0]
    for r, c in ((0, 0), (-1, -1), (0, -1), (-1, 0)):
        np.testing.assert_array_equal(up[r, c], im[0, r, c])
    x = torch.from_numpy(im)
    assert device_resize_image(x, 12, 10) is x


def test_yuv420_to_rgb_matches_jax():
    yuv = np.random.RandomState(0).randint(0, 256, (2, 96, 80),
                                           dtype=np.uint8)
    ours = yuv420_to_rgb(torch.from_numpy(yuv)).numpy()
    theirs = np.asarray(jax_yuv(jnp.asarray(yuv)))
    assert ours.shape == (2, 64, 80, 3)
    np.testing.assert_array_max_ulp(ours, theirs, maxulp=1)


# ---------------------------------------------------------------------------
# decode + compaction
# ---------------------------------------------------------------------------

TREE_TEXT = "animal -1\nvehicle -1\ncat 0\ndog 0\ncar 1\ntruck 1\nbus 1\n"

REGION_CFG = """[net]
width=64
height=64
channels=3
[convolutional]
filters={filters}
size=1
stride=1
pad=0
activation=linear
[region]
anchors = 1.08,1.19,  3.42,4.41,  6.63,11.38
classes={classes}
coords=4
num=3
softmax=1
{extra}
"""


def _head_specs(cfg_path):
    """Both packages' head specs of one cfg (each decode dispatches on its
    own spec classes)."""
    out = []
    for mod in (JC, TC):
        spec = mod.parse_network_cfg(cfg_path, batch=1, echo_table=False)
        out.append([l for l in spec.layers
                    if isinstance(l, (mod.YoloSpec, mod.RegionSpec))])
    return out


def _yolo_heads(rng, specs, b, ties):
    """Post-activation yolo head maps: sigmoid-range x, y, obj and classes,
    raw w, h; with ``ties``, obj and class scores on a coarse grid, so the
    top-k boundary falls inside runs of equal scores."""
    heads = []
    for l in specs:
        h = rng.rand(b, l.out_h, l.out_w, l.n, 5 + l.classes).astype(
            np.float32)
        h[..., 2:4] = rng.randn(b, l.out_h, l.out_w, l.n, 2)
        if ties:
            h[..., 4:] = np.round(h[..., 4:] * 4) / 4
        heads.append(h)
    return heads


def _region_heads(rng, specs, b):
    heads = []
    for l in specs:
        h = rng.rand(b, l.out_h, l.out_w, l.n,
                     l.coords + 1 + l.classes).astype(np.float32)
        h[..., :4] = rng.randn(b, l.out_h, l.out_w, l.n, 4)
        heads.append(h)
    return heads


def _decode_cases(tmp_path):
    tree = tmp_path / "mini.tree"
    tree.write_text(TREE_TEXT)
    cmap = tmp_path / "t.map"
    cmap.write_text("\n".join(str(i) for i in (6, 2, 4, 3, 5)) + "\n")
    cases = {"yolo": os.path.join(DATA, "mini-yolo3.cfg"),
             "region": os.path.join(DATA, "mini-yolo2.cfg")}
    for name, classes, extra in (
            ("tree", 7, f"tree={tree}"),
            ("class_map", 7, f"tree={tree}\nmap={cmap}")):
        path = tmp_path / f"{name}.cfg"
        path.write_text(REGION_CFG.format(filters=3 * (5 + classes),
                                          classes=classes, extra=extra))
        cases[name] = str(path)
    return cases


@pytest.mark.parametrize("case", ["yolo", "yolo_ties", "region", "tree",
                                  "class_map"])
@pytest.mark.parametrize("k", [64, 100000], ids=["k_below_n", "k_above_n"])
@pytest.mark.parametrize("decode_order", [False, True])
def test_decode_and_compact_matches_jax(tmp_path, case, k, decode_order):
    path = _decode_cases(tmp_path)[case.replace("_ties", "")]
    jspecs, tspecs = _head_specs(path)
    rng = np.random.RandomState(len(case) + k % 7)
    if case.startswith("yolo"):
        heads = _yolo_heads(rng, tspecs, 2, ties=case.endswith("ties"))
    else:
        heads = _region_heads(rng, tspecs, 2)
    thresh = 0.3
    jb, jo, jp, jv = (np.asarray(a) for a in JDD.decode_and_compact(
        [jnp.asarray(h) for h in heads], jspecs, 64, 64, thresh, k,
        decode_order=decode_order))
    tb, to, tp, tv = (a.numpy() for a in TDD.decode_and_compact(
        [torch.from_numpy(h) for h in heads], tspecs, 64, 64, thresh, k,
        decode_order=decode_order))
    np.testing.assert_array_equal(tv, jv)
    assert int(tv.min()) > 0
    # the same rows in the same order: probs and objectness are products
    # of the same inputs (exact), the boxes carry exp and divisions
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_max_ulp(tb, jb, maxulp=2)
    if case == "yolo_ties" and k == 64:
        # the boundary falls inside a run of equal scores: more candidates
        # share the last selected score than were selected
        every = TDD.decode_and_compact(
            [torch.from_numpy(h) for h in heads], tspecs, 64, 64, thresh,
            100000)[2].numpy().max(-1)
        last = tp.max(-1).min(-1)
        for i in range(2):
            assert ((every[i] == last[i]).sum()
                    > (tp[i].max(-1) == last[i]).sum())
    packed = TDD.decode_and_compact_packed(
        [torch.from_numpy(h) for h in heads], tspecs, 64, 64, thresh, k,
        decode_order=decode_order).numpy()
    jpacked = np.asarray(JDD.decode_and_compact_packed(
        [jnp.asarray(h) for h in heads], jspecs, 64, 64, thresh, k,
        decode_order=decode_order))
    np.testing.assert_array_equal(packed[..., 4:], jpacked[..., 4:])
    np.testing.assert_array_max_ulp(packed[..., :4], jpacked[..., :4],
                                    maxulp=2)


def test_compact_to_detections_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.rand(40, 4).astype(np.float32)
    obj = rng.rand(40).astype(np.float32)
    probs = np.where(rng.rand(40, 3) > 0.5, rng.rand(40, 3), 0).astype(
        np.float32)
    a = TDD.compact_to_detections(torch.from_numpy(boxes),
                                  torch.from_numpy(obj),
                                  torch.from_numpy(probs), None, 128, 96, 64,
                                  64)
    b = JDD.compact_to_detections(boxes, obj, probs, None, 128, 96, 64, 64)
    for f in ("bbox", "objectness", "prob"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# exact greedy NMS (the walk's plain twin)
# ---------------------------------------------------------------------------


def _candidates(rng, k, classes, cluster=True):
    """Overlapping clusters of boxes, sparse thresholded probs, trailing
    all-zero padding rows (built as tests/test_device_nms.py builds them)."""
    boxes = rng.rand(k, 4).astype(np.float32)
    boxes[:, 2:] = 0.05 + 0.3 * boxes[:, 2:]
    if cluster:
        centers = rng.rand(max(1, k // 8), 2)
        which = rng.randint(0, centers.shape[0], k)
        boxes[:, :2] = centers[which] + 0.02 * rng.randn(k, 2)
    probs = rng.rand(k, classes).astype(np.float32)
    probs[probs < 0.6] = 0.0
    n_pad = k // 5
    if n_pad:
        probs[-n_pad:] = 0.0
    return boxes, probs


@pytest.mark.parametrize("k,classes,ties", [(64, 3, False), (128, 20, False),
                                            (37, 1, False), (256, 7, False),
                                            (160, 6, True), (96, 4, True)])
def test_nms_probs_with_order_matches_jax(k, classes, ties):
    boxes, probs = _candidates(np.random.RandomState(k + classes), k, classes)
    if ties:
        probs = (np.round(probs * 8) / 8).astype(np.float32)
    jp, jperm = (np.asarray(a) for a in JDN.nms_probs_with_order(
        jnp.asarray(boxes), jnp.asarray(probs), 0.45))
    tp, tperm = TDN.nms_probs_with_order(torch.from_numpy(boxes),
                                         torch.from_numpy(probs), 0.45)
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(tperm.numpy(), jperm)
    assert (tp.numpy()[probs > 0] == 0).any()       # it did suppress
    np.testing.assert_array_equal(
        TDN.nms_probs(torch.from_numpy(boxes), torch.from_numpy(probs),
                      0.45).numpy(), jp)


def test_suppressed_box_does_not_suppress():
    """B overlaps A (suppressed) and C overlaps B but not A => C survives."""
    boxes = torch.tensor([[0.30, 0.5, 0.20, 0.2], [0.36, 0.5, 0.20, 0.2],
                          [0.42, 0.5, 0.20, 0.2]])
    probs = torch.tensor([[0.9], [0.8], [0.7]])
    out = TDN.nms_probs(boxes, probs, 0.45)
    assert out[:, 0].tolist() == pytest.approx([0.9, 0.0, 0.7])


@pytest.mark.parametrize("reorder", [True, False])
def test_nms_packed_matches_jax_on_exact_prob_ties(reorder):
    rng = np.random.RandomState(123)
    packed = []
    for _ in range(3):
        boxes, probs = _candidates(rng, 160, 6)
        probs = (np.round(probs * 8) / 8).astype(np.float32)
        packed.append(np.concatenate(
            [boxes, np.ones((160, 1), np.float32), probs], axis=1))
    packed = np.stack(packed)
    ours = TDN.nms_packed(torch.from_numpy(packed), 0.45, reorder).numpy()
    theirs = np.asarray(JDN.nms_packed(jnp.asarray(packed), 0.45, reorder))
    np.testing.assert_array_equal(ours, theirs)


def test_walk_stops_at_the_first_rank_without_work():
    """The walk's stop rank is per image, as the vmapped while_loop's."""
    rng = np.random.RandomState(4)
    boxes = torch.from_numpy(np.stack([_candidates(rng, 48, 3)[0]
                                       for _ in range(2)]))
    probs = torch.from_numpy(np.stack([_candidates(rng, 48, 3)[1]
                                       for _ in range(2)]))
    over, order, rhw, _ = TDN.walk_inputs(boxes, probs, 0.45)
    cut = rhw.clone()
    cut[0, 5:] = 0.0
    out = NW.nms_walk(over, order, cut, probs)
    full = NW.nms_walk(over, order, rhw, probs)
    np.testing.assert_array_equal(out[1].numpy(), full[1].numpy())
    assert not torch.equal(out[0], full[0])


def test_pack_rows_round_trip():
    over = torch.from_numpy(np.random.RandomState(0).rand(2, 45, 45) > 0.5)
    bits = NW.pack_rows(over)
    assert bits.shape == (2, 45, 2) and bits.dtype == torch.int32
    assert torch.equal(NW.unpack_rows(bits, 45), over)
    assert int(NW.unpack_rows(bits, 64)[..., 45:].sum()) == 0


# ---------------------------------------------------------------------------
# DetectionPipeline end to end
# ---------------------------------------------------------------------------

MODES = {
    "fp32": ("mini-yolo3.cfg", False, {}),
    "int8": ("mini-yolo3.cfg", True, {"int8_impl": "xla"}),
    "int8_fused": ("mini-res.cfg", True, {"int8_impl": "fused"}),
    "xnor_pallas_mxu": ("mini-xnor-32", False, {"xnor_impl": "pallas_mxu"}),
}


def _cfg_path(name, tmp_path):
    if name != "mini-xnor-32":
        return os.path.join(DATA, name)
    # the JAX package runs its XNOR kernel in interpret mode on the CPU: a
    # 32x32 net keeps that quick (tests/test_serve_scan.py does the same)
    text = open(os.path.join(DATA, "mini-xnor.cfg")).read().replace(
        "width=64", "width=32").replace("height=64", "height=32")
    path = tmp_path / "mini-xnor-32.cfg"
    path.write_text(text)
    return str(path)


def _pair(mode, tmp_path, seed=3, k=256, **kw):
    """(spec, JAX pipeline, port pipeline) with the same params."""
    name, quantized, impl = MODES[mode]
    cfg = _cfg_path(name, tmp_path)
    jspec, jparams, jmode = jax_build_params(cfg, None, quantized=quantized,
                                             seed=seed, echo=False)
    spec, params, tmode = build_params(cfg, None, quantized=quantized,
                                       seed=seed, echo=False)
    args = dict(thresh=0.3, nms=0.4, k=k, **impl, **kw)
    return (spec, JaxPipeline(jspec, jparams, jmode, **args),
            DetectionPipeline(spec, params, tmode, device="cpu", **args))


def _lines(dets, w, h, thresh=0.3):
    return TB.format_detections(dets, NAMES, thresh, w, h).splitlines()


def _assert_same_detections(ours, theirs, w, h, thresh=0.3):
    """Identical printed detections per image, or a difference that is F7
    noise only (``_ulp_class_only``, never a wider tolerance)."""
    sys.path.insert(0, TESTS)
    from fuzz_cfgs import _ulp_class_only
    assert len(ours) == len(theirs)
    n = 0
    for a, b in zip(ours, theirs):
        la, lb = _lines(a, w, h, thresh), _lines(b, w, h, thresh)
        n += len(la)
        if la != lb:
            assert _ulp_class_only(lb, la), (lb, la)
    assert n > 0                    # the comparison covers real detections


def _frames(seed, b, h=96, w=128):
    return (np.random.RandomState(seed).rand(b, h, w, 3) * 255).astype(
        np.uint8)


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_matches_jax_uint8_source_frames(tmp_path, mode, device_nms):
    """b=3 uint8 frames at their source size (resized on the device),
    coordinates corrected to the source dims."""
    spec, jp, tp = _pair(mode, tmp_path, device_nms=device_nms)
    x = _frames(1, 3)
    _assert_same_detections(tp(x), jp(x), 128, 96)


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
def test_pipeline_matches_jax_b1_float_net_size(tmp_path, device_nms):
    spec, jp, tp = _pair("int8", tmp_path, device_nms=device_nms)
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    _assert_same_detections(tp(x), jp(x), 64, 64)
    letter = [(199, 83)]
    _assert_same_detections(tp(x, im_sizes=letter), jp(x, im_sizes=letter),
                            199, 83)


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
def test_pipeline_matches_jax_yuv_ingest(tmp_path, device_nms):
    spec, jp, tp = _pair("fp32", tmp_path, device_nms=device_nms)
    yuv = np.random.RandomState(4).randint(0, 256, (3, 96 * 3 // 2, 128),
                                           dtype=np.uint8)
    _assert_same_detections(tp(yuv), jp(yuv), 128, 96)


def test_pipeline_stream_depth_2_matches_jax_and_calls(tmp_path):
    spec, jp, tp = _pair("int8", tmp_path)
    batches = [_frames(s, 2) for s in (5, 6, 7)]
    streamed = list(tp.stream(iter(batches), depth=2))
    jstreamed = list(jp.stream(iter(batches), depth=2))
    assert len(streamed) == 3
    for xb, ours, theirs in zip(batches, streamed, jstreamed):
        # stream() corrects to the net dims unless given sizes
        _assert_same_detections(ours, theirs, 64, 64)
        for a, b in zip(ours, tp(xb, im_sizes=[(64, 64)] * 2)):
            np.testing.assert_array_equal(a.bbox, b.bbox)
            np.testing.assert_array_equal(a.prob, b.prob)


@pytest.mark.parametrize("mode", ["fp32", "int8", "xnor_pallas_mxu"])
def test_serve_scan_matches_per_frame_calls_and_jax(tmp_path, mode):
    spec, jp, tp = _pair(mode, tmp_path, device_nms=(mode == "int8"))
    frames = _frames(8, 4, 80, 96)
    scanned = tp.serve_scan(frames.copy())
    assert len(scanned) == 4
    for i, d in enumerate(scanned):
        one = tp(frames[i:i + 1])[0]
        np.testing.assert_array_equal(d.bbox, one.bbox)
        np.testing.assert_array_equal(d.prob, one.prob)
        np.testing.assert_array_equal(d.objectness, one.objectness)
    _assert_same_detections(scanned, jp.serve_scan(frames.copy()), 96, 80)


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
def test_autogrow_from_small_k_matches_jax(tmp_path, capsys, device_nms):
    """A K=16 buffer saturates and grows with the JAX pipeline's stderr
    notes, and converges to its detections; the grown pipeline shares the
    converted params."""
    spec, jp, tp = _pair("int8", tmp_path, seed=2, k=16,
                         device_nms=device_nms)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    capsys.readouterr()
    theirs = jp(x)
    jerr = capsys.readouterr().err
    ours = tp(x)
    terr = capsys.readouterr().err
    assert "note: candidate buffer K=16 saturated" in terr
    assert terr == jerr
    assert tp._promoted is not None and tp._promoted.params is tp.params
    _assert_same_detections(ours, theirs, 64, 64)


def test_pipeline_refuses_what_is_not_ported(tmp_path):
    """The pipeline takes a mesh and pipeline stages (their parity with
    JAX: tests/test_torch_parallel.py, tests/test_torch_pp.py); as in the
    JAX package it refuses both together, and ``serve_scan`` under either,
    with JAX's messages."""
    from yolo2_light_tpu.parallel.mesh import make_mesh as jax_mesh
    from yolo2_light_tpu_torch.parallel.mesh import make_mesh
    cfg = os.path.join(DATA, "mini-yolo3.cfg")
    spec, params, mode = build_params(cfg, None, echo=False)
    jspec, jparams, _ = jax_build_params(cfg, None, echo=False)
    mesh = make_mesh(2, data=2, device="cpu")
    for cls, sp, p, m, kw in (
            (JaxPipeline, jspec, jparams, jax_mesh(2, data=2), {}),
            (DetectionPipeline, spec, params, mesh, {"device": "cpu"})):
        with pytest.raises(ValueError, match="pp_stages and mesh are "
                           "mutually exclusive"):
            cls(sp, p, mode, mesh=m, pp_stages=2, **kw)
        for par in ({"mesh": m}, {"pp_stages": 2},
                    {"pp_stages": 2, "pp_tp": 2}):
            pipe = cls(sp, p, mode, **par, **kw)
            with pytest.raises(ValueError, match="serve_scan is the "
                               "single-device serving loop"):
                pipe.serve_scan(np.zeros((2, 64, 64, 3), np.uint8))
    pipe = DetectionPipeline(spec, params, mode, device="cpu", pp_stages=2,
                             pp_tp=2)
    assert pipe._pp.tp == 2 and not pipe._cuda_graph
