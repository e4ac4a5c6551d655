"""The port's copies of the JAX package's NumPy host chain (cfg, tree, datacfg,
weights, quant, native, io/image, post/boxes) against the modules they
mirror: the same inputs give equal results, bit for bit.

The port carries these copies so that it imports nothing of the JAX package;
each side parses its own spec, since the modules dispatch on their own spec
classes. Nothing here needs a card.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest

from yolo2_light_tpu import cfg as JC
from yolo2_light_tpu import datacfg as JD
from yolo2_light_tpu import native as JNat
from yolo2_light_tpu import quant as JQ
from yolo2_light_tpu import tree as JT
from yolo2_light_tpu import weights as JW
from yolo2_light_tpu.eval import map as JM
from yolo2_light_tpu.io import image as JI
from yolo2_light_tpu.post import boxes as JB
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch import datacfg as TD
from yolo2_light_tpu_torch import native as TNat
from yolo2_light_tpu_torch import quant as TQ
from yolo2_light_tpu_torch import tree as TT
from yolo2_light_tpu_torch import weights as TW
from yolo2_light_tpu_torch.eval import map as TM
from yolo2_light_tpu_torch.io import image as TI
from yolo2_light_tpu_torch.post import boxes as TB

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
# cfgs of what the port adds to the JAX package's parser (yolov4's mish and
# [yolo] options), which the JAX package parses otherwise
PORT_ONLY_CFGS = {"mini-yolov4.cfg"}
CFGS = sorted(p for p in glob.glob(os.path.join(DATA, "*.cfg"))
              if os.path.basename(p) not in PORT_ONLY_CFGS)
# fields the port's specs add, at the value that keeps the JAX package's
# behaviour: a spec holding that value equals the JAX spec without the field
PORT_ONLY_FIELDS = {"scale_x_y": 1.0}
IMAGE = os.path.join(DATA, "dog160.png")
NET_CFGS = ["mini-yolo3", "mini-yolo2", "mini-res", "mini-xnor"]


def _port_asdict(spec) -> dict:
    """``dataclasses.asdict`` of a port spec without :data:`PORT_ONLY_FIELDS`
    where they hold the JAX package's behaviour (their value there)."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items()
                    if PORT_ONLY_FIELDS.get(k, object()) != x}
        if isinstance(v, (list, tuple)):
            return type(v)(strip(x) for x in v)
        return v
    return strip(dataclasses.asdict(spec))


def _assert_same(a, b, where="value"):
    """Deep equality of nested dicts/lists/tuples/arrays (arrays: equal
    dtype, shape and bits)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _specs(name):
    path = os.path.join(DATA, f"{name}.cfg")
    return JC.parse_network_cfg(path, batch=1), TC.parse_network_cfg(
        path, batch=1)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_every_cfg_parses_to_the_same_spec(path, quantized):
    j = JC.parse_network_cfg(path, batch=1, quantized=quantized)
    t = TC.parse_network_cfg(path, batch=1, quantized=quantized)
    assert [type(l).__name__ for l in t.layers] == [
        type(l).__name__ for l in j.layers]
    _assert_same(_port_asdict(t), dataclasses.asdict(j))


def test_yolov2_voc_cfg_parses_as_jax_and_regenerates(tmp_path):
    """tests/data/yolov2-voc.cfg (scripts/gen_yolov2_voc_cfg.py): the port's
    parse equals the JAX parse layer for layer, in both modes; it is
    darknet's yolov2-voc-416 (23 convs, 5 maxpools, the passthrough route /
    reorg / route to 1280 channels at 13x13, a 20-class region head over 5
    anchors); and the script writes the file byte for byte."""
    import importlib.util
    path = os.path.join(DATA, "yolov2-voc.cfg")
    for quantized in (False, True):
        j = JC.parse_network_cfg(path, batch=1, quantized=quantized)
        t = TC.parse_network_cfg(path, batch=1, quantized=quantized)
        for lt, lj in zip(t.layers, j.layers, strict=True):
            assert type(lt).__name__ == type(lj).__name__
            _assert_same(dataclasses.asdict(lt), dataclasses.asdict(lj),
                         f"layer {lj.index}")
        _assert_same(dataclasses.asdict(t.net), dataclasses.asdict(j.net))
    kinds = [type(l).__name__ for l in t.layers]
    assert (t.net.w, t.net.h, t.net.c) == (416, 416, 3) and len(kinds) == 32
    assert kinds.count("ConvSpec") == 23 and kinds.count("MaxpoolSpec") == 5
    assert t.layers[25].layers == (16,) and t.layers[28].layers == (27, 24)
    assert (t.layers[28].out_c, t.layers[28].out_h) == (1280, 13)
    head = t.layers[30]
    assert (head.n, head.size, head.activation) == (125, 1, "linear")
    region = t.layers[31]
    assert (region.classes, region.n, region.softmax) == (20, 5, True)
    assert all(l.activation == "leaky" and l.batch_normalize
               for l in t.conv_layers()[:-1])
    gen = os.path.join(os.path.dirname(DATA), "..", "scripts",
                       "gen_yolov2_voc_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_yolov2_voc_cfg", gen)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "yolov2-voc.cfg"
    assert mod.main([str(out)]) == 0
    with open(path) as f:
        assert out.read_text() == f.read()


def test_tree_map_and_datacfg_match(tmp_path):
    tree = tmp_path / "t.tree"
    tree.write_text("root\nanimal 0\nplant 0\ncat 1\ndog 1\noak 2\n")
    _assert_same(dataclasses.asdict(TT.read_tree(str(tree))),
                 dataclasses.asdict(JT.read_tree(str(tree))))
    t, j = TT.read_tree(str(tree)), JT.read_tree(str(tree))
    assert TT.softmax_groups(t) == JT.softmax_groups(j)
    pred = np.random.RandomState(0).rand(3, t.n).astype(np.float32)
    _assert_same(TT.hierarchy_predictions(pred, t, True),
                 JT.hierarchy_predictions(pred, j, True))
    mp = tmp_path / "m.map"
    mp.write_text("3\n1\n0\n")
    assert TT.read_map(str(mp)) == JT.read_map(str(mp))
    names = tmp_path / "n.names"
    names.write_text("a\nb b\n\nc\n")
    data = tmp_path / "d.data"
    data.write_text(f"classes = 3\nnames = {names}\nvalid=v.txt\n# note\n")
    assert TD.read_data_cfg(str(data)) == JD.read_data_cfg(str(data))
    assert TD.load_names(str(names)) == JD.load_names(str(names))


@pytest.mark.parametrize("name", NET_CFGS)
def test_random_params_save_load_and_fuse_match(tmp_path, name):
    j_spec, t_spec = _specs(name)
    jp, tp = JW.random_params(j_spec, seed=5), TW.random_params(t_spec, seed=5)
    _assert_same(tp, jp)
    JW.save_weights(j_spec, jp, str(tmp_path / "j.weights"))
    TW.save_weights(t_spec, tp, str(tmp_path / "t.weights"))
    assert ((tmp_path / "t.weights").read_bytes()
            == (tmp_path / "j.weights").read_bytes())
    jl = JW.load_weights(j_spec, str(tmp_path / "j.weights"))
    tl = TW.load_weights(t_spec, str(tmp_path / "j.weights"))
    _assert_same(tl, jl)
    tf, jf = TW.fuse_conv_batchnorm(t_spec, tl), JW.fuse_conv_batchnorm(j_spec,
                                                                        jl)
    _assert_same(tf, jf)
    assert TW.is_fused(tf) and JW.is_fused(jf)


def test_dontload_layers_get_darknet_init_weights(tmp_path):
    """A ``dontload=1`` conv keeps darknet's construction-time weights, the
    glibc rand() stream of utils/crand, on both sides."""
    from yolo2_light_tpu.utils import crand as jcrand
    from yolo2_light_tpu_torch.utils import crand as tcrand
    j_spec, t_spec = _specs("mini-dontload")
    assert any(getattr(l, "dontload", False) for l in t_spec.layers)
    _assert_same(tcrand.darknet_conv_init(t_spec),
                 jcrand.darknet_conv_init(j_spec))
    path = str(tmp_path / "d.weights")
    JW.save_weights(j_spec, JW.random_params(j_spec, seed=2), path)
    _assert_same(TW.load_weights(t_spec, path), JW.load_weights(j_spec, path))


@pytest.mark.parametrize("name", NET_CFGS)
def test_quantize_params_match(name):
    j_spec, t_spec = _specs(name)
    fused = JW.fuse_conv_batchnorm(j_spec, JW.random_params(j_spec, seed=9))
    tq, jq = TQ.quantize_params(t_spec, fused), JQ.quantize_params(j_spec,
                                                                   fused)
    _assert_same(tq, jq)
    assert any(p is not None and "weights_int8" in p for p in tq)
    assert TQ.R_MULT == JQ.R_MULT


def test_quant_helpers_match():
    arr = np.random.RandomState(2).randn(5000).astype(np.float32) * 3
    assert TQ.get_multiplier(arr) == JQ.get_multiplier(arr)
    _assert_same(TQ.get_distribution(arr), JQ.get_distribution(arr))
    _assert_same(TQ._max_abs_trunc(arr * 40, 127),
                 JQ._max_abs_trunc(arr * 40, 127))
    assert TQ.entropy_calibration(arr) == JQ.entropy_calibration(arr)


def test_image_load_resize_letterbox_byte_identical():
    j, t = JI.load_image(IMAGE), TI.load_image(IMAGE)
    assert t.tobytes() == j.tobytes() and t.shape == j.shape
    for w, h in ((64, 64), (97, 41), (416, 416)):
        assert (TI.resize_image(t, w, h).tobytes()
                == JI.resize_image(j, w, h).tobytes())
        assert (TI.letterbox_image(t, w, h).tobytes()
                == JI.letterbox_image(j, w, h).tobytes())
    assert TI.to_batch(t).tobytes() == JI.to_batch(j).tobytes()


def _random_heads(spec, seed):
    """Random post-activation head maps of ``spec``'s heads, [H,W,n,entries],
    with a tenth of the objectness set to 0 (the NMS compaction path)."""
    rng = np.random.RandomState(seed)
    heads = []
    for l in spec.layers:
        if isinstance(l, (JC.YoloSpec, JC.RegionSpec)):
            entries = (5 + l.classes if isinstance(l, JC.YoloSpec)
                       else l.coords + 1 + l.classes)
            n = len(l.mask) if isinstance(l, JC.YoloSpec) else l.n
            hd = rng.rand(l.h, l.w, n, entries).astype(np.float32)
            obj = 4 if isinstance(l, JC.YoloSpec) else l.coords
            hd[..., obj][rng.rand(l.h, l.w, n) < 0.1] = 0.0
            heads.append(hd)
    return heads


@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_nms_and_print_lines_match(name, seed):
    j_spec, t_spec = _specs(name)
    heads = _random_heads(j_spec, seed)
    names = [f"c{i}" for i in range(80)]
    j_specs = [l for l in j_spec.layers
               if isinstance(l, (JC.YoloSpec, JC.RegionSpec))]
    t_specs = [l for l in t_spec.layers
               if isinstance(l, (TC.YoloSpec, TC.RegionSpec))]
    net = (j_spec.net.w, j_spec.net.h)
    jd = JB.get_network_boxes([h.copy() for h in heads], j_specs, 160, 120,
                              *net, 0.2)
    td = TB.get_network_boxes([h.copy() for h in heads], t_specs, 160, 120,
                              *net, 0.2)
    _assert_same(dataclasses.asdict(td), dataclasses.asdict(jd))
    jd, td = JB.do_nms_sort(jd, jd.prob.shape[1], 0.45), TB.do_nms_sort(
        td, td.prob.shape[1], 0.45)
    _assert_same(td.nms_order, jd.nms_order)
    _assert_same(td.prob, jd.prob)
    tl = TB.format_detections(td, names, 0.2, 160, 120)
    jl = JB.format_detections(jd, names, 0.2, 160, 120)
    assert tl == jl and tl.count("\n") >= 5


@pytest.mark.parametrize("iou_thresh", [0.5, 0.25])
def test_map_accounting_and_report_match(tmp_path, iou_thresh):
    """eval/map: the accumulator, the rank sweep, the report (NaN spelling
    included) and the label-file helpers, on random post-NMS detections with
    exact-prob ties and difficult boxes."""
    rng = np.random.RandomState(int(iou_thresh * 100))
    accs = [M.MapAccumulator(classes=4, iou_thresh=iou_thresh,
                             thresh_calc_avg_iou=0.25) for M in (JM, TM)]
    for i in range(5):
        n = rng.randint(0, 30)
        bbox = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)),
                               rng.uniform(0.05, 0.4, (n, 2))],
                              1).astype(np.float32)
        prob = np.where(rng.rand(n, 4) < 0.6, 0.0,
                        np.round(rng.rand(n, 4) * 8) / 8).astype(np.float32)
        truth = np.concatenate([rng.randint(0, 4, (3, 1)),
                                rng.uniform(0.2, 0.8, (3, 2)),
                                rng.uniform(0.05, 0.4, (3, 2))],
                               1).astype(np.float32)
        dif = truth[:1] + np.float32(0.01) if i % 2 else None
        for acc, B in zip(accs, (JB, TB)):
            dets = B.Detections(bbox.copy(), np.ones(n, np.float32),
                                prob.copy())
            B.do_nms_sort(dets, 4, 0.45)
            acc.add_image(dets, truth, dif)
    jr, tr = accs[0].compute(), accs[1].compute()
    assert tr.keys() == jr.keys()
    for k in tr:
        # NaN metrics (0/0, printed as -nan) compare by their bits
        _assert_same(np.asarray(tr[k]).view(np.uint64)
                     if isinstance(tr[k], float) else tr[k],
                     np.asarray(jr[k]).view(np.uint64)
                     if isinstance(jr[k], float) else jr[k], k)
    names = ["a", "b", "c", "d"]
    assert (TM.format_map_report(tr, names, iou_thresh, 0.25)
            == JM.format_map_report(jr, names, iou_thresh, 0.25))
    empty = [M.MapAccumulator(classes=2).compute() for M in (JM, TM)]
    assert (TM.format_map_report(empty[1], names, 0.5, 0.25)
            == JM.format_map_report(empty[0], names, 0.5, 0.25))
    label = tmp_path / "labels" / "x.txt"
    label.parent.mkdir()
    label.write_text("1 0.5 0.5 0.2 0.2\n2 0.1 0.2 0.3 0.4\nbad\n")
    _assert_same(TM.read_truth_boxes(str(label)),
                 JM.read_truth_boxes(str(label)))
    _assert_same(TM.read_truth_boxes("/nope.txt"),
                 JM.read_truth_boxes("/nope.txt"))
    for p in ("/d/images/a.jpg", "/d/JPEGImages/b.png", "/x/c.JPEG"):
        assert TM.label_path_for(p) == JM.label_path_for(p)


def test_native_nms_and_resize_match():
    assert TNat.get_lib() is not None and JNat.get_lib() is not None
    rng = np.random.RandomState(4)
    n, classes = 300, 7
    bbox = rng.rand(n, 4).astype(np.float32)
    bbox[:, 2:] *= 0.3
    obj = rng.rand(n).astype(np.float32)
    obj[rng.rand(n) < 0.2] = 0.0
    prob = np.where(rng.rand(n, classes) < 0.5, 0.0,
                    rng.rand(n, classes)).astype(np.float32)
    jp, tp = prob.copy(), prob.copy()
    jo = JNat.nms_sort_native(bbox, jp, obj, 0.45)
    to = TNat.nms_sort_native(bbox, tp, obj, 0.45)
    _assert_same(to, jo)
    _assert_same(tp, jp)
    assert not np.array_equal(tp, prob)       # the NMS suppressed something
    im = rng.rand(37, 53, 3).astype(np.float32)
    for w, h in ((16, 16), (80, 20), (53, 37)):
        _assert_same(TNat.resize_hwc_native(im, w, h),
                     JNat.resize_hwc_native(im, w, h))


def test_native_library_builds_inside_the_checkout():
    lib = TNat.get_lib()
    assert lib is not None
    build = os.path.join(os.path.dirname(DATA), os.pardir, "build", "native")
    assert glob.glob(os.path.join(os.path.abspath(build),
                                  "libyolo2native-*.so"))


# ---------------------------------------------------------------------------
# post/boxes_legacy.py, utils/distribution.py, utils/voc_label.py: the
# JAX package's own tests of these modules, run on the port's copies, and
# the copies against the originals on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dintersect", "dunion"])
def test_boxes_legacy_gradient_tests_run_on_the_copy(name):
    from tests import test_boxes_legacy as T
    from yolo2_light_tpu_torch.post import boxes_legacy as TBL
    T.test_gradients_match_finite_differences(
        getattr(TBL, name), {"dintersect": T._inter, "dunion": T._union}[name])


@pytest.mark.parametrize("test", [
    "test_diou_analytic_matches_finite_differences",
    "test_diou_is_unconditionally_the_delta_branch",
    "test_derivative_disjoint_is_pure_approach", "test_box_rmse",
    "test_encode_decode_roundtrip"])
def test_boxes_legacy_tests_run_on_the_copy(monkeypatch, test):
    from tests import test_boxes_legacy as T
    from yolo2_light_tpu_torch.post import boxes_legacy as TBL
    monkeypatch.setattr(T, "BL", TBL)
    getattr(T, test)()


def test_boxes_legacy_copy_matches_jax():
    from yolo2_light_tpu.post import boxes_legacy as JBL
    from yolo2_light_tpu_torch.post import boxes_legacy as TBL
    rng = np.random.RandomState(4)
    a = (rng.rand(50, 4) + 0.1).astype(np.float32)
    b = (a + rng.randn(50, 4) * 0.3).astype(np.float32)
    for fn in ("derivative", "dintersect", "dunion", "diou",
               "diou_analytic"):
        for x, y in zip(a, b):
            _assert_same(getattr(TBL, fn)(x, y), getattr(JBL, fn)(x, y), fn)
    for fn in ("box_rmse", "encode_box", "decode_box"):
        _assert_same(getattr(TBL, fn)(a, np.abs(b) + 0.1),
                     getattr(JBL, fn)(a, np.abs(b) + 0.1), fn)


@pytest.mark.parametrize("test", [
    "test_draw_distribution", "test_draw_distribution_show_headless_noop",
    "test_draw_distribution_geometry", "test_voc_label_converter"])
def test_utils_tools_tests_run_on_the_copies(monkeypatch, tmp_path, test):
    """tests/test_utils_tools.py with the JAX modules it imports replaced by
    the port's copies (and the port's quant)."""
    import sys

    from tests import test_utils_tools as T
    from yolo2_light_tpu_torch import quant as TQ
    from yolo2_light_tpu_torch.utils import distribution as TDist
    from yolo2_light_tpu_torch.utils import voc_label as TVoc
    for name, mod in (("yolo2_light_tpu.utils.distribution", TDist),
                      ("yolo2_light_tpu.utils.voc_label", TVoc),
                      ("yolo2_light_tpu.quant", TQ)):
        monkeypatch.setitem(sys.modules, name, mod)
    fn = getattr(T, test)
    if test == "test_draw_distribution_show_headless_noop":
        fn(tmp_path, monkeypatch)
    else:
        fn(tmp_path)


def test_distribution_and_voc_label_copies_match_jax(tmp_path):
    """The same array draws the same pixels and multiplier; the same VOC
    annotation converts to the same label and list files."""
    from PIL import Image

    from yolo2_light_tpu.utils import distribution as JDist
    from yolo2_light_tpu.utils import voc_label as JVoc
    from yolo2_light_tpu_torch.utils import distribution as TDist
    from yolo2_light_tpu_torch.utils import voc_label as TVoc
    arr = (np.random.RandomState(2).randn(5000) * 0.07).astype(np.float32)
    mj = JDist.draw_distribution(arr, "w", out_path=str(tmp_path / "j.png"))
    mt = TDist.draw_distribution(arr, "w", out_path=str(tmp_path / "t.png"))
    assert mt == mj
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    assert TVoc.convert_box((100, 200), (10, 50, 20, 120)) == \
        JVoc.convert_box((100, 200), (10, 50, 20, 120))
    outs = {}
    for tag, main in (("j", JVoc.main), ("t", TVoc.main)):
        root = tmp_path / tag / "VOCdevkit"
        ann = root / "VOC2012" / "Annotations"
        sets = root / "VOC2012" / "ImageSets" / "Main"
        ann.mkdir(parents=True)
        sets.mkdir(parents=True)
        (ann / "a1.xml").write_text(
            "<annotation><size><width>64</width><height>48</height></size>"
            "<object><name>car</name><difficult>0</difficult><bndbox>"
            "<xmin>3</xmin><xmax>40</xmax><ymin>5</ymin><ymax>30</ymax>"
            "</bndbox></object></annotation>")
        (sets / "train.txt").write_text("a1\n")
        cwd = os.getcwd()
        os.chdir(tmp_path / tag)
        try:
            main(["--root", "VOCdevkit", "--sets", "2012,train"])
        finally:
            os.chdir(cwd)
        outs[tag] = ((root / "VOC2012" / "labels" / "a1.txt").read_text(),
                     (tmp_path / tag / "2012_train.txt").read_text())
    assert outs["t"][0] == outs["j"][0] and outs["t"][0].startswith("6 ")
    assert outs["t"][1].replace("/t/", "/j/") == outs["j"][1]
