"""The port's device mesh (``yolo2_light_tpu_torch/parallel/mesh.py``)
against the JAX package's (``yolo2_light_tpu/parallel/mesh.py``) on the
CPU, where the JAX side runs on the 8 virtual host devices of
tests/conftest.py and every position of the port's mesh is the CPU.

* ``make_mesh``'s auto-split and errors, and ``shard_params``' decisions,
  layer by layer, against JAX's PartitionSpecs;
* the sharded heads against JAX's ``make_sharded_predict`` at rtol=1e-4,
  atol=1e-5 (the tolerance of the port's single-device parity test,
  tests/test_torch_network.py, for the same reason: the float convs sum in
  another order than XLA), and against the port's single-device Predictor:
  bit for bit on the data axis in every mode and in int8 mode on every axis
  (the int8 convs sum integers; its few float convs, layer 0 and the linear
  head convs, sum in the whole conv's order on these CPU cases), an fp32
  net under ``model`` or ``space`` within ``FLOAT_SLICE`` (rtol=1e-5,
  atol=1e-6): a float conv of a channel slice or a row slab may run another
  conv algorithm, which sums in another order (measured 6e-7 on the
  rendered yolov2-voc under tp2);
* ``DetectionPipeline(mesh=...)`` against JAX's at JAX's own mesh-test
  tolerance (tests/test_parallel.py: equal counts, sorted max probs at
  rtol=1e-4) and against the port's meshless pipeline, equal detections;
* ``build_forward(layer_range=...)`` chained over every split, equal to the
  whole forward; the row partition (uneven slabs, the stride-1 maxpool,
  reorg and routes) and its refusals.
"""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.parallel import mesh as JM
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.cfg import ConvSpec, parse_network_cfg
from yolo2_light_tpu_torch.models.network import (Predictor, build_forward,
                                                  device_params)
from yolo2_light_tpu_torch.parallel import mesh as TM
from yolo2_light_tpu_torch.pipeline import DetectionPipeline

TESTS = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(TESTS, "data")
CPU8 = ["cpu"] * 8
# an fp32 forward under model or space against the single-device one
FLOAT_SLICE = dict(rtol=1e-5, atol=1e-6)


def _voc_cfg():
    """yolov2-voc rendered at 128x128 with widths / 8 (reorg and a route of
    a 8x8 and a reorganized 16x16 map), written once."""
    path = os.path.join(TESTS, "..", "scripts", "gen_yolov2_voc_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_yolov2_voc_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                       f"yolov2-voc-128-8-{os.getpid()}.cfg")
    with open(out, "w") as f:
        f.write(mod.render(128, 8))
    return out


def _cfg(name):
    if name == "yolov2-voc":
        return _cfg_voc()
    return os.path.join(DATA, f"{name}.cfg")


@functools.lru_cache(maxsize=None)
def _cfg_voc():
    return _voc_cfg()


@functools.lru_cache(maxsize=None)
def _both(name, quantized, seed=3):
    """(JAX spec and params, port spec and params, mode) of one net."""
    cfg = _cfg(name)
    j = jax_build_params(cfg, None, quantized=quantized, seed=seed,
                         echo=False)
    t = build_params(cfg, None, quantized=quantized, seed=seed, echo=False)
    return j, t


def _x(spec, b=2, seed=0):
    return np.random.RandomState(seed).rand(
        b, spec.net.h, spec.net.w, spec.net.c).astype(np.float32)


# ---------------------------------------------------------------------------
# make_mesh and shard_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 4, 2, 1, 6])
def test_make_mesh_autosplit_matches_jax(n):
    j = JM.make_mesh(n)
    t = TM.make_mesh(n, devices=CPU8)
    assert t.shape == {a: j.shape[a] for a in TM.AXES}
    assert t.size == np.prod(list(j.shape.values()))
    assert t.shape["data"] >= t.shape["model"]


@pytest.mark.parametrize("kw", [dict(data=4, model=4), dict(space=9),
                                dict(n_devices=2, data=3, model=3)])
def test_make_mesh_errors_match_jax(kw):
    with pytest.raises(ValueError) as je:
        JM.make_mesh(**kw)
    with pytest.raises(ValueError) as te:
        TM.make_mesh(**kw, devices=CPU8)
    assert str(te.value) == str(je.value)


def test_make_mesh_positions():
    """A device may repeat; a list shorter than the mesh raises (it never
    shrinks quietly); with no list, the CPU holds any number of positions
    and on CUDA the default is one position per GPU."""
    m = TM.make_mesh(4, data=2, model=2, devices=["cpu"] * 4)
    assert [p.index for p in m.positions] == [(0, 0, 0), (0, 0, 1),
                                              (1, 0, 0), (1, 0, 1)]
    assert all(p.device.type == "cpu" and p.stream is None
               for p in m.positions)
    assert m.position(1, 0, 1) is m.positions[3]
    with pytest.raises(ValueError, match="needs 4 devices, have 3"):
        TM.make_mesh(4, data=2, model=2, devices=["cpu"] * 3)
    m = TM.make_mesh(16, data=2, space=4, model=2, device="cpu")
    assert m.shape == {"data": 2, "space": 4, "model": 2} and m.size == 16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.make_mesh(2)


@pytest.mark.parametrize("axes", [dict(data=2, model=4),
                                  dict(data=2, space=2, model=2),
                                  dict(model=2), dict(space=4, model=2)])
@pytest.mark.parametrize("name,quantized", [("mini-yolo3", True),
                                            ("mini-res", False),
                                            ("mini-xnor", False),
                                            ("yolov2-voc", True)])
def test_shard_params_decisions_match_jax(name, quantized, axes):
    """Layer by layer and tensor by tensor: a conv's per-output-channel
    tensors shard over ``model`` exactly where JAX's PartitionSpec names
    ``model``, and each position holds its M/model rows of them."""
    (jspec, jparams, _), (spec, params, mode) = _both(name, quantized)
    n = int(np.prod(list(axes.values())))
    jsh = JM.shard_params(jspec, jparams, JM.make_mesh(n, **axes))
    mesh = TM.make_mesh(n, **axes, devices=CPU8)
    conv = device_params(spec, params, mode, "cpu")
    tsh = TM.shard_params(spec, conv, mesh)
    sharded = TM.sharded_layers(spec, mesh)
    model = axes.get("model", 1)
    n_sharded = 0
    for l, jp in zip(jspec.layers, jsh):
        if jp is None:
            assert l.index not in sharded
            continue
        for key in ("weights", "weights_int8", "biases", "sign_weights",
                    "mean_arr"):
            if key not in jp:
                continue
            ps = tuple(jp[key].sharding.spec)
            assert (("model" in ps) == (l.index in sharded)), (l.index, key)
        if l.index not in sharded:
            continue
        n_sharded += 1
        for pos, per_layer in zip(mesh.positions, tsh):
            m = pos.index[2]
            for k, v in per_layer[l.index].items():
                full = conv[l.index][k]
                if isinstance(full, torch.Tensor) and full.shape[0] == l.n:
                    rows = l.n // model
                    assert torch.equal(v, full[m * rows:(m + 1) * rows])
                else:
                    assert v is full or v == full
    assert n_sharded > 0


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------


SHARDED = [
    # cfg, quantized, port engine, axes
    ("mini-yolo3", False, {}, dict(data=2, model=4)),
    ("mini-yolo3", False, {}, dict(space=4)),
    ("mini-yolo3", True, {}, dict(data=2, space=2, model=2)),
    ("mini-res", True, {"int8_impl": "fused"}, dict(model=2)),
    ("mini-res", True, {"int8_impl": "fused"}, dict(data=2, space=2)),
    ("mini-xnor", False, {"xnor_impl": "pallas"}, dict(model=4)),
    ("mini-xnor", False, {"xnor_impl": "pallas_mxu"}, dict(space=2)),
    ("mini-yolo2", False, {}, dict(space=2, model=2)),
    ("yolov2-voc", True, {}, dict(space=2)),
    ("yolov2-voc", False, {}, dict(data=2, model=2)),
]


@pytest.mark.parametrize("name,quantized,kw,axes", SHARDED)
def test_sharded_heads_match_jax_and_single(name, quantized, kw, axes):
    (jspec, jparams, jmode), (spec, params, mode) = _both(name, quantized)
    x = _x(spec, b=2)
    n = int(np.prod(list(axes.values())))
    jfn, jsh = JM.make_sharded_predict(jspec, jparams,
                                       JM.make_mesh(n, **axes), jmode)
    theirs = jfn(jsh, x)
    mesh = TM.make_mesh(n, **axes, devices=CPU8)
    fn, sh = TM.make_sharded_predict(spec, params, mesh, mode, **kw)
    ours = fn(sh, x)
    single = Predictor(spec, params, mode, device="cpu", **kw)(x)
    assert len(ours) == len(theirs) == len(single) >= 1
    exact = mode == "int8" or set(axes) == {"data"}
    for o, r, s in zip(ours, theirs, single):
        assert o.shape == s.data.shape
        if exact:
            assert torch.equal(o, s.data)
        else:
            np.testing.assert_allclose(o.numpy(), s.data.numpy(),
                                       **FLOAT_SLICE)
        np.testing.assert_allclose(o.numpy(), np.asarray(r).reshape(o.shape),
                                   rtol=1e-4, atol=1e-5)


def test_collectives_sit_between_runs():
    """tp2 on mini-yolo3: one all-gather for every conv whose M is even,
    after the maxpool that alone reads its output (convs 0 and 4: the
    pooled map crosses) or else right after the conv (conv 2, which route
    12 reads too), and the runs between them cut there; sp2: a halo
    exchange before every 3x3 conv and the stride-1 maxpool, none before
    the 2x2/2 maxpools (their slabs need no neighbour rows)."""
    _, (spec, _, mode) = _both("mini-yolo3", False)
    tp = TM.ShardedForward(spec, TM.make_mesh(2, model=2, device="cpu"))
    gathered = [s.b - 1 for s in tp.segments if s.gather]
    shard = sorted(TM.sharded_layers(
        spec, TM.make_mesh(2, model=2, device="cpu")))
    assert shard == [l.index for l in spec.layers
                     if isinstance(l, ConvSpec) and l.n % 2 == 0]
    assert shard == [0, 2, 4, 6, 7, 10, 13, 14]
    assert gathered == [1, 2, 5, 6, 7, 10, 13, 14]
    assert all(type(spec.layers[i]).__name__ == "MaxpoolSpec"
               for i in (1, 5))
    sp = TM.ShardedForward(spec, TM.make_mesh(2, space=2, device="cpu"))
    halo = [s.a for s in sp.segments if s.halo is not None]
    kinds = {l.index: (type(l).__name__, l.size, l.stride)
             for l in spec.layers if hasattr(l, "size")}
    assert [kinds[i] for i in halo] == [
        ("ConvSpec", 3, 1), ("ConvSpec", 3, 1), ("ConvSpec", 3, 1),
        ("MaxpoolSpec", 2, 1), ("ConvSpec", 3, 1)]


def test_uneven_slabs():
    """The row partition comes from the coarsest grid: yolov3-416's 13 rows
    over 2 positions are 7 and 6, scaled by 32 at the input; over 3
    positions mini-yolo3's 16 rows are 6, 5, 5, and its sharded heads are
    the single-device ones."""
    spec = parse_network_cfg(os.path.join(DATA, "yolov3.cfg"), batch=1,
                             echo_table=False)
    sf = TM.ShardedForward(spec, TM.make_mesh(2, space=2, device="cpu"))
    assert [sf.slab(13, s) for s in (0, 1)] == [(0, 7), (7, 13)]
    assert [sf.slab(416, s) for s in (0, 1)] == [(0, 224), (224, 416)]
    assert [sf.slab(26, s) for s in (0, 1)] == [(0, 14), (14, 26)]
    _, (spec, params, mode) = _both("mini-yolo3", True)
    mesh = TM.make_mesh(3, space=3, device="cpu")
    fn, sh = TM.make_sharded_predict(spec, params, mesh, mode)
    sf = TM.ShardedForward(spec, mesh, mode)
    assert [sf.slab(16, s) for s in range(3)] == [(0, 6), (6, 11), (11, 16)]
    x = _x(spec, b=1, seed=4)
    single = Predictor(spec, params, mode, device="cpu")(x)
    for o, s in zip(fn(sh, x), single):
        assert torch.equal(o, s.data)


@pytest.mark.parametrize("what", ["rows", "route", "softmax"])
def test_space_axis_refusals(what, tmp_path):
    if what == "rows":
        spec = parse_network_cfg(os.path.join(DATA, "mini-res.cfg"), batch=1,
                                 echo_table=False)
        with pytest.raises(ValueError, match="space=9 positions but the "
                           "net's coarsest grid has 8 rows"):
            TM.ShardedForward(spec, TM.make_mesh(9, space=9, device="cpu"))
        return
    if what == "route":
        cfg = os.path.join(DATA, "mini-routeflat.cfg")
        match = "joins maps of different sizes"
    else:
        text = open(os.path.join(DATA, "mini-xnor.cfg")).read()
        text = text.rsplit("[yolo]", 1)[0] + "[softmax]\ngroups=1\n"
        cfg = str(tmp_path / "softmax.cfg")
        open(cfg, "w").write(text)
        match = r"\[softmax\] layer reads its whole map"
    spec = parse_network_cfg(cfg, batch=1, echo_table=False)
    with pytest.raises(ValueError, match=match):
        TM.ShardedForward(spec, TM.make_mesh(2, space=2, device="cpu"))
    # the other axes run such nets
    TM.ShardedForward(spec, TM.make_mesh(4, data=2, model=2, device="cpu"))


@pytest.mark.parametrize("name,quantized,kw", [
    ("mini-yolo3", False, {}), ("mini-yolo3", True, {}),
    ("mini-res", True, {"int8_impl": "fused"}),
    ("mini-res", True, {"turbo": "int8"}),
    ("mini-yolo2", True, {}), ("mini-xnor", False, {"xnor_impl": "pallas"}),
    ("yolov2-voc", True, {})])
def test_layer_range_chained_equals_whole(name, quantized, kw):
    """``build_forward(layer_range=(0, b))`` then ``(b, n)``, the second fed
    the first's running activation and carried outputs, equals the whole
    forward at every split b, heads and final output, bit for bit (with
    turbo="int8" the trunk a later range quantizes crosses as float, as in
    the JAX package, so the chained heads are held to the whole forward's
    only where no trunk target crosses)."""
    from yolo2_light_tpu_torch.parallel.pp import carried_for_boundary
    _, (spec, params, mode) = _both(name, quantized)
    conv = device_params(spec, params, mode, "cpu", **{
        k: v for k, v in kw.items() if k == "xnor_impl"})
    x = torch.from_numpy(_x(spec, b=2, seed=5))
    with torch.inference_mode():
        whole, waux = build_forward(spec, mode, **kw)(conv, x)
        for b in range(1, spec.n):
            carry = carried_for_boundary(spec, b)
            h0, a0 = build_forward(spec, mode, layer_range=(0, b),
                                   carry_out=carry, **kw)(conv, x)
            h1, a1 = build_forward(spec, mode, layer_range=(b, spec.n),
                                   carry_out=set(), **kw)(
                conv, a0["final"], a0["outputs"])
            assert set(a0["outputs"]) == carry and a1["outputs"] == {}
            heads = h0 + h1
            assert [h.index for h in heads] == [h.index for h in whole]
            if kw.get("turbo") == "int8":
                continue
            for h, w in zip(heads, whole):
                assert torch.equal(h.data, w.data), (b, h.index)
            assert torch.equal(a1["final"], waux["final"]), b


def test_cpu_old_runs_under_data_axis_only():
    """The legacy chain (cpu_old) takes no layer range: the data axis runs
    it whole on every position, bit for bit; -tp/-sp refuse, naming the
    flags."""
    _, (spec, params, mode) = _both("yolov2-voc", True)
    x = _x(spec, b=2)
    fn, sh = TM.make_sharded_predict(
        spec, params, TM.make_mesh(2, data=2, device="cpu"), mode,
        int8_policy="cpu_old")
    single = Predictor(spec, params, mode, device="cpu",
                       int8_policy="cpu_old")(x)
    for o, s in zip(fn(sh, x), single):
        assert torch.equal(o, s.data)
    for axes in (dict(model=2), dict(space=2)):
        with pytest.raises(ValueError, match="-tp/-sp"):
            TM.make_sharded_predict(spec, params,
                                    TM.make_mesh(2, **axes, device="cpu"),
                                    mode, int8_policy="cpu_old")


@pytest.mark.parametrize("axes", [dict(model=2), dict(space=2),
                                  dict(data=2, space=2, model=2)])
@pytest.mark.parametrize("name,turbo", [("mini-res", "int8"),
                                        ("mini-yolo3", "int8"),
                                        ("mini-yolo3", True)])
def test_turbo_under_collectives_equals_single(name, turbo, axes):
    """``-turbo`` (bf16 activations) and ``-turbo_int8`` (the int8 trunk:
    the int8 tensors cross the all-gathers and halo exchanges beside their
    float views) under every axis: the single-device forward, bit for bit
    (the JAX package's mesh takes no turbo keyword; the single-device
    turbo forwards are held to JAX in tests/test_torch_precision.py)."""
    _, (spec, params, mode) = _both(name, True)
    x = _x(spec, b=2, seed=6)
    n = int(np.prod(list(axes.values())))
    fn, sh = TM.make_sharded_predict(
        spec, params, TM.make_mesh(n, **axes, device="cpu"), mode,
        turbo=turbo)
    single = Predictor(spec, params, mode, device="cpu", turbo=turbo)(x)
    for o, s in zip(fn(sh, x), single):
        assert torch.equal(o, s.data)


# ---------------------------------------------------------------------------
# DetectionPipeline on a mesh
# ---------------------------------------------------------------------------


PIPES = [
    # cfg, quantized, JAX and port keywords, axes
    ("mini-yolo3", False, {}, dict(data=2, model=4)),
    ("mini-yolo3", True, {}, dict(data=2, space=2, model=2)),
    ("mini-xnor", False, {}, dict(data=2, model=4)),
    ("mini-yolo3", False, {"device_nms": True}, dict(data=2, model=2)),
]


@pytest.mark.parametrize("name,quantized,kw,axes", PIPES)
def test_mesh_pipeline_matches_jax_and_single(name, quantized, kw, axes):
    (jspec, jparams, jmode), (spec, params, mode) = _both(name, quantized,
                                                          seed=4)
    x = (np.random.RandomState(2).rand(2, 96, 128, 3) * 255).astype(np.uint8)
    args = dict(thresh=0.3, nms=0.4, k=2048, **kw)
    n = int(np.prod(list(axes.values())))
    jp = JaxPipeline(jspec, jparams, jmode, mesh=JM.make_mesh(n, **axes),
                     **args)
    tp = DetectionPipeline(spec, params, mode,
                           mesh=TM.make_mesh(n, **axes, devices=CPU8), **args)
    single = DetectionPipeline(spec, params, mode, device="cpu", **args)
    assert tp.data_parallel == jp.data_parallel == axes.get("data", 1)
    ours, theirs, one = tp(x), jp(x), single(x)
    assert sum(d.n for d in ours) > 0
    for a, b, c in zip(ours, theirs, one):
        assert a.n == b.n
        np.testing.assert_allclose(np.sort(a.prob.max(-1)),
                                   np.sort(b.prob.max(-1)), rtol=1e-4)
        np.testing.assert_array_equal(a.prob, c.prob)
        np.testing.assert_array_equal(a.bbox, c.bbox)


def test_mesh_pipeline_refusals_match_jax():
    """mesh with pp_stages, serve_scan under a mesh, and planar YUV under a
    space axis raise ValueError in both packages, with JAX's messages for
    the first two."""
    (jspec, jparams, jmode), (spec, params, mode) = _both("mini-yolo3", False)
    jm, tm = JM.make_mesh(2, data=2), TM.make_mesh(2, data=2, devices=CPU8)
    for pkg, sp, p, m, cls in ((0, jspec, jparams, jm, JaxPipeline),
                               (1, spec, params, tm, DetectionPipeline)):
        with pytest.raises(ValueError, match="pp_stages and mesh are "
                           "mutually exclusive"):
            cls(sp, p, mode, mesh=m, pp_stages=2)
        pipe = cls(sp, p, mode, mesh=m, thresh=0.3)
        with pytest.raises(ValueError, match="serve_scan is the "
                           "single-device serving loop"):
            pipe.serve_scan(np.zeros((2, 64, 64, 3), np.uint8))
    sp2 = DetectionPipeline(spec, params, mode,
                            mesh=TM.make_mesh(2, space=2, devices=CPU8))
    with pytest.raises(ValueError, match="planar YUV420"):
        sp2(np.zeros((1, 96, 64), np.uint8))
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        DetectionPipeline(spec, params, mode, mesh=tm)(
            np.zeros((3, 64, 64, 3), np.uint8))
