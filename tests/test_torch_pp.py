"""The port's pipeline parallelism (``yolo2_light_tpu_torch/parallel/pp.py``)
against the JAX package's (``yolo2_light_tpu/parallel/pp.py``) on the CPU:
the JAX side on the 8 virtual host devices of tests/conftest.py, every stage
of the port on the CPU.

* ``split_stages`` and ``carried_for_boundary`` equal JAX's;
* ``PipelinedPredictor`` and ``ReplicatedPipeline`` heads against JAX's at
  rtol=1e-4, atol=1e-5 (tests/test_torch_network.py's single-device
  tolerance, for its reason), and against the port's single-device forward
  at the same microbatch size bit for bit in every mode (JAX's caveat (a):
  the reference is the same per-microbatch program); under ``tp`` the float
  convs of a channel slice within tests/test_torch_parallel.py's
  ``FLOAT_SLICE``;
* ``DetectionPipeline(pp_stages=...)`` against JAX's (equal counts, sorted
  max probs at rtol=1e-4, tests/test_parallel.py's mesh tolerance) and
  against the port's single-device pipeline at the same microbatch, equal
  detections;
* ``-int8_policy cpu_old`` under pipeline stages: both packages refuse.
"""

import functools
import os

import numpy as np
import pytest
import torch

from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.parallel import pp as JP
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.models.network import (Predictor, build_forward,
                                                  device_params)
from yolo2_light_tpu_torch.parallel import pp as TP
from yolo2_light_tpu_torch.pipeline import DetectionPipeline

TESTS = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(TESTS, "data")
FLOAT_SLICE = dict(rtol=1e-5, atol=1e-6)


def _cfg(name):
    if name == "yolov2-voc":
        from tests.test_torch_parallel import _cfg_voc
        return _cfg_voc()
    return os.path.join(DATA, f"{name}.cfg")


@functools.lru_cache(maxsize=None)
def _both(name, quantized, seed=3):
    cfg = _cfg(name)
    return (jax_build_params(cfg, None, quantized=quantized, seed=seed,
                             echo=False),
            build_params(cfg, None, quantized=quantized, seed=seed,
                         echo=False))


def _x(spec, b=4, seed=0):
    return np.random.RandomState(seed).rand(
        b, spec.net.h, spec.net.w, spec.net.c).astype(np.float32)


@pytest.mark.parametrize("name", ["mini-yolo3", "mini-res", "mini-xnor",
                                  "yolov2-voc"])
def test_split_and_carried_sets_match_jax(name):
    (jspec, _, _), (spec, _, _) = _both(name, False)
    for n in (2, 3, 4):
        ranges = TP.split_stages(spec, n)
        assert ranges == JP.split_stages(jspec, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == spec.n
        for (a0, b0), (a1, _) in zip(ranges, ranges[1:]):
            assert b0 == a1 and a0 < b0
    for stop in range(1, spec.n):
        assert (TP.carried_for_boundary(spec, stop)
                == JP.carried_for_boundary(jspec, stop))


def _single_per_microbatch(spec, params, mode, x, mb, **kw):
    pred = Predictor(spec, params, mode, device="cpu", **kw)
    outs = [pred(x[m * mb:(m + 1) * mb]) for m in range(x.shape[0] // mb)]
    return [torch.cat([o[h].data for o in outs]) for h in range(len(outs[0]))]


PP = [
    # cfg, quantized, port engine, stages, microbatch, tp
    ("mini-yolo3", False, {}, 2, 2, 1),
    ("mini-yolo3", False, {}, 4, 1, 1),
    ("mini-yolo3", True, {}, 3, 2, 1),
    ("mini-res", True, {"int8_impl": "fused"}, 2, 2, 1),
    ("mini-xnor", False, {"xnor_impl": "pallas_mxu"}, 2, 1, 1),
    ("mini-yolo3", False, {}, 2, 2, 2),
    ("mini-res", True, {"int8_impl": "fused"}, 2, 1, 2),
    ("mini-xnor", False, {"xnor_impl": "pallas"}, 2, 2, 2),
]


@pytest.mark.parametrize("name,quantized,kw,stages,mb,tp", PP)
def test_pipelined_heads_match_jax_and_single(name, quantized, kw, stages,
                                              mb, tp):
    (jspec, jparams, jmode), (spec, params, mode) = _both(name, quantized)
    x = _x(spec)
    theirs, _ = JP.PipelinedPredictor(jspec, jparams, jmode, n_stages=stages,
                                      microbatch=mb, tp=tp)(x)
    pp = TP.PipelinedPredictor(spec, params, mode, n_stages=stages,
                               microbatch=mb, tp=tp, device="cpu", **kw)
    assert pp.ranges == TP.split_stages(spec, stages)
    ours, aux = pp(x)
    assert len(aux["final"]) == x.shape[0] // mb
    single = _single_per_microbatch(spec, params, mode, x, mb, **kw)
    assert len(ours) == len(theirs) == len(single) >= 1
    for o, r, s in zip(ours, theirs, single):
        assert (o.index, o.kind) == (r.index, r.kind)
        if tp == 1 or mode == "int8":
            assert torch.equal(o.data, s)
        else:
            np.testing.assert_allclose(o.data.numpy(), s.numpy(),
                                       **FLOAT_SLICE)
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   rtol=1e-4, atol=1e-5)


def test_stage_params_hold_their_layers_only():
    """Each stage holds the params of its own layers, on its device; under
    tp its sharded convs hold M/tp rows on each position."""
    _, (spec, params, mode) = _both("mini-yolo3", False)
    pp = TP.PipelinedPredictor(spec, params, mode, n_stages=4, microbatch=1,
                               device="cpu")
    for s, (a, b) in enumerate(pp.ranges):
        for i, p in enumerate(pp.stage_params[s]):
            assert (p is not None) == (a <= i < b and params[i] is not None)
    pt = TP.PipelinedPredictor(spec, params, mode, n_stages=2, microbatch=1,
                               tp=2, device="cpu")
    halves = 0
    for s, (a, b) in enumerate(pt.ranges):
        for per_pos in pt.stage_params[s]:
            for i in range(a, b):
                l, p = spec.layers[i], per_pos[i]
                if p is not None and "weights" in p and l.n % 2 == 0:
                    assert p["weights"].shape[0] == l.n // 2
                    halves += 1
    assert halves >= 8


@pytest.mark.parametrize("tp", [1, 2])
def test_replicated_pipeline_matches_single_and_jax(tp):
    """dp x pp (x tp): two replicas of a 2-stage pipeline are bit-identical
    to one PipelinedPredictor at the same microbatch, and hold JAX's."""
    (jspec, jparams, jmode), (spec, params, mode) = _both("mini-yolo3", True)
    x = _x(spec, seed=1)
    kw = dict(n_stages=2, microbatch=1, tp=tp)
    theirs, _ = JP.ReplicatedPipeline(jspec, jparams, jmode, replicas=2,
                                      **kw)(x)
    rep = TP.ReplicatedPipeline(spec, params, mode, replicas=2,
                                device="cpu", **kw)
    assert rep.ranges == TP.split_stages(spec, 2)
    ours, aux = rep(x)
    one, _ = TP.PipelinedPredictor(spec, params, mode, device="cpu", **kw)(x)
    assert len(aux["final"]) == 4
    for o, r, s in zip(ours, theirs, one):
        assert torch.equal(o.data, s.data)
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   rtol=1e-4, atol=1e-5)


def test_devices_are_counted_as_jax_counts_them():
    """Fewer devices than stages x tp raise with JAX's message; the default
    on CUDA is one GPU a stage."""
    _, (spec, params, mode) = _both("mini-yolo3", False)
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        TP.PipelinedPredictor(spec, params, mode, n_stages=2, tp=2,
                              devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"need 8 devices \(2 replicas x 2 "
                       r"stages x tp 2\), have 4"):
        TP.ReplicatedPipeline(spec, params, mode, tp=2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.PipelinedPredictor(spec, params, mode, n_stages=2)


def test_cpu_old_pipeline_stages_are_refused_by_both():
    """JAX's pipeline stages call the legacy chain's forward with a carried
    dict it does not take (a TypeError at the first call); the port refuses
    at construction, naming -pp."""
    (jspec, jparams, jmode), (spec, params, mode) = _both("yolov2-voc", True)
    x = _x(spec, b=2)
    with pytest.raises(TypeError):
        JP.PipelinedPredictor(jspec, jparams, jmode, n_stages=2,
                              int8_policy="cpu_old", microbatch=2)(x)
    with pytest.raises(ValueError, match="-pp.*cpu_old"):
        TP.PipelinedPredictor(spec, params, mode, n_stages=2,
                              int8_policy="cpu_old", device="cpu")
    with pytest.raises(ValueError, match="cpu_old"):
        build_forward(spec, mode, int8_policy="cpu_old", layer_range=(0, 3))


def test_fused_runs_straddling_a_stage_run_unfused():
    """-int8_impl fused under stages: a residual run that straddles a
    boundary runs on the int8 conv kernel (the range filter of JAX's
    build_forward); the heads are the whole fused forward's."""
    _, (spec, params, mode) = _both("mini-res", True)
    x = torch.from_numpy(_x(spec, b=2, seed=3))
    conv = device_params(spec, params, mode, "cpu")
    with torch.inference_mode():
        whole, _ = build_forward(spec, mode, int8_impl="fused")(conv, x)
    pp = TP.PipelinedPredictor(spec, params, mode, n_stages=2, microbatch=2,
                               int8_impl="fused", device="cpu")
    heads, _ = pp(x)
    for h, w in zip(heads, whole):
        assert torch.equal(h.data, w.data)


PIPES = [
    ("mini-yolo3", False, {}, dict(pp_stages=4, pp_microbatch=2)),
    ("mini-yolo3", True, {"device_nms": True},
     dict(pp_stages=2, pp_microbatch=2)),
    ("mini-yolo3", True, {}, dict(pp_stages=2, pp_tp=2, pp_microbatch=1)),
    ("mini-xnor", False, {}, dict(pp_stages=2, pp_tp=2, pp_microbatch=2)),
]


@pytest.mark.parametrize("name,quantized,kw,pp", PIPES)
def test_pp_pipeline_matches_jax_and_single(name, quantized, kw, pp):
    (jspec, jparams, jmode), (spec, params, mode) = _both(name, quantized,
                                                          seed=4)
    x = (np.random.RandomState(1).rand(4, 96, 128, 3) * 255).astype(np.uint8)
    args = dict(thresh=0.3, nms=0.4, k=2048, **kw)
    jp = JaxPipeline(jspec, jparams, jmode, **pp, **args)
    tp = DetectionPipeline(spec, params, mode, device="cpu", **pp, **args)
    single = DetectionPipeline(spec, params, mode, device="cpu", **args)
    mb = pp["pp_microbatch"]
    one = [d for m in range(0, 4, mb) for d in single(x[m:m + mb])]
    ours, theirs = tp(x), jp(x)
    assert sum(d.n for d in ours) > 0
    for a, b, c in zip(ours, theirs, one):
        assert a.n == b.n
        np.testing.assert_allclose(np.sort(a.prob.max(-1)),
                                   np.sort(b.prob.max(-1)), rtol=1e-4)
        if pp.get("pp_tp", 1) == 1 or mode == "int8":
            np.testing.assert_array_equal(a.prob, c.prob)
            np.testing.assert_array_equal(a.bbox, c.bbox)
    with pytest.raises(ValueError, match="serve_scan is the single-device "
                       "serving loop"):
        tp.serve_scan(x)
