"""The port's communication account (``yolo2_light_tpu_torch/parallel/
commvol.py``) against the JAX package's (``yolo2_light_tpu/parallel/
commvol.py``) on the CPU, where the JAX side runs on the 8 virtual host
devices of tests/conftest.py and every position of the port's mesh is the
CPU.

* ``wire_bytes``, ``project_throughput`` and ``pp_boundary_bytes`` equal
  JAX's on the same inputs (each package parsing yolov3-416 with its own
  ``cfg``);
* the recorder's entries on mini-yolo3 equal a count made here from layer
  shapes, the sharded layers and the row slabs (``commvol_count``, which
  ``chip_smoke.py`` holds yolov3-416 to as well), under model2, space2,
  data2 x model2, pp2 and pp2 x tp2, and under ``-turbo_int8`` with its
  int8 tensors at 1 byte an element, and the heads are bit-identical with
  the recorder on and off;
* the per-image normalisation by ``batch // data`` (the port of JAX's
  ``test_per_image_normalizes_by_device_batch``), exact;
* the port's ``measure_mesh_comm`` beside JAX's at model2, the numbers as
  found and where the two programs part.
"""

import collections
import os

import numpy as np
import pytest
import torch

from yolo2_light_tpu.cfg import parse_network_cfg as jax_parse
from yolo2_light_tpu.parallel import commvol as JC
from yolo2_light_tpu.parallel import pp as JP
from yolo2_light_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo2_light_tpu.weights import fuse_conv_batchnorm, random_params
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.cfg import (ConvSpec, MaxpoolSpec,
                                       parse_network_cfg, YoloSpec)
from yolo2_light_tpu_torch.models.network import Predictor, _consumers
from yolo2_light_tpu_torch.parallel import commvol as TC
from yolo2_light_tpu_torch.parallel import mesh as TM
from yolo2_light_tpu_torch.parallel import pp as TP

from .commvol_count import expected_mesh, int8_twins, recorded

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MINI = os.path.join(DATA, "mini-yolo3.cfg")
YOLOV3 = os.path.join(DATA, "yolov3.cfg")


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------

VOLUMES = [
    # JAX's own test: a model-subgroup all-gather, a grouped and an
    # ungrouped all-reduce
    ({"all-gather": {"count": 1, "result_bytes": 256,
                     "group_bytes": {2: 256}},
      "all-reduce": {"count": 2, "result_bytes": 128,
                     "group_bytes": {4: 64, None: 64}}}, 8),
    # every op class, groups of one, a None bucket, permutes at g = 1
    ({"all-gather": {"count": 3, "result_bytes": 7000,
                     "group_bytes": {1: 1000, 2: 2000, None: 4000}},
      "reduce-scatter": {"count": 2, "result_bytes": 300,
                         "group_bytes": {4: 100, None: 200}},
      "all-reduce": {"count": 1, "result_bytes": 96,
                     "group_bytes": {3: 96}},
      "all-to-all": {"count": 2, "result_bytes": 640,
                     "group_bytes": {8: 512, 1: 128}},
      "collective-permute": {"count": 4, "result_bytes": 1234,
                             "group_bytes": {1: 34, 2: 200, None: 1000}}},
     4),
    # no buckets: the result bytes at the mesh size
    ({"all-gather": {"count": 1, "result_bytes": 4096, "group_bytes": {}},
      "collective-permute": {"count": 1, "result_bytes": 77}}, 2),
]


@pytest.mark.parametrize("volumes,n", VOLUMES)
def test_wire_bytes_equals_jax(volumes, n):
    assert TC.wire_bytes(volumes, n) == JC.wire_bytes(volumes, n)


def test_project_throughput_equals_jax():
    """The same rows, keys and numbers at the same link bandwidth (the
    port's argument is JAX's ``ici_bw``)."""
    wire = {("tp", 2): 26117260.0, ("tp", 8): 45705205.0,
            ("sp", 4): 2938624.0, ("dp", 2): 0.0, ("sp", 2): 1.5e6}
    for single in (0.5, 1.75):
        got = TC.project_throughput(single, wire, TC.NVLINK_BW_H100_SXM)
        want = JC.project_throughput(single, wire,
                                     ici_bw=TC.NVLINK_BW_H100_SXM)
        assert got == want


@pytest.mark.parametrize("stages", [2, 3, 4])
def test_pp_boundary_bytes_equals_jax(stages):
    """yolov3-416 at full width, each package parsing with its own cfg:
    the same stage ranges and the same handoff bytes per boundary."""
    t = parse_network_cfg(YOLOV3, batch=1, echo_table=False)
    j = jax_parse(YOLOV3, batch=1)
    ranges = TP.split_stages(t, stages)
    assert ranges == JP.split_stages(j, stages)
    for dtype_bytes in (4, 1):
        got = TC.pp_boundary_bytes(t, ranges, dtype_bytes)
        assert got == JC.pp_boundary_bytes(j, ranges, dtype_bytes)
        assert len(got) == stages - 1 and all(v > 0 for v in got)


def test_recording_is_off_by_default_and_nests():
    assert TC.current() is None
    with TC.recording() as outer:
        assert TC.current() is outer
        with TC.recording() as inner:
            assert TC.current() is inner
        assert TC.current() is outer
    assert TC.current() is None


# ---------------------------------------------------------------------------
# the recorder against a count from layer shapes
# ---------------------------------------------------------------------------


def expected_pp(spec, ranges, microbatches, mb, elem=4):
    """{(position, what): [count, bytes]} of a pipeline at tp 1: every
    stage after the first receives each tensor of its boundary's live set
    once a microbatch; the last stage receives the earlier stages' heads."""
    out = collections.defaultdict(lambda: [0, 0])
    consumers = _consumers(spec)
    for s, (a, _) in enumerate(ranges[1:], start=1):
        for j in range(a):
            if any(c >= a for c in consumers[j]):
                l = spec.layers[j]
                out[(s,), "handoff"][0] += microbatches
                out[(s,), "handoff"][1] += (microbatches * mb * l.out_h
                                            * l.out_w * l.out_c * elem)
    last = len(ranges) - 1
    for l in spec.layers:
        if isinstance(l, YoloSpec) and l.index < ranges[-1][0]:
            out[(last,), "collect"][0] += microbatches
            out[(last,), "collect"][1] += (microbatches * mb * l.out_h
                                           * l.out_w * l.out_c * elem)
    return dict(out)


def _mini(quantized=True):
    return build_params(MINI, None, quantized=quantized, seed=3, echo=False)


def _x(spec, b, seed=0):
    return np.random.RandomState(seed).rand(
        b, spec.net.h, spec.net.w, spec.net.c).astype(np.float32)


@pytest.mark.parametrize("axes", [dict(model=2), dict(space=2),
                                  dict(data=2, model=2),
                                  dict(space=2, model=2)])
@pytest.mark.parametrize(
    "name,quantized,turbo",
    [("mini-yolo3", True, None), ("mini-yolo3", False, None),
     ("mini-res", True, None), ("mini-yolo3", True, "int8"),
     ("mini-res", True, "int8")],
    ids=["mini-yolo3-True", "mini-yolo3-False", "mini-res-True",
         "mini-yolo3-turbo_int8", "mini-res-turbo_int8"])
def test_recorder_counts_the_mesh_from_layer_shapes(name, quantized, turbo,
                                                    axes):
    """Also mini-res's 3x3/s2 convs under space: the slab below reads one
    row above its own, which crosses; the row above that only aligns the
    window to the stride and is made locally (the heads equal the
    single-device forward's). Under -turbo_int8, where a gathered or
    haloed output has an int8 trunk or chain tensor, that tensor crosses
    beside the float32 one, an entry of its own at 1 byte an element
    (mini-yolo3: layers 0, 1, 4, 5, 6, 9, 10 and 11 hold one, and those of
    1, 4, 5, 6 and 10 cross)."""
    spec, params, mode = build_params(os.path.join(DATA, f"{name}.cfg"),
                                      None, quantized=quantized, seed=3,
                                      echo=False)
    kw = dict(turbo=turbo) if turbo else {}
    mesh = TM.make_mesh(int(np.prod(list(axes.values()))), **axes,
                        device="cpu")
    fn, sh = TM.make_sharded_predict(spec, params, mesh, mode, **kw)
    x = _x(spec, 2)
    off = fn(sh, x)
    with TC.recording() as log:
        on = fn(sh, x)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    if quantized:
        single = Predictor(spec, params, mode, device="cpu", **kw)
        assert all(torch.equal(a, h.data) for a, h in zip(on, single(x)))
    twins = int8_twins(spec) if turbo else ()
    if turbo and name == "mini-yolo3":
        assert twins == {0, 1, 4, 5, 6, 9, 10, 11}
    got = recorded(log)
    assert got == expected_mesh(spec, axes, 2, twins=twins)
    if turbo:
        assert got != expected_mesh(spec, axes, 2)
    assert {e.op for e in log.entries} == (
        {"all-gather", "collective-permute"} if "model" in axes
        else {"collective-permute"})
    assert all(e.group == (2 if e.op == "collective-permute"
                           else axes["model"]) for e in log.entries)


@pytest.mark.parametrize("tp", [1, 2])
def test_recorder_counts_the_pipeline_from_layer_shapes(tp):
    """pp2 at b=2 in microbatches of 1: each boundary's live set
    (``pp_boundary_bytes`` a microbatch), the running activation once; under
    pp2 x tp2 each stage's own gathers and scatter, recorded under it."""
    spec, params, mode = _mini()
    pp = TP.PipelinedPredictor(spec, params, mode, n_stages=2, tp=tp,
                               device="cpu")
    x = _x(spec, 2)
    off = [h.data for h in pp(x)[0]]
    with TC.recording() as log:
        on = [h.data for h in pp(x)[0]]
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    got = recorded(log)
    handoff = sum(v[1] for (p, w), v in got.items() if w == "handoff")
    assert handoff == 2 * sum(TC.pp_boundary_bytes(spec, pp.ranges))
    if tp == 1:
        assert got == expected_pp(spec, pp.ranges, 2, 1)
        return
    want = collections.defaultdict(lambda: [0, 0])
    for (pos, what), (n, v) in expected_pp(spec, pp.ranges, 2, 1).items():
        want[pos + (0, 0, 0), what] = [n, v]
    consumers = _consumers(spec)
    for s, (a, z) in enumerate(pp.ranges):
        # a 1 x 1 x 2 mesh over the stage's layers, a microbatch at a time:
        # every even-M conv gathered, after the maxpools of the stage that
        # alone read it where no later stage reads it
        carry_out = TP.carried_for_boundary(spec, z) if z < spec.n else ()
        for l in spec.layers[a:z]:
            if isinstance(l, ConvSpec) and l.n % 2 == 0:
                g = l.index
                while (g + 1 < z and consumers[g] == [g + 1]
                       and g not in carry_out
                       and isinstance(spec.layers[g + 1], MaxpoolSpec)):
                    g += 1
                o = spec.layers[g]
                for m in (0, 1):
                    want[(s, 0, 0, m), "gather"][0] += 2
                    want[(s, 0, 0, m), "gather"][1] += (
                        2 * o.out_h * o.out_w * o.out_c * 4)
        # the running activation (once) and the carried tensors the stage
        # reads, to the second model position
        live = {a - 1} | {j for j in range(a)
                          if any(c >= a for c in consumers[j])}
        shape = ([(spec.net.h, spec.net.w, spec.net.c)] if a == 0 else
                 [(spec.layers[j].out_h, spec.layers[j].out_w,
                   spec.layers[j].out_c) for j in sorted(live)])
        for h, w, c in shape:
            want[(s, 0, 0, 1), "scatter"][0] += 2
            want[(s, 0, 0, 1), "scatter"][1] += 2 * h * w * c * 4
    assert got == dict(want)


def test_per_image_normalizes_by_device_batch():
    """The port of JAX's test of the same name. A position of data2 x model2
    at b=2 runs the per-image program of model2 at b=1, so its wire bytes
    over the images it runs (``batch // data`` = 1, not the global 2) equal
    model2's exactly: every position but the first receives its input rows
    and the gathers, as model2's pacing position does. The first position
    also collects the other data group's heads where model2's pacing
    position receives its input: ``measure_mesh_comm`` reports it, the
    pacing position, at exactly model2's bytes less one input image plus
    one image's heads."""
    spec, params, mode = _mini(False)
    _, tp_only = TC.measure_mesh_comm(
        spec, params, TM.make_mesh(2, model=2, device="cpu"), batch=1)
    mesh = TM.make_mesh(4, data=2, model=2, device="cpu")
    fn, sh = TM.make_sharded_predict(spec, params, mesh, mode)
    with TC.recording() as log:
        fn(sh, np.zeros((2, 64, 64, 3), np.float32))
    per_image = {p: TC.wire_bytes(TC.collective_volumes(log, p), 4) / 1
                 for p in TC.positions(log)}
    assert tp_only > 0
    assert all(v == tp_only for p, v in per_image.items() if p != (0, 0, 0))
    _, mixed = TC.measure_mesh_comm(spec, params, mesh, batch=2)
    image = 64 * 64 * 3 * 4
    heads = sum(l.out_h * l.out_w * l.out_c * 4 for l in spec.layers
                if isinstance(l, YoloSpec))
    assert mixed == per_image[(0, 0, 0)] == tp_only - image + heads


def test_measure_mesh_comm_beside_jax_at_model2():
    """mini-yolo3 fp32 at model2, b=1: the port's pacing position against
    JAX's per-device program, per op class as found.

    * all-gather: 8 on both sides; the port's results total 532,480 bytes,
      JAX's 614,400. Both gather after the 2x2/2 maxpool behind conv 0
      (65,536: the pooled map), conv 4's pooled map, conv 6 and the first
      head conv 7. They part at conv 2, whose output a maxpool and route 12
      read: the port gathers it whole (131,072) once, where GSPMD gathers
      the pooled map (32,768) and, at route 12, the concatenation of the
      upsampled conv 10 and conv 2 (196,608); the port gathers conv 10
      (16,384) before the upsample. And at the second head conv 14: the
      port gathers it (98,304) so that every model position holds the
      heads; JAX's program leaves its output sharded.
    * all-to-all: JAX 3 (196,608 bytes), moving the upsampled conv 10
      and the route's pieces between channel layouts; the port has none.
    * collective-permute: the port 1 (49,152 bytes), the input image handed
      from the caller to the second model position; JAX's program takes its
      input already placed on every device (``in_shardings``).

    Per image: the port 315,392 wire bytes, JAX 405,504."""
    spec, params, _ = _mini(False)
    vols, per_image = TC.measure_mesh_comm(
        spec, params, TM.make_mesh(2, model=2, device="cpu"), batch=1)
    jspec = jax_parse(MINI, batch=1)
    jparams = fuse_conv_batchnorm(jspec, random_params(jspec, seed=3))
    jvols, jper_image = JC.measure_mesh_comm(
        jspec, jparams, jax_make_mesh(2, data=1, model=2), batch=1)
    assert vols == {
        "all-gather": {"count": 8, "result_bytes": 532480,
                       "group_bytes": {2: 532480}},
        "collective-permute": {"count": 1, "result_bytes": 49152,
                               "group_bytes": {2: 49152}}}
    assert jvols == {
        "all-gather": {"count": 8, "result_bytes": 614400,
                       "group_bytes": {2: 614400}},
        "all-to-all": {"count": 3, "result_bytes": 196608,
                       "group_bytes": {2: 196608}}}
    assert vols["all-gather"]["count"] == jvols["all-gather"]["count"]
    assert per_image == 315392.0 and jper_image == 405504.0


def test_replicated_pipeline_records_each_replica():
    """2 replicas x pp2 at b=2: each replica, under its index, hands its
    boundary's live set over and its first stage's head to its last stage;
    the second replica receives its image at its first stage and hands its
    heads to the first replica's last stage."""
    spec, params, mode = _mini()
    rp = TP.ReplicatedPipeline(spec, params, mode, replicas=2, n_stages=2,
                               device="cpu")
    x = _x(spec, 2)
    off = [h.data for h in rp(x)[0]]
    with TC.recording() as log:
        on = [h.data for h in rp(x)[0]]
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    heads = sum(l.out_h * l.out_w * l.out_c * 4 for l in spec.layers
                if isinstance(l, YoloSpec))
    want = {((r,) + pos, what): list(v) for r in (0, 1)
            for (pos, what), v in expected_pp(spec, rp.ranges, 1, 1).items()}
    want[(1, 0), "scatter"] = [1, 64 * 64 * 3 * 4]
    want[(0, 1), "collect"][0] += 2
    want[(0, 1), "collect"][1] += heads
    assert recorded(log) == want
