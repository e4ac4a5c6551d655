"""yolov4 in the benchmark: its configuration and cell in BENCHMARK.json,
the per-layer metrics of yolov3's batch64 cell that read it too, its
reference package (``portbench/yolov4``), a whole run of the harness on the
small yolov4 net on the CPU, and those readers on yolov4's work and on
synthetic segments."""

import json
import os
import time

import pytest

from portbench import bench, model, readers, trace, work
from portbench import yolov4 as ref
from portbench.tests.conftest import ROOT
from portbench.traffic import Record

M = bench.load_manifest()
CELL = "yolov4-416-int8.batch64"
CONFIG = os.path.join(ROOT, "portbench", "configs", "yolov4-416-int8.json")
MINI = os.path.join(ROOT, "tests", "data", "mini-yolov4.cfg")
# the per-layer metrics of yolov3-416-int8.batch64 that read the new cell
SHARED = ("host_dispatch_ms.batch", "mfu.batch", "nms_device_ms.batch",
          "device_idle.batch")
SEED = 2**31 + 4141


def test_the_manifest_gains_the_configuration_and_its_cell():
    assert M["configs"][-1]["name"] == "yolov4-416-int8"
    assert M["configs"][-1]["file"] == "portbench/configs/yolov4-416-int8.json"
    assert M["configs"][-1]["reduced"] == []
    cell = M["workloads"][-1]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) == (
        CELL, "yolov4-416-int8", "batch64", 1)
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["img_s"]["workloads"] == ["yolov3-416-int8.batch64", CELL]
    # new cells are appended to accepted metrics' lists; no entry is added
    for m in M["per_layer"]:
        assert m["workloads"] == (["yolov3-416-int8.batch64", CELL]
                                  if m["name"] in SHARED else
                                  [w for w in m["workloads"] if w != CELL])
    assert [m["name"] for m in bench.metrics_of(M, CELL, False)] == [
        "img_s", "setup_s"]
    assert [m["name"] for m in bench.metrics_of(M, CELL, True)] == list(
        SHARED)
    assert all(m["moves"] == "img_s" for m in bench.metrics_of(M, CELL, True))
    files = bench.cell_files(M, CELL)
    assert all(os.path.exists(p) for p in files.values())
    with open(files["limits"]) as f:
        assert json.load(f)["unlike_pct"] == 2.0


def test_the_configuration_names_its_reference_and_the_yolov3_program():
    config, net = model.load_config(CONFIG)
    assert net.ref is ref
    with open(os.path.join(ROOT, "portbench", "configs",
                           "yolov3-416-int8.json")) as f:
        v3 = json.load(f)
    for k in ("program", "arith", "control", "assumed"):
        assert config[k] == v3[k]
    assert config["kernels"] == ["int8_conv", "int8_conv_mish"]
    w = work.conv_work(net, "int8")
    assert [c.arith for c in w].count("int8") == 106
    assert round(2 * sum(c.macs for c in w) / 1e9, 2) == 60.10


def _mini_files(tmp_path) -> dict:
    """The new cell's files, cut to the small yolov4 net and a test's
    size."""
    net = ref.parse(MINI)
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg.update(cfg=MINI, shape={
        "input": [net.h, net.w, net.c], "layers": len(net.layers),
        "convs": len(net.convs), "classes": [3],
        "params": ref.count_params(net)}, kernels=[])
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "batch64.json")) as f:
        tr = json.load(f)
    tr.update(pool=8, frame=[48, 64, 3], batch=4, sample=6, trace_warm=1,
              trace_requests=2, candidates=20)
    files = {}
    for kind, body in (("config", cfg), ("traffic", tr),
                       ("limits", {"unlike_pct": 2.0})):
        p = tmp_path / f"{kind}.json"
        p.write_text(json.dumps(body))
        files[kind] = str(p)
    return files


def test_a_run_of_the_small_yolov4_net_is_correct_on_its_reference(tmp_path):
    keep = {}
    result, _ = bench.run_cell(M, CELL, SEED, 0.3, False, "cpu",
                               time.perf_counter(),
                               files=_mini_files(tmp_path),
                               say=lambda s: None, keep=keep)
    assert keep["net"].ref is ref
    assert keep["numbers"]["detections"] > 0
    assert keep["numbers"]["unlike_pct"] == 0
    assert result["correct"] and result["metrics"]["img_s"]["value"] > 0


# ---- the readers -------------------------------------------------------


def _ctx(segment=None, rate_images=0):
    config, net = model.load_config(CONFIG)
    return readers.Context(
        config=config, traffic={}, work=work.conv_work(net, "int8"),
        record=Record(t0=0.0, t1=2.0, images=rate_images), setup_s=1.0,
        segment=segment)


def test_mfu_batch_reads_the_whole_steps_share_over_yolov4s_work():
    ctx = _ctx(rate_images=2000)
    assert len(ctx.work) == 110
    assert bench.reader("mfu.batch")(ctx) == pytest.approx(
        100 * 1000 * work.peak_s_per_image(ctx.work))


def test_the_device_readers_take_yolov4s_kernels_and_idle_share():
    """The NMS kernels and the idle share are read by kernel name and
    interval, whatever the network; K1's mish form is busy time like any
    other kernel."""
    seg = trace.Segment(t0=0, t1=10**9, images=128, batch=64, kernels=[
        ("void (anonymous namespace)::int8_conv_mish_kernel<1>(A)", 0,
         4 * 10**8),
        ("void nms_order_kernel(A)", 5 * 10**8, 6 * 10**8),
        ("void nms_walk_kernel(A)", 6 * 10**8, 7 * 10**8)])
    assert bench.reader("nms_device_ms.batch")(_ctx(seg)) == \
        pytest.approx(200 / 128)
    assert bench.reader("device_idle.batch")(_ctx(seg)) == pytest.approx(40)
    assert bench.reader("device_idle.batch")(_ctx()) is None


def test_host_dispatch_reads_the_windows_dispatch_calls():
    ctx = _ctx()
    ctx.record.dispatch = [0.002, 0.004]
    assert bench.reader("host_dispatch_ms.batch")(ctx) == pytest.approx(3.0)
