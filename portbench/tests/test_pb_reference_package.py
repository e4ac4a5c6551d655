"""A configuration brings its own reference package: a net the default
reference cannot run (relu convs) runs through the harness on the package
its configuration names (``tests/ref_relu``), a configuration that cannot
run is refused before its program is built, and the default reference
reads what it read before the harness took it from the configuration."""

import json
import time
import types

import pytest

from portbench import bench, model, readers, readings, trace, traffic
from portbench import work as W
from portbench.tests.conftest import MINI_CFG, parsed
from portbench.traffic import Record

M = bench.load_manifest()
SEED = 2**31 + 71
REQUESTS = 5        # the pinned runs' window, in requests


def _relu_cfg(tmp_path) -> str:
    """The small net with relu convs where it has leaky ones."""
    with open(MINI_CFG) as f:
        text = f.read()
    path = tmp_path / "mini-relu.cfg"
    path.write_text(text.replace("activation=leaky", "activation=relu"))
    return str(path)


def _run(files: dict, cell: str, keep=None) -> dict:
    result, _ = bench.run_cell(M, cell, SEED, 0.3, False, "cpu",
                               time.perf_counter(), files=files,
                               say=lambda s: None, keep=keep)
    return result


def test_a_configuration_runs_on_the_reference_it_names(mini, tmp_path):
    files = mini("f32", "batch64", cfg_path=_relu_cfg(tmp_path),
                 reference="tests.ref_relu")
    keep = {}
    result = _run(files, "yolov3-416-int8.batch64", keep)
    assert keep["net"].ref.__name__ == "portbench.tests.ref_relu"
    assert keep["numbers"]["detections"] > 0
    assert result["correct"], keep["numbers"]


@pytest.mark.parametrize("change,refusal", [
    ({"cfg": "relu"}, "activation 'relu'"),      # the default reference
    ({"reference": "reference.cfg"}, "lacks"),   # not the interface
    ({"program": {"mode": "fp32", "batch": 2}}, "takes no")])
def test_a_configuration_is_refused_before_its_program_is_built(
        mini, tmp_path, monkeypatch, change, refusal):
    cfg = _relu_cfg(tmp_path) if "cfg" in change else MINI_CFG
    files = mini("f32", "batch64", cfg_path=cfg,
                 reference=change.get("reference"))
    if "program" in change:
        with open(files["config"]) as f:
            c = json.load(f)
        with open(files["config"], "w") as f:
            json.dump({**c, "program": change["program"]}, f)
    built = []
    monkeypatch.setattr(model, "build_program", lambda *a: built.append(a))
    with pytest.raises(ValueError, match=refusal):
        _run(files, "yolov3-416-int8.batch64")
    assert not built


# what the harness read on the default reference before a configuration
# named its reference (the same run, this file's seed, on the CPU)
PINNED = {
    "batch64": {
        "bias": -5.468654632568359,
        "numbers": {"unlike_pct": 0.0, "frame_ratio_pct": 0.0,
                    "prob_gap": 0.0, "prob_gap_p50": 0.0, "detections": 24,
                    "answers": 7, "candidates": 21.0},
        "control": {"unlike_pct": 100.0, "frame_ratio_pct": 100.0,
                    "prob_gap": 0.0, "prob_gap_p50": 0.0, "detections": 24,
                    "answers": 7, "candidates": 21.0},
        "bf16": {"unlike_pct": 270.8333333333333,
                 "frame_ratio_pct": 57.82999454624722,
                 "prob_gap": 0.003047363366931677,
                 "prob_gap_p50": 0.0014736256562173367},
    },
    "cam1": {
        "bias": -1.0482076406478882,
        "numbers": {"unlike_pct": 0.0, "frame_ratio_pct": 0.0,
                    "prob_gap": 0.0, "prob_gap_p50": 0.0, "detections": 6,
                    "answers": 6, "candidates": 19.833333333333332},
        "control": {"unlike_pct": 100.0, "frame_ratio_pct": 100.0,
                    "prob_gap": 0.0, "prob_gap_p50": 0.0, "detections": 6,
                    "answers": 6, "candidates": 19.833333333333332},
        "bf16": {"unlike_pct": 433.3333333333333,
                 "frame_ratio_pct": 67.71682181792892,
                 "prob_gap": 0.08507436513900757,
                 "prob_gap_p50": 0.0373622328042984},
    },
}
PINNED_WORK = (1.0402090921843536e-07, 1.3601471044776119e-05,
               1.1463603582089552e-05)


@pytest.mark.parametrize("traffic_name", ["batch64", "cam1"])
def test_the_default_reference_reads_as_before(mini, monkeypatch,
                                               traffic_name):
    """The calibrated bias, the check's numbers, the int4 control's and the
    bf16 reference's judged by them, and the conv work, on the small int8
    net over a window of :data:`REQUESTS` requests."""
    window = traffic.run_window

    def by_requests(pipe, tr, pool, seconds=0, requests=0, **kw):
        return window(pipe, tr, pool,
                      requests=requests or (REQUESTS if seconds else 0), **kw)
    monkeypatch.setattr(traffic, "run_window", by_requests)
    keep = {}
    result = _run(mini("int8", traffic_name),
                  f"yolov3-416-int8.{traffic_name}", keep)
    want = PINNED[traffic_name]
    assert result["correct"]
    assert keep["bias"] == want["bias"]
    assert keep["numbers"] == want["numbers"]
    assert readings.control_numbers(keep, SEED, "cpu") == want["control"]
    bf16 = {**keep, "config": {**keep["config"], "control": "bf16"}}
    got = readings.control_numbers(bf16, SEED, "cpu")
    assert {k: got[k] for k in want["bf16"]} == want["bf16"]
    work = W.conv_work(keep["net"], "int8")
    assert (W.peak_s_per_image(work), W.least_s(work, "int8", 64, 4),
            W.least_s(work, "f32", 64, 4)) == PINNED_WORK


def test_a_package_that_counts_its_own_work_is_asked():
    """``work.conv_work`` takes a package's ``conv_work`` where it has one;
    the peaks stay the harness's, so an arithmetic without a published
    peak has no least time, and no roofline share or mfu reads it."""
    net = parsed()
    own = [W.ConvWork(0, "int8", 100, 1000, 10),
           W.ConvWork(1, "bin", 100, 1000, 10)]
    net.ref = types.SimpleNamespace(conv_work=lambda n, mode: own)
    assert W.conv_work(net, "xnor") is own
    assert W.least_s(own, "int8", 1, 1) == own[0].least_s(1)
    assert W.least_s(own, "bin", 1, 1) is None
    assert W.peak_s_per_image(own) is None
    seg = trace.Segment(t0=0, t1=10**9, images=1, batch=1,
                        kernels=[("xnor_gemm_kernel", 0, 10**6)])
    ctx = readers.Context(config={}, traffic={}, work=own,
                          record=Record(t0=0.0, t1=1.0, images=10),
                          setup_s=1.0, segment=seg)
    assert readers.kernel_roofline(ctx, "bin", "xnor_gemm") is None
    assert readers.mfu(ctx) is None


@pytest.mark.parametrize("extra", [
    {}, {"xnor_impl": "pallas_mxu", "turbo": "int8", "int8_chain": False,
         "letter": True}])
def test_the_program_block_reaches_the_pipeline(mini, monkeypatch, extra):
    """The pipeline's settings that the program block holds are passed on,
    and a block without them makes the call it always made."""
    import torch

    import yolo2_light_tpu_torch.pipeline as pipeline
    files = mini("int8", "cam1")
    config, net = model.load_config(files["config"])
    keys = model.program_keys()
    assert set(config["program"]) | set(extra) <= keys
    assert not keys & set(model.HARNESS_SETS)
    calls = []
    monkeypatch.setattr(pipeline, "DetectionPipeline",
                        lambda *a, **kw: calls.append((a[2], kw)))
    config["program"].update(extra)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    host = model.host_params(net, model.make_weights(net, SEED, "cpu"))
    model.build_program(config, tr, host, "cpu")
    assert calls == [("int8", {
        "thresh": tr["thresh"], "nms": model.nms_of(config, tr), "k": tr["k"],
        "int8_policy": "cpu", "int8_impl": "xla",
        "compute_dtype": torch.float32, "device_nms": tr["device_nms"],
        "device": "cpu", **extra})]
