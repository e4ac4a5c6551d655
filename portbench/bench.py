"""One run of one cell of the benchmark (``run.py`` is its command).

The cell (``--workload``) is found in ``BENCHMARK.json`` at the root of
the checkout; its configuration, traffic and metrics are files under
``portbench/`` found by their names: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py`` and
``limits/<workload>.json``, the limits of the check.

A run: set-up (weights and frames from the seed, the objectness bias
calibrated on the reference, the program built, one pass over the frame
pool so every shape is captured and every kernel built), the measured
window of ``--seconds``, with ``--trace 1`` a profiled segment of whole
requests after it, then the check of a sample of the window's answers
against the reference, once the program is freed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

import torch

from . import model, readers, trace, traffic, verify
from . import work as W

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "yolo2_light_tpu")


def load_manifest(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell: str, traced: bool) -> list:
    """The cell's end-to-end metrics (every one without ``workloads``,
    and those whose ``workloads`` name the cell), or with ``traced`` its
    per-layer ones: those whose ``workloads``, which each must have, name
    the cell."""
    if traced:
        return [m for m in manifest["per_layer"] if cell in m["workloads"]]
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def config_path(manifest: dict, name: str) -> str:
    for c in manifest["configs"]:
        if c["name"] == name:
            return os.path.join(ROOT, c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cell_files(manifest: dict, cell_name: str) -> dict:
    """The cell's configuration, traffic and limits files."""
    cell = cell_of(manifest, cell_name)
    return {"config": config_path(manifest, cell["config"]),
            "traffic": os.path.join(HERE, "traffic",
                                    f"{cell['traffic']}.json"),
            "limits": os.path.join(HERE, "limits", f"{cell_name}.json")}


def run_cell(manifest: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, files=None,
             program_hook=None, say=print, keep=None) -> tuple:
    """One run; returns (result dict, check lines). Tests may give other
    ``files`` (:func:`cell_files`' keys) and a ``program_hook`` that wraps
    the program before the set-up's pass; ``keep``, a dict, receives what
    the check compared (``readings.py``)."""
    files = {**cell_files(manifest, cell_name), **(files or {})}
    config, net = model.load_config(files["config"])
    tr = _json(files["traffic"])
    limits = _json(files["limits"])
    dev = torch.device(device)
    nms = model.nms_of(config, tr)

    t = time.perf_counter()
    if dev.type == "cuda":
        model.prebuild(config, tr)
    say(f"set-up: kernels built or found in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    pool = traffic.frame_pool(tr, seed, dev)
    raw = model.make_weights(net, seed, dev)
    t_calib = time.perf_counter()
    bias = model.calibrate_obj_bias(net, raw, pool[:model.CALIB_FRAMES],
                                    config["arith"], tr["thresh"],
                                    tr["candidates"], dev)
    _sync(dev)
    # the calibration runs the reference's forward: it sets the traffic's
    # candidates and is no part of the program's set-up
    calib_s = time.perf_counter() - t_calib
    model.set_obj_bias(net, raw, bias)
    host = model.host_params(net, raw)
    del raw
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    say(f"set-up: frames, weights, objectness bias {bias} in "
        f"{time.perf_counter() - t:.3f} s, of which the calibration on the "
        f"reference {calib_s:.3f} s (not counted)")
    t = time.perf_counter()
    pipe = model.build_program(config, tr, host, dev)
    del host
    if program_hook is not None:
        pipe = program_hook(pipe)
    say(f"set-up: program built in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    traffic.run_window(pipe, tr, pool,
                       requests=max(1, tr["pool"] // tr["batch"]))
    _sync(dev)
    say(f"set-up: pass over the pool in {time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t_start - calib_s

    sample = verify.Sample(tr["sample"], model.sub_seed(seed, "sample"))
    gc.collect()
    rec = traffic.run_window(pipe, tr, pool, seconds=seconds, sample=sample)
    say(f"window: {rec.images} images in {rec.window_s:.3f} s, "
        f"{rec.failed} failed of {rec.attempted}; dispatch "
        f"{readers.percentile(rec.dispatch, 50)} s, collect "
        f"{readers.percentile(rec.collect, 50)} s (medians); img/s "
        f"{readers.images_per_s_of(rec)}, p50 {readers.percentile(rec.latencies, 50)}"
        f" s, p95 {readers.percentile(rec.latencies, 95)} s")
    segment = None
    if traced:
        prof, images = traffic.traced_segment(pipe, tr, pool)
        segment = trace.from_profiler(prof, images, tr["batch"],
                                      traffic.SPANS)
        del prof
        say(f"segment: {images} images in {segment.window_s:.6f} s, "
            f"{len(segment.kernels)} kernels, {len(segment.copies)} copies, "
            f"busy {segment.busy_s():.6f} s")
    memory = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
              else 0)
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    raw = model.set_obj_bias(net, model.make_weights(net, seed, dev), bias)
    answers = sample.answers()
    truths = verify.reference_truths(net, raw, pool, [a.frame for a in answers],
                                     config["arith"], tr["thresh"], nms, dev)
    del raw
    numbers = verify.compare(answers, truths, tr["thresh"])
    ok, shown = verify.judge(numbers, limits)
    if keep is not None:
        keep.update(numbers=numbers, answers=answers, truths=truths, net=net,
                    config=config, traffic=tr, pool=pool, bias=bias, nms=nms)
    say(f"check: {numbers['answers']} answers, {numbers['detections']} "
        f"reference detections, in {time.perf_counter() - t:.3f} s")

    ctx = readers.Context(config=config, traffic=tr,
                          work=W.conv_work(net, config["arith"]),
                          record=rec, setup_s=setup_s, segment=segment)
    metrics = {}
    for m in metrics_of(manifest, cell_name, traced):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": memory}
    result = {"correct": bool(ok and rec.failed == 0 and rec.images > 0),
              "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device_info}
    if segment is not None:
        device_info["busy_s"] = segment.busy_s()
        device_info["window_s"] = segment.window_s
        result["breakdown"] = trace.breakdown(segment)
    result["check"] = shown
    lines = [f"check {k}: {v['value']!r} against the limit {v['limit']!r}"
             f" ({'within' if v['value'] <= v['limit'] else 'BEYOND'})"
             for k, v in shown.items()]
    lines.append(f"check: failed requests {rec.failed} against the limit 0")
    return result, lines


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(args, t_start: float) -> int:
    manifest = load_manifest()
    cell = cell_of(manifest, args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is false; the benchmark "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} GPUs, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the host side of a run is one thread's: no CPU op of the timed path
    # needs a pool, and idle pool threads spinning on other cores make the
    # host's timings spread
    torch.set_num_threads(1)
    result, lines = run_cell(manifest, args.workload, args.seed,
                             args.seconds, bool(args.trace), "cuda:0",
                             t_start,
                             say=lambda s: print(s, file=sys.stderr,
                                                 flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules {bad} are loaded; the benchmark and the "
              "program may not load JAX or the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
