"""Where a traced benchmark run's idle device time goes, by the serving
pipeline's own spans.

Runs one cell of the benchmark (``portbench``) as ``portbench/run.py
--trace 1`` does, keeps the profiled segment, and reads the program's
recording (``utils/profiling.recorded``) against it:

* the segment's idle time (no kernel running) split by the innermost
  program span open at each instant, cut exactly at the spans' bounds;
* the share of the idle time inside some program span;
* how much of each ``dispatch`` and ``collect`` its child spans cover, and
  for each one under 95% where the rest went: the host us before each
  child and after the last, and how much of it Python's garbage collector
  took;
* the spans, counters and device times a request records, each counter's
  total a request (``overlapped``: the share of requests whose host finish
  began while a later replay was on the device), the host ns one span and
  one counter cost, and the host ms a request of the tracer's own
  ``trace.wait`` (reading the last replay's stage times before a replay);
* the segment's request rate under the profiler;
* the host ms of each span a request, in the segment and in as many
  requests run again after it with the recording set by hand and no
  profiler: how far the profiler stretches each span.

Prints the run's result line, then one JSON line of these (with ``--out``,
writes both to that file too). Needs one CUDA device.

Usage: ``python scripts/trace_split.py --workload yolov3-416-int8.cam1
[--seed 7] [--seconds 10] [--out PATH]``
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

T_START = time.perf_counter()

import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import bench, spans, trace, traffic  # noqa: E402
from yolo2_light_tpu_torch.utils import profiling  # noqa: E402


def idle_by_span(seg, rec) -> dict:
    """Idle ns of the segment by the innermost program span open then
    (``harness``: none), from one sweep over the gaps' and the clipped
    spans' bounds. The program's spans nest within a thread, so the open
    spans form a stack."""
    events = []
    for s in rec.spans:
        a, b = max(s.start, seg.t0), min(s.end, seg.t1)
        if b > a:
            # at one instant ends go before starts, outer starts first
            events.append((a, 1, -b, s.name))
            events.append((b, 0, 0, s.name))
    for a, b in trace.gaps(seg):
        events.append((a, 1, 0, None))
        events.append((b, 0, 0, None))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    out: dict = {}
    stack: list = []
    idle, t = False, seg.t0
    for when, starts, _, name in events:
        if idle and when > t:
            label = stack[-1] if stack else "harness"
            out[label] = out.get(label, 0) + (when - t)
        t = when
        if name is None:
            idle = bool(starts)
        elif starts:
            stack.append(name)
        else:
            # the innermost open span of that name closes
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    return out


def coverage(rec, seg, name: str, collections: list) -> dict:
    """How much of each span ``name`` inside the segment its child spans
    cover: the least and mean share, how many reach 95%, the median host us
    left uncovered before each child and after the last, for the commonest
    order of children, and for each span under 95% its length, its
    uncovered stretches and the part of them inside ``collections`` (the
    garbage collector's runs)."""
    kids: dict = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)
    shares, stretches, under = [], {}, []
    for s in rec.spans:
        if s.name != name or s.start < seg.t0 or s.end > seg.t1:
            continue
        ch = sorted(kids.get(s.id, []), key=lambda c: c.start)
        inside = trace.union([(max(c.start, s.start), min(c.end, s.end))
                              for c in ch if c.end > c.start])
        share = sum(b - a for a, b in inside) / max(1, s.end - s.start)
        shares.append(share)
        t, gaps, holes = s.start, [], []
        for c in ch:
            gaps.append(max(0, c.start - t))
            holes.append((t, max(t, c.start)))
            t = max(t, c.end)
        gaps.append(max(0, s.end - t))
        holes.append((t, max(t, s.end)))
        order = tuple(c.name for c in ch)
        stretches.setdefault(order, []).append(gaps)
        if share < 0.95:
            under.append({
                "share": share, "us": (s.end - s.start) * 1e-3,
                "children": list(order),
                "uncovered_us": [g * 1e-3 for g in gaps],
                "gc_us": 1e-3 * spans.overlap(trace.union(holes),
                                              collections)})
    order, rows = max(stretches.items(), key=lambda kv: len(kv[1]),
                      default=((), []))
    marks = [f"before {n}" for n in order] + ["after the last"]
    median = [sorted(col)[len(col) // 2] * 1e-3 for col in zip(*rows)]
    return {"min": min(shares, default=None),
            "mean": sum(shares) / max(1, len(shares)),
            "at_least_95": sum(x >= 0.95 for x in shares), "of": len(shares),
            "uncovered_us": dict(zip(marks, median)), "under_95": under}


def gc_runs() -> list:
    """Start stamping the garbage collector's runs (Unix ns, the profiler's
    time base); returns the list of ``(start, end)`` it fills."""
    runs: list = []
    started = []

    def stamp(phase, _info):
        if phase == "start":
            started.append(time.time_ns())
        elif started:
            runs.append((started.pop(), time.time_ns()))
    gc.callbacks.append(stamp)
    return runs


def span_ms(rec, t0: int, t1: int, requests: int) -> dict:
    """Host ms of each span name between ``t0`` and ``t1``, a request."""
    out: dict = {}
    for s in rec.spans:
        if t0 <= s.start and s.end <= t1:
            out[s.name] = out.get(s.name, 0) + (s.end - s.start)
    return {k: v * 1e-6 / requests for k, v in sorted(out.items())}


def unprofiled(pipe, tr: dict, pool) -> dict:
    """The traced segment's requests again with a recording set by hand and
    no profiler session: their rate and each span's host ms a request."""
    rec = profiling.REC = profiling.Recording()
    try:
        t0 = time.time_ns()
        n = traffic.run_window(pipe, tr, pool,
                               requests=tr["trace_requests"]).images
        torch.cuda.synchronize()
        t1 = time.time_ns()
    finally:
        profiling.REC = None
    requests = n // tr["batch"]
    return {"requests_per_s": requests / ((t1 - t0) * 1e-9),
            "span_ms": span_ms(rec, t0, t1, requests)}


def hook_ns(n: int = 20000) -> dict:
    """Host ns of one span (open and close) and of one counter."""
    rec = profiling.Recording()
    t = time.perf_counter_ns()
    for _ in range(n):
        with rec.span("x"):
            pass
    span = (time.perf_counter_ns() - t) / n
    with rec.span("x"):
        t = time.perf_counter_ns()
        for _ in range(n):
            rec.count("x", 1)
        count = (time.perf_counter_ns() - t) / n
    return {"span_ns": span, "counter_ns": count}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("trace_split: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    kept = []
    from_profiler = trace.from_profiler

    def keep(*a, **kw):
        kept.append(from_profiler(*a, **kw))
        return kept[-1]
    trace.from_profiler = keep
    manifest = bench.load_manifest()
    collections = gc_runs()
    pipes = []
    result, lines = bench.run_cell(
        manifest, args.workload, args.seed, args.seconds, True, "cuda:0",
        T_START, program_hook=lambda p: pipes.append(p) or p,
        say=lambda s: print(s, file=sys.stderr, flush=True))
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)

    seg, rec = kept[0], profiling.recorded()
    idle = trace.gaps(seg)
    idle_ns = sum(b - a for a, b in idle)
    inside = [s for s in rec.spans if s.end > seg.t0 and s.start < seg.t1]
    covered = spans.overlap(idle, trace.union(
        [(max(s.start, seg.t0), min(s.end, seg.t1)) for s in inside]))
    requests = seg.images // seg.batch
    per_request = {
        "spans": len(inside) / requests,
        "counters": sum(1 for c in rec.counters
                        if seg.t0 <= c.at <= seg.t1) / requests,
        "device_times": sum(1 for d in rec.device
                            if seg.t0 <= d.at <= seg.t1) / requests,
        "counter_totals": {
            n: spans.counted(seg, rec, n) / requests
            for n in sorted({c.name for c in rec.counters})}}
    collected = trace.union([(max(a, seg.t0), min(b, seg.t1))
                             for a, b in collections if b > seg.t0
                             and a < seg.t1])
    cover = {n: coverage(rec, seg, n, collected)
             for n in ("dispatch", "collect")}
    tracer_ms = sum(b - a for a, b in spans.clipped_spans(
        seg, rec, "trace.wait")) * 1e-6 / requests
    files = bench.cell_files(manifest, args.workload)
    with open(files["traffic"]) as f:
        tr = json.load(f)
    pool = traffic.frame_pool(tr, args.seed, torch.device("cuda:0"))
    split = {
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(0),
        "segment_s": seg.window_s, "images": seg.images,
        "requests_per_s": requests / seg.window_s,
        "idle_s": idle_ns * 1e-9,
        "idle_in_some_span": covered / max(1, idle_ns),
        "idle_by_span_s": {k: v * 1e-9 for k, v in sorted(
            idle_by_span(seg, rec).items(), key=lambda kv: -kv[1])},
        "children_cover": cover,
        "span_ms": span_ms(rec, seg.t0, seg.t1, requests),
        "unprofiled": unprofiled(pipes[0], tr, pool),
        "gc_in_segment_ms": sum(b - a for a, b in collected) * 1e-6,
        "per_request": per_request, "trace_wait_ms": tracer_ms,
        "hooks": hook_ns()}
    print(json.dumps(split), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"result": result, "split": split}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
