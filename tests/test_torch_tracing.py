"""The serving pipeline's tracer (``utils/profiling.py``): spans, counters
and device times recorded while a ``torch.profiler`` session is active, on
the profiler's time base, and nothing at any other time. The CPU cases run
the pipeline's plain path; the cases marked ``cuda`` run the captured
graph on the card (the events at its stage bounds)."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.pipeline import SPLIT, STAGES, DetectionPipeline
from yolo2_light_tpu_torch.utils import profiling

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "mini-yolo3.cfg")
# each span's enclosing span (None: a root); an auto-grow re-runs the request
# inside its collect.regrow
NESTING = {"dispatch": (None, "collect.regrow"), "dispatch.h2d": "dispatch",
           "dispatch.replay": "dispatch", "trace.wait": "dispatch.replay",
           "collect": (None, "collect.regrow"),
           "collect.wait": "collect", "collect.d2h": "collect",
           "collect.saturated": "collect",
           "collect.regrow": "collect", "collect.finish": "collect",
           "finish.nms": "collect.finish"}


def _pipe(device="cpu", **kw):
    spec, params, mode = build_params(CFG, None, quantized=False, seed=3,
                                      echo=False)
    # at 0.4 the random net clears a few candidates a frame: no auto-grow
    args = dict(thresh=0.4, nms=0.4, k=256, device=device)
    args.update(kw)
    return DetectionPipeline(spec, params, mode, **args)


def _frames(b=2, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (b, 64, 64, 3)).astype(np.uint8)


def _session(device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _totals(rec):
    out = {}
    for c in rec.counters:
        out[c.name] = out.get(c.name, 0) + c.value
    return out


def _check_nesting(rec):
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        want = NESTING[s.name]
        want = want if isinstance(want, tuple) else (want,)
        if s.parent == -1:
            assert None in want, s
        else:
            outer = by_id[s.parent]
            assert outer.name in want, (s, outer)
            assert outer.start <= s.start <= s.end <= outer.end
            assert outer.request == s.request


def test_untraced_pipeline_records_nothing():
    pipe = _pipe()
    before = profiling.recorded()
    n = (len(before.spans), len(before.counters), len(before.device))
    pipe(_frames())
    assert profiling.REC is None
    after = profiling.recorded()
    assert after is before
    assert (len(after.spans), len(after.counters), len(after.device)) == n


@pytest.mark.parametrize("device_nms", [False, True])
def test_spans_share_request_and_nest(device_nms):
    pipe = _pipe(device_nms=device_nms)
    with _session():
        assert profiling.REC is not None
        out = pipe(_frames())
    assert profiling.REC is None
    rec = profiling.recorded()
    names = [s.name for s in rec.spans]
    assert {"dispatch", "collect", "collect.d2h", "collect.finish"} <= set(
        names)
    assert len({s.request for s in rec.spans}) == 1
    _check_nesting(rec)
    # finish.nms: the host NMS, a span per frame, only without device NMS
    assert names.count("finish.nms") == (0 if device_nms else len(out))


@pytest.mark.parametrize("device_nms", [False, True])
def test_counters_equal_what_the_call_returned(device_nms):
    pipe = _pipe(device_nms=device_nms)
    x = _frames(3, seed=1)
    packed = pipe.raw(x)
    with _session():
        out = pipe(x)
    got = _totals(profiling.recorded())
    assert got["images"] == len(out) == 3
    assert got["candidates"] == sum(d.n for d in out) > 0
    assert packed.shape[0] == 3
    # the plain path copies nothing to a device
    assert set(got) == {"images", "candidates"}


def test_plain_path_records_no_overlapped():
    """``overlapped`` belongs to the graph path's copy stream: the plain
    path, batches dispatched ahead included, neither records it nor carries
    a replay's event in its tickets."""
    pipe = _pipe()
    with _session():
        a = pipe.dispatch(_frames(seed=11))
        b = pipe.dispatch(_frames(seed=12))
        pipe.collect(a)
        pipe.collect(b)
        list(pipe.stream(iter([_frames(seed=13)] * 3), depth=2))
    assert a[2] is None and b[2] is None
    got = _totals(profiling.recorded())
    assert got["images"] == 10
    assert "overlapped" not in got


def test_requests_dispatched_ahead_keep_their_ids():
    """Two dispatches before their collects: each collect's spans take the
    request id its ticket carries."""
    pipe = _pipe()
    with _session():
        a = pipe.dispatch(_frames(seed=2))
        b = pipe.dispatch(_frames(seed=3))
        pipe.collect(a)
        pipe.collect(b)
    rec = profiling.recorded()
    roots = [(s.name, s.request) for s in
             sorted(rec.spans, key=lambda s: s.start) if s.parent == -1]
    ra, rb = roots[0][1], roots[1][1]
    assert ra != rb
    assert roots == [("dispatch", ra), ("dispatch", rb), ("collect", ra),
                     ("collect", rb)]
    _check_nesting(rec)


def test_regrow_nests_the_rerun_in_the_request():
    """A saturated buffer: each re-run's dispatch and collect sit inside a
    ``collect.regrow`` with the request's id, and only the last collect
    counts the images."""
    pipe = _pipe(thresh=0.35, k=16)
    with _session():
        out = pipe(_frames())
    rec = profiling.recorded()
    got = _totals(rec)
    assert got["images"] == len(out)
    assert len({s.request for s in rec.spans}) == 1
    regrow = [s for s in rec.spans if s.name == "collect.regrow"]
    inner = [s for s in rec.spans if s.name == "dispatch" and s.parent != -1]
    assert len(regrow) == len(inner) >= 1
    _check_nesting(rec)


def test_stream_and_serve_scan_record_the_same_spans():
    pipe = _pipe()
    with _session():
        streamed = list(pipe.stream(iter([_frames(seed=4), _frames(seed=5)]),
                                    depth=2))
    rec = profiling.recorded()
    assert len(streamed) == 2
    assert sorted(s.name for s in rec.spans if s.parent == -1) == [
        "collect", "collect", "dispatch", "dispatch"]
    assert _totals(rec)["images"] == 4
    _check_nesting(rec)
    with _session():
        scanned = pipe.serve_scan(_frames(3, seed=6))
    rec = profiling.recorded()
    assert len({s.request for s in rec.spans}) == 1
    assert _totals(rec)["images"] == len(scanned) == 3
    _check_nesting(rec)


def test_stream_workers_keep_their_requests_apart():
    """More finishing threads than cores, switching often: every request
    keeps one dispatch and one collect, each collect's spans on one thread
    and nested, and the counters add up."""
    pipe = _pipe()
    batches = [_frames(2, seed=s) for s in range(24)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _session():
            out = list(pipe.stream(iter(batches), depth=8,
                                   workers=2 * (os.cpu_count() or 1)))
    finally:
        sys.setswitchinterval(interval)
    rec = profiling.recorded()
    assert len(out) == 24
    roots: dict = {}
    for s in rec.spans:
        if s.parent == -1:
            roots.setdefault(s.request, []).append(s.name)
    assert len(roots) == 24
    assert all(sorted(v) == ["collect", "dispatch"] for v in roots.values())
    by_id = {s.id: s for s in rec.spans}
    assert all(s.thread == by_id[s.parent].thread for s in rec.spans
               if s.parent != -1)
    assert _totals(rec)["images"] == 48
    _check_nesting(rec)


def test_each_session_starts_a_new_recording():
    pipe = _pipe()
    with _session():
        pipe(_frames())
    first = profiling.recorded()
    pipe(_frames())                      # between sessions: kept as it was
    assert profiling.recorded() is first
    n = len(first.spans)
    with _session():
        pipe(_frames(1))
    second = profiling.recorded()
    assert second is not first and len(first.spans) == n
    assert _totals(second)["images"] == 1


def test_program_span_brackets_the_profilers_interval_of_its_op():
    """The shared clock: a span around an aten op holds that op's interval
    as the profiler stamps it."""
    a = torch.randn(256, 256)
    with _session() as prof:
        for _ in range(20):
            with profiling.REC.span("probe"):
                torch.mm(a, a)
    spans = sorted((s.start, s.end) for s in profiling.recorded().spans)
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "aten::mm"
                 and e.device_type() == DeviceType.CPU)
    assert len(spans) == len(ops) == 20
    for (s0, s1), (o0, o1) in zip(spans, ops):
        assert s0 <= o0 <= o1 <= s1


def test_trace_writes_spans_and_counters(tmp_path):
    pipe = _pipe()
    with profiling.trace(str(tmp_path)):
        out = pipe(_frames())
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("pid") == "yolo2_light_tpu_torch"]
    spans = {e["name"]: e for e in ours if e["ph"] == "X"}
    assert {"dispatch", "collect", "collect.finish"} <= set(spans)
    counters = {e["name"]: e["args"][e["name"]] for e in ours
                if e["ph"] == "C"}
    assert counters["images"] == len(out)
    # on the trace's time base: the dispatch span holds the profiler's own
    # events of the forward, which all end before the collect starts
    disp, coll = spans["dispatch"], spans["collect"]
    held = [e for e in events if e.get("ph") == "X"
            and e.get("pid") != "yolo2_light_tpu_torch"
            and e.get("name", "").startswith("aten::conv")
            and disp["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= disp["ts"] + disp["dur"]]
    assert held
    assert all(e["ts"] + e["dur"] <= coll["ts"] for e in held)


def test_hooks_do_nothing_while_off():
    """Off, the span hook hands back one shared context that records
    nothing and carries no request; under a session, a span of its own."""
    off = profiling.span("dispatch")
    assert off is profiling.span("collect", 3)
    with off as s:
        assert s.request is None
    with _session():
        with profiling.span("probe") as s:
            assert s is not off and s.request is not None
    assert [x.name for x in profiling.recorded().spans] == ["probe"]


def test_profile_on_demo_writes_the_pipelines_spans(tmp_path, capsys):
    """``detector demo -profile DIR`` runs the serving pipeline inside the
    trace: DIR/trace.json holds its spans and the images it finished."""
    from yolo2_light_tpu_torch.apps.cli import main
    from yolo2_light_tpu_torch.cfg import parse_network_cfg
    from yolo2_light_tpu_torch.io.rawvideo import write_rawvideo
    from yolo2_light_tpu_torch.weights import random_params, save_weights
    weights = str(tmp_path / "w.weights")
    spec = parse_network_cfg(CFG, batch=1)
    save_weights(spec, random_params(spec, seed=3), weights)
    vid = str(tmp_path / "v.cvs")
    write_rawvideo(vid, list(_frames(3, seed=9)))
    names = tmp_path / "names.txt"
    names.write_text("aaa\nbbb\nccc\n")
    prof = tmp_path / "prof"
    rc = main(["detector", "demo", str(names), CFG, weights, vid,
               "-dont_show", "-fp32", "-thresh", "0.4", "-device", "cpu",
               "-profile", str(prof)])
    capsys.readouterr()
    assert rc == 0
    with open(prof / "trace.json") as f:
        ours = [e for e in json.load(f)["traceEvents"]
                if e.get("pid") == "yolo2_light_tpu_torch"]
    names = {e["name"] for e in ours if e["ph"] == "X"}
    assert {"dispatch", "collect", "collect.finish", "finish.nms"} <= names
    images = [e["args"]["images"] for e in ours
              if e["ph"] == "C" and e["name"] == "images"]
    # the demo pads its tail batch to a batch of 4 (one graph a stream)
    assert images and images[-1] == 4


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graph and its events "
                    "run only on the card")
    return torch.device("cuda")


class _Timed:
    """A graph whose replays an event pair times, outside the graph."""

    def __init__(self, graph):
        self.graph = graph
        self.pairs = []

    def replay(self):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        self.graph.replay()
        b.record()
        self.pairs.append((a, b))


@pytest.mark.cuda
def test_replay_events_and_stage_times_on_the_card(dev):
    """yolov3-416 in float32 at b=1: each replay of the traced graph records
    its four stage times, in order, and they add up to the replay's device
    time as an event pair around it measures it, within 5% (the pair also
    holds the launch); the network stage's two parts on either side of its
    split event (after layer 84, before the first upsample) follow them and
    add up to it."""
    spec, params, mode = build_params(
        os.path.join(os.path.dirname(CFG), "yolov3.cfg"), None,
        quantized=False, seed=3, echo=False)
    pipe = DetectionPipeline(spec, params, mode, thresh=0.3, nms=0.4, k=256,
                             device="cuda")
    x = np.random.RandomState(7).randint(0, 256, (1, 480, 640, 3)).astype(
        np.uint8)
    pipe(x)                               # the untraced graph
    # the random net saturates K: later calls run on the grown pipeline
    live = pipe
    while live._promoted is not None:
        live = live._promoted
    # CPU activity only: under CUDA activity the profiler stretches each
    # launch, which the pair (not the stages) would hold
    with _session():
        pipe(x)                           # captures the traced graph
        traced = [g for key, g in live._graphs.items() if key[-1]]
        assert len(traced) == 1
        timed = traced[0].graph = _Timed(traced[0].graph)
        for _ in range(3):
            pipe(x)
    rec = profiling.recorded()
    _check_nesting(rec)
    names = ["stage." + s for s in STAGES + SPLIT]
    stages = [d for d in rec.device if d.name.startswith("stage.")]
    assert len(stages) == 4 * len(names)
    assert all(d.ms > 0 for d in stages)
    replays = sorted({d.at for d in stages})[1:]
    assert len(replays) == len(timed.pairs) == 3
    for at, (a, b) in zip(replays, timed.pairs):
        mine = [d for d in stages if d.at == at]
        assert [d.name for d in mine] == names
        whole = mine[:len(STAGES)]
        pair = a.elapsed_time(b)
        assert abs(sum(d.ms for d in whole) - pair) <= 0.05 * pair
        down, up = mine[len(STAGES):]
        assert abs(down.ms + up.ms - whole[1].ms) <= 1e-3 * whole[1].ms


@pytest.mark.cuda
def test_untraced_replays_the_graph_without_stage_events(dev):
    pipe = _pipe("cuda", k=256)
    x = _frames(2, seed=8)
    replayed = []
    plain = pipe._replay

    def spy(g, xd, span, out=None):
        replayed.append(g)
        return plain(g, xd, span, out)
    pipe._replay = spy
    pipe(x)
    with _session("cuda"):
        pipe(x)
    pipe(x)
    assert len(replayed) == 3
    untraced, traced, again = replayed
    assert untraced.stages is None and again is untraced
    assert traced.stages is not None and traced is not untraced
    assert len(pipe._graphs) == 2


@pytest.mark.cuda
def test_overlapped_counts_a_finish_under_a_later_replay(dev):
    """``overlapped`` is 1 for a collect whose finish begins while a later
    dispatch's replay is still on the device (held there behind a device
    sleep of about half a second, which the collect's D2H on the copy
    stream does not wait for), and 0 for the last collect and in a closed
    loop."""
    pipe = _pipe("cuda")
    x = _frames(2, seed=10)
    with _session():
        pipe(x)                            # captures the traced graph
        a = pipe.dispatch(x)
        torch.cuda._sleep(1_000_000_000)
        b = pipe.dispatch(_frames(2, seed=11))
        pipe.collect(a)
        assert not b[2].query()           # b's replay still held back
        pipe.collect(b)
        pipe(x)
    rec = profiling.recorded()
    flags = [(c.request, c.value) for c in rec.counters
             if c.name == "overlapped"]
    assert [v for _, v in flags] == [0, 1, 0, 0]
    assert flags[1][0] == a[-1]
    assert _totals(rec)["images"] == 8
    _check_nesting(rec)
