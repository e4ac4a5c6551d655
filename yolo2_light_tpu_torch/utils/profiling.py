"""Profiling and tracing.

Counterpart of ``yolo2_light_tpu/utils/profiling.py``. The reference's
observability is ad hoc (wall-clock prints around predict,
src/main.c:197-220; per-layer BFLOPs at construction,
src/additionally.c:2903-2907). Here:

* :func:`layer_cost_table`: the static per-layer BFLOPs / params /
  activation-bytes table, the JAX package's text;
* :func:`profile_layers`: measured cumulative time after each layer of one
  eager forward, from CUDA events recorded between the layers on the card
  (the forward queued behind a device sleep, so they time its kernels and
  not the host's dispatch) and from the wall clock on the CPU;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace (``trace.json``) into a directory (``-profile DIR``), with the
  serving pipeline's spans and counters in it;
* the tracer: while a ``torch.profiler`` session is active in the process,
  and at no other time, the serving pipeline (``pipeline.py``) records
  spans, counters and device times into a :class:`Recording`, stamped on
  the profiler's own time base (``time.time_ns``: the Unix epoch, on which
  the profiler stamps its host and device events), so that each of the
  profiler's idle gaps can be put down to what the program was doing.
  :data:`REC` is the recording being filled, or None; each hook of the
  pipeline tests it once (:func:`span` then hands back a shared context
  that does nothing). :func:`recorded` returns the last session's
  recording, kept until the next session starts.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

from ..cfg import ConvSpec, ModelSpec

_SLEEP_HZ = 2.0e9       # device-sleep cycles per second, at least


def layer_cost_table(spec: ModelSpec) -> str:
    """Static cost table: BFLOPs, params, output activation MB per layer."""
    lines = ["idx  type            BFLOPs    params     out-MB"]
    total_bf = 0.0
    total_p = 0
    for l in spec.layers:
        name = type(l).__name__.replace("Spec", "").lower()
        bf = l.bflops if isinstance(l, ConvSpec) else 0.0
        par = (l.n * l.c * l.size * l.size + l.n) if isinstance(l, ConvSpec) else 0
        out_mb = l.outputs * 4 / 1e6
        total_bf += bf
        total_p += par
        lines.append(f"{l.index:3d}  {name:12s} {bf:9.3f} {par:9d} {out_mb:9.2f}")
    lines.append(f"total {total_bf:.3f} BFLOPs, {total_p / 1e6:.1f}M params")
    return "\n".join(lines)


def profile_layers(spec: ModelSpec, params: list, x, *, iters: int = 3,
                   mode: str = "fp32", compute_dtype=None,
                   device="cuda") -> list:
    """Measured cumulative time after each layer of the eager forward.

    Returns ``[(index, layer_name, cumulative_ms, delta_ms)]``, the JAX
    function's rows: the mean over ``iters`` forwards (after warm-up) of
    the time from the forward's start to the end of layer ``index``, and its
    difference to the previous layer's (clamped at 0). ``params``: the host
    params of ``apps/detect.build_params``. On a CUDA ``device`` each layer
    is bracketed by CUDA events on the current stream, and each forward is
    queued behind a device sleep twice as long as one synchronised forward
    takes on the host clock: the host has issued the whole forward before
    the card starts it, so the events time the layers' kernels back to back
    (device time, without the gaps where the card would wait for the
    host). On the CPU the rows are the wall clock.
    """
    from ..models.network import build_forward, device_params, load_kernels

    dev = torch.device(device)
    cd = compute_dtype if compute_dtype is not None else torch.float32
    cuda = dev.type == "cuda"
    marks: dict = {}

    def mark(i: int) -> None:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[i] = ev
        else:
            marks[i] = time.perf_counter()

    fwd = build_forward(spec, mode, compute_dtype=cd, layer_hook=mark)
    dev_params = device_params(spec, params, mode, dev, compute_dtype=cd)
    if cuda:
        load_kernels(spec, mode, compute_dtype=cd)
    xd = torch.as_tensor(x).to(dev, torch.float32)
    cum = [0.0] * spec.n
    with torch.inference_mode():
        fwd(dev_params, xd)              # warm-up: kernels, caches, cuDNN
        if cuda:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fwd(dev_params, xd)
            torch.cuda.synchronize(dev)
            # cycles at the card's top clock (under 2 GHz on an H100)
            sleep = int(2 * (time.perf_counter() - t0) * _SLEEP_HZ)
        for _ in range(iters):
            marks.clear()
            if cuda:
                torch.cuda._sleep(sleep)
            mark(-1)
            fwd(dev_params, xd)
            if cuda:
                torch.cuda.synchronize(dev)
            for i in range(spec.n):
                cum[i] += (marks[-1].elapsed_time(marks[i]) if cuda
                           else (marks[i] - marks[-1]) * 1e3)
    results = []
    prev = 0.0
    for i, l in enumerate(spec.layers):
        c = cum[i] / iters
        results.append((i, type(l).__name__.replace("Spec", ""), c,
                        max(0.0, c - prev)))
        prev = c
    return results


# ---- the tracer -------------------------------------------------------


class Span(NamedTuple):
    """A stretch of the program's host side. ``start``, ``end``: ns on the
    profiler's time base; ``parent``: the ``id`` of the span it opened
    inside (-1: none); ``request``: shared by every span of one request (a
    ``dispatch`` and its ``collect``); ``thread``: the host thread's id."""
    id: int
    name: str
    start: int
    end: int
    parent: int
    request: int
    thread: int


class Counter(NamedTuple):
    """``value`` more of ``name`` at ``at`` (ns), in ``request``."""
    name: str
    at: int
    value: int
    request: int


class DeviceTime(NamedTuple):
    """Device milliseconds of ``stage.<stage>`` of one graph replay, between
    the events captured in the graph at that stage's bounds. ``at``: the
    host ns at which the replay was enqueued."""
    name: str
    at: int
    ms: float
    request: int


class _Open:
    """An open span (:meth:`Recording.span`)."""

    __slots__ = ("rec", "name", "request", "id", "parent", "start", "outer")

    def __init__(self, rec: "Recording", name: str, request):
        self.rec = rec
        self.name = name
        self.request = request

    def __enter__(self) -> "_Open":
        # stamped first and last, so the span's own bookkeeping falls inside
        # it and not in its parent's time outside its children
        self.start = time.time_ns()
        rec = self.rec
        outer = getattr(rec._open, "span", None)
        self.outer = outer
        self.parent = -1 if outer is None else outer.id
        if self.request is None:
            self.request = (next(rec._requests) if outer is None
                            else outer.request)
        self.id = next(rec._ids)
        rec._open.span = self
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec._open.span = self.outer
        rec.spans.append(Span(self.id, self.name, self.start, time.time_ns(),
                              self.parent, self.request,
                              threading.get_ident()))
        return False


class _Off:
    """The span of a hook while nothing records: no request, no start."""

    request = None
    start = 0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Recording:
    """What the program recorded in one profiler session: :attr:`spans`,
    :attr:`counters` and :attr:`device` times, in the order they ended."""

    def __init__(self):
        self.spans: list = []
        self.counters: list = []
        self.device: list = []
        self._ids = itertools.count()
        self._requests = itertools.count()
        self._open = threading.local()      # .span: this thread's innermost

    def span(self, name: str, request=None) -> _Open:
        """A span, as a context manager, inside this thread's open span;
        ``request``: its request id (default: the enclosing span's, or a new
        one at the root)."""
        return _Open(self, name, request)

    def count(self, name: str, value) -> None:
        """``value`` more of ``name``, in the request of the open span."""
        cur = getattr(self._open, "span", None)
        self.counters.append(Counter(name, time.time_ns(), int(value),
                                     -1 if cur is None else cur.request))

    def stages(self, events: list, names, request, at, wait: str,
               inner=()) -> None:
        """Record ``stage.<name>``: the device ms between each two of
        ``events`` (one more than ``names``), of the replay of ``request``
        enqueued at ``at``, inside a span named ``wait`` that waits for the
        last event first; then the same of each ``(name, start event, end
        event)`` of ``inner``, parts of those stages."""
        with self.span(wait):
            events[-1].synchronize()
            for name, a, b in [*zip(names, events, events[1:]), *inner]:
                self.device.append(DeviceTime("stage." + name, at,
                                              a.elapsed_time(b), request))


# the Recording being filled while a torch.profiler session is active, or
# None; set and cleared by the profiler's own start and stop hooks
REC: Recording | None = None
_last = Recording()


def recorded() -> Recording:
    """The recording of the last (or the active) profiler session."""
    return _last


def span(name: str, request=None):
    """The pipeline's span hook: :meth:`Recording.span` of :data:`REC`, or,
    while nothing records, a shared context that does nothing."""
    rec = REC
    return _OFF if rec is None else _Open(rec, name, request)


def _install() -> None:
    """Wrap ``torch.autograd.profiler``'s start and stop hooks, which every
    profiler session runs, so that each session fills a new recording."""
    from torch.autograd import profiler as prof
    if getattr(prof._run_on_profiler_start, "_tracer", False):
        return
    start, stop = prof._run_on_profiler_start, prof._run_on_profiler_stop

    def on_start():
        global REC, _last
        start()
        _last = REC = Recording()

    def on_stop():
        global REC
        REC = None
        stop()

    on_start._tracer = True
    prof._run_on_profiler_start = on_start
    prof._run_on_profiler_stop = on_stop


_install()


def export(rec: Recording, path: str) -> None:
    """Add ``rec`` to the Chrome trace that ``torch.profiler`` wrote to
    ``path``, on that trace's time base: the spans on a track of their own
    (a row a thread), the counters as counter events of their running
    totals, and each device time as a counter event at its replay's
    enqueue."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = "yolo2_light_tpu_torch"
    out = doc["traceEvents"]
    out.append({"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": "yolo2_light_tpu_torch spans"}})
    for s in sorted(rec.spans, key=lambda s: s.start):
        out.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": (s.start - base) / 1e3,
                    "dur": (s.end - s.start) / 1e3,
                    "args": {"id": s.id, "parent": s.parent,
                             "request": s.request}})
    totals: dict = {}
    for c in sorted(rec.counters, key=lambda c: c.at):
        totals[c.name] = totals.get(c.name, 0) + c.value
        out.append({"ph": "C", "name": c.name, "pid": pid,
                    "ts": (c.at - base) / 1e3,
                    "args": {c.name: totals[c.name]}})
    for d in sorted(rec.device, key=lambda d: d.at):
        out.append({"ph": "C", "name": d.name + "_device_ms", "pid": pid,
                    "ts": (d.at - base) / 1e3, "args": {"ms": d.ms}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the CPU and, where there is a card, the
    CUDA activity inside the block, written to ``<log_dir>/trace.json``
    (Chrome trace format: chrome://tracing, Perfetto), with the serving
    pipeline's spans and counters recorded meanwhile (:func:`export`)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    export(recorded(), path)
