"""The one traffic generator: a traffic file's parameters drive the program.

A traffic file (``traffic/<name>.json``) gives:

* ``pool``, ``frame``: how many uint8 frames of shape ``frame`` (H, W, C)
  are made from the seed and held in host memory before the window;
* ``loop``: ``batch_ahead`` (offline detection as ``detector map`` feeds
  the pipeline: batches of ``batch`` frames, the next dispatched before
  the last is collected) or ``closed`` (one client at a time: the next
  frame goes when the last one's detections are back);
* ``thresh``, ``nms`` (``nms_<mode>`` for one mode), ``k``,
  ``device_nms``: the pipeline's settings; ``candidates``: about how many
  candidates a frame clears the threshold with (the objectness bias is
  calibrated to it);
* ``sample``: how many served frames the check compares;
* ``trace_warm``, ``trace_requests``: the traced run's requests before the
  profiled segment and in it.

Frames are taken from the pool in order, round and round; every seed sends
the same sizes at the same pace, only the pixels differ.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch

from .model import sub_seed
from .verify import Sample


def frame_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """``pool`` uint8 frames ``[P, H, W, C]`` in host memory, made on the
    device from the seed."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "frames"))
    shape = (traffic["pool"], *traffic["frame"])
    x = torch.randint(0, 256, shape, generator=g, device=device,
                      dtype=torch.uint8)
    return x.cpu().numpy()


@dataclass
class Record:
    """What a window recorded: host seconds of each request's latency and
    of each dispatch and collect call, images completed, the window's
    bounds."""
    t0: float = 0.0
    t1: float = 0.0
    attempted: int = 0
    failed: int = 0
    images: int = 0
    latencies: list = field(default_factory=list)
    dispatch: list = field(default_factory=list)
    collect: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def _batches(traffic: dict, pool: np.ndarray) -> list:
    b = traffic["batch"]
    return [(i, pool[i:i + b]) for i in range(0, len(pool) - b + 1, b)]


SPANS = ("dispatch", "collect")


def _span(name: str):
    return torch.profiler.record_function(name)


def run_window(pipe, traffic: dict, pool: np.ndarray, seconds: float = 0,
               requests: int = 0, sample: Sample | None = None,
               spans: bool = False) -> Record:
    """Drive ``pipe`` with the traffic for ``seconds``, or for ``requests``
    requests (batches or frames) where ``seconds`` is 0, and record it;
    served answers go to ``sample``. With ``spans`` each dispatch and
    collect is a profiler span."""
    rec = Record()
    now = time.perf_counter
    rec.t0 = now()
    if seconds > 0:
        deadline = rec.t0 + seconds

        def more(_):
            return now() < deadline
    else:
        def more(i):
            return i < requests
    if traffic["loop"] == "batch_ahead":
        _batch_ahead(pipe, traffic, pool, more, sample, spans, rec)
    elif traffic["loop"] == "closed":
        _closed(pipe, pool, more, sample, spans, rec)
    else:
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    rec.t1 = now()
    return rec


def _failed(rec: Record, n: int) -> None:
    rec.failed += n
    if rec.failed == n:
        traceback.print_exc()


def _closed(pipe, pool, more, sample, spans, rec) -> None:
    now = time.perf_counter
    n = len(pool)
    j = 0
    while more(j):
        f = j % n
        x = pool[f:f + 1]
        rec.attempted += 1
        t0 = now()
        try:
            if spans:
                with _span("dispatch"):
                    ticket = pipe.dispatch(x)
                t1 = now()
                with _span("collect"):
                    dets = pipe.collect(ticket)
            else:
                ticket = pipe.dispatch(x)
                t1 = now()
                dets = pipe.collect(ticket)
        except Exception:
            _failed(rec, 1)
            j += 1
            continue
        t2 = now()
        rec.dispatch.append(t1 - t0)
        rec.collect.append(t2 - t1)
        rec.latencies.append(t2 - t0)
        rec.images += 1
        if sample is not None:
            sample.offer(f, dets[0])
        j += 1


def _batch_ahead(pipe, traffic, pool, more, sample, spans, rec) -> None:
    now = time.perf_counter
    batches = _batches(traffic, pool)
    inflight = None
    i = 0
    while True:
        nxt = None
        go = more(i)
        if go:
            first, x = batches[i % len(batches)]
            rec.attempted += len(x)
            t0 = now()
            try:
                if spans:
                    with _span("dispatch"):
                        nxt = (pipe.dispatch(x), first, len(x))
                else:
                    nxt = (pipe.dispatch(x), first, len(x))
                rec.dispatch.append(now() - t0)
            except Exception:
                _failed(rec, len(x))
            i += 1
        if inflight is not None:
            ticket, first, b = inflight
            t0 = now()
            try:
                if spans:
                    with _span("collect"):
                        dets = pipe.collect(ticket)
                else:
                    dets = pipe.collect(ticket)
                rec.collect.append(now() - t0)
                rec.images += b
                if sample is not None:
                    for k, d in enumerate(dets):
                        sample.offer(first + k, d)
            except Exception:
                _failed(rec, b)
        inflight = nxt
        if inflight is None and not go:
            break


def traced_segment(pipe, traffic: dict, pool: np.ndarray):
    """The traced run's profiled stretch: ``trace_warm`` requests (a
    profiler may miss the first kernels of its session), then
    ``trace_requests`` whole requests inside the ``segment`` span, each
    stretch drained before the next. Returns (profiler, images)."""
    from torch.profiler import ProfilerActivity, profile

    from .trace import SEGMENT_SPAN

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_window(pipe, traffic, pool, requests=traffic["trace_warm"])
        with _span(SEGMENT_SPAN):
            images = run_window(pipe, traffic, pool,
                                requests=traffic["trace_requests"],
                                spans=True).images
    return prof, images
