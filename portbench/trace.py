"""What a profiled segment of a run holds, read from torch.profiler.

:class:`Segment` keeps, for one traced stretch of whole requests, the
device's kernels and copies and the host's spans and operations as
(name, start, end) in nanoseconds, the segment's bounds (the harness's
``segment`` span) and how many images it served. The readers in
``metrics/`` take their numbers from it; :func:`breakdown` gives the
device operations that took most time and the idle gaps by what the host
was doing.
"""

from __future__ import annotations

import heapq
import re
from dataclasses import dataclass, field

SEGMENT_SPAN = "segment"
TOP = 10


@dataclass
class Segment:
    t0: int = 0
    t1: int = 0
    images: int = 0
    batch: int = 1
    kernels: list = field(default_factory=list)   # (name, start, end)
    copies: list = field(default_factory=list)
    spans: list = field(default_factory=list)     # the harness's own spans
    ops: list = field(default_factory=list)       # host operations

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def clipped(self, items: list) -> list:
        return [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in items
                if b > self.t0 and a < self.t1]

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.clipped(self.kernels)
                   if rx.search(n)) * 1e-9

    def busy_s(self) -> float:
        """Seconds in which some kernel ran: the union of the kernels'
        intervals (copies are not counted)."""
        return sum(b - a for a, b in union(
            [(a, b) for _, a, b in self.clipped(self.kernels)])) * 1e-9


def union(intervals: list) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(seg: Segment) -> list:
    """The stretches of the segment in which no kernel ran."""
    busy = union([(a, b) for _, a, b in seg.clipped(seg.kernels)])
    out, t = [], seg.t0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if seg.t1 > t:
        out.append((t, seg.t1))
    return out


def _innermost_at(items: list, times: list) -> list:
    """For each of the ascending ``times``, the name of the interval of
    ``items`` that covers it and opened last (None where none does)."""
    items = sorted(items, key=lambda it: it[1])
    heap, out, k = [], [], 0
    for t in times:
        while k < len(items) and items[k][1] <= t:
            n, a, b = items[k]
            heapq.heappush(heap, (-a, b, n))
            k += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def host_labels(seg: Segment, times: list) -> list:
    """What the host was doing at each of the ascending ``times``: the
    innermost harness span and host operation open then."""
    spans = _innermost_at([s for s in seg.spans if s[0] != SEGMENT_SPAN],
                          times)
    ops = _innermost_at(seg.ops, times)
    return [f"{s or 'harness'} / {o or 'python'}" for s, o in zip(spans, ops)]


def breakdown(seg: Segment) -> dict:
    """The :data:`TOP` device operations by seconds (kernels and copies,
    summed by name) and the idle gaps summed by what the host was doing
    at their middle."""
    by_op: dict = {}
    for n, a, b in seg.clipped(seg.kernels) + seg.clipped(seg.copies):
        by_op[n] = by_op.get(n, 0) + (b - a)
    by_gap: dict = {}
    idle = gaps(seg)
    for (a, b), label in zip(idle, host_labels(seg, [(a + b) // 2
                                                     for a, b in idle])):
        by_gap[label] = by_gap.get(label, 0) + (b - a)

    def top(d):
        return [[n[:160], v * 1e-9] for n, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}


def from_profiler(prof, images: int, batch: int, spans=()) -> Segment:
    """The segment of a finished ``torch.profiler.profile``: its events
    bounded by the harness's ``segment`` span. ``spans``: the names of the
    harness's other spans. On the device, copies are the events named
    ``Memcpy`` or ``Memset``, and every other event is a kernel but the
    harness's spans' device-side marks; on the host, the harness's spans
    are told from the operations by name."""
    from torch.autograd import DeviceType
    seg = Segment(images=images, batch=batch)
    ours = {SEGMENT_SPAN, *spans}
    bounds = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(("Memcpy", "Memset")):
                seg.copies.append((name, a, b))
            elif name not in ours and "Sync" not in name:
                seg.kernels.append((name, a, b))
        elif name in ours:
            seg.spans.append((name, a, b))
            if name == SEGMENT_SPAN:
                bounds = (a, b)
        else:
            seg.ops.append((name, a, b))
    if bounds is None:
        raise RuntimeError("the profile holds no segment span")
    seg.t0, seg.t1 = bounds
    return seg
