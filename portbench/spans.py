"""The arithmetic of the readers in ``metrics/`` that read the program's own
recording: the spans, counters and device times that the serving pipeline
records while a profiler session runs (``profiling.recorded()`` of
``yolo2_light_tpu_torch.utils``). They are stamped on the profiler's time
base, so a reader compares them with the profiled segment's bounds and its
idle gaps (``trace.gaps``) directly, and keeps what lies inside the
segment.

Each function returns None where there is nothing to read: a run without
a segment, a program that records nothing (one without
``profiling.recorded``), or a segment in which the named span, device time
or counter never appears.
"""

from __future__ import annotations

from . import trace


def recording():
    """The program's last recording, or None where the program keeps
    none."""
    try:
        from yolo2_light_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


def _segment_and_recording(ctx):
    seg = ctx.segment
    if seg is None or seg.window_s <= 0 or not seg.images:
        return None, None
    return seg, recording()


def clipped_spans(seg, rec, name: str) -> list:
    """``(start, end)`` of every span named ``name`` that overlaps the
    segment, clipped to its bounds."""
    return [(max(s.start, seg.t0), min(s.end, seg.t1)) for s in rec.spans
            if s.name == name and s.end > seg.t0 and s.start < seg.t1]


def overlap(a: list, b: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_ms(ctx, name: str) -> float | None:
    """Host milliseconds inside the spans named ``name``, a request of the
    segment (its images over its batch)."""
    seg, rec = _segment_and_recording(ctx)
    if rec is None:
        return None
    found = clipped_spans(seg, rec, name)
    if not found:
        return None
    return 1e-6 * sum(b - a for a, b in found) * seg.batch / seg.images


def idle_in(ctx, name: str) -> float | None:
    """The part of the segment in which no kernel ran while the host was in
    a span named ``name``, in % of the segment: the exact overlap of the
    segment's gaps with those spans."""
    seg, rec = _segment_and_recording(ctx)
    if rec is None or not seg.kernels:
        return None
    found = clipped_spans(seg, rec, name)
    if not found:
        return None
    idle = overlap(trace.gaps(seg), trace.union(found))
    return 100.0 * idle / (seg.t1 - seg.t0)


def counted(seg, rec, name: str) -> int:
    """The total of counter ``name`` over the segment."""
    return sum(c.value for c in rec.counters
               if c.name == name and seg.t0 <= c.at <= seg.t1)


def device_ms_per_image(ctx, names) -> float | None:
    """Device milliseconds of the device times named in ``names`` whose
    replay was enqueued in the segment, over the images the program counted
    there."""
    seg, rec = _segment_and_recording(ctx)
    if rec is None:
        return None
    ms = [d.ms for d in rec.device
          if d.name in names and seg.t0 <= d.at <= seg.t1]
    images = counted(seg, rec, "images")
    if not ms or not images:
        return None
    return sum(ms) / images


def counted_per_image(ctx, name: str) -> float | None:
    """The total of counter ``name`` over the segment, over the images the
    program counted there."""
    seg, rec = _segment_and_recording(ctx)
    if rec is None:
        return None
    images = counted(seg, rec, "images")
    if not images or not any(c.name == name for c in rec.counters):
        return None
    return counted(seg, rec, name) / images


def gb_per_s(ctx, counter: str, name: str) -> float | None:
    """The bytes of counter ``counter`` over the segment over the host time
    inside the spans named ``name`` there, in GB/s."""
    seg, rec = _segment_and_recording(ctx)
    if rec is None:
        return None
    ns = sum(b - a for a, b in clipped_spans(seg, rec, name))
    moved = counted(seg, rec, counter)
    if not ns or not moved:
        return None
    return moved / ns
