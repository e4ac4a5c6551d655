"""The arithmetic the metric readers in ``metrics/`` share.

A reader is ``read(ctx) -> float | None``: None where the run holds
nothing for it to read, and the harness then leaves the metric out of the
result line. ``ctx`` is a :class:`Context`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import work as W


@dataclass
class Context:
    config: dict
    traffic: dict
    work: list              # work.ConvWork of every conv
    record: object          # traffic.Record of the window
    setup_s: float
    segment: object = None  # trace.Segment of a traced run


def percentile(values: list, p: float) -> float | None:
    """The ``p``-th percentile of every value, by nearest rank: the
    smallest value that at least ``p`` percent of the values do not
    exceed."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]


def images_per_s_of(r) -> float | None:
    """Images completed a second of a window's record."""
    if not r.images or r.window_s <= 0:
        return None
    return r.images / r.window_s


def images_per_s(ctx: Context) -> float | None:
    return images_per_s_of(ctx.record)


def latency_ms(ctx: Context, p: float) -> float | None:
    q = percentile(ctx.record.latencies, p)
    return None if q is None else q * 1e3


def dispatch_ms(ctx: Context) -> float | None:
    """Mean host milliseconds of a ``dispatch`` call in the window."""
    d = ctx.record.dispatch
    return 1e3 * sum(d) / len(d) if d else None


def mfu(ctx: Context) -> float | None:
    """Every conv's operations at the peak of its arithmetic, times the
    images completed a second, in % of the card."""
    rate = images_per_s(ctx)
    peak_s = W.peak_s_per_image(ctx.work)
    if rate is None or peak_s is None:
        return None
    return 100.0 * peak_s * rate


def kernel_roofline(ctx: Context, arith: str, pattern: str) -> float | None:
    """The least time of the convs computed in ``arith`` for the segment's
    images over the device time of the kernels matching ``pattern``, in
    %."""
    seg = ctx.segment
    if seg is None or not seg.images:
        return None
    spent = seg.kernel_s(pattern)
    least = W.least_s(ctx.work, arith, seg.images, seg.batch)
    if spent <= 0 or least is None:
        return None
    return 100.0 * least / spent


def kernel_ms_per_image(ctx: Context, pattern: str) -> float | None:
    seg = ctx.segment
    if seg is None or not seg.images:
        return None
    spent = seg.kernel_s(pattern)
    return 1e3 * spent / seg.images if spent > 0 else None


def device_idle(ctx: Context) -> float | None:
    """The share of the segment in which no kernel ran, in %."""
    seg = ctx.segment
    if seg is None or seg.window_s <= 0 or not seg.kernels:
        return None
    return 100.0 * (1.0 - seg.busy_s() / seg.window_s)
