"""The metric arithmetic on synthetic records and traces."""

import math

import pytest

from portbench import readers, trace, work
from portbench.traffic import Record
from portbench.tests.conftest import ROOT, parsed


def test_union_of_kernel_intervals_and_the_gaps_between():
    assert trace.union([(5, 9), (0, 2), (1, 3), (8, 12), (20, 21)]) == \
        [(0, 3), (5, 12), (20, 21)]
    seg = trace.Segment(t0=0, t1=30, images=2, batch=1,
                        kernels=[("a", 5, 9), ("b", 0, 2), ("a", 1, 3),
                                 ("b", 8, 12), ("a", 20, 21), ("a", 28, 40)])
    assert trace.gaps(seg) == [(3, 5), (12, 20), (21, 28)]
    # 3 + 7 + 1 + 2 of 30 ns busy
    assert seg.busy_s() == pytest.approx(13e-9)
    assert seg.kernel_s(r"^a$") == pytest.approx((4 + 2 + 1 + 2) * 1e-9)


def test_device_idle_counts_kernels_not_copies():
    seg = trace.Segment(t0=0, t1=100, images=1, batch=1,
                        kernels=[("k", 10, 30)], copies=[("Memcpy HtoD", 30, 90)])
    ctx = readers.Context(config={}, traffic={}, work=[], record=Record(),
                          setup_s=0.0, segment=seg)
    assert readers.device_idle(ctx) == pytest.approx(80.0)


def test_idle_gaps_are_labelled_by_the_innermost_host_span_and_op():
    seg = trace.Segment(
        t0=0, t1=100, images=1, batch=1, kernels=[("k", 0, 10), ("k", 60, 100)],
        spans=[("segment", 0, 100), ("dispatch", 5, 50), ("collect", 50, 95)],
        ops=[("cudaGraphLaunch", 20, 30), ("aten::copy_", 12, 40)])
    b = trace.breakdown(seg)
    # the gap 10..60 has its middle at 35: in dispatch, inside the copy only
    assert b["idle_gaps"] == [["dispatch / aten::copy_", pytest.approx(5e-8)]]
    assert b["device_ops"] == [["k", pytest.approx(5e-8)]]


def test_percentiles_by_nearest_rank_over_every_request():
    v = list(range(1, 101))
    assert readers.percentile(v, 95) == 95
    assert readers.percentile(v, 50) == 50
    assert readers.percentile([7.0], 95) == 7.0
    assert readers.percentile([], 95) is None
    rec = Record(latencies=[0.001 * x for x in v])
    ctx = readers.Context(config={}, traffic={}, work=[], record=rec,
                          setup_s=0.0)
    assert readers.latency_ms(ctx, 95) == pytest.approx(95.0)


def test_conv_work_roofline_and_mfu_from_shapes():
    net = parsed()
    w8 = work.conv_work(net, "int8")
    # the first conv and the linear head convs stay float32
    assert [c.arith for c in w8].count("f32") == 3
    first = w8[0]
    l0 = net.convs[0]
    assert first.macs == 64 * 64 * 16 * 3 * 3 * 3
    assert first.bytes == 4 * (64 * 64 * 3) + 4 * 16 * 27 + 4 * 16 \
        + 4 * 64 * 64 * 16
    c = next(c for c in w8 if c.arith == "int8")
    # one image: the larger of bytes and operations at peak
    assert c.least_s(1) == max(c.bytes / work.PEAK_BYTES,
                               2 * c.macs / work.PEAK_OPS["int8"])
    # the weights are read once a launch of 4 images
    assert c.least_s(4) >= c.least_s(1)
    assert work.least_s(w8, "int8", 8, 4) == pytest.approx(
        2 * sum(x.least_s(4) for x in w8 if x.arith == "int8"))
    seg = trace.Segment(t0=0, t1=10**9, images=8, batch=4,
                        kernels=[("void int8_conv_kernel<1>(A)", 0, 10**6)])
    rec = Record(t0=0.0, t1=2.0, images=100)
    ctx = readers.Context(config={}, traffic={}, work=w8, record=rec,
                          setup_s=1.0, segment=seg)
    assert readers.kernel_roofline(ctx, "int8", r"\bint8_conv_kernel\b") == \
        pytest.approx(100 * work.least_s(w8, "int8", 8, 4) / 1e-3)
    assert readers.kernel_roofline(ctx, "bf16", r"\bbf16_conv_kernel") is None
    assert readers.mfu(ctx) == pytest.approx(
        100 * 50 * sum(2 * x.macs / work.PEAK_OPS[x.arith] for x in w8))
    assert readers.images_per_s(ctx) == 50


def test_yolov3_counts_the_published_work():
    net = parsed(f"{ROOT}/portbench/configs/yolov3-416.cfg")
    w = work.conv_work(net, "bf16")
    # darknet prints 65.86 BFLOPs for yolov3-416
    assert math.isclose(2 * sum(c.macs for c in w) / 1e9, 65.864, rel_tol=1e-3)
