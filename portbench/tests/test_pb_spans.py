"""The readers of the program's own recording (``spans.py`` and the
metrics that use it) on synthetic segments and recordings, and on a traced
run of the small net on the CPU."""

import time
from types import SimpleNamespace

import pytest

from portbench import bench, readers, spans, trace
from portbench.traffic import Record
from portbench.tests import test_pb_manifest
from yolo2_light_tpu_torch.utils import profiling
from yolo2_light_tpu_torch.utils.profiling import Counter, DeviceTime, Span

M = bench.load_manifest()
NEW = {"host_finish_ms.batch": "yolov3-416-int8.batch64",
       "idle_in_finish.batch": "yolov3-416-int8.batch64",
       "h2d_ms.batch": "yolov3-416-int8.batch64",
       "replay_device_ms.batch": "yolov3-416-int8.batch64",
       "replay_device_ms.cam": "yolov3-416-int8.cam1",
       "idle_in_wait.cam": "yolov3-416-int8.cam1",
       "h2d_ms.cam": "yolov3-416-int8.cam1",
       "host_nms_ms.cam": "yolov3-416-int8.cam1",
       "decode_device_ms.cam": "yolov3-416-int8.cam1",
       "candidates.batch": "yolov3-416-int8.batch64",
       "candidates.cam": "yolov3-416-int8.cam1",
       "h2d_gb_s.batch": "yolov3-416-int8.batch64",
       "h2d_gb_s.cam": "yolov3-416-int8.cam1"}
BETTER = {"h2d_gb_s.batch": "higher", "h2d_gb_s.cam": "higher"}


def _span(name, a, b, request=0):
    return Span(0, name, a, b, -1, request, 0)


# a segment of 1000 ns holding 2 requests of 2 images; kernels leave the
# gaps 200..400 and 900..1000
SEG = trace.Segment(t0=100, t1=1100, images=4, batch=2,
                    kernels=[("k", 100, 200), ("k", 400, 900),
                             ("k", 1000, 1100)])
REC = SimpleNamespace(
    spans=[_span("collect.finish", 0, 50),        # before the segment
           _span("collect.finish", 150, 250),
           _span("collect.finish", 600, 700),
           _span("collect.finish", 1050, 1200),   # clipped to 1050..1100
           _span("collect.wait", 50, 300),        # clipped to 100..300
           _span("collect.wait", 350, 500),
           _span("collect.wait", 880, 960),
           _span("dispatch.h2d", 120, 170),
           _span("finish.nms", 700, 740)],
    counters=[Counter("images", 300, 2, 0), Counter("images", 800, 2, 1),
              Counter("images", 1300, 5, 2),
              Counter("candidates", 300, 30, 0),
              Counter("candidates", 800, 50, 1),
              Counter("candidates", 1300, 99, 2),         # after the segment
              Counter("h2d_bytes", 130, 100, 0)],
    # the stage times of three replays; their sums are 2.0, 3.0 and 9.0 ms
    device=[DeviceTime("stage." + name, at, ms * share, request)
            for at, ms, request in ((150, 2.0, 0), (600, 3.0, 1),
                                    (1200, 9.0, 2))       # after the segment
            for name, share in (("ingest", 0.125), ("network", 0.625),
                                ("decode", 0.125), ("nms", 0.125))])


def _ctx(seg=SEG):
    return readers.Context(config={}, traffic={}, work=[], record=Record(),
                           setup_s=0.0, segment=seg)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(spans, "recording", lambda: REC)


def test_spans_are_clipped_to_the_segment():
    assert spans.clipped_spans(SEG, REC, "collect.finish") == [
        (150, 250), (600, 700), (1050, 1100)]
    assert spans.clipped_spans(SEG, REC, "collect.wait")[0] == (100, 300)


def test_overlap_is_exact():
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], [(10, 20)]) == 0
    assert spans.overlap([(0, 100)], [(10, 20), (30, 40), (90, 120)]) == 30


def test_span_ms_is_per_request(recorded):
    # 100 + 100 + 50 ns over 2 requests
    assert spans.span_ms(_ctx(), "collect.finish") == pytest.approx(125e-6)
    assert spans.span_ms(_ctx(), "collect.regrow") is None


def test_idle_in_counts_the_exact_overlap(recorded):
    """The gap 200..400 lies in collect.wait for 200..300 and 350..400, the
    gap 900..1000 for 900..960: 210 of 1000 ns. Labelled by the middle of
    each gap (300 and 950) the first would count whole or not at all."""
    assert spans.idle_in(_ctx(), "collect.wait") == pytest.approx(21.0)
    # the finish spans meet the gaps only at 200..250
    assert spans.idle_in(_ctx(), "collect.finish") == pytest.approx(5.0)


def test_device_ms_per_image_keeps_the_segments_replays(recorded):
    stages = ("stage.ingest", "stage.network", "stage.decode", "stage.nms")
    assert spans.device_ms_per_image(_ctx(), stages) == pytest.approx(1.25)
    assert spans.device_ms_per_image(_ctx(), ("stage.decode",)) == \
        pytest.approx(0.15625)
    assert spans.device_ms_per_image(_ctx(), ("replay",)) is None


def test_counters_per_image_and_bytes_per_span_second(recorded):
    # 80 candidates of the segment over its 4 images; 100 bytes in 50 ns
    assert spans.counted_per_image(_ctx(), "candidates") == 20.0
    assert spans.counted_per_image(_ctx(), "detections") is None
    assert spans.gb_per_s(_ctx(), "h2d_bytes", "dispatch.h2d") == 2.0
    assert spans.gb_per_s(_ctx(), "d2h_bytes", "collect.d2h") is None


@pytest.mark.parametrize("name,want", [
    ("host_finish_ms.batch", 125e-6), ("idle_in_finish.batch", 5.0),
    ("h2d_ms.batch", 25e-6), ("replay_device_ms.batch", 1.25),
    ("replay_device_ms.cam", 1.25), ("idle_in_wait.cam", 21.0),
    ("h2d_ms.cam", 25e-6), ("host_nms_ms.cam", 20e-6),
    ("decode_device_ms.cam", 0.15625), ("candidates.batch", 20.0),
    ("candidates.cam", 20.0), ("h2d_gb_s.batch", 2.0),
    ("h2d_gb_s.cam", 2.0)])
def test_each_new_reader(recorded, name, want):
    assert bench.reader(name)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_reader_finds_nothing_without_a_segment_or_a_recording(
        monkeypatch, name):
    assert bench.reader(name)(_ctx(None)) is None
    # a program that keeps no recording (the parent of the tracer)
    monkeypatch.delattr(profiling, "recorded")
    assert spans.recording() is None
    assert bench.reader(name)(_ctx()) is None


def test_the_manifest_with_the_new_entries_still_passes():
    layer = {m["name"]: m for m in M["per_layer"]}
    for name, cell in NEW.items():
        m = layer[name]
        assert m["workloads"] == [cell]
        assert m["better"] == BETTER.get(name, "lower")
        assert m["source"] in ("program_span", "program_counter")
    # the new entries come after every entry the benchmark had
    names = [m["name"] for m in M["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for test in (test_pb_manifest.test_top_level_keys_command_and_paths,
                 test_pb_manifest.test_names_units_and_lines_use_only_the_allowed_characters,
                 test_pb_manifest.test_every_layer_metric_is_reported_where_the_metric_it_moves_is,
                 test_pb_manifest.test_every_named_file_is_there):
        test()


def test_a_traced_run_of_the_small_net_reads_the_programs_spans(mini):
    """cam1 on the CPU: the plain path has no graph and no kernels, so only
    the host's spans are there to read; the host NMS is."""
    files = mini("int8", "cam1")
    result, _ = bench.run_cell(M, "yolov3-416-int8.cam1", 2**31 + 53, 0.3,
                               True, "cpu", time.perf_counter(), files=files,
                               say=lambda s: None)
    assert result["correct"]
    got = result["metrics"]
    assert got["host_nms_ms.cam"]["value"] > 0
    assert got["host_nms_ms.cam"]["unit"] == "ms"
    assert got["candidates.cam"]["value"] > 0
    for name in ("replay_device_ms.cam", "decode_device_ms.cam",
                 "idle_in_wait.cam", "h2d_ms.cam", "h2d_gb_s.cam"):
        assert name not in got
