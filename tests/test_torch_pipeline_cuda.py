"""The serving pipeline's graph path on the card, where both transfers run
on the pipeline's copy stream: batches dispatched ahead of their collects,
``stream`` with several finishing threads and ``serve_scan`` give detections
bit-identical to one ``__call__`` at a time. A device sleep queued on the
replays' stream keeps it busy, so the H2Ds take the copy stream, and holds
the replays back while the copies go on: an input block handed to the next
H2D before its replay read it, or an output read before its replay wrote
it, shows in the detections.

They skip without a CUDA device. This file imports neither JAX nor the JAX
package, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_pipeline_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.pipeline import DetectionPipeline

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                   "mini-yolo3.cfg")

pytestmark = pytest.mark.cuda

# device-sleep cycles: about 0.1 s on an H100, far longer than a mini net's
# replays and its frames' copies
_HOLD = 200_000_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graph and its copy "
                    "stream run only on the card")
    return torch.device("cuda")


def _pipe(device_nms):
    spec, params, mode = build_params(CFG, None, quantized=True, seed=3,
                                      echo=False)
    # -quantized at 0.36: about 270 candidates a 480x640 frame, under K
    return DetectionPipeline(spec, params, mode, thresh=0.36, nms=0.4,
                             k=1024, device_nms=device_nms, device="cuda")


def _batches(n=3, b=4):
    """``n`` batches of distinct uint8 480x640 frames (resized on the
    device), 3.7 MB each."""
    return [(np.random.RandomState(20 + i).rand(b, 480, 640, 3) * 255).astype(
        np.uint8) for i in range(n)]


def _hold() -> torch.cuda.Event:
    """Queue the device sleep on the current stream; the event after it."""
    torch.cuda._sleep(_HOLD)
    held = torch.cuda.Event()
    held.record()
    return held


def _assert_identical(got, want):
    assert len(got) == len(want)
    n = 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bbox, b.bbox)
        np.testing.assert_array_equal(a.prob, b.prob)
        np.testing.assert_array_equal(a.objectness, b.objectness)
        n += a.n
    assert n > 0                    # the comparison covers real candidates


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
def test_dispatched_ahead_equal_sequential_calls(dev, device_nms):
    pipe = _pipe(device_nms)
    batches = _batches()
    want = [pipe(x) for x in batches]
    held = _hold()
    tickets = [pipe.dispatch(x) for x in batches]
    assert not held.query()         # no H2D waited behind the sleep
    got = [pipe.collect(t) for t in tickets]
    assert pipe._promoted is None
    for g, w in zip(got, want):
        _assert_identical(g, w)


def test_stream_equals_sequential_calls(dev):
    pipe = _pipe(True)
    batches = _batches(6)
    want = [pipe(x) for x in batches]

    def held():
        torch.cuda._sleep(_HOLD)
        yield from batches
    # stream() corrects to the net dims unless given sizes
    sizes = [[(640, 480)] * len(x) for x in batches]
    got = list(pipe.stream(held(), sizes, depth=3, workers=2))
    assert len(got) == len(batches)
    for g, w in zip(got, want):
        _assert_identical(g, w)


def test_serve_scan_equals_per_frame_calls(dev):
    pipe = _pipe(False)
    frames = _batches(1, 5)[0]
    want = [pipe(frames[i:i + 1])[0] for i in range(len(frames))]
    _hold()
    _assert_identical(pipe.serve_scan(frames), want)
