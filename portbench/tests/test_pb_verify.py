"""The comparison that decides ``correct``, on made-up frames: what an
answer as the reference gives it, an empty one and an unsuppressed one
read."""

import numpy as np
import pytest

from portbench import verify
from portbench.reference import post

THRESH, NMS = 0.25, 0.4
# 0 and 1 overlap (1 is suppressed); 2 stands alone; 3 is under the
# threshold
BOXES = [[0.2, 0.2, 0.2, 0.2], [0.21, 0.2, 0.2, 0.2], [0.6, 0.6, 0.2, 0.2],
         [0.9, 0.1, 0.05, 0.05]]
SCORES = [0.9, 0.5, 0.6, 0.1]


def _truth(scores):
    boxes = np.asarray(BOXES, np.float64)
    raw = np.asarray(scores, np.float64)[:, None]
    kept = np.where(raw > THRESH, raw, 0.0)
    return verify.Truth(boxes, raw, post.nms(boxes, kept, NMS))


def _answer(t, rows):
    rows = np.asarray(rows, int)
    return verify.Answer(0, t.boxes[rows].astype(np.float32),
                         t.raw[rows].astype(np.float32))


@pytest.mark.parametrize("rows,unlike,ratio", [
    ([0, 2], 0.0, 0.0),           # the reference's own answer
    ([], 100.0, 100.0),           # every detection left out
    ([0, 1, 2], 50.0, 0.0)])      # the NMS skipped: frame_ratio cannot see it
def test_an_answer_reads_what_it_gets_wrong(rows, unlike, ratio):
    t = _truth(SCORES)
    truths = {0: t, 1: _truth([s * 0.5 for s in SCORES])}
    a = (_answer(t, rows) if rows else
         verify.Answer(0, np.zeros((0, 4), np.float32),
                       np.zeros((0, 1), np.float32)))
    n = verify.compare([a], truths, THRESH)
    assert n["unlike_pct"] == pytest.approx(unlike)
    assert n["frame_ratio_pct"] == pytest.approx(ratio)
