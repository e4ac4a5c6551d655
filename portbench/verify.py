"""The comparison that decides ``correct``.

The window's answers are :class:`Answer` s: a sample of the requests it
served, drawn from the seed (:class:`Sample`), each the frame's index in
the pool and the detections the program returned for it (boxes ``[n, 4]``
centre x, y, w, h relative to the frame; class scores ``[n, C]`` after the
threshold and the NMS, zero where there is no detection).

Once the window has closed and the program is freed, the configuration's
plain reference (``net.ref``: ``reference/`` unless the configuration
names another) runs over the sampled frames from the same
weights and gives every candidate of each frame: its box, its scores
before the threshold and after the threshold and the NMS. Each served row
is matched to the candidate whose box lies nearest (largest coordinate
difference), and these numbers are taken over the whole sample:

* ``unlike_pct``: the detections (candidate, class) that one side has and
  the other has not, as a share of the reference's detections, in %;
* ``frame_ratio_pct``: how much better the answers' own frames explain
  them than the other sampled frames do (:func:`_frame_ratio_pct`);
* ``prob_gap``, ``prob_gap_p50``: the largest and the median difference
  between a served detection's score and the reference's score of that
  candidate and class before the threshold.

A cell compares numbers that separate the program's readings on a dozen
seeds from the control's (the reference one precision below, put in the
program's place) on three or more, each against its limit in
``limits/<workload>.json``, which also gives the readings of the numbers
it leaves out.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

import numpy as np
import torch


NUMBERS = ("unlike_pct", "frame_ratio_pct", "prob_gap", "prob_gap_p50")
REF_BLOCK = 8       # frames a reference forward takes at once


@dataclass
class Answer:
    frame: int
    bbox: np.ndarray
    prob: np.ndarray


class Sample:
    """A uniform sample of ``size`` answers out of all offered (reservoir
    sampling, Vitter's algorithm R, from ``seed``), plus the answer with the
    most rows, so the densest frame is always judged. Offering costs the
    window a random draw an answer."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0
        self.densest = None
        self.densest_n = -1

    def offer(self, frame: int, dets) -> None:
        n = len(dets.bbox)
        if n > self.densest_n:
            self.densest_n = n
            self.densest = Answer(frame, dets.bbox, dets.prob)
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(Answer(frame, dets.bbox, dets.prob))
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            self.items[j] = Answer(frame, dets.bbox, dets.prob)

    def answers(self) -> list:
        out = list(self.items)
        if self.densest is not None and all(a is not self.densest
                                            for a in out):
            out.append(self.densest)
        return out


@dataclass
class Truth:
    """The reference's view of one frame: every candidate's box (relative
    to the frame), its class scores before the threshold, and its scores
    after the threshold and the NMS."""
    boxes: np.ndarray
    raw: np.ndarray
    final: np.ndarray


def reference_truths(net, raw_params, pool, frames, arith: str,
                     thresh: float, nms: float, device) -> dict:
    """frame index -> :class:`Truth`, the reference run over the frames of
    ``pool`` (uint8 ``[P, H, W, 3]`` host array) named in ``frames``, in
    blocks of :data:`REF_BLOCK`."""
    ref = net.ref
    prep = ref.prepare(net, raw_params, arith, device)
    out = {}
    idx = sorted(set(frames))
    fh, fw = pool.shape[1], pool.shape[2]
    with torch.inference_mode():
        for s in range(0, len(idx), REF_BLOCK):
            block = idx[s:s + REF_BLOCK]
            x = ref.ingest(torch.from_numpy(pool[block]).to(device),
                           net.w, net.h)
            heads = ref.forward(net, prep, x, arith)
            boxes, raw, kept = (t.cpu().numpy() for t in
                                ref.decode(net, heads, thresh))
            for j, f in enumerate(block):
                bx = ref.correct_boxes(boxes[j], fw, fh, net.w, net.h)
                out[f] = Truth(bx, raw[j], ref.nms(bx, kept[j], nms))
    del prep
    return out


def as_answers(truths: dict, frames: list) -> list:
    """The reference's own detections of ``frames`` in the form of served
    answers: the rows holding a score, as the program returns them (the
    control's answers are made so)."""
    out = []
    for f in frames:
        t = truths[f]
        rows = t.final.max(axis=1) > 0
        out.append(Answer(f, t.boxes[rows].astype(np.float32),
                          t.final[rows].astype(np.float32)))
    return out


def _frame_ratio_pct(entries: list, truths: dict) -> float:
    """How well the answers' own frames explain them against how well the
    other sampled frames do, in %: for each answer, the sum of squared
    differences between its scores and its own frame's reference scores of
    the same candidates and classes, over the mean of that sum taken
    against every other sampled frame; the 75th percentile (nearest rank)
    over the answers. An answer computed from another frame reads about
    100; one computed from its own frame reads less by the share of the
    frames' differences in the whole, even where frames differ little. An
    answer with no detections where its frame has some reads 100. The
    percentile sits among the wrong answers once a quarter of them or more
    are wrong (half a batch, or every answer one request late)."""
    frames = sorted(truths)
    ratios = []
    for f, ii, cc, p in entries:
        if not len(ii):
            if truths[f].final.max(initial=0.0) > 0:
                ratios.append(1.0)
            continue
        p = p.astype(np.float64)
        sq = [float(np.sum((p - truths[g].raw[ii, cc]) ** 2)) for g in frames
              if g != f]
        if sq and sum(sq) > 0:
            own = float(np.sum((p - truths[f].raw[ii, cc]) ** 2))
            ratios.append(own / (sum(sq) / len(sq)))
    if not ratios:
        return 0.0
    ratios.sort()
    return 100.0 * ratios[max(0, math.ceil(0.75 * len(ratios)) - 1)]


def compare(answers: list, truths: dict, thresh: float) -> dict:
    """The numbers over ``answers`` judged by ``truths`` (``thresh``: the
    traffic's, for the count of candidates a frame)."""
    unlike = base = 0
    prob_gaps = []
    entries = []            # per answer: (frame, candidates, classes, scores)
    for a in answers:
        t = truths[a.frame]
        mine = []           # (candidate, class, score) of each detection
        for r in np.nonzero(a.prob.max(axis=1, initial=0.0) > 0)[0]:
            d = np.abs(t.boxes - a.bbox[r].astype(np.float64)).max(axis=1)
            i = int(np.argmin(d))
            for c in np.nonzero(a.prob[r] > 0)[0]:
                p = float(a.prob[r, c])
                mine.append((i, int(c), p))
                prob_gaps.append(abs(p - float(t.raw[i, c])))
        served = {(i, c) for i, c, _ in mine}
        ii, cc, pp = ((np.asarray(v) for v in zip(*mine)) if mine else
                      (np.zeros(0, int), np.zeros(0, int), np.zeros(0)))
        entries.append((a.frame, ii, cc, pp))
        ref = {(int(i), int(c)) for i, c in zip(*np.nonzero(t.final > 0))}
        unlike += len(served ^ ref)
        base += len(ref)
    return {"unlike_pct": 100.0 * unlike / max(1, base),
            "frame_ratio_pct": _frame_ratio_pct(entries, truths),
            "prob_gap": max(prob_gaps, default=0.0),
            "prob_gap_p50": float(np.median(prob_gaps)) if prob_gaps else 0.0,
            "detections": base, "answers": len(answers),
            "candidates": float(np.mean([(truths[a.frame].raw > thresh)
                                         .any(axis=1).sum() for a in answers]))
            if answers else 0.0}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; with none, nothing is compared and the run is not correct."""
    shown = {name: {"value": numbers[name], "limit": limits[name]}
             for name in NUMBERS if name in limits}
    ok = bool(shown) and all(s["value"] <= s["limit"]
                             for s in shown.values())
    return ok, shown
