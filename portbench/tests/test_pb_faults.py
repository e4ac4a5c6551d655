"""Whole runs with the timed path broken underneath the harness: each
fault a cell can have makes ``correct`` false, and the sound program
makes it true, each cell held to its own limits
(``limits/<workload>.json``).

On the CPU the small net runs every cell (its plain path repeats the
reference's arithmetic, so the sound program reads no gap); the card runs
every cell at its own size (``cuda``)."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import bench, model

M = bench.load_manifest()
LIMITS = os.path.join(bench.HERE, "limits")


class Faulty:
    """The program with one fault where its answers are produced."""

    def __init__(self, pipe, fault: str):
        self.pipe, self.fault, self.last = pipe, fault, None

    def dispatch(self, x):
        return self.pipe.dispatch(x)

    def collect(self, ticket):
        dets = self.pipe.collect(ticket)
        if self.fault == "stale":
            # the state handed back unchanged: the last request's answer
            last, self.last = self.last, dets
            return last or dets
        if self.fault == "half_batch":
            # half of the batch left out: its frames get the other half's
            half = len(dets) // 2
            return dets[:len(dets) - half] + dets[:half]
        if self.fault == "altered":
            # every score moved to the next class and halved
            for d in dets:
                d.prob = np.roll(d.prob, 1, axis=1) * np.float32(0.5)
        if self.fault == "empty":
            # every answer without its detections
            for d in dets:
                d.bbox, d.prob = d.bbox[:0], d.prob[:0]
        return dets


def _faulty(fault: str, monkeypatch):
    """The program hook of ``fault``; for ``nms_skipped`` the program is
    built with its NMS off (device NMS too), as a flag lost on the way to
    the pipeline would leave it."""
    if fault is None:
        return None
    if fault == "nms_skipped":
        build = model.build_program

        def without_nms(config, tr, host, device):
            return build(config, {**tr, "nms": 0.0, "nms_int8": 0.0}, host,
                         device)
        monkeypatch.setattr(model, "build_program", without_nms)
        return None
    return lambda p: Faulty(p, fault)


def _run(mini, cell, arith, traffic, fault, monkeypatch):
    with open(os.path.join(LIMITS, f"{cell}.json")) as f:
        limits = json.load(f)
    files = mini(arith, traffic, limits)
    hook = _faulty(fault, monkeypatch)
    result, _ = bench.run_cell(M, cell, 2**31 + 29, 0.3, False, "cpu",
                               time.perf_counter(), files=files,
                               program_hook=hook, say=lambda s: None)
    return result


CASES = [("yolov3-416-int8.batch64", "int8", "batch64"),
         ("yolov3-416-int8.cam1", "int8", "cam1")]
FAULTS = {"batch64": [None, "stale", "altered", "half_batch", "empty",
                      "nms_skipped"],
          "cam1": [None, "stale", "altered", "empty", "nms_skipped"]}
ON_CPU = [(cell, arith, traffic, fault) for cell, arith, traffic in CASES
          for fault in FAULTS[traffic]]
ON_CARD = [(cell, traffic, fault) for cell, _, traffic in CASES
           for fault in FAULTS[traffic]]


@pytest.mark.parametrize("cell,arith,traffic,fault", ON_CPU)
def test_a_fault_makes_the_small_net_incorrect(mini, cell, arith, traffic,
                                               fault, monkeypatch):
    result = _run(mini, cell, arith, traffic, fault, monkeypatch)
    assert result["correct"] == (fault is None)
    assert list(result)[-1] == "check"


@pytest.mark.cuda
@pytest.mark.parametrize("cell,traffic,fault", ON_CARD)
def test_a_fault_makes_the_cell_incorrect_on_the_card(cell, traffic, fault,
                                                      monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    hook = _faulty(fault, monkeypatch)
    keep = {}
    result, lines = bench.run_cell(M, cell, 2**31 + 41, 2.0, False, "cuda:0",
                                   time.perf_counter(), program_hook=hook,
                                   say=lambda s: None, keep=keep)
    print(cell, fault, keep["numbers"])
    assert result["correct"] == (fault is None)
