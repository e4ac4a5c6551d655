"""The control, the reference one precision below the configuration's
(int4 for int8, fp8 for bf16) put in the program's place, is not correct
by the cell's own limits: on the CPU for the int8 cells at the small
net's size, on the card for every cell at its own size on three seeds."""

import json
import os

import pytest
import torch

from portbench import bench, model, traffic, verify

M = bench.load_manifest()
FRAMES = 16


def control_numbers(files: dict, seed: int, device) -> tuple:
    """(the control's numbers, the cell's limits) on the first frames of
    the seed's pool."""
    config, net = model.load_config(files["config"])
    with open(files["traffic"]) as f:
        tr = json.load(f)
    with open(files["limits"]) as f:
        limits = json.load(f)
    pool = traffic.frame_pool(tr, seed, device)
    raw = model.make_weights(net, seed, device)
    bias = model.calibrate_obj_bias(net, raw, pool[:model.CALIB_FRAMES],
                                    config["arith"], tr["thresh"],
                                    tr["candidates"], device)
    model.set_obj_bias(net, raw, bias)
    frames = list(range(min(FRAMES, len(pool))))
    nms = model.nms_of(config, tr)
    truths = verify.reference_truths(net, raw, pool, frames, config["arith"],
                                     tr["thresh"], nms, device)
    low = verify.reference_truths(net, raw, pool, frames, config["control"],
                                  tr["thresh"], nms, device)
    numbers = verify.compare(verify.as_answers(low, frames), truths,
                             tr["thresh"])
    return numbers, limits


@pytest.mark.parametrize("cell,traffic_name", [
    ("yolov3-416-int8.batch64", "batch64"), ("yolov3-416-int8.cam1", "cam1")])
def test_the_int4_control_fails_the_small_net(mini, cell, traffic_name):
    with open(os.path.join(bench.HERE, "limits", f"{cell}.json")) as f:
        limits = json.load(f)
    numbers, limits = control_numbers(mini("int8", traffic_name, limits),
                                      2**31 + 53, "cpu")
    assert not verify.judge(numbers, limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
@pytest.mark.parametrize("seed", [2**31 + 61, 62, 63])
def test_the_control_fails_the_cell_on_the_card(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    numbers, limits = control_numbers(bench.cell_files(M, cell), seed,
                                      "cuda:0")
    print(cell, seed, numbers)
    assert not verify.judge(numbers, limits)[0]
