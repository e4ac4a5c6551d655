"""``detector map`` on the port (``-device cpu``) against the JAX CLI, on a
synthetic labelled dataset built as tests/test_map_parity.py builds one: the
printed mAP report blocks must be identical, with host NMS and with
``-device_nms``; and the map CLI's refusals."""

import os

import numpy as np
import pytest
import torch

from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch.apps.cli import main as torch_main

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CFG = os.path.join(DATA, "mini-yolo3.cfg")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """6 random PNG images under images/, random labels under labels/, and
    random mini-yolo3 weights (seed 11)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("mapds")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(6):
        arr = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
        p = root / "images" / f"im{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
        with open(root / "labels" / f"im{i}.txt", "w") as f:
            for _ in range(rng.randint(1, 4)):
                cid = rng.randint(0, 3)
                x, y = rng.uniform(0.2, 0.8, 2)
                w, h = rng.uniform(0.1, 0.4, 2)
                f.write(f"{cid} {x:.6f} {y:.6f} {w:.6f} {h:.6f}\n")
    valid = root / "valid.txt"
    valid.write_text("\n".join(paths) + "\n")
    names = root / "mini.names"
    names.write_text("aaa\nbbb\nccc\n")
    data = root / "mini.data"
    data.write_text(f"classes=3\nvalid={valid}\nnames={names}\n")
    spec = parse_network_cfg(CFG, batch=1)
    weights = str(root / "w.weights")
    save_weights(spec, random_params(spec, seed=11), weights)
    return {"data": str(data), "weights": weights}


def _run(main, capsys, args):
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, out, err


def _block(text):
    """The printed report, from the detections_count line to the mAP line
    (\\r and \\n both break, like the tty)."""
    out, on = [], False
    for line in text.splitlines():
        if "detections_count" in line:
            on = True
        if on:
            out.append(line.rstrip())
        if "mean average precision" in line:
            break
    return out


def _progress(err):
    return [l for l in err.splitlines() if l.strip().isdigit()]


@pytest.mark.parametrize("extra", [[], ["-quantized"], ["-device_nms"],
                                   ["-quantized", "-turbo"]],
                         ids=["fp32", "int8", "device_nms", "int8_turbo"])
def test_map_report_matches_jax_cli(dataset, capsys, extra):
    args = ["detector", "map", dataset["data"], CFG, dataset["weights"],
            "-thresh", "0.24", "-batch", "3", "-k", "4096"] + extra
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    block = _block(out_t)
    assert block and block == _block(out_j)
    assert "mean average precision (mAP)" in block[-1]
    assert int(block[0].split("detections_count = ")[1].split(",")[0]) > 100
    assert _progress(err_t) == _progress(err_j) == ["4", "8"]
    assert "Total Detection Time" in err_t


def test_map_device_nms_and_host_nms_print_one_report(dataset, capsys):
    """The port's two NMS paths, with auto-grow from a small -k and another
    batch size: one report."""
    base = ["detector", "map", dataset["data"], CFG, dataset["weights"],
            "-device", "cpu", "-batch", "4"]
    rc_h, out_h, err_h = _run(torch_main, capsys, base + ["-k", "4096"])
    rc_d, out_d, err_d = _run(torch_main, capsys,
                              base + ["-k", "256", "-device_nms"])
    assert rc_h == rc_d == 0
    assert _block(out_h) == _block(out_d)
    assert "note: candidate buffer K=256 saturated" in err_d


def test_device_nms_with_test_exits_1(capsys):
    rc, _, err = _run(torch_main, capsys,
                      ["detector", "test", "x.names", CFG, "-device_nms",
                       "-device", "cpu"])
    assert rc == 1 and "-device_nms applies to detector map/demo only" in err


def test_map_without_cuda_fails_with_a_message(dataset, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")
    rc, out, err = _run(torch_main, capsys,
                        ["detector", "map", dataset["data"], CFG,
                         dataset["weights"]])
    assert rc == 1 and "CUDA is not available" in err
    assert "mean average precision" not in out


@pytest.mark.parametrize("flag", [["-pp", "2"], ["-parallel", "2"],
                                  ["-device_resize"],
                                  ["-params_cache", "CACHE"],
                                  ["-parallel", "2", "-sp", "2", "-tp", "2"],
                                  ["-parallel", "4"],
                                  ["-pp", "2", "-pp_tp", "2"]])
def test_map_unported_flags_exit_nonzero(dataset, capsys, flag, tmp_path):
    """Every flag of the JAX CLI's map is ported: the mesh axes (on
    ``-device cpu`` every position is the CPU; the JAX CLI's are virtual
    host devices), the pipeline stages, ``-params_cache`` (JAX's cache key
    and file) and ``-device_resize`` (ignored by map, as in JAX). Each
    prints the JAX CLI's report and progress, at ``test_map_report_matches_
    jax_cli``'s ``-batch 3`` (under ``-parallel 2`` cut to 2, a multiple of
    the data axis; under ``-parallel 4`` raised to 4, the tail batch of 2
    padded with zero images whose detections are dropped; under ``-pp 2`` a
    microbatch of 3 // 2 = 1)."""
    flag = [str(tmp_path / "cache") if f == "CACHE" else f for f in flag]
    args = ["detector", "map", dataset["data"], CFG, dataset["weights"],
            "-thresh", "0.24", "-batch", "3", "-k", "4096"] + flag
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    block = _block(out_t)
    assert block and block == _block(out_j)
    assert _progress(err_t) == _progress(err_j) == ["4", "8"]
    if "-params_cache" in flag:
        # the JAX run wrote the cache under its key; the port read it back
        assert len(os.listdir(flag[-1])) == 1
        rc_t, out_t, _ = _run(torch_main, capsys,
                              args + ["-device", "cpu"])
        assert rc_t == 0 and _block(out_t) == block


def test_map_pp_tail_batch_error_matches_jax(dataset, capsys):
    """-pp 2 at the default -batch 8 over 6 images: the one batch of 6 does
    not divide by the microbatch of 4, and both CLIs exit 1 with the same
    error."""
    args = ["detector", "map", dataset["data"], CFG, dataset["weights"],
            "-pp", "2"]
    rc_j, _, err_j = _run(jax_main, capsys, args)
    rc_t, _, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 1
    want = "Error: batch 6 not divisible by microbatch 4"
    assert want in err_j and want in err_t
