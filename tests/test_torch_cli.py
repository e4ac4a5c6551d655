"""``python -m yolo2_light_tpu_torch detector test`` against the JAX CLI: the
same cfg, weights and image must print the same streams, detection lines
included, fp32 and -quantized, and in the precision modes (``-int8_policy
gpu``, ``-turbo``, ``-turbo_int8``, ``-bf16``; on the CPU, the port runs its
plain PyTorch kernels). Only the "Predicted in <seconds>" timing line is
dropped."""

import os
import subprocess
import sys

import pytest
import torch

from tests.util_parity import assert_streams_match, parse_detection_lines
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch.apps.cli import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CFG = os.path.join(DATA, "mini-yolo3.cfg")
IMAGE = os.path.join(DATA, "dog160.png")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    spec = parse_network_cfg(CFG, batch=1)
    weights = str(d / "mini.weights")
    save_weights(spec, random_params(spec, seed=1), weights)
    names = str(d / "mini.names")
    with open(names, "w") as f:
        f.write("a\nb\nc\n")
    return d, names, weights


def _run(main, capsys, args):
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("quantized,thresh", [(False, "0.3"), (True, "0.1")],
                         ids=["fp32", "int8"])
def test_detector_test_streams_match_jax_cli(assets, capsys, quantized,
                                             thresh):
    d, names, weights = assets
    args = ["detector", "test", names, CFG, weights, IMAGE, "-thresh", thresh,
            "-dont_show"] + (["-quantized"] if quantized else [])
    rc_j, out_j, err_j = _run(jax_main, capsys,
                              args + ["-save", str(d / "jax")])
    rc_t, out_t, err_t = _run(torch_main, capsys,
                              args + ["-save", str(d / "torch"),
                                      "-device", "cpu"])
    assert rc_j == rc_t == 0
    boxes, _ = parse_detection_lines(out_t)
    assert len(boxes) >= 10          # the comparison covers real detections
    if quantized:
        assert "Quantinization!" in out_t
        assert "81 - CONVOLUTIONAL" not in out_t   # mini-yolo3 has 15 layers
        assert "\n 14 - CONVOLUTIONAL \t\t l.size = 1  \n" in out_t
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")
    assert (d / "torch.png").exists()


def test_int8_impl_pallas_prints_same_lines(assets, capsys):
    d, names, weights = assets
    base = ["detector", "test", names, CFG, weights, IMAGE, "-thresh", "0.1",
            "-dont_show", "-quantized", "-device", "cpu", "-save",
            str(d / "p")]
    _, out_x, _ = _run(torch_main, capsys, base)
    rc, out_p, _ = _run(torch_main, capsys, base + ["-int8_impl", "pallas"])
    assert rc == 0
    assert_streams_match(out_p, out_x, drop=("Predicted in",))


def test_int8_impl_fused_streams_match_jax_cli(capsys, tmp_path):
    """``-quantized -int8_impl fused`` on mini-res, whose residual blocks the
    fused engine takes: the same streams as the JAX CLI's fused engine.
    Weights from seed 1, as the fixture's; at seed 2 both engines of the two
    CLIs part (F7 in ROADMAP: the jitted JAX forward's reciprocal multiply
    and FMA flip int8 bins), while each CLI's fused and unfused engines
    still agree with each other."""
    cfg = os.path.join(DATA, "mini-res.cfg")
    spec = parse_network_cfg(cfg, batch=1)
    weights = str(tmp_path / "res.weights")
    save_weights(spec, random_params(spec, seed=1), weights)
    names = str(tmp_path / "res.names")
    with open(names, "w") as f:
        f.write("a\nb\nc\n")
    args = ["detector", "test", names, cfg, weights, IMAGE, "-thresh", "0.1",
            "-dont_show", "-quantized", "-int8_impl", "fused"]
    rc_j, out_j, err_j = _run(jax_main, capsys,
                              args + ["-save", str(tmp_path / "jax")])
    rc_t, out_t, err_t = _run(torch_main, capsys,
                              args + ["-save", str(tmp_path / "torch"),
                                      "-device", "cpu"])
    assert rc_j == rc_t == 0
    assert parse_detection_lines(out_t)[0]
    assert "\n 10 - CONVOLUTIONAL \t\t l.size = 3  \n" in out_t
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")


@pytest.mark.parametrize("flags,thresh", [
    (["-quantized", "-int8_policy", "gpu"], "0.1"),
    (["-quantized", "-turbo"], "0.1"),
    (["-quantized", "-turbo_int8"], "0.1"),
    (["-bf16"], "0.3"),
], ids=["int8_gpu", "int8_turbo", "int8_turbo_int8", "bf16"])
def test_precision_modes_stream_match_jax_cli(assets, capsys, flags, thresh):
    """The precision modes print the JAX CLI's streams, detection lines
    included."""
    d, names, weights = assets
    args = ["detector", "test", names, CFG, weights, IMAGE, "-thresh", thresh,
            "-dont_show"] + flags
    rc_j, out_j, err_j = _run(jax_main, capsys,
                              args + ["-save", str(d / "jax")])
    rc_t, out_t, err_t = _run(torch_main, capsys,
                              args + ["-save", str(d / "torch"),
                                      "-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    assert len(parse_detection_lines(out_t)[0]) >= 10
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")


@pytest.mark.parametrize("flags", [["-quantized", "-turbo", "-turbo_int8"],
                                   ["-turbo_int8"]],
                         ids=["both_turbos", "turbo_int8_without_int8"])
def test_turbo_flag_guards_match_jax_cli(assets, capsys, flags):
    """-turbo with -turbo_int8, and -turbo_int8 without -quantized, exit 1
    with the JAX CLI's message."""
    d, names, weights = assets
    args = ["detector", "test", names, CFG, weights, IMAGE, "-dont_show",
            "-save", str(d / "g")] + flags
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 1
    assert err_t == err_j and err_t.startswith("error: -turbo")
    assert out_t == out_j == ""


@pytest.mark.parametrize("sub", ["demo"])
def test_other_apps_not_yet_ported(capsys, sub):
    rc, _, err = _run(torch_main, capsys,
                      ["detector", sub, "x.data", "x.cfg", "x.weights"])
    assert rc != 0 and "not yet ported" in err


@pytest.mark.parametrize("flag", [["-device_resize"], ["-uint8_ingest"],
                                  ["-pp", "2"], ["-no_uint8_ingest"]])
def test_unported_flags_exit_nonzero(assets, capsys, flag):
    d, names, weights = assets
    rc, _, err = _run(torch_main, capsys,
                      ["detector", "test", names, CFG, weights, IMAGE,
                       "-dont_show", "-device", "cpu", "-save",
                       str(d / "u")] + flag)
    assert rc != 0 and "not yet ported" in err


def test_bad_values_exit_nonzero(capsys):
    for args in (["-int8_impl", "triton"], ["-int8_impl", "plain"],
                 ["-device", "tpu"]):
        rc, _, err = _run(torch_main, capsys,
                          ["detector", "test", "n", "c.cfg"] + args)
        assert rc == 1 and "Error:" in err


def test_missing_files_exit_zero_like_reference(capsys):
    rc, _, err = _run(torch_main, capsys, ["detector", "test", "/nope.names",
                                           "/nope.cfg", "-device", "cpu"])
    assert rc == 0 and "Couldn't open file" in err


def test_default_device_is_cuda_and_never_falls_back(assets, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")
    d, names, weights = assets
    rc, out, err = _run(torch_main, capsys,
                        ["detector", "test", names, CFG, weights, IMAGE,
                         "-dont_show", "-save", str(d / "c")])
    assert rc == 1 and "CUDA is not available" in err
    assert "Predicted in" not in out


def test_module_entry_point(assets):
    d, names, weights = assets
    r = subprocess.run(
        [sys.executable, "-m", "yolo2_light_tpu_torch", "detector", "test",
         names, CFG, weights, IMAGE, "-thresh", "0.3", "-dont_show",
         "-device", "cpu", "-save", str(d / "m")],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Predicted in" in r.stdout
    assert parse_detection_lines(r.stdout)[0]
