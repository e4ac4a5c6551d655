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


@pytest.mark.parametrize("extra", [[], ["-pp", "2"],
                                   ["-pp", "2", "-pp_tp", "2"]],
                         ids=["one_device", "pp2", "pp2_tp2"])
def test_detector_demo_streams_match_jax_cli(assets, capsys, tmp_path,
                                             extra):
    """``detector demo`` (ported): a 4-frame raw video through both CLIs in
    -fp32, the same streams once the FPS figures are masked, on one device
    and as pipeline stages (tests/test_torch_demo.py covers the other modes
    and flags)."""
    import re

    import numpy as np

    from yolo2_light_tpu_torch.io.rawvideo import write_rawvideo
    d, names, weights = assets
    rng = np.random.RandomState(5)
    vid = str(tmp_path / "v.cvs")
    write_rawvideo(vid, [(rng.rand(64, 64, 3) * 255).astype(np.uint8)
                         for _ in range(4)])
    args = ["detector", "demo", names, CFG, weights, vid, "-dont_show",
            "-fp32", "-thresh", "0.4"] + extra
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 0, err_t[-2000:]
    fps = re.compile(r"FPS:\S*")
    out_t, out_j = fps.sub("FPS:#", out_t), fps.sub("FPS:#", out_j)
    assert out_t.count("Objects:") == 4
    assert_streams_match(out_t, out_j, context="stdout")
    assert_streams_match(err_t, err_j, context="stderr")


@pytest.mark.parametrize("flag", [["-device_resize"], ["-uint8_ingest"],
                                  ["-pp", "2"], ["-no_uint8_ingest"],
                                  ["-pp", "2", "-pp_tp", "2"]])
def test_unported_flags_exit_nonzero(assets, capsys, flag):
    """Every flag of the JAX CLI is ported: the demo's ingest flags
    (tests/test_torch_demo.py runs them), which ``detector test`` parses as
    the JAX CLI does, and the pipeline stages ``-pp`` (with ``-pp_tp``; on
    ``-device cpu`` every stage is the CPU, the JAX CLI's are virtual host
    devices). Each prints the same streams as the JAX CLI, and as the port
    without it."""
    d, names, weights = assets
    args = ["detector", "test", names, CFG, weights, IMAGE, "-dont_show",
            "-device", "cpu", "-save", str(d / "u")]
    rc, out, err = _run(torch_main, capsys, args + flag)
    rc_base, out_base, err_base = _run(torch_main, capsys, args)
    rc_j, out_j, err_j = _run(jax_main, capsys, args[:-3] + flag + [
        "-save", str(d / "uj")])
    assert rc == rc_base == rc_j == 0
    drop = ("Predicted in",)
    assert_streams_match(out, out_base, drop=drop, context="stdout")
    assert_streams_match(out, out_j, drop=drop, context="stdout")
    assert_streams_match(err, err_j, drop=drop, context="stderr")


@pytest.mark.parametrize("sub", ["test", "map", "demo"])
def test_pp_tp_without_pp_exits_1_as_jax(assets, capsys, sub):
    """-pp_tp without -pp S > 1 would run on one device: both CLIs refuse,
    with the same stderr and exit code."""
    d, names, weights = assets
    args = ["detector", sub, names, CFG, weights, "-pp_tp", "2"]
    rc_j, out_j, err_j = _run(jax_main, capsys, args)
    rc_t, out_t, err_t = _run(torch_main, capsys, args + ["-device", "cpu"])
    assert rc_j == rc_t == 1
    assert out_t == out_j == ""
    assert err_t == err_j
    assert "-pp_tp requires -pp S with S > 1" in err_t


def test_pp_on_too_few_gpus_exits_1(assets, capsys):
    """-pp 2 on -device cuda needs two GPUs: with fewer, the port exits 1
    with the JAX package's message, and runs on no fewer devices (on a
    machine without CUDA it says so instead)."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("checks a machine with fewer than two GPUs")
    d, names, weights = assets
    rc, out, err = _run(torch_main, capsys,
                        ["detector", "test", names, CFG, weights, IMAGE,
                         "-pp", "2", "-dont_show", "-save", str(d / "g")])
    assert rc == 1 and "Predicted in" not in out
    assert (("Error: need 2 devices, have 1" if torch.cuda.is_available()
             else "CUDA is not available") in err)


def test_params_cache_key_hit_and_miss_match_jax(assets, capsys, tmp_path):
    """-params_cache: the port names its cache file as the JAX CLI does for
    the same inputs; a second run loads it and prints the same streams as
    the first (and as the JAX CLI's cached run); an edited cfg misses."""
    import shutil

    from yolo2_light_tpu_torch.apps.detect import params_cache_path
    d, names, weights = assets
    cfg = str(tmp_path / "c.cfg")
    shutil.copy(CFG, cfg)
    jdir, tdir = str(tmp_path / "jc"), str(tmp_path / "tc")
    args = ["detector", "test", names, cfg, weights, IMAGE, "-dont_show",
            "-quantized", "-thresh", "0.1", "-save", str(tmp_path / "p")]
    rc, out1, err1 = _run(torch_main, capsys,
                          args + ["-params_cache", tdir, "-device", "cpu"])
    assert rc == 0 and os.listdir(tdir)
    rc_j, _, _ = _run(jax_main, capsys, args + ["-params_cache", jdir])
    assert rc_j == 0 and os.listdir(jdir) == os.listdir(tdir)
    assert os.listdir(tdir) == [os.path.basename(
        params_cache_path(tdir, cfg, weights, True))]
    rc, out2, err2 = _run(torch_main, capsys,
                          args + ["-params_cache", tdir, "-device", "cpu"])
    rc_j, out_j2, err_j2 = _run(jax_main, capsys,
                                args + ["-params_cache", jdir])
    drop = ("Predicted in",)
    assert rc == rc_j == 0
    # a hit skips the quantize step and its prints, as in the JAX CLI
    assert "Quantinization!" in out1 and "Quantinization!" not in out2
    assert_streams_match(out2, out_j2, drop=drop, context="stdout")
    assert_streams_match(err2, err_j2, drop=drop, context="stderr")
    assert parse_detection_lines(out2)[0] == parse_detection_lines(out1)[0]
    with open(cfg, "a") as f:
        f.write("\n")
    rc, _, _ = _run(torch_main, capsys,
                    args + ["-params_cache", tdir, "-device", "cpu"])
    assert rc == 0 and len(os.listdir(tdir)) == 2


def test_profile_writes_a_trace_and_cost_table_matches_jax(assets, capsys,
                                                           tmp_path):
    """-profile DIR: ``detector test`` prints its usual streams and leaves a
    torch.profiler trace in DIR; ``layer_cost_table`` prints the JAX
    package's text; ``profile_layers`` gives a row per layer on the CPU."""
    import numpy as np

    from yolo2_light_tpu.utils import profiling as JP
    from yolo2_light_tpu_torch import cfg as TC
    from yolo2_light_tpu_torch.apps.detect import build_params
    from yolo2_light_tpu_torch.utils import profiling as TP
    d, names, weights = assets
    prof = tmp_path / "prof"
    args = ["detector", "test", names, CFG, weights, IMAGE, "-dont_show",
            "-device", "cpu", "-save", str(tmp_path / "p")]
    rc, out, err = _run(torch_main, capsys, args + ["-profile", str(prof)])
    rc_base, out_base, _ = _run(torch_main, capsys, args)
    assert rc == rc_base == 0
    assert_streams_match(out, out_base, drop=("Predicted in",))
    assert (prof / "trace.json").stat().st_size > 0
    for path in (CFG, os.path.join(DATA, "yolov3.cfg"),
                 os.path.join(DATA, "mini-xnor.cfg")):
        assert TP.layer_cost_table(TC.parse_network_cfg(path, batch=1)) == \
            JP.layer_cost_table(parse_network_cfg(path, batch=1))
    spec, params, _ = build_params(CFG, weights, echo=False)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    rows = TP.profile_layers(spec, params, x, iters=2, device="cpu")
    assert [r[:2] for r in rows] == [
        (l.index, type(l).__name__.replace("Spec", "")) for l in spec.layers]
    assert all(r[2] >= 0 and r[3] >= 0 for r in rows)
    assert rows[-1][2] >= rows[0][2]


def test_device_index_flag(assets, capsys):
    """-i 0 changes nothing; an index past the devices of the chosen kind
    exits 1 with the JAX CLI's message."""
    d, names, weights = assets
    args = ["detector", "test", names, CFG, weights, IMAGE, "-dont_show",
            "-device", "cpu", "-save", str(d / "i")]
    rc0, out0, _ = _run(torch_main, capsys, args + ["-i", "0"])
    rc, out, _ = _run(torch_main, capsys, args)
    assert rc0 == rc == 0
    assert_streams_match(out0, out, drop=("Predicted in",))
    rc, out, err = _run(torch_main, capsys, args + ["-i", "3"])
    assert rc == 1 and out == ""
    assert err == "device index 3 out of range (1 devices)\n"


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
