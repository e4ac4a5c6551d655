"""``detector calibrate`` on the port against the JAX package, on the CPU.

The histogram (``quant.activation_histogram``) is held bit for bit; the
device KL sweep (``quant.entropy_calibration_multipliers``) within 0.02 of
the host sweep's multiplier, the JAX package's own bound
(tests/test_calibrate_parity.py), against both JAX's device sweep and the
host sweep, and at most one threshold bin from the host sweep's, as the
float32 sweep's ties and rounding allow. The captured conv inputs of the fp32 forward equal JAX's: the
first bit for bit (the image), the others, outputs of float32 convs summed
in another order than XLA's, at rtol=1e-5 / atol=1e-6. The CLI: with
``-calib_method host`` stdout, stderr and the written file are
byte-identical to the JAX CLI's, on the dataset tests/test_calibrate_parity.py
builds; with ``-calib_method device`` the same streams apart from the
multiplier values, each within the bound.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo2_light_tpu import quant as JQ
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.cfg import parse_network_cfg as jax_parse
from yolo2_light_tpu.models import network as JN
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch import quant as TQ
from yolo2_light_tpu_torch.apps.calibrate import calibrate_multipliers
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.models import network as TN

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
MINI_CALIB = os.path.join(DATA, "mini-calib.cfg")
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?|-?\d+(?:e[-+]\d+)?")
MULTIPLIER_LINE = re.compile(r" multiplier = (\S+), l\.inputs")


def _threshold_bin(mult):
    """The threshold bin m of a multiplier 127 / ((m + 0.5) / 16)."""
    return round(127 * 16 / mult - 0.5)


def _assert_within_one_bin(device, host):
    for d, h in zip(device, host):
        assert abs(_threshold_bin(d) - _threshold_bin(h)) <= 1, (d, h)


def _distributions():
    """The four activation distributions of
    tests/test_calibrate_parity.py::test_entropy_calibration_device_matches_host."""
    rng = np.random.RandomState(0)
    return [
        rng.randn(40000).astype(np.float32) * 12.0,
        np.abs(rng.randn(40000)).astype(np.float32) * 40.0 + 8.0,
        rng.exponential(25.0, 40000).astype(np.float32),
        rng.rand(40000).astype(np.float32) * 250.0,
    ]


@pytest.mark.parametrize("k", range(4), ids=["normal", "shifted", "exp",
                                              "uniform"])
def test_activation_histogram_bit_equal_to_jax(k):
    c = _distributions()[k]
    want = np.asarray(JQ.activation_histogram(jnp.asarray(c)))
    got = TQ.activation_histogram(torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == (4096,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == c.size


def test_activation_histogram_saturates_into_the_last_bin():
    x = torch.tensor([0.0, -0.03, 0.03125, 1e9, -np.inf, 255.96, 255.97])
    got = TQ.activation_histogram(x)
    want = np.asarray(JQ.activation_histogram(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[4095] == 4 and got[0] == 2 and got[1] == 1


@pytest.fixture(scope="module")
def sweeps():
    """The four distributions' histograms, JAX's device sweep of them and
    the host sweep of each."""
    cases = _distributions()
    hists = torch.stack([TQ.activation_histogram(torch.from_numpy(c))
                         for c in cases])
    jax_dev = np.asarray(JQ.entropy_calibration_multipliers(
        jnp.asarray(hists.numpy())))
    host = [JQ.entropy_calibration(c, 1.0 / 16, 4096) for c in cases]
    return hists, jax_dev, host


@pytest.mark.parametrize("stacked", [True, False],
                         ids=["four-layers", "one-layer"])
def test_entropy_multipliers_within_bound_of_jax_and_host(sweeps, stacked):
    """The sweep over the four distributions at once (chunks of 256
    candidates on the CPU) and over each alone (chunks of 1024), both with
    a ragged last chunk: within 0.02 of the host sweep, as the JAX device
    sweep is, and at most one threshold bin from the host's."""
    hists, jax_dev, host = sweeps
    if stacked:
        got = TQ.entropy_calibration_multipliers(hists)
    else:
        got = torch.cat([TQ.entropy_calibration_multipliers(h[None])
                         for h in hists])
    assert got.dtype == torch.float32 and got.shape == (4,)
    for g, j, h in zip(got.tolist(), jax_dev, host):
        assert abs(g - h) <= 0.02 * h, (g, h)
        assert abs(g - j) <= 0.02 * h, (g, j)
    _assert_within_one_bin(got.tolist(), host)


def _dense_params(cfg, seed=21):
    return (jax_build_params(cfg, None, seed=seed, echo=False),
            build_params(cfg, None, seed=seed, echo=False))


@pytest.mark.parametrize("int8_impl", [None, "fused"])
def test_capture_conv_inputs_matches_jax(int8_impl):
    """The fp32 forward's conv inputs (mini-calib); with int8_impl="fused"
    in int8 mode the fused engine is off under capture, as in JAX, and every
    conv's input is captured."""
    (jspec, jparams, _), (tspec, tparams, _) = _dense_params(MINI_CALIB)
    x = np.random.RandomState(6).rand(1, 64, 64, 3).astype(np.float32)
    if int8_impl is None:
        _, jaux = JN.build_forward(jspec, "fp32", capture_conv_inputs=True)(
            JN.params_to_device(jparams), x)
        fwd = TN.build_forward(tspec, "fp32", capture_conv_inputs=True)
        _, taux = fwd(TN.device_params(tspec, tparams, "fp32", "cpu"),
                      torch.from_numpy(x))
        want = [np.asarray(c) for c in jaux["conv_inputs"]]
        got = [c.numpy() for c in taux["conv_inputs"]]
        assert len(got) == len(want) == len(tspec.conv_layers()) == 4
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, **FLOAT_TOL)
        return
    res = os.path.join(DATA, "mini-res.cfg")
    tspec = build_params(res, None, quantized=True, echo=False)[0]
    fwd = TN.build_forward(tspec, "int8", int8_impl="fused",
                           capture_conv_inputs=True)
    _, tparams, _ = build_params(res, None, quantized=True, seed=2,
                                 echo=False)
    x = np.random.RandomState(6).rand(1, tspec.net.h, tspec.net.w,
                                      3).astype(np.float32)
    _, taux = fwd(TN.device_params(tspec, tparams, "int8", "cpu"),
                  torch.from_numpy(x))
    assert len(taux["conv_inputs"]) == len(tspec.conv_layers())
    assert TN._fused_stage_runs(tspec, TN._int8_layer_set(tspec, "cpu"))


def test_calibrate_multipliers_methods_agree_and_refuse_bad_values(capsys):
    """The saved multipliers within 0.02 of the host method's; each image's
    multiplier of each layer (its printed line) at most one threshold bin
    from the host's."""
    (_, _, _), (tspec, tparams, _) = _dense_params(MINI_CALIB)
    imgs = [np.random.RandomState(s).rand(64, 64, 3).astype(np.float32)
            for s in range(3)]
    capsys.readouterr()
    host = calibrate_multipliers(tspec, tparams, iter(imgs), 3, "host",
                                 device="cpu")
    host_lines = MULTIPLIER_LINE.findall(capsys.readouterr().out)
    dev = calibrate_multipliers(tspec, tparams, iter(imgs), 3, "device",
                                device="cpu")
    dev_lines = MULTIPLIER_LINE.findall(capsys.readouterr().out)
    assert len(host) == len(dev) == 4
    for h, d in zip(host, dev):
        assert abs(h - d) <= 0.02 * h, (host, dev)
    assert len(dev_lines) == len(host_lines) == 3 * 4
    _assert_within_one_bin([float(v) for v in dev_lines],
                           [float(v) for v in host_lines])
    with pytest.raises(ValueError, match="calibration method"):
        calibrate_multipliers(tspec, tparams, iter(imgs), 3, "gpu",
                              device="cpu")


@pytest.fixture(scope="module")
def calib_dataset(tmp_path_factory):
    """tests/test_calibrate_parity.py's dataset: 4 random 80x100 PNGs
    (seed 5), their valid list and .data, and mini-calib weights (seed
    21)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("calibds")
    rng = np.random.RandomState(5)
    paths = []
    for i in range(4):
        arr = (rng.rand(80, 100, 3) * 255).astype(np.uint8)
        p = root / f"im{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    valid = root / "valid.txt"
    valid.write_text("\n".join(paths) + "\n")
    names = root / "mini.names"
    names.write_text("aaa\nbbb\nccc\n")
    data = root / "mini.data"
    data.write_text(f"classes=3\nvalid={valid}\nnames={names}\n")
    spec = jax_parse(MINI_CALIB, batch=1)
    weights = str(root / "w.weights")
    save_weights(spec, random_params(spec, seed=21), weights)
    return str(data), weights


def _calibrate(main, capsys, cwd, args, monkeypatch):
    """Run one CLI's calibrate in ``cwd``; (rc, stdout, stderr, file)."""
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    path = os.path.join(cwd, "input_calibration.txt")
    with open(path) as f:
        return rc, out, err, f.read()


def _numbers(text):
    return [float(v) for v in NUMBER.findall(text)]


@pytest.mark.parametrize("method", ["host", "device"])
@pytest.mark.parametrize("n", [2, 4])
def test_calibrate_cli_matches_jax(calib_dataset, capsys, tmp_path,
                                   monkeypatch, n, method):
    data, weights = calib_dataset
    args = ["detector", "calibrate", data, MINI_CALIB, weights,
            "-input_calibration", str(n), "-calib_method", method]
    rc_j, out_j, err_j, file_j = _calibrate(jax_main, capsys,
                                            str(tmp_path / "jax"), args,
                                            monkeypatch)
    rc_t, out_t, err_t, file_t = _calibrate(torch_main, capsys,
                                            str(tmp_path / "torch"),
                                            args + ["-device", "cpu"],
                                            monkeypatch)
    assert rc_j == rc_t == 0
    assert file_t.startswith("input_calibration = ")
    assert file_t.endswith(", 16") and not file_t.endswith("\n")
    assert err_t == err_j
    assert out_t.count(" multiplier = ") == 4 * n
    if method == "host":
        assert out_t == out_j
        assert file_t == file_j
        return
    # device: the lines match once their numbers are taken out, and every
    # multiplier (and the mean of a stripe) is within the bound
    assert NUMBER.sub("#", out_t) == NUMBER.sub("#", out_j)
    assert NUMBER.sub("#", file_t) == NUMBER.sub("#", file_j)
    for line_t, line_j in zip(out_t.splitlines(), out_j.splitlines()):
        if "multiplier = " in line_t or "input_calibration = " in line_t:
            nt, nj = _numbers(line_t), _numbers(line_j)
            assert len(nt) == len(nj)
            for a, b in zip(nt, nj):
                assert abs(a - b) <= 0.02 * abs(b) + 1e-4, (line_t, line_j)
        else:
            assert line_t == line_j


def test_calibrate_notes_on_stderr(calib_dataset, capsys, tmp_path,
                                   monkeypatch):
    """The JAX CLI's two notes: -bf16 is ignored, and the device method may
    land one bin off the host's."""
    data, weights = calib_dataset
    args = ["detector", "calibrate", data, MINI_CALIB, weights,
            "-input_calibration", "1", "-bf16"]
    _, _, err_j, _ = _calibrate(jax_main, capsys, str(tmp_path / "j"), args,
                                monkeypatch)
    _, _, err_t, _ = _calibrate(torch_main, capsys, str(tmp_path / "t"),
                                args + ["-device", "cpu"], monkeypatch)
    notes = [l for l in err_t.splitlines() if l.startswith("note: ")]
    assert len(notes) == 2 and "-bf16 ignored" in notes[0]
    assert "-calib_method host" in notes[1]
    assert err_t == err_j
