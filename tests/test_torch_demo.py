"""``detector demo`` of the port against the JAX package's, on the CPU, on
CVSTUBV1 raw videos written by numpy (``io/rawvideo.py``), and the port's
copy of ``io/rawvideo.py``.

The two demos print the same stdout once the FPS figures (wall-clock) are
masked, and the same stderr; in the default bfloat16 mode too (the CPU runs
the bf16 conv's plain twin, the float32 sums of the bfloat16 operands, as
XLA does: equal printed lines here, where test_torch_precision.py's ``bf16``
bound is what the heads are held to). ``-prefix`` PNGs are compared as
decoded pixels (two PNG encoders may differ in bytes, not in pixels).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.util_parity import assert_streams_match
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu.io import rawvideo as JR
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.io import rawvideo as TR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CFG = os.path.join(DATA, "mini-yolo3.cfg")
_FPS = re.compile(r"FPS:\S*")


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """mini-yolo3 with random weights (seed 3), three names, and a 6-frame
    96x80 CVSTUBV1 video from numpy (seed 0): frames larger than the
    64x64 net, so the host or the device resizes them."""
    d = tmp_path_factory.mktemp("demo")
    spec = parse_network_cfg(CFG, batch=1)
    weights = str(d / "w.weights")
    save_weights(spec, random_params(spec, seed=3), weights)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(80, 96, 3) * 255).astype(np.uint8) for _ in range(6)]
    vid = str(d / "in.cvs")
    JR.write_rawvideo(vid, frames, fps=10)
    names = str(d / "names.txt")
    with open(names, "w") as f:
        f.write("aaa\nbbb\nccc\n")
    return d, names, weights, vid


def _run(main, capsys, args):
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, _FPS.sub("FPS:#", out), err


def _pair(video, capsys, flags, ours=("-device", "cpu"), theirs=()):
    d, names, weights, vid = video
    args = ["detector", "demo", names, CFG, weights, vid, "-dont_show",
            "-thresh", "0.4"] + list(flags)
    rc_j, out_j, err_j = _run(jax_main, capsys, args + list(theirs))
    rc_t, out_t, err_t = _run(torch_main, capsys, args + list(ours))
    assert rc_j == rc_t == 0, err_t[-2000:]
    return out_t, err_t, out_j, err_j


@pytest.mark.parametrize("flags", [
    ["-fp32"], ["-quantized", "-fp32"], ["-s", "2", "-fp32"], [],
    ["-quantized"], ["-device_resize", "-fp32"], ["-uint8_ingest", "-fp32"],
    ["-no_uint8_ingest"], ["-batch", "4", "-fp32"], ["-device_nms"]],
    ids=["fp32", "quantized", "s2", "bf16", "quantized_bf16",
         "device_resize", "uint8_ingest", "no_uint8_ingest", "batch4",
         "device_nms"])
def test_demo_streams_match_jax_cli(video, capsys, flags):
    """The banners, the quantized per-frame conv echo, the per-frame
    screen-clear / FPS / Objects blocks and the object lines: equal to the
    JAX demo's in every mode and ingest option."""
    out_t, err_t, out_j, err_j = _pair(video, capsys, flags)
    assert out_t.startswith("Demo\n")
    assert out_t.count("\033[2J\033[1;1H\nFPS:#\nObjects:\n\n") == 6
    assert re.search(r"\n\w+: \d+%", out_t)      # real detections compared
    if "-quantized" in flags:
        assert "Quantinization!" in out_t and "CONVOLUTIONAL" in out_t
    assert_streams_match(out_t, out_j, context="stdout")
    assert_streams_match(err_t, err_j, context="stderr")


def test_demo_prefix_pngs_decode_to_jax_pixels(video, capsys):
    """-prefix writes one PNG per frame count, the stale frame repeated
    between the -s gate's advances: the same files, the same pixels."""
    import cv2
    d = video[0]
    out_t, _, out_j, _ = _pair(
        video, capsys, ["-s", "2", "-fp32"],
        theirs=["-prefix", str(d / "jax")],
        ours=["-device", "cpu", "-prefix", str(d / "torch")])
    assert out_t == out_j
    jax_pngs = sorted(f for f in os.listdir(d) if f.startswith("jax_"))
    ours = sorted(f for f in os.listdir(d) if f.startswith("torch_"))
    assert jax_pngs == [f"jax_{i:08d}.png" for i in range(1, 7)]
    assert ours == [f"torch_{i:08d}.png" for i in range(1, 7)]
    for a, b in zip(ours, jax_pngs):
        pa, pb = cv2.imread(str(d / a)), cv2.imread(str(d / b))
        assert pa.shape == (80, 96, 3)
        np.testing.assert_array_equal(pa, pb)
    # the gate: frame 2 repeats frame 1, frame 3 advances
    first = cv2.imread(str(d / ours[0]))
    np.testing.assert_array_equal(cv2.imread(str(d / ours[1])), first)
    assert not np.array_equal(cv2.imread(str(d / ours[2])), first)


def test_demo_out_filename_writes_the_gated_frames(video, capsys):
    """-out_filename writes one frame per -s window (plus the first), as
    the JAX demo's writer does."""
    import cv2
    d = video[0]
    _pair(video, capsys, ["-s", "2", "-fp32"],
          theirs=["-out_filename", str(d / "jax.mp4")],
          ours=["-device", "cpu", "-out_filename", str(d / "torch.mp4")])

    def frames(path):
        cap, n = cv2.VideoCapture(path), 0
        while cap.read()[0]:
            n += 1
        return n
    assert frames(str(d / "torch.mp4")) == frames(str(d / "jax.mp4")) == 3


def test_demo_max_frames_and_missing_source(video, capsys):
    """``max_frames`` stops the stream; an unopenable source prints the
    reference's message and processes nothing, as in the JAX demo."""
    from yolo2_light_tpu.apps.demo import demo as jax_demo
    from yolo2_light_tpu_torch.apps.demo import demo
    d, _, weights, vid = video
    names = ["aaa", "bbb", "ccc"]
    assert demo(CFG, weights, 0.4, vid, names, max_frames=4,
                device="cpu") == jax_demo(CFG, weights, 0.4, vid, names,
                                          max_frames=4) == 4
    capsys.readouterr()
    missing = str(d / "missing.mp4")
    assert demo(CFG, weights, 0.4, missing, names, device="cpu") == 0
    err_t = capsys.readouterr().err
    assert jax_demo(CFG, weights, 0.4, missing, names) == 0
    err_j = capsys.readouterr().err
    assert "Couldn't connect to webcam." in err_t
    assert_streams_match(err_t, err_j, context="stderr")


def test_demo_runs_without_cv2_on_a_raw_video(video):
    """A raw video with -dont_show and no -prefix needs no OpenCV: with
    ``cv2`` blocked the demo still runs every frame, and never imports it."""
    d, names, weights, vid = video
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "from yolo2_light_tpu_torch.apps.cli import main\n"
        f"rc = main(['detector', 'demo', {names!r}, {CFG!r}, {weights!r}, "
        f"{vid!r}, '-dont_show', '-device', 'cpu'])\n"
        "assert sys.modules['cv2'] is None\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(d), timeout=600,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("Objects:") == 6


# ---------------------------------------------------------------------------
# io/rawvideo.py, the port's copy
# ---------------------------------------------------------------------------


def test_rawvideo_roundtrip_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    frames = [(rng.rand(5, 7, 3) * 255).astype(np.uint8) for _ in range(3)]
    path = str(tmp_path / "v.cvs")
    TR.write_rawvideo(path, frames, fps=9)
    other = str(tmp_path / "j.cvs")
    JR.write_rawvideo(other, frames, fps=9)
    assert open(path, "rb").read() == open(other, "rb").read()
    assert TR.is_rawvideo(path)
    cap = TR.RawVideoCapture(path)
    assert cap.isOpened()
    assert (cap.get(3), cap.get(4), cap.get(5)) == (7.0, 5.0, 9.0)
    for fr in frames:
        ok, got = cap.read()
        assert ok and np.array_equal(got, fr)
    assert cap.read() == (False, None)
    cap.release()
    assert not cap.isOpened()


def test_rawvideo_rejects_non_magic(tmp_path):
    p = tmp_path / "x.cvs"
    p.write_bytes(b"NOTMAGIC" + b"\0" * 32)
    assert not TR.is_rawvideo(str(p))
    assert not TR.is_rawvideo(str(tmp_path / "missing.cvs"))
    assert not TR.is_rawvideo(None)
    assert not TR.RawVideoCapture(str(p)).isOpened()
    short = tmp_path / "short.cvs"
    short.write_bytes(TR.MAGIC + b"\0" * 4)
    assert not TR.RawVideoCapture(str(short)).isOpened()


def test_rawvideo_shape_mismatch_raises(tmp_path):
    frames = [np.zeros((4, 4, 3), np.uint8), np.zeros((4, 5, 3), np.uint8)]
    with pytest.raises(ValueError, match="frame shape"):
        TR.write_rawvideo(str(tmp_path / "bad.cvs"), frames)
