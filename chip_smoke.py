"""Chip check of the PyTorch/CUDA port (yolo2_light_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them.
2. build: compiles the kernels of ``yolo2_light_tpu_torch/csrc``, one nvcc
   per source, all started together (timed).
3. kernels: the int8 conv kernel against its plain PyTorch version on the
   card at yolov3-416's three int8 conv shape classes (3x3 s1, 3x3 s2, 1x1);
   outputs must be bit-identical. Times both with CUDA events.
4. int8: ``detector test ... -quantized`` through the CLI on yolov3-416 with
   random weights (seed 7); the kernel's launch count must rise by the size
   of the int8 set in that one forward. The same forward with the plain
   versions on the card must give equal head maps and identical detection
   lines. Times the warm b=1 forward.
5. fused: the fused residual-block kernel against its plain version at
   yolov3-416's five residual-block shapes (b1 > 0) and on a chain of two
   blocks at 104x104; bit-identical. Times the kernel, the unfused pair of
   int8 conv launches with its quantizes and add, and the plain version.
   Then ``detector test ... -quantized -int8_impl fused`` through the CLI:
   one forward must launch the fused kernel 23 times and the int8 conv
   kernel 25 times; its head maps must equal those of the int8 conv path
   and of the plain path, and its detection lines those of the int8 conv
   path. Times the warm b=1 forward of both kernel paths.
6. fp32: the same ``detector test`` without ``-quantized`` (TF32 off), its
   heads checked finite, and the port's card and CPU paths held to each
   other on a small net. Times the warm b=1 forward.

Any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
preceded by a line with one JSON object describing each kernel.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from yolo2_light_tpu_torch.apps import cli, detect
from yolo2_light_tpu_torch.models import layers, network
from yolo2_light_tpu_torch.ops import _build, fused_res, int8_conv
from yolo2_light_tpu_torch.params import save_random_weights

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
CFG = os.path.join(DATA, "yolov3.cfg")
SMALL_CFG = os.path.join(DATA, "mini-yolo3.cfg")
IMAGE = os.path.join(DATA, "dog160.png")
SEED = 7
THRESH = "0.25"         # the CLI's default -thresh
N_CLASSES = 80
HEAD_GRIDS = [13, 26, 52]
# (label, (B, H, W, C, M, ks, stride, pad)): yolov3-416's int8 conv classes
SHAPES = [
    ("3x3/s1 52x52x128->256", (1, 52, 52, 128, 256, 3, 1, 1)),
    ("3x3/s2 416x416x32->208x208x64", (1, 416, 416, 32, 64, 3, 2, 1)),
    ("1x1/s1 13x13x1024->512", (1, 13, 13, 1024, 512, 1, 1, 0)),
]
KERNEL_SOURCE = "yolo2_light_tpu_torch/csrc/int8_conv.cu"
REPLACES = "yolo2_light_tpu/ops/pallas_int8.py:141"        # conv3x3_int8_tiled
ALSO_REPLACES = "yolo2_light_tpu/ops/pallas_int8.py:71"    # conv3x3_int8_fused
# (label, (B, H, W, C, C2)): yolov3-416's residual blocks, one per stage
FUSED_SHAPES = [
    ("208x208 64->32->64", (1, 208, 208, 64, 32)),
    ("104x104 128->64->128", (1, 104, 104, 128, 64)),
    ("52x52 256->128->256", (1, 52, 52, 256, 128)),
    ("26x26 512->256->512", (1, 26, 26, 512, 256)),
    ("13x13 1024->512->1024", (1, 13, 13, 1024, 512)),
]
FUSED_SOURCE = "yolo2_light_tpu_torch/csrc/fused_res.cu"
FUSED_REPLACES = "yolo2_light_tpu/ops/pallas_fused.py:272"  # fused_res_stage
FUSED_ALSO_REPLACES = ":358"                                # ..._stage_strips
N_FUSED_BLOCKS = 23     # 1 + 2 + 8 + 8 + 4 residual blocks
N_UNFUSED_INT8 = 25     # 71 int8 convs minus the blocks' 46


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def forward_ms(pred, x, iters: int = 20, warmup: int = 3) -> float:
    """Median host wall time of one synchronised forward (input on the
    host, as ``detector test`` feeds it)."""
    for _ in range(warmup):
        pred(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        pred(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_cli(args):
    """``cli.main(args)`` with its streams captured; returns (rc, stdout)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    if rc != 0:
        sys.stderr.write(err.getvalue()[-4000:])
    return rc, out.getvalue()


def detection_text(stdout: str) -> str:
    """The detection lines ``detector test`` prints after 'Predicted in'."""
    check("Predicted in" in stdout, "no 'Predicted in' line in the output")
    tail = stdout.split("Predicted in", 1)[1]
    return tail.split("\n", 1)[1].rstrip("\n") if "\n" in tail else ""


def check_same_lines(a: str, b: str, what: str) -> None:
    la, lb = a.splitlines(), b.splitlines()
    if la == lb:
        return
    diff = [(i, x, y) for i, (x, y) in enumerate(zip(la, lb)) if x != y]
    print(f"{what}: {len(la)} vs {len(lb)} lines, {len(diff)} differ; "
          f"first: {diff[:5]}", file=sys.stderr)
    raise AssertionError(f"{what} differ")


def check_heads(heads, what: str) -> None:
    check([h.index for h in heads] == [82, 94, 106], f"{what}: head layers")
    for h, g in zip(heads, HEAD_GRIDS):
        check(tuple(h.data.shape) == (1, g, g, 3, 5 + N_CLASSES),
              f"{what}: head {h.index} shape {tuple(h.data.shape)}")
        check(bool(torch.isfinite(h.data).all()),
              f"{what}: head {h.index} has non-finite values")


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs one NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    say("device", f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return line


def phase_build() -> None:
    t0 = time.perf_counter()
    names = ("int8_conv", "fused_res")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    int8_conv.load_kernel()
    fused_res.load_kernel()
    for name, path in zip(names, paths):
        say("build", f"csrc/{name}.cu -> {os.path.relpath(path, ROOT)}")
    say("build", f"{len(names)} kernels in {time.perf_counter() - t0:.2f} s, "
        f"built in parallel (nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_kernels() -> list:
    dev = torch.device("cuda")
    rows = []
    for i, (label, (b, h, w, c, m, ks, s, pad)) in enumerate(SHAPES):
        rng = np.random.RandomState(SEED + i)
        x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(
            np.int8)).to(dev)
        wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
            np.int8)).to(dev)
        bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
        alpha = int8_conv.alpha_f32(40.0, 16.0)
        err = 0.0
        for act in ("leaky", "linear"):
            out = int8_conv.conv2d_int8_cuda(x, wt, bias, alpha, s, pad, act)
            ref = int8_conv.conv2d_int8_plain(x, wt, bias, alpha, s, pad, act)
            torch.cuda.synchronize()
            check(torch.equal(out, ref),
                  f"kernel != plain at {label} ({act})")
            err = max(err, float((out - ref).abs().max()))
        k_ms = event_ms(lambda: int8_conv.conv2d_int8_cuda(
            x, wt, bias, alpha, s, pad, "leaky"))
        p_ms = event_ms(lambda: int8_conv.conv2d_int8_plain(
            x, wt, bias, alpha, s, pad, "leaky"), iters=10)
        say("kernels", f"{label}: bit-identical to plain (max_abs_err {err}); "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        rows.append({"shape": label, "ms": k_ms, "plain_ms": p_ms,
                     "max_abs_err": err})
    return rows


def phase_int8(tmp: str, weights: str, names_file: str, names: list):
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-quantized",
            "-dont_show", "-thresh", THRESH, "-save",
            os.path.join(tmp, "pred_int8")]
    int8_conv.reset_launch_counts()
    rc, out = run_cli(args)
    launches = int8_conv.LAUNCH_COUNTS["int8_conv"]
    check(rc == 0, f"detector test -quantized exited {rc}")
    kernel_text = detection_text(out)
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("int8", f"CLI: {predicted}; {len(kernel_text.splitlines())} "
        "detection lines")

    spec, params, _ = detect.build_params(CFG, weights, quantized=True,
                                          echo=False)
    int8_set = network._int8_layer_set(spec, "cpu")
    check(len(int8_set) == 71, f"int8 set of yolov3 has {len(int8_set)} convs")
    check(launches == len(int8_set),
          f"int8 kernel launched {launches} times in one forward, expected "
          f"{len(int8_set)}")
    say("int8", f"int8_conv launches in one forward: {launches} (int8 set: "
        f"{len(int8_set)} of {len(spec.conv_layers())} convs)")

    kernel = network.Predictor(spec, params, "int8", device="cuda")
    plain = network.Predictor(spec, params, "int8", device="cuda",
                              int8_impl="plain")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    hk, hp, hk2 = kernel(x), plain(x), kernel(x)
    check_heads(hk, "int8 kernel path")
    for a, b, c in zip(hk, hp, hk2):
        check(torch.equal(a.data, b.data),
              f"int8 head {a.index}: kernel path != plain path")
        check(torch.equal(a.data, c.data),
              f"int8 head {a.index}: two kernel-path runs differ")
    say("int8", "head maps of the kernel path and the plain path are equal "
        "(3 heads), and equal across two kernel-path runs")

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        plain_text = detect.run(names, CFG, weights, IMAGE,
                                thresh=float(THRESH), quantized=True,
                                save_path=os.path.join(tmp, "pred_plain"),
                                int8_impl="plain", device="cuda")
    check_same_lines(kernel_text, plain_text.rstrip("\n"),
                     "detection lines of the kernel and the plain path")
    say("int8", "detection lines of the kernel path and the plain path are "
        "identical")

    k_ms = forward_ms(kernel, x)
    p_ms = forward_ms(plain, x, iters=5)
    say("int8", f"warm b=1 forward: kernel path {k_ms:.3f} ms, plain path "
        f"{p_ms:.3f} ms (median, host clock, synchronised)")
    return launches, dict(spec=spec, params=params, x=x, kernel=kernel,
                          k1_heads=hk, plain_heads=hp, k1_text=kernel_text)


def _block_operands(dev, seed: int, b: int, h: int, w: int, c: int,
                    c2: int, b1_shift: float = 2.0):
    """A trunk and one residual block's arguments, with b1 > 0 so a wrong
    halo mask would show on the image border."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32) * 4)
    m1, m2 = np.float32(rng.uniform(8, 24)), np.float32(rng.uniform(8, 24))
    args = dict(
        w1=torch.from_numpy(rng.randint(-127, 128, (c2, 1, 1, c)).astype(
            np.int8)).to(dev),
        b1=torch.from_numpy((rng.randn(c2) + b1_shift).astype(
            np.float32)).to(dev),
        m1=float(m1), alpha1=int8_conv.alpha_f32(m1, rng.uniform(64, 256)),
        w2=torch.from_numpy(rng.randint(-127, 128, (c, 3, 3, c2)).astype(
            np.int8)).to(dev),
        b2=torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev),
        m2=float(m2), alpha2=int8_conv.alpha_f32(m2, rng.uniform(64, 256)))
    return x.to(dev), args


def _unfused_block(x, a):
    """The int8 conv path's residual block: two int8 conv launches with
    their input quantizes, then the shortcut add."""
    t1 = layers.conv2d_int8(x, a["w1"], a["b1"], 1, 0, "leaky", a["m1"],
                            a["alpha1"])
    t2 = layers.conv2d_int8(t1, a["w2"], a["b2"], 1, 1, "leaky", a["m2"],
                            a["alpha2"])
    return layers.shortcut(t2, x, "linear")


def phase_fused_kernels() -> list:
    dev = torch.device("cuda")
    rows = []
    for i, (label, (b, h, w, c, c2)) in enumerate(FUSED_SHAPES):
        x, a = _block_operands(dev, SEED + i, b, h, w, c, c2)
        out = fused_res.fused_res_block_cuda(x, **a)
        ref = fused_res.res_block_plain(x, **a)
        unfused = _unfused_block(x, a)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"fused kernel != plain at {label}")
        check(torch.equal(out, unfused),
              f"fused kernel != int8 conv path at {label}")
        err = float((out - ref).abs().max())
        k_ms = event_ms(lambda: fused_res.fused_res_block_cuda(x, **a))
        u_ms = event_ms(lambda: _unfused_block(x, a))
        p_ms = event_ms(lambda: fused_res.res_block_plain(x, **a), iters=10)
        say("fused", f"{label}: bit-identical to plain and to the int8 conv "
            f"path (max_abs_err {err}); kernel {k_ms:.4f} ms, int8 conv path "
            f"{u_ms:.4f} ms (2 int8_conv + 8 quantize + 1 add launches), "
            f"plain {p_ms:.4f} ms")
        rows.append({"shape": label, "ms": k_ms, "unfused_ms": u_ms,
                     "plain_ms": p_ms, "max_abs_err": err})
    x, a1 = _block_operands(dev, SEED + 10, 1, 104, 104, 128, 64)
    _, a2 = _block_operands(dev, SEED + 11, 1, 104, 104, 128, 64, -1.0)
    keep = x.clone()
    out = fused_res.run_blocks(x, [a1, a2])
    ref = fused_res.res_block_plain(fused_res.res_block_plain(x, **a1), **a2)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "fused K=2 chain at 104x104 != plain")
    check(torch.equal(x, keep), "fused K=2 chain wrote its input")
    say("fused", "K=2 chain at 104x104x128: bit-identical to plain, input "
        "untouched")
    return rows


def phase_fused(tmp: str, weights: str, names_file: str, k1: dict):
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-quantized",
            "-int8_impl", "fused", "-dont_show", "-thresh", THRESH, "-save",
            os.path.join(tmp, "pred_fused")]
    int8_conv.reset_launch_counts()
    rc, out = run_cli(args)
    launches = dict(int8_conv.LAUNCH_COUNTS)
    check(rc == 0, f"detector test -quantized -int8_impl fused exited {rc}")
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("fused", f"CLI: {predicted}")
    check(launches.get("fused_res_block", 0) == N_FUSED_BLOCKS,
          f"fused kernel launched {launches.get('fused_res_block', 0)} "
          f"times in one forward, expected {N_FUSED_BLOCKS}")
    check(launches.get("int8_conv", 0) == N_UNFUSED_INT8,
          f"int8 conv kernel launched {launches.get('int8_conv', 0)} times "
          f"in one fused forward, expected {N_UNFUSED_INT8}")
    say("fused", f"launches in one forward: fused_res_block "
        f"{launches['fused_res_block']}, int8_conv {launches['int8_conv']}")
    check_same_lines(detection_text(out), k1["k1_text"],
                     "detection lines of the fused and the int8 conv path")
    say("fused", "detection lines of the fused path and the int8 conv path "
        "are identical")

    fused = network.Predictor(k1["spec"], k1["params"], "int8",
                              device="cuda", int8_impl="fused")
    x = k1["x"]
    hf = fused(x)
    check_heads(hf, "fused path")
    for a, b, c in zip(hf, k1["k1_heads"], k1["plain_heads"]):
        check(torch.equal(a.data, b.data),
              f"int8 head {a.index}: fused path != int8 conv path")
        check(torch.equal(a.data, c.data),
              f"int8 head {a.index}: fused path != plain path")
    say("fused", "head maps of the fused path equal those of the int8 conv "
        "path and of the plain path (3 heads)")
    f_ms = forward_ms(fused, x)
    k_ms = forward_ms(k1["kernel"], x)
    say("fused", f"warm b=1 forward: fused path {f_ms:.3f} ms, int8 conv "
        f"path {k_ms:.3f} ms (median, host clock, synchronised)")
    return launches


def phase_fp32(tmp: str, weights: str, names_file: str) -> None:
    args = ["detector", "test", names_file, CFG, weights, IMAGE, "-dont_show",
            "-thresh", THRESH, "-save", os.path.join(tmp, "pred_fp32")]
    rc, out = run_cli(args)
    check(rc == 0, f"detector test exited {rc}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    predicted = [l for l in out.splitlines() if "Predicted in" in l][0]
    say("fp32", f"CLI: {predicted}; {len(detection_text(out).splitlines())} "
        "detection lines")

    spec, params, _ = detect.build_params(CFG, weights, echo=False)
    pred = network.Predictor(spec, params, "fp32", device="cuda")
    x = np.random.RandomState(SEED).rand(1, 416, 416, 3).astype(np.float32)
    check_heads(pred(x), "fp32")
    say("fp32", f"warm b=1 forward: {forward_ms(pred, x):.3f} ms (median, "
        "host clock, synchronised)")

    # the card against the port's CPU path on a small net
    small, small_params, _ = detect.build_params(SMALL_CFG, None, echo=False)
    xs = np.random.RandomState(SEED).rand(2, 64, 64, 3).astype(np.float32)
    on_card = network.Predictor(small, small_params, device="cuda")(xs)
    on_cpu = network.Predictor(small, small_params, device="cpu")(xs)
    err = 0.0
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.data.cpu(), b.data, rtol=1e-4, atol=1e-5)
        err = max(err, float((a.data.cpu() - b.data).abs().max()))
    say("fp32", f"mini-yolo3 on the card vs on the CPU: max abs diff {err:.3g} "
        "(rtol 1e-4, atol 1e-5)")


def main() -> int:
    smi_line = phase_device()
    phase_build()
    rows = phase_kernels()
    fused_rows = phase_fused_kernels()
    names = [f"class_{i:02d}" for i in range(N_CLASSES)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        weights = os.path.join(tmp, "yolov3.weights")
        save_random_weights(CFG, weights, seed=SEED)
        names_file = os.path.join(tmp, "coco80.names")
        with open(names_file, "w") as f:
            f.write("\n".join(names) + "\n")
        launches, k1 = phase_int8(tmp, weights, names_file, names)
        fused_launches = phase_fused(tmp, weights, names_file, k1)
        del k1
        phase_fp32(tmp, weights, names_file)
    print(json.dumps({"kernels": [{
        "name": "int8_conv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "also_replaces": ALSO_REPLACES,
        "launches": launches,
        "launches_fused_path": fused_launches["int8_conv"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "shapes": rows}, {
        "name": "fused_res_block", "route": "cuda", "source": FUSED_SOURCE,
        "replaces": FUSED_REPLACES, "also_replaces": FUSED_ALSO_REPLACES,
        "launches": fused_launches["fused_res_block"],
        "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
        "ms": sum(r["ms"] for r in fused_rows),
        "plain_ms": sum(r["plain_ms"] for r in fused_rows),
        "unfused_ms": sum(r["unfused_ms"] for r in fused_rows),
        "shapes": fused_rows}]}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
