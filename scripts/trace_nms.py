"""Where the device NMS's two kernels spend their time on the GPU.

K7 (``csrc/nms_order.cu``) runs the overlap bit rows on most of the card and
one chain of C class steps per image on one SM; the walk
(``csrc/nms_walk.cu``) one warp per class. At the shapes phase 8 of
``chip_smoke.py`` uses, on two kinds of data, ``clustered`` (chip_smoke's
synthetic buffer: each class's probs thresholded on their own, exact ties)
and ``pipeline`` (``--live`` candidates nonzero in every class, the rest
zero, as detector map's sparse heads give them), this script prints:

* times (CUDA events over 50 launches behind a device sleep,
  ``chip_smoke.event_ms``): K7 with C = 0 (the bit rows alone), C = 1 and
  all C, the slope being one class step; K7 with every class ranked by
  sorted runs and every class by the bitonic sort (``count_max``); the
  walk, and the walk with no rank to walk (its set-up and output alone);
* cycles from builds with ``-DNMS_TRACE`` (``clock64`` marks, see the
  kernels' ``Trace``): per chain block of K7 its total and its steps' three
  phases per class (gather and prefix, compaction, ranking), the bits
  blocks' cycles; per warp of the walk its set-up (stop rank, bit rows), its
  walk, its output, and the windows and candidate rows it walked.

Needs one CUDA device. Usage: ``python scripts/trace_nms.py [--live 300]``
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from yolo2_light_tpu_torch.ops import _build, nms_order, nms_walk  # noqa: E402

SHAPES = [(1, 1024, 80), (8, 256, 80), (8, 1024, 80), (8, 4096, 80),
          (1, 1024, 20)]
ORDER_FIELDS, WALK_FIELDS = 7, 6


def pipeline_like(b: int, k: int, c: int, live: int, seed: int = 7):
    """A packed buffer whose first ``live`` rows hold a candidate with a
    nonzero prob in every class (clustered boxes), the rest zero rows."""
    packed = cs._nms_packed_input(torch.device("cuda"), b, k, c)
    rng = np.random.RandomState(seed)
    probs = np.zeros((b, k, c), np.float32)
    probs[:, :live] = 0.005 + 0.5 * rng.rand(b, min(live, k), c)
    packed[..., 5:] = torch.from_numpy(probs).cuda()
    return packed


def build_traced(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with -DNMS_TRACE (beside the kernels'
    builds)."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"{name}-trace.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                          "-DNMS_TRACE", "-o", out,
                          os.path.join(_build.CSRC_DIR, f"{name}.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stderr[-4000:])
    lib = ctypes.CDLL(out)
    lib.read_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def use(name: str, lib: ctypes.CDLL) -> None:
    """Bind the wrappers of ``name`` to ``lib`` for the following calls."""
    _build._loaded[name] = lib
    nms_order.load_kernel.cache_clear()
    nms_order.prepare.cache_clear()
    nms_walk.load_kernel.cache_clear()


def read(lib, n: int, fields: int) -> np.ndarray:
    torch.cuda.synchronize()
    out = np.zeros((n, fields), np.int64)
    rc = lib.read_trace(out.ctypes.data, n)
    if rc:
        raise RuntimeError(f"read_trace: cudaError {rc}")
    return out


def bits_blocks(b: int, k: int) -> int:
    """K7's bits blocks: tiles of 32 rows (one a warp) by 32 words."""
    words = -(-k // 32)
    return b * -(-k // 32) * -(-words // 32)


def times(boxes, probs, c: int) -> dict:
    def k7(cc=c, count_max=nms_order.COUNT_MAX):
        return nms_order.nms_order_cuda(boxes, probs[..., :cc], cs.PIPE_NMS,
                                        count_max)

    t = {f"C={cc}": cs.event_ms(lambda: k7(cc)) for cc in (0, 1, c)}
    t["runs"] = cs.event_ms(lambda: k7(count_max=1 << 30))
    t["sorted"] = cs.event_ms(lambda: k7(count_max=0))
    ins = k7()
    t["walk"] = cs.event_ms(lambda: nms_walk.nms_walk_cuda(*ins[:3], probs))
    idle = torch.zeros_like(ins[2])
    t["walk, no rank"] = cs.event_ms(lambda: nms_walk.nms_walk_cuda(
        ins[0], ins[1], idle, probs))
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--live", type=int, default=cs.TARGET_LIVE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_nms: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    plain = {n: _build.load(n) for n in ("nms_order", "nms_walk")}
    traced = {n: build_traced(n) for n in ("nms_order", "nms_walk")}
    dev = torch.device("cuda")
    for b, k, c in SHAPES:
        for data in ("clustered", "pipeline"):
            packed = (cs._nms_packed_input(dev, b, k, c) if data == "clustered"
                      else pipeline_like(b, k, c, args.live))
            boxes, probs = packed[..., :4], packed[..., 5:]
            for n, lib in plain.items():
                use(n, lib)
            t = times(boxes, probs, c)
            ins = nms_order.nms_order_cuda(boxes, probs, cs.PIPE_NMS)
            live = int((ins[2] > 0).sum(1).max())
            nz = int((probs != 0).sum(1).max())
            step = (t[f"C={c}"] - t["C=1"]) / max(1, c - 1) * 1e3
            print(f"B={b} K={k} C={c} {data} ({live} live ranks, at most {nz}"
                  " nonzero probs of a class): "
                  + ", ".join(f"{key} {v:.4f}" for key, v in t.items())
                  + f" ms; a class step {step:.2f} us", flush=True)
            for n, lib in traced.items():
                use(n, lib)
            nms_order.nms_order_cuda(boxes, probs, cs.PIPE_NMS)
            rec = read(traced["nms_order"], b + bits_blocks(b, k),
                       ORDER_FIELDS)
            chain, bits = rec[:b], rec[b:]
            per = chain[:, 1:4].sum(0) / max(1, b * c)
            print(f"  nms_order trace (cycles): chain {chain[:, 0].max()} "
                  f"(gather+prefix {per[0]:.0f}, compaction {per[1]:.0f}, "
                  f"ranking {per[2]:.0f} a class; {chain[:, 4].sum()} "
                  f"classes by runs, {chain[:, 5].sum()} sorted, "
                  f"{chain[:, 6].sum() / max(1, b * c):.0f} nonzero a class);"
                  f" {len(bits)} bits blocks, median "
                  f"{int(np.median(bits[:, 0]))}, max {bits[:, 0].max()}",
                  flush=True)
            nms_walk.nms_walk_cuda(*ins[:3], probs)
            groups = -(-c // 8)
            w = read(traced["nms_walk"], b * groups * 8, WALK_FIELDS)
            w = w.reshape(b, groups * 8, WALK_FIELDS)[:, :c].reshape(
                -1, WALK_FIELDS)
            per_row = w[:, 1] / np.maximum(w[:, 4], 1)
            print(f"  nms_walk trace (cycles a warp): set-up median "
                  f"{int(np.median(w[:, 0]))}, max {w[:, 0].max()}; walk "
                  f"median {int(np.median(w[:, 1]))}, max {w[:, 1].max()}; "
                  f"output median {int(np.median(w[:, 2]))}; windows "
                  f"{w[:, 3].mean():.1f}, rows {w[:, 4].mean():.1f} a class, "
                  f"{np.median(per_row):.0f} cycles a row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
