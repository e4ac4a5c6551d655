"""Where a block of the bf16 conv kernel (K6) spends its time, on the GPU.

Builds a copy of ``yolo2_light_tpu_torch/csrc/bf16_conv.cu`` into
``build/trace/`` with timestamps added (``%globaltimer`` at a block's start
and end, ``clock64`` at the phase marks; the kernel's own code is
unchanged), checks it against the plain twin, and prints for each of
yolov3-416's 23 conv shapes at b=1: the plan, the mean device time of a
launch (CUDA events), the span from the first block's start to the last
block's end, the blocks and the most that ran on one SM, how long the last
block waited to start, a block's mean duration and the mean cycles of its
phases. The main kernel's phases: prologue (halo table, first weight
copies), main loop (its rank's K slabs), store (unsplit: the fragments
through the epilogue; split: the partial tile staged, the cluster's
partials summed in rank order, the epilogue, the stores, both cluster
barriers) and the wait at a last block barrier. The c3 form's: loads (weights, the A rows built), MMAs (and the
staged tile), the store pass.

``--plans``: each of yolov3-416's 23 conv shapes at b=1 under every slab
width, tile, ring depth and split (1, 2, 4, 8) the kernel takes, each
within the float32-accumulate bound of the twin: the time of each, the
planner's plan and the fastest.

``--parent DIR``: times the K6 of another checkout of the repository (a
``git archive`` unpacked in DIR) at the 23 shapes in a subprocess, before
and after this one's (parent, this, parent), in one run on one card; where
DIR holds K6's first design (one block per output tile, no split, the
bare conv), also traces its blocks at the shapes this design leaves
unsplit, with the same phase marks, beside this design's. The traced
builds print their registers, spills and shared memory (``ptxas -v``).

Results are also written to ``build/trace/trace_bf16_conv.json``. Needs
one CUDA device.

Usage: ``python scripts/trace_bf16_conv.py [--plans] [--parent DIR]``
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from yolo2_light_tpu_torch.models import layers  # noqa: E402
from yolo2_light_tpu_torch.ops import _build  # noqa: E402
from yolo2_light_tpu_torch.ops import bf16_conv as B  # noqa: E402

OUT = os.path.join(ROOT, "build", "trace")
RESULTS = os.path.join(OUT, "trace_bf16_conv.json")
MAX_BLOCKS = 16384
_RECORD = (
    "  __syncthreads();\n"
    "  const long long c4 = clock64();\n"
    "  unsigned smid;\n"
    "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
    "  const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
    f"  if (threadIdx.x == 0 && blk < {MAX_BLOCKS}) {{\n"
    "    unsigned long long* d = g_trace + blk * 7;\n"
    "    d[0] = t_start; d[1] = gtime(); d[2] = smid;\n"
    "    d[3] = c1 - c0; d[4] = c2 - c1; d[5] = c3 - c2; d[6] = c4 - c3;\n"
    "  }\n")
_START = ("  const unsigned long long t_start = gtime();\n"
          "  const long long c0 = clock64();\n")
_TIMER = ("namespace {\n",
          f"__device__ unsigned long long g_trace[{MAX_BLOCKS} * 7];\n"
          "__device__ __forceinline__ unsigned long long gtime() {\n"
          "  unsigned long long t;\n"
          "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
          "  return t;\n}\n")
# (anchor in bf16_conv.cu, what is inserted after it)
PATCHES = [
    _TIMER,
    # the main kernel
    ("  const int n_slabs = (rank + 1) * a.slabs / split - s_lo;\n", _START),
    ("  __syncthreads();   // the halo table\n",
     "  const long long c1 = clock64();\n"),
    ("  i8mma::cp_async_wait<0>();   // the main loop's copies, all landed\n",
     "  const long long c2 = clock64();\n"),
    ("  }  // the store\n", "  const long long c3 = clock64();\n" + _RECORD),
    # the c3 form
    ("  constexpr int kReal = KS * kRow;      // K values of a pixel\n",
     _START),
    ("  i8mma::cp_async_wait<0>();\n  __syncthreads();\n\n",
     "  const long long c1 = clock64();\n"),
    ("  stage_acc(tile, acc, wp, wn, lane);\n",
     "  const long long c2 = clock64();\n"),
    ("  store_tile<1>(a, ep, tile, 0, true, p0, 0, 0, 0, m0);\n",
     "  const long long c3 = clock64();\n" + _RECORD),
]
# the same marks in K6's first design (one block per tile, no split; its
# main kernel had the same prologue, main loop and store as this design's
# unsplit path, with the bare conv's stores)
FIRST_PATCHES = [
    _TIMER,
    ("  const int P = a.B * a.OH * a.OW;\n", _START),
    ("  __syncthreads();   // the halo table\n",
     "  const long long c1 = clock64();\n"),
    ("  i8mma::cp_async_wait<0>();\n", "  const long long c2 = clock64();\n"),
    ("          if (n + 1 < a.M) dst[n + 1] = v1;\n        }\n      }\n"
     "    }\n", "  const long long c3 = clock64();\n" + _RECORD),
]


def build_traced(src_path: str, patches, name: str) -> ctypes.CDLL:
    """``src_path`` with the phase marks of ``patches``, built into
    ``build/trace/<name>.so``; prints each kernel's registers, spills and
    shared memory."""
    src = open(src_path).read()
    for anchor, insert in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + insert)
    src += ('extern "C" int read_trace(void* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_trace, n * 56);\n}\n')
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"{name}.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                          "-Xptxas", "-v", "-I", os.path.dirname(src_path),
                          "-o", lib, path], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    for line in res.stderr.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"{name}: {line.strip()}", flush=True)
    return ctypes.CDLL(lib)


def _operands(i: int, shape):
    h, w, c, m, ks, _, _ = shape
    rng = np.random.RandomState(cs.SEED + i)
    x = torch.from_numpy(rng.randn(1, h, w, c).astype(np.float32)).cuda()
    wt = torch.from_numpy((rng.randn(m, ks, ks, c) / np.sqrt(ks * ks * c))
                          .astype(np.float32)).cuda().to(torch.bfloat16)
    return x, wt


def _k32(wt):
    """The c3 form's padded weights where ``wt`` is a first conv's."""
    return B.pad_k32(wt) if B.c3_form(wt.shape[3], wt.shape[1]) else None


def _label(shape) -> str:
    h, w, c, m, ks, s, _ = shape
    return f"{ks}x{ks}/s{s} {h}x{w}x{c}->{m}"


def _plan_text(p) -> str:
    tile = "flat" if p.tile_h == 0 else f"{p.tile_h}x{p.tile_w}"
    return (f"{p.form} {tile} kc{p.kc} split{p.split} st{p.stages} "
            f"({p.blocks} blocks)")


def _traced_row(lib, launch, n: int, label: str, plan_text: str,
                names) -> dict:
    """Times ``launch`` (CUDA events), runs it once more and reads its
    ``n`` blocks' marks from ``lib``; prints and returns the row."""
    ms = cs.event_ms(launch)
    launch()
    torch.cuda.synchronize()
    buf = np.zeros(n * 7, np.uint64)
    cs.check(lib.read_trace(buf.ctypes.data, n) == 0, "read_trace")
    t = buf.reshape(n, 7).astype(np.int64)
    t0 = t[:, 0].min()
    row = {"shape": label, "plan": plan_text, "ms": ms,
           "span_us": (t[:, 1].max() - t0) / 1e3, "blocks": n,
           "most_on_one_sm": int(np.bincount(t[:, 2].astype(int)).max()),
           "last_start_us": (t[:, 0].max() - t0) / 1e3,
           "block_us": float((t[:, 1] - t[:, 0]).mean()) / 1e3,
           "phase_cycles": [float(t[:, j].mean()) for j in range(3, 7)]}
    print(f"{label} {plan_text}: {ms * 1e3:.1f} us a launch; "
          f"span {row['span_us']:.1f} us, {n} blocks, at most "
          f"{row['most_on_one_sm']} on one SM, last start "
          f"{row['last_start_us']:.1f} us; a block {row['block_us']:.1f} "
          "us: " + ", ".join(f"{k} {v:.0f}" for k, v in
                            zip(names, row["phase_cycles"]) if k != "-")
          + " cycles", flush=True)
    return row


_PHASES = ("prologue", "main loop", "store", "last wait")


def trace(lib, shapes) -> list:
    rows = []
    for i, shape in shapes:
        h, w, c, m, ks, s, pad = shape
        x, wt = _operands(i, shape)
        k32 = _k32(wt)
        plan = B.plan_launch(1, h, w, c, m, ks, s, pad)
        out = B.conv2d_bf16_cuda(x, wt, s, pad, w_k32=k32)
        ref = B.conv2d_bf16_plain(x, wt, s, pad)
        d = (out.double() - ref.double()).abs()
        cs.check(bool((d <= B.sum_bound(x, wt, s, pad)).all()),
                 f"traced K6 off its twin at {_label(shape)}")
        rows.append(_traced_row(
            lib, lambda: B.conv2d_bf16_cuda(x, wt, s, pad, w_k32=k32),
            plan.blocks, _label(shape), _plan_text(plan),
            ("loads", "MMAs", "store", "-") if plan.form == "c3"
            else _PHASES))
    return rows


def trace_first(lib, shapes, first_plans: list) -> list:
    """K6's first design, traced, at the shapes this design leaves unsplit
    (not the first conv, whose form changed): its entry point takes x, w,
    out, B, H, W, C, M, OH, OW, ks, stride, pad, tile_h, tile_w, stages,
    device, stream; the plan (tile_h, tile_w, stages, blocks) is the first
    design's own, from its planner."""
    fn = lib.bf16_conv_nhwc
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    rows = []
    for i, shape in shapes:
        h, w, c, m, ks, s, pad = shape
        if c == 3 or B.plan_launch(1, *shape).split != 1:
            continue
        x, wt = _operands(i, shape)
        th, tw, st, n = first_plans[i]
        oh, ow = (h + 2 * pad - ks) // s + 1, (w + 2 * pad - ks) // s + 1
        out = torch.empty((1, oh, ow, m), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            cs.check(fn(x.data_ptr(), wt.data_ptr(), out.data_ptr(), 1, h, w,
                        c, m, oh, ow, ks, s, pad, th, tw, st, 0,
                        stream) == 0, "first design's launch")
        launch()
        torch.cuda.synchronize()
        # unsplit, both designs sum each output in one order
        cs.check(torch.equal(out, cs.k6_bare(x, wt, s, pad)),
                 f"first design != this design at {_label(shape)}")
        tile = "flat" if th == 0 else f"{th}x{tw}"
        rows.append(_traced_row(lib, launch, n, _label(shape),
                                f"first design {tile} st{st} ({n} blocks)",
                                _PHASES))
    return rows


def _candidates(shape):
    """Every (kc, tile, stages, split) the kernel takes at ``shape``."""
    h, w, c, m, ks, s, pad = shape
    base = B.plan_launch(1, h, w, c, m, ks, s, pad)
    if base.form == "c3":
        return [base]
    out = []
    flat = base.form == "flat"
    for kc in ((16, 32) if c % 32 == 0 else (16,)):
        for th, tw in [(0, 0)] if flat else B._SPATIAL_TILES:
            rows = (B.TILE_PIXELS if flat
                    else ((th - 1) * s + ks) * ((tw - 1) * s + ks))
            slabs = -(-c // kc)
            for st in B.STAGES:
                sm = B._smem_bytes(rows, ks * ks, st, kc)
                if sm > B.MAX_SMEM:
                    continue
                for split in sorted({1, 2, 4, 8, base.split}):
                    if split <= slabs:
                        out.append(base._replace(
                            tile_h=th, tile_w=tw, kc=kc, stages=st,
                            split=split, halo_rows=rows, slabs=slabs,
                            smem=sm))
    return out


def plans(shapes) -> list:
    rows = []
    for i, shape in shapes:
        h, w, c, m, ks, s, pad = shape
        x, wt = _operands(i, shape)
        ref = B.conv2d_bf16_plain(x, wt, s, pad)
        lim = B.sum_bound(x, wt, s, pad)
        base = B.plan_launch(1, h, w, c, m, ks, s, pad)
        timed = []
        k32 = _k32(wt)
        for p in _candidates(shape):
            out = B.conv2d_bf16_cuda(x, wt, s, pad, w_k32=k32, plan=p)
            d = (out.double() - ref.double()).abs()
            cs.check(bool((d <= lim).all()),
                     f"K6 {_label(shape)} {_plan_text(p)} off its twin")
            timed.append((cs.event_ms(lambda: B.conv2d_bf16_cuda(
                x, wt, s, pad, w_k32=k32, plan=p)), p))
        best_ms, best = min(timed, key=lambda t: t[0])
        base_ms = next(t for t, p in timed if p._replace(
            tiles=0, blocks=0) == base._replace(tiles=0, blocks=0))
        print(f"{_label(shape)}: planner {_plan_text(base)} "
              f"{base_ms * 1e3:.1f} us; fastest {_plan_text(best)} "
              f"{best_ms * 1e3:.1f} us; "
              + "; ".join(f"{_plan_text(p)} {t * 1e3:.1f}"
                          for t, p in timed), flush=True)
        rows.append({"shape": _label(shape), "planner": _plan_text(base),
                     "planner_ms": base_ms, "fastest": _plan_text(best),
                     "fastest_ms": best_ms,
                     "all": [[_plan_text(p), t] for t, p in timed]})
    return rows


_PARENT_CODE = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
from yolo2_light_tpu_torch.models import layers
from yolo2_light_tpu_torch.ops import bf16_conv as B
layers.set_fp32_precision()
bare = getattr(cs, "k6_bare", B.conv2d_bf16_cuda)
out, plans = [], []
for i, (h, w, c, m, ks, s, pad) in enumerate(cs._bf16_shapes()):
    rng = np.random.RandomState(cs.SEED + i)
    x = torch.from_numpy(rng.randn(1, h, w, c).astype(np.float32)).cuda()
    wt = torch.from_numpy((rng.randn(m, ks, ks, c) / np.sqrt(ks * ks * c))
                          .astype(np.float32)).cuda().to(torch.bfloat16)
    out.append(cs.event_ms(lambda: bare(x, wt, s, pad)))
    p = B.plan_launch(1, h, w, c, m, ks, s, pad)
    plans.append([p.tile_h, p.tile_w, p.stages, p.blocks])
print(json.dumps({"ms": out, "plans": plans}))
"""


def _parent_ms(parent_dir: str) -> dict:
    res = subprocess.run([sys.executable, "-c", _PARENT_CODE],
                         cwd=parent_dir, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=parent_dir))
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def parent(parent_dir: str) -> tuple:
    """K6 of the checkout in ``parent_dir`` (bare conv) at the 23 shapes,
    timed before and after this checkout's bare conv and its conv with
    bias and leaky in the store; returns the rows and the parent's plans
    (tile_h, tile_w, stages, blocks) at each shape."""
    before = _parent_ms(parent_dir)
    rows = []
    for i, shape in enumerate(cs._bf16_shapes()):
        x, wt = _operands(i, shape)
        k32 = _k32(wt)
        s, pad = shape[5], shape[6]
        bias = torch.randn(shape[3], device="cuda")
        new = cs.event_ms(lambda: B.conv2d_bf16_cuda(x, wt, s, pad,
                                                     w_k32=k32))
        fused = cs.event_ms(lambda: B.conv2d_bf16_cuda(
            x, wt, s, pad, w_k32=k32, biases=bias, activation="leaky"))
        rows.append({"shape": _label(shape), "ms": new, "fused_ms": fused})
    after = _parent_ms(parent_dir)
    for i, row in enumerate(rows):
        row["parent_ms"], row["parent_again_ms"] = (before["ms"][i],
                                                    after["ms"][i])
        print(f"{row['shape']}: parent {row['parent_ms'] * 1e3:.1f} us "
              f"(again after this: {row['parent_again_ms'] * 1e3:.1f}), this "
              f"{row['ms'] * 1e3:.1f} us, with bias and leaky "
              f"{row['fused_ms'] * 1e3:.1f} us", flush=True)
    print(f"summed over the 23 shapes: parent {sum(before['ms']):.4f} ms "
          f"(again {sum(after['ms']):.4f}), this "
          f"{sum(r['ms'] for r in rows):.4f} ms, with bias and leaky "
          f"{sum(r['fused_ms'] for r in rows):.4f} ms", flush=True)
    return rows, before["plans"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_bf16_conv: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    layers.set_fp32_precision()
    shapes = list(enumerate(cs._bf16_shapes()))
    result = {}
    first_src = None
    if args.parent:
        parent_dir = os.path.abspath(args.parent)
        result["parent"], first_plans = parent(parent_dir)
        src = os.path.join(parent_dir, "yolo2_light_tpu_torch", "csrc",
                           "bf16_conv.cu")
        text = open(src).read()
        if all(text.count(anchor) == 1 for anchor, _ in FIRST_PATCHES):
            first_src = src
    if args.plans:
        result["plans"] = plans(shapes)
    lib = build_traced(os.path.join(_build.CSRC_DIR, "bf16_conv.cu"), PATCHES,
                       "bf16_conv_traced")
    entry = lib.bf16_conv_nhwc
    bound = B.load_kernel()
    entry.restype, entry.argtypes = bound.restype, bound.argtypes
    B.load_kernel = lambda: entry
    result["trace"] = trace(lib, shapes)
    if first_src:
        first = build_traced(first_src, FIRST_PATCHES, "bf16_conv_first")
        result["trace_first"] = trace_first(first, shapes, first_plans)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
