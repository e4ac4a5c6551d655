"""Where a block of the fused residual-block kernel (K2) spends its time, on
the GPU.

Builds copies of ``yolo2_light_tpu_torch/csrc/fused_res.cu`` into
``build/trace/`` with timestamps added (``%globaltimer`` at a block's start
and end, ``clock64`` at its phase boundaries; the kernel's own code is
unchanged), checks the traced kernel against the plain version, and prints
for each of yolov3-416's five residual-block shapes: the mean device time of
a launch (CUDA events), the span from the first block's start to the last
block's end, the blocks and the most that ran on one SM, how long the last
block waited to start, a block's mean duration, and the mean cycles of
phase 1 (the 1x1 and t1q stored into the cluster's tiles; of it, the K
loops), from there to the cluster barrier's end (of it, issuing the first
w2 copies) and of phase 2 (the 3x3 and the output; of it, the K loop).

With ``--variants`` it also times diagnostic copies whose results are wrong
on purpose, to show what the time follows: ``no_x`` zero-fills the f32 halo
copies instead of reading the trunk, ``no_w`` does the same for the weight
copies, ``no_mma`` drops both products' MMAs, ``no_q`` replaces the f32
halo's quantize by a bit copy, ``no_dsmem`` stores every t1q chunk into the
block's own tile instead of the cluster's.

Usage: ``python scripts/trace_fused_res.py [--variants]``
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
from yolo2_light_tpu_torch.ops import _build  # noqa: E402
from yolo2_light_tpu_torch.ops import fused_res as FR  # noqa: E402

OUT = os.path.join(ROOT, "build", "trace")
MAX_BLOCKS = 8192
FIELDS = 9
# (anchor in fused_res.cu, what is inserted after it)
PATCHES = [
    ("namespace {\n",
     f"__device__ unsigned long long g_trace[{MAX_BLOCKS} * {FIELDS}];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int tid = threadIdx.x;\n",
     "  const unsigned long long t_start = gtime();\n"
     "  const long long c0 = clock64();\n"
     "  long long k1cyc = 0, k2cyc = 0;\n"),
    ("      quantize_own(0, 0);\n",
     "      const long long cl1 = clock64();\n"),
    ("      i8mma::cp_async_wait<0>();\n"
     "      __syncthreads();   // every warp is done with the ring\n",
     "      k1cyc += clock64() - cl1;\n"),
    ("  // ---- phase 2 set-up; its first w2 stages are copied before the "
     "barrier\n",
     "  const long long c1 = clock64();\n"),
    ("  if (m_lo < m_hi) prologue2(m_lo);\n",
     "  const long long c1a = clock64();\n"),
    ("  else __syncthreads();\n",
     "  const long long c2 = clock64();\n"),
    ("    int tap = 0, c0 = 0, slot = 0;\n",
     "    const long long cl2 = clock64();\n"),
    ("\n    i8mma::cp_async_wait<0>();\n",
     "    k2cyc += clock64() - cl2;\n"),
    ("    __syncthreads();   // the acc tile overlays the next chunk's ring\n"
     "  }\n",
     "  __syncthreads();\n"
     "  const long long c3 = clock64();\n"
     "  unsigned smid;\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     f"  if (tid == 0 && blk < {MAX_BLOCKS}) {{\n"
     f"    unsigned long long* d = g_trace + blk * {FIELDS};\n"
     "    d[0] = t_start; d[1] = gtime(); d[2] = smid;\n"
     "    d[3] = c1 - c0; d[4] = k1cyc; d[5] = c2 - c1;\n"
     "    d[6] = c3 - c2; d[7] = k2cyc; d[8] = c1a - c1;\n"
     "  }\n"),
]
# diagnostic variants: (old, new) replacements of the traced source
VARIANTS = {
    "traced": [],
    "no_x": [("valid ? a.x + xoff[j] + c : a.x, valid);",
              "a.x, false);")],
    "no_w": [("          if (a.vec1) i8mma::cp_async16(dst, src, valid);\n"
              "          else i8mma::cp_async4(dst, src, valid);\n",
              "          if (a.vec1) i8mma::cp_async16(dst, src, false);\n"
              "          else i8mma::cp_async4(dst, src, false);\n"),
             ("      if (a.vec2) i8mma::cp_async16(dst, src, valid);\n"
              "      else i8mma::cp_async4(dst, src, valid);\n",
              "      if (a.vec2) i8mma::cp_async16(dst, src, false);\n"
              "      else i8mma::cp_async4(dst, src, false);\n")],
    "no_mma": [("i8mma::warp_tile_k32<1, 4>(acc, aa,",
                "if (a.H < 0) i8mma::warp_tile_k32<1, 4>(acc, aa,"),
               ("i8mma::mma_frags<2, 2>(acc, f[kk & 1]);",
                "if (a.H < 0) i8mma::mma_frags<2, 2>(acc, f[kk & 1]);")],
    "no_q": [("                quantize_pack4(v[j], a.m1);",
              "                __float_as_int(v[j].x);")],
    "no_dsmem": [("(dst == rank ? t1q : cluster.map_shared_rank(t1q, dst))",
                  "t1q")],
}


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"anchor not found once: {old!r}")
    return src.replace(old, new)


def build_traced(variant: str) -> ctypes.CDLL:
    src = open(os.path.join(_build.CSRC_DIR, "fused_res.cu")).read()
    for anchor, insert in PATCHES:
        src = _replace_once(src, anchor, anchor + insert)
    for old, new in VARIANTS[variant]:
        src = _replace_once(src, old, new)
    src += ('extern "C" int read_trace(void* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_trace, n * '
            f'{FIELDS * 8});\n}}\n')
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"fused_res_{variant}.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, f"fused_res_{variant}.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          _build.CSRC_DIR, "-o", lib, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return ctypes.CDLL(lib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_fused_res: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    bound = FR.load_kernel()
    variants = list(VARIANTS) if args.variants else ["traced"]
    libs = {}
    for v in variants:
        libs[v] = build_traced(v)
        entry = libs[v].fused_res_block_nhwc
        entry.restype, entry.argtypes = bound.restype, bound.argtypes
    dev = torch.device("cuda")
    for i, (label, (b, h, w, c, c2)) in enumerate(cs.FUSED_SHAPES):
        x, a = cs._block_operands(dev, cs.SEED + i, b, h, w, c, c2)
        ref = FR.res_block_plain(x, **a)
        n = min(16, -(-c // 64)) * -(-h // 8) * -(-w // 8) * b
        for v in variants:
            entry = libs[v].fused_res_block_nhwc
            FR.load_kernel = lambda entry=entry: entry
            out = FR.fused_res_block_cuda(x, **a)
            torch.cuda.synchronize()
            if v == "traced":
                cs.check(torch.equal(out, ref),
                         f"traced kernel != plain at {label}")
            ms = cs.event_ms(lambda: FR.fused_res_block_cuda(x, **a))
            FR.fused_res_block_cuda(x, **a)
            torch.cuda.synchronize()
            buf = np.zeros(n * FIELDS, np.uint64)
            cs.check(libs[v].read_trace(buf.ctypes.data, n) == 0,
                     "read_trace")
            d = buf.reshape(n, FIELDS).astype(np.int64)
            t0 = d[:, 0].min()
            print(f"{label} [{v}]: {ms * 1e3:.1f} us a launch; span "
                  f"{(d[:, 1].max() - t0) / 1e3:.1f} us, {n} blocks, at most "
                  f"{np.bincount(d[:, 2].astype(int)).max()} on one SM, last "
                  f"start {(d[:, 0].max() - t0) / 1e3:.1f} us; a block "
                  f"{(d[:, 1] - d[:, 0]).mean() / 1e3:.1f} us: phase 1 "
                  f"{d[:, 3].mean():.0f} (K loops {d[:, 4].mean():.0f}), "
                  f"exchange {d[:, 5].mean():.0f} (w2 prologue "
                  f"{d[:, 8].mean():.0f}), "
                  "phase 2 "
                  f"{d[:, 6].mean():.0f} (K loop {d[:, 7].mean():.0f}) "
                  "cycles", flush=True)
        FR.load_kernel = lambda: bound
    return 0


if __name__ == "__main__":
    sys.exit(main())
