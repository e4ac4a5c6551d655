"""Where a block of the int8 conv kernel (K1) spends its time, on the GPU.

Builds a copy of ``yolo2_light_tpu_torch/csrc/int8_conv.cu`` into
``build/trace/``, its body (``csrc/int8_conv.cuh``) with timestamps added (``%globaltimer`` at a block's start
and end, ``clock64`` after its prologue, after its main loop and after its
epilogue; the kernel's own code is unchanged), checks it against the plain
version, and prints for each of yolov3-416's 15 int8 conv classes and both
input forms: the mean device time of a launch (CUDA events), the span from
the first block's start to the last block's end, the blocks and the most
that ran on one SM, how long the last block waited to start, a block's mean
duration, and the mean cycles of its prologue (halo table, first copies
issued), main loop (the K slabs) and epilogue (cluster sum, requant,
stores). Needs one CUDA device.

Usage: ``python scripts/trace_int8_conv.py``
"""

from __future__ import annotations

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
from yolo2_light_tpu_torch.ops import int8_conv as K  # noqa: E402

OUT = os.path.join(ROOT, "build", "trace")
MAX_BLOCKS = 8192
# (anchor in int8_conv.cuh, what is inserted after it)
PATCHES = [
    ("namespace {\n",
     f"__device__ unsigned long long g_trace[{MAX_BLOCKS} * 6];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int tid = threadIdx.x;\n",
     "  const unsigned long long t_start = gtime();\n"
     "  const long long c0 = clock64();\n"),
    ("  __syncthreads();   // the halo table\n",
     "  const long long c1 = clock64();\n"),
    ("  __syncthreads();   // every warp is done with the pipeline buffers\n",
     "  const long long c2 = clock64();\n"),
    ("  // no block may leave while a peer still reads its partial tile\n"
     "  if (split > 1) cluster.sync();\n",
     "  __syncthreads();\n"
     "  const long long c3 = clock64();\n"
     "  unsigned smid;\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "  const int blk = blockIdx.y * gridDim.x + blockIdx.x;\n"
     f"  if (tid == 0 && blk < {MAX_BLOCKS}) {{\n"
     "    unsigned long long* d = g_trace + blk * 6;\n"
     "    d[0] = t_start; d[1] = gtime(); d[2] = smid;\n"
     "    d[3] = c1 - c0; d[4] = c2 - c1; d[5] = c3 - c2;\n"
     "  }\n"),
]


def build_traced() -> ctypes.CDLL:
    body = open(os.path.join(_build.CSRC_DIR, "int8_conv.cuh")).read()
    for anchor, insert in PATCHES:
        if body.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        body = body.replace(anchor, anchor + insert)
    src = open(os.path.join(_build.CSRC_DIR, "int8_conv.cu")).read()
    src += ('extern "C" int read_trace(void* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, g_trace, n * 48);\n}\n')
    os.makedirs(OUT, exist_ok=True)
    # the traced body beside the copy: its #include finds this one first
    with open(os.path.join(OUT, "int8_conv.cuh"), "w") as f:
        f.write(body)
    path = os.path.join(OUT, "int8_conv_traced.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, "int8_conv_traced.so")
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                          _build.CSRC_DIR, "-o", lib, path],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return ctypes.CDLL(lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_int8_conv: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build_traced()
    entry = lib.int8_conv_nhwc
    bound = K.load_kernel()
    entry.restype, entry.argtypes = bound.restype, bound.argtypes
    K.load_kernel = lambda mish=False: entry
    dev = torch.device("cuda")
    alpha = K.alpha_f32(cs.IN_MULT, cs.W_MULT)
    for i, (label, (b, h, w, c, m, ks, s, pad)) in enumerate(cs.SHAPES):
        rng = np.random.RandomState(cs.SEED + i)
        x = torch.from_numpy((rng.randn(b, h, w, c) * 4).astype(
            np.float32)).to(dev)
        x8 = K.quantize_i8(x, cs.IN_MULT)
        wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
            np.int8)).to(dev)
        bias = torch.from_numpy(rng.randn(m).astype(np.float32)).to(dev)
        ref = K.conv2d_int8_plain(x8, wt, bias, alpha, s, pad)
        for f32 in (True, False):
            if f32:
                def call():
                    return K.conv2d_int8_f32_cuda(x, wt, bias, cs.IN_MULT,
                                                  alpha, s, pad)
            else:
                def call():
                    return K.conv2d_int8_cuda(x8, wt, bias, alpha, s, pad)
            cs.check(torch.equal(call(), ref), f"traced kernel != plain at "
                     f"{label}")
            ms = cs.event_ms(call)
            call()
            torch.cuda.synchronize()
            n = K.plan_launch(b, h, w, c, m, ks, s, pad, f32).blocks
            buf = np.zeros(n * 6, np.uint64)
            cs.check(lib.read_trace(buf.ctypes.data, n) == 0, "read_trace")
            d = buf.reshape(n, 6).astype(np.int64)
            t0 = d[:, 0].min()
            print(f"{label} ({'f32' if f32 else 'int8'} input): {ms * 1e3:.1f}"
                  f" us a launch; span {(d[:, 1].max() - t0) / 1e3:.1f} us, "
                  f"{n} blocks, at most "
                  f"{np.bincount(d[:, 2].astype(int)).max()} on one SM, last "
                  f"start {(d[:, 0].max() - t0) / 1e3:.1f} us; a block "
                  f"{(d[:, 1] - d[:, 0]).mean() / 1e3:.1f} us: prologue "
                  f"{d[:, 3].mean():.0f}, main loop {d[:, 4].mean():.0f}, "
                  f"epilogue {d[:, 5].mean():.0f} cycles", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
