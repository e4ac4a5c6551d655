"""Where the XNOR bit kernels (K3 ``xnor_gemm``, K4 ``xnor_gemm_mxu``) spend
their time, on the GPU.

Two parts, both printed with the card's name and power limit first:

(a) The tensor cores' issue rate for the two MMA forms the bit kernels can
    use: ``mma.sync m16n8k256 .b1 .and.popc`` (K4) against ``mma.sync
    m16n8k32 .s8`` (the unpack path K4 had before). One warp with a
    dependent chain (latency), one warp with 8 independent chains, and 132
    blocks of 16 warps with 8 chains each (the SM's rate); cycles by
    ``clock64``. Also whether ptxas for ``sm_90a`` takes the ``.xor.popc``
    form beside ``.and.popc``.

(b) Per-block phase cycles of a traced build of each kernel (built with
    ``-DXNOR_TRACE``: ``%globaltimer`` at a block's start and end,
    ``clock64`` after its set-up, after its K loop and after its epilogue
    and stores; see ``Trace`` in ``csrc/xnor_common.cuh``) at
    tiny-yolo-obj_xnor-416's seven XNOR convs, after checking
    the traced copy against the plain version: the mean device time of a
    launch (CUDA events), the span from the first block's start to the last
    block's end, the blocks, the most on one SM, a block's mean duration and
    its phase cycles. For K3, each shape's share of its popcount floor
    (P*M*kwords popcounts at 16 an SM a clock on 132 SMs, at the SM clock
    that ``nvidia-smi`` reports) beside its share of the bound
    ``chip_smoke.py`` counts. ``--plans`` also times each shape under every
    other tile, K step and split the kernels take.

With ``--variants`` it also times builds of the kernels whose results are
wrong on purpose (``-DXNOR_DROP``, the ``kDrop`` bits of
``csrc/xnor_common.cuh``), to show what each shape's time follows: ``no_x``
drops the pixel-row copies of the gather, ``no_w`` the filter-row copies,
``no_compute`` the reduction of each step (MMAs or popcounts), ``no_start``
the copies a block requests before its pixel table (mean, bias and the
first weights), ``skeleton`` the first three (what is left: launch, set-up,
barriers, epilogue and stores). Each prints its time and phase cycles.

Usage: ``python scripts/trace_xnor_gemm.py [--plans] [--variants]``
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
from yolo2_light_tpu_torch.ops import xnor_gemm as XG  # noqa: E402

OUT = os.path.join(ROOT, "build", "trace")
FIELDS = 6                # kTraceFields of csrc/xnor_common.cuh
POPC_PER_SM_CLOCK = 16
SMS = 132

PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kB1, int kChains>
__global__ void probe(const uint32_t* in, int* out, long long* cycles,
                      int iters) {
  const int lane = threadIdx.x & 31;
  const uint32_t a[4] = {in[lane], in[lane + 32], in[lane + 64],
                         in[lane + 96]};
  const uint32_t b0 = in[lane + 128], b1 = in[lane + 160];
  int c[kChains][4];
#pragma unroll
  for (int i = 0; i < kChains; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[i][r] = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (kB1) mma_b1(c[i], a, b0, b1);
      else mma_s8(c[i], a, b0, b1);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kChains; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  const int warp = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  out[warp * 32 + lane] = s;
  if (lane == 0) cycles[warp] = t1 - t0;
}

// form: 0 = b1 and.popc, 1 = s8; chains: 1 or 8.
extern "C" int run_probe(int form, int chains, int blocks, int warps,
                         int iters, const void* in, void* out, void* cycles) {
  const dim3 grid(blocks), block(32 * warps);
  const uint32_t* i = static_cast<const uint32_t*>(in);
  int* o = static_cast<int*>(out);
  long long* c = static_cast<long long*>(cycles);
  if (form == 0 && chains == 1) probe<true, 1><<<grid, block>>>(i, o, c, iters);
  else if (form == 0) probe<true, 8><<<grid, block>>>(i, o, c, iters);
  else if (chains == 1) probe<false, 1><<<grid, block>>>(i, o, c, iters);
  else probe<false, 8><<<grid, block>>>(i, o, c, iters);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
"""

XOR_SRC = r"""
#include <cstdint>
__global__ void xor_popc(const uint32_t* in, int* out) {
  int c[4] = {0, 0, 0, 0};
  const uint32_t a0 = in[0], a1 = in[1], a2 = in[2], a3 = in[3];
  const uint32_t b0 = in[4], b1 = in[5];
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  out[threadIdx.x] = c[0] + c[1] + c[2] + c[3];
}
"""

# the kDrop bits of csrc/xnor_common.cuh each diagnostic variant sets
DROP_X, DROP_W, DROP_COMPUTE, DROP_START = 1, 2, 4, 8
VARIANTS = {"no_x": DROP_X, "no_w": DROP_W, "no_compute": DROP_COMPUTE,
            "no_start": DROP_START,
            "skeleton": DROP_X | DROP_W | DROP_COMPUTE}
ENGINES = {"xnor_gemm": ("popcount", XG.xnor_gemm_cuda, XG.xnor_gemm_plain),
           "xnor_gemm_mxu": ("mxu", XG.xnor_gemm_mxu_cuda,
                             XG.xnor_gemm_mxu_plain)}


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def nvcc(src_path: str, out: str, extra=()) -> subprocess.CompletedProcess:
    return subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *extra,
                           "-o", out, src_path], capture_output=True,
                          text=True)


def write(name: str, text: str) -> str:
    path = os.path.join(OUT, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def probe() -> None:
    lib_path = os.path.join(OUT, "mma_probe.so")
    res = nvcc(write("mma_probe.cu", PROBE_SRC), lib_path)
    cs.check(res.returncode == 0, f"probe build: {res.stderr[-3000:]}")
    lib = ctypes.CDLL(lib_path)
    lib.run_probe.restype = ctypes.c_int
    lib.run_probe.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    dev = torch.device("cuda")
    src = torch.randint(0, 2 ** 31 - 1, (192,), dtype=torch.int32,
                        device=dev)
    iters = 4096
    macs = {0: 16 * 8 * 256, 1: 16 * 8 * 32}
    names = {0: "b1 m16n8k256 and.popc", 1: "s8 m16n8k32"}
    for form in (0, 1):
        for chains, blocks, warps in ((1, 1, 1), (8, 1, 1), (8, SMS, 16)):
            n = blocks * warps
            out = torch.empty(n * 32, dtype=torch.int32, device=dev)
            cyc = torch.empty(n, dtype=torch.int64, device=dev)
            for _ in range(2):   # the first run warms the instruction cache
                rc = lib.run_probe(form, chains, blocks, warps, iters,
                                   src.data_ptr(), out.data_ptr(),
                                   cyc.data_ptr())
                cs.check(rc == 0, f"probe launch: cudaError {rc}")
            per_mma = float(cyc.double().mean()) / (iters * chains)
            per_sm = warps / per_mma      # MMAs an SM retires a cycle
            print(f"[probe] {names[form]}: {chains} chain(s), {blocks} "
                  f"block(s) x {warps} warp(s): {per_mma:.2f} cycles per "
                  f"MMA per warp; {per_sm:.3f} MMAs per SM per cycle = "
                  f"{per_sm * macs[form]:.0f} multiply-adds per SM per "
                  "cycle", flush=True)
    res = nvcc(write("xor_popc.cu", XOR_SRC),
               os.path.join(OUT, "xor_popc.cubin"), ("-cubin",))
    first = (res.stderr.strip().splitlines() or [""])[0]
    print(f"[probe] ptxas sm_90a on mma ... .b1.b1.s32.xor.popc: "
          f"{'accepted' if res.returncode == 0 else 'refused'}"
          f"{'' if res.returncode == 0 else ': ' + first}", flush=True)


def build_traced(name: str, drop: int, tag: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with its trace on and the parts ``drop``
    (kDrop bits) left out, into ``build/trace/<tag>/``."""
    lib = os.path.join(OUT, tag, f"{name}.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    res = nvcc(os.path.join(_build.CSRC_DIR, f"{name}.cu"), lib,
               ("-DXNOR_TRACE", f"-DXNOR_DROP={drop}"))
    if res.returncode != 0:
        raise RuntimeError(res.stderr[-4000:])
    return ctypes.CDLL(lib)


def report(label: str, lib, n: int, ms: float, extra: str = "") -> None:
    buf = np.zeros(n * FIELDS, np.uint64)
    cs.check(lib.read_trace(buf.ctypes.data, n) == 0, "read_trace")
    d = buf.reshape(n, FIELDS).astype(np.int64)
    t0 = d[:, 0].min()
    print(f"{label}: {ms * 1e3:.2f} us a launch; span "
          f"{(d[:, 1].max() - t0) / 1e3:.2f} us, {n} blocks, at most "
          f"{np.bincount(d[:, 2].astype(int)).max()} on one SM, last start "
          f"{(d[:, 0].max() - t0) / 1e3:.2f} us; a block "
          f"{(d[:, 1] - d[:, 0]).mean() / 1e3:.2f} us: set-up "
          f"{d[:, 3].mean():.0f}, K loop {d[:, 4].mean():.0f}, epilogue "
          f"{d[:, 5].mean():.0f} cycles{extra}", flush=True)


def popc_floor_us(p: int, m: int, kwords: int, mhz: float) -> float:
    return p * m * kwords / (SMS * POPC_PER_SM_CLOCK) / mhz


def other_plans(base, p: int, m: int, kwords: int):
    """Every tile, K step and split the kernels take at a shape other than
    the planner's ``base``: each 4096-output tile at each K step, and the
    warp split's tile at each K step with each cluster split."""
    plans = [XG.make_plan(p, m, kwords, tile, kstep, 1)
             for tile in XG.TILES for kstep in XG.KSTEPS]
    plans += [XG.make_plan(p, m, kwords, XG.WARP_SPLIT_TILE, kstep, split)
              for kstep in XG.KSTEPS
              for split in range(1, min(XG.MAX_SPLIT, -(-kwords // kstep)) + 1)]
    return [q for q in plans if q[:5] != base[:5]]


def bind(libs: dict) -> None:
    """Make the wrappers launch the entries of ``libs`` (name -> library)."""
    entries = {}
    for name, lib in libs.items():
        fn = getattr(lib, f"{name}_nhwc")
        bound = LOAD_KERNEL(name)
        fn.restype, fn.argtypes = bound.restype, bound.argtypes
        entries[name] = fn
    XG.load_kernel = entries.__getitem__


LOAD_KERNEL = XG.load_kernel


def trace_variants() -> None:
    """The diagnostic variants' times and phases at the planner's plans."""
    dev = torch.device("cuda")
    for variant, drop in VARIANTS.items():
        libs = {name: build_traced(name, drop, variant) for name in ENGINES}
        bind(libs)
        for name, (engine, cuda, _) in ENGINES.items():
            times = []
            for i, (label, (b, h, w, c, m)) in enumerate(cs.XNOR_SHAPES):
                x, wp, _, mean, bias = cs._xnor_operands(
                    dev, cs.SEED + i, b, h, w, c, m)
                xp = XG.pack_activations(x, c)

                def call():
                    return cuda(xp, wp, mean, bias, c, 1, 1)
                times.append(cs.event_ms(call) * 1e3)
                call()
                torch.cuda.synchronize()
                plan = XG.plan_launch(b, h, w, xp.shape[-1], m, 3, 1, 1,
                                      engine)
                report(f"[variants] {name} {variant} {label}", libs[name],
                       plan.blocks, times[-1] / 1e3)
            print(f"[variants] {name} {variant}: sum {sum(times):.2f} us",
                  flush=True)


def trace_current(mhz: float, plans: bool) -> None:
    """The kernels of this checkout, at the planner's plan (and, with
    ``plans``, at every other)."""
    dev = torch.device("cuda")
    libs = {name: build_traced(name, 0, "traced") for name in ENGINES}
    bind(libs)
    for name, (engine, cuda, plain) in ENGINES.items():
        for i, (label, (b, h, w, c, m)) in enumerate(cs.XNOR_SHAPES):
            x, wp, _, mean, bias = cs._xnor_operands(dev, cs.SEED + i, b, h,
                                                     w, c, m)
            xp = XG.pack_activations(x, c)
            c32 = xp.shape[-1]
            ref = plain(xp, wp, mean, bias, c, 1, 1)
            base = XG.plan_launch(b, h, w, c32, m, 3, 1, 1, engine)
            b_ms, _ = cs.xnor_bound(xp, wp, c)
            fl = popc_floor_us(b * h * w, m, 9 * c32, mhz)
            for plan in [base] + (other_plans(base, b * h * w, m, 9 * c32)
                                  if plans else []):
                def call():
                    return cuda(xp, wp, mean, bias, c, 1, 1, plan=plan)
                cs.check(torch.equal(call(), ref),
                         f"traced {name} != plain at {label}, {plan}")
                ms = cs.event_ms(call)
                desc = (f"tile {plan.tile_p}x{plan.tile_m}, K step "
                        f"{plan.kstep}, {plan.stages} stages, split "
                        f"{plan.split}")
                if plan is not base:
                    print(f"[plans] {name} {label}: {desc}: "
                          f"{ms * 1e3:.2f} us", flush=True)
                    continue
                call()
                torch.cuda.synchronize()
                extra = (f"; {desc}; {100 * b_ms / ms:.1f}% of the bound "
                         f"({b_ms * 1e3:.2f} us)")
                if engine == "popcount":
                    extra += (f", {100 * fl / (ms * 1e3):.1f}% of the "
                              f"popcount floor ({fl:.2f} us)")
                report(f"{name} {label}", libs[name], plan.blocks, ms, extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plans", action="store_true",
                    help="also time every other tile and split")
    ap.add_argument("--variants", action="store_true",
                    help="also time the diagnostic variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_xnor_gemm: needs a CUDA device", file=sys.stderr)
        return 1
    print(smi("name,power.limit"), flush=True)
    mhz = float(smi("clocks.max.sm").split()[0])
    print(f"[clock] SM clock {mhz:.0f} MHz (clocks.max.sm)", flush=True)
    probe()
    trace_current(mhz, args.plans)
    if args.variants:
        trace_variants()
    return 0


if __name__ == "__main__":
    sys.exit(main())
