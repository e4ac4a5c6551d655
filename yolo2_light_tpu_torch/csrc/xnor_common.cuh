// Shared by the two XNOR bit kernels (xnor_gemm.cu, xnor_gemm_mxu.cu): the
// launch geometry, the implicit-GEMM gather of bit words into a cp.async
// ring in shared memory, the K loop that walks the ring, the two splits of
// K (across a block's warps, across a thread-block cluster), the epilogue
// and the launch.
//
// Operands: x is a packed NHWC map [B][H][W][C32] of int32 words (bit b of
// word j = channel 32*j + b, set iff the activation is > 0); w is
// [M][ks][ks][C32] (tap-major). The reduction runs over the kwords =
// ks*ks*C32 words of one output pixel's window, in the weights' (tap, word)
// order. Taps outside the image read as 0 words: -1 activations, the
// reference's bit-path border.
//
// Geometry, chosen per conv by ops/xnor_gemm.plan_launch and passed in: a
// block of 128 threads computes a tile of TP output pixels x TM filters:
// 128x32 or 64x64, each warp a 32x32 part of it over every K step;
// or 32x32, each warp the whole tile over a quarter of each K step, the four
// partial tiles summed through shared memory at the end (the warp split).
// K runs in steps of `kstep` words (8, 16 or 32); `stages` steps (2-4) sit
// in the ring, up to stages - 1 in flight while one is reduced; with the
// warp split, `split` blocks of a cluster (1-8) may also share a tile's K
// steps (the cluster split).
//
// Shared memory: a table of the tile's pixels (window origin and word
// offset, set up once), the tile's mean and bias (copied with the first
// step, so the epilogue does not wait on device memory), the ring (per
// stage TP pixel rows and TM filter rows of kstep + 4 words: [pixel][word]
// and [filter][word]) and the buffer of partial tiles a split sums. A row
// is an odd number of 16-byte units, so eight rows at one K offset fall in
// eight distinct bank groups (ldmatrix and the popcount kernel's 16-byte
// loads are free of conflicts).
//
// The gather: where C32 % 4 == 0 (and the pointers are 16-byte aligned)
// each thread copies 16 bytes of a row, lanes along the words of a tap;
// else 4 bytes, pixel rows with lanes along the pixels (neighbouring output
// pixels read neighbouring words of one tap) and filter rows with lanes
// along the words. A thread's tap and word are set up once, without a
// division, and advanced by adds. The first steps' weights are requested
// before the pixel table is built. Taps outside the image, pixels past P,
// filters past M and words past kwords are zero-filled (cp.async src-size
// 0); words no kernel reads (past kwords for K3, past the last whole 256-bit
// step for K4) are not copied at all.

#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace xnor {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;       // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowPad = 4;          // words of padding per shared row
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kNoPixel = -(1 << 29);   // window origin of a pixel past P
constexpr int kTiles = 3;              // tile shapes a kernel takes

// The tile shapes, in the order of a kernel's instances.
__host__ __device__ constexpr int tile_p_of(int i) {
  return i == 0 ? 128 : i == 1 ? 64 : 32;
}
__host__ __device__ constexpr int tile_m_of(int i) {
  return i == 0 ? 32 : i == 1 ? 64 : 32;
}
// The warp split: the 32x32 tile's warps share each K step.
__host__ __device__ constexpr bool warp_split(int tp, int tm) {
  return tp * tm < 4096;
}

// Diagnostics, off unless a build defines them (scripts/trace_xnor_gemm.py):
// with XNOR_TRACE each block records in g_trace its start and end time, its
// SM and the cycles of its set-up, K loop and epilogue (read_trace copies
// the records out); XNOR_DROP, a mask of the kDrop bits, leaves parts of the
// work out, so that a timing shows what it follows (the results are wrong).
#ifndef XNOR_DROP
#define XNOR_DROP 0
#endif
constexpr int kDropX = 1;         // the gather's pixel-row copies
constexpr int kDropW = 2;         // its filter-row copies
constexpr int kDropCompute = 4;   // the reduction of each step
constexpr int kDropStart = 8;     // what a block requests before its table
__host__ __device__ constexpr bool dropped(int bit) {
  return (XNOR_DROP & bit) != 0;
}

#ifdef XNOR_TRACE
constexpr int kTraceBlocks = 8192;
constexpr int kTraceFields = 6;
__device__ unsigned long long g_trace[kTraceBlocks * kTraceFields];
#endif

// A block's trace: construct it first thing, call set_up_done() and
// k_loop_done() as they happen, finish() (a barrier) after the stores.
struct Trace {
#ifdef XNOR_TRACE
  unsigned long long start;
  long long c[3];
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ Trace() : start(now()) { c[0] = clock64(); }
  __device__ void set_up_done() { c[1] = clock64(); }
  __device__ void k_loop_done() { c[2] = clock64(); }
  __device__ void finish() {
    __syncthreads();
    const long long end = clock64();
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0 && blk < kTraceBlocks) {
      unsigned long long* d = g_trace + blk * kTraceFields;
      d[0] = start; d[1] = now(); d[2] = sm;
      d[3] = c[1] - c[0]; d[4] = c[2] - c[1]; d[5] = end - c[2];
    }
  }
#else
  __device__ __forceinline__ void set_up_done() {}
  __device__ __forceinline__ void k_loop_done() {}
  __device__ __forceinline__ void finish() {}
#endif
};

struct XnorArgs {
  const uint32_t* x;        // [B][H][W][C32]
  const uint32_t* w;        // [M][ks][ks][C32]
  const float* mean;        // [M]
  const float* bias;        // [M]
  float* out;               // [B][OH][OW][M]
  int B, H, W, C32, M, OH, OW, ks, stride, pad;
  int scale, offset, leaky; // y = epilogue(scale * sum + offset)
  int P, kwords, kfill;     // kfill: words the kernel reads (<= steps*kstep)
  int kstep, stages, split, vec;
  int rank_steps, rank_extra;   // steps per cluster rank; ranks with one more
};

// y = dot * mean + bias with two roundings (explicit intrinsics, so nvcc
// cannot contract an FMA), then leaky y > 0 ? y : 0.1 * y (the XNOR path's
// slope, not the int8 path's y / 10).
__device__ __forceinline__ float epilogue(int dot, float mean, float bias,
                                          int leaky) {
  float y = __fadd_rn(__fmul_rn(static_cast<float>(dot), mean), bias);
  if (leaky && !(y > 0.0f)) y = __fmul_rn(0.1f, y);
  return y;
}

__host__ __device__ constexpr int row_words(int kstep) {
  return kstep + kRowPad;
}

// Rows of the tile each block of a split cluster finishes.
__host__ __device__ constexpr int split_rows(int tp, int split) {
  return (tp + split - 1) / split;
}

// Byte offsets in shared memory: the pixel table at 0 (16 bytes a pixel),
// the tile's mean then bias (TM floats each), the ring, the partial tiles.
__host__ __device__ constexpr int mb_offset(int tp) { return tp * 16; }
__host__ __device__ constexpr int ring_offset(int tp, int tm) {
  return tp * 16 + tm * 8;
}
__host__ __device__ constexpr int stage_bytes(int tp, int tm, int kstep) {
  return (tp + tm) * row_words(kstep) * 4;
}
__host__ __device__ constexpr int part_offset(int tp, int tm, int kstep,
                                              int stages) {
  return ring_offset(tp, tm) + stages * stage_bytes(tp, tm, kstep);
}

// Bytes of the warp split's partial tiles: one per warp, rows of TM + 4
// words; the cluster split's push buffer follows them.
__host__ __device__ constexpr int warp_part_bytes(int tp, int tm) {
  return kWarps * tp * (tm + 4) * 4;
}

// Bytes of dynamic shared memory of a launch: up to the partial tiles, then
// with the warp split its partial tiles and for a cluster split a slot of
// split_rows rows of TM + 4 words per block of the cluster.
__host__ __device__ inline int smem_bytes(int tp, int tm, int kstep,
                                          int stages, int split) {
  if (!warp_split(tp, tm)) return part_offset(tp, tm, kstep, stages);
  const int push = split > 1 ? split * split_rows(tp, split) * (tm + 4) * 4
                             : 0;
  return part_offset(tp, tm, kstep, stages) + warp_part_bytes(tp, tm) + push;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_x() {
  unsigned r;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// Fills the pixel table: per tile row, the word offset of its window's
// origin (may be negative; only read with an in-image tap), the origin's
// y and x (kNoPixel past P, which fails every bounds test).
template <int TP>
__device__ void build_table(const XnorArgs& a, int4* tab, int p0) {
  for (int r = threadIdx.x; r < TP; r += kThreads) {
    const int p = p0 + r;
    int4 e = make_int4(0, kNoPixel, kNoPixel, 0);
    if (p < a.P) {
      const int img = p / (a.OH * a.OW);
      const int rem = p - img * a.OH * a.OW;
      const int oy = rem / a.OW;
      const int iy0 = oy * a.stride - a.pad;
      const int ix0 = (rem - oy * a.OW) * a.stride - a.pad;
      e = make_int4(((img * a.H + iy0) * a.W + ix0) * a.C32, iy0, ix0, 0);
    }
    tab[r] = e;
  }
}

// One thread's share of the gather. Filter rows (and pixel rows with 16-byte
// copies): column bcol of every step, rows brow0, brow0 + brstep, ...
// Pixel rows with 4-byte copies: row xrow, columns xcol .. xcol + xn - 1.
template <int TP, int TM>
struct Gather {
  static constexpr int kRowThreads = kThreads / TP;   // 4-byte pixel rows
  int bcol, brow0, brstep;
  int xrow, xcol, xn;
  int4 xe;                // xrow's table entry
  int k, ky, kx, cword;   // the window word of the first pixel column
  int kb;                 // the window word of column bcol

  __device__ Gather(const XnorArgs& a, int k0) {
    const int per_row = a.kstep / a.vec;   // a power of two
    const int lg = __ffs(per_row) - 1;
    bcol = (threadIdx.x & (per_row - 1)) * a.vec;
    brow0 = threadIdx.x >> lg;
    brstep = kThreads >> lg;
    xrow = threadIdx.x % TP;
    xn = a.kstep / kRowThreads;
    xcol = static_cast<int>(threadIdx.x) / TP * xn;
    kb = k0 + bcol;
    k = k0 + (a.vec == 4 ? bcol : xcol);
    // the tap of word k by subtraction: at most ks*ks rounds
    cword = k;
    ky = kx = 0;
    while (cword >= a.C32) {
      cword -= a.C32;
      if (++kx == a.ks) {
        kx = 0;
        ++ky;
      }
    }
  }

  __device__ __forceinline__ void load_row(const int4* tab) {
    xe = tab[xrow];
  }

  // The filter rows of the step whose column bcol is window word kw.
  __device__ __forceinline__ void issue_w(const XnorArgs& a, uint32_t stage,
                                          int m0, int kw) const {
    if (dropped(kDropW) || kw >= a.kfill) return;
    const bool k_ok = kw < a.kwords;   // vec 4: kwords % 4 == 0
    const uint32_t rb = row_words(a.kstep) * 4;
    uint32_t dst = stage + (TP + brow0) * rb + bcol * 4;
    const uint32_t* src =
        a.w + static_cast<size_t>(m0 + brow0) * a.kwords + kw;
    const size_t step = static_cast<size_t>(brstep) * a.kwords;
#pragma unroll 1
    for (int r = brow0; r < TM; r += brstep, dst += brstep * rb, src += step) {
      const bool ok = k_ok && m0 + r < a.M;
      if (a.vec == 4) i8mma::cp_async16(dst, ok ? src : a.w, ok);
      else i8mma::cp_async4(dst, ok ? src : a.w, ok);
    }
  }

  // The pixel rows of the current step; then the thread's columns move one
  // step on.
  __device__ __forceinline__ void issue_x(const XnorArgs& a, const int4* tab,
                                          uint32_t stage) {
    const uint32_t rb = row_words(a.kstep) * 4;
    if (a.vec == 4) {
      if (k < a.kfill) {
        const bool k_ok = k < a.kwords;
        const int tapoff = (ky * a.W + kx) * a.C32 + cword;
        uint32_t dst = stage + brow0 * rb + bcol * 4;
#pragma unroll 1
        for (int r = brow0; r < TP; r += brstep, dst += brstep * rb) {
          const int4 e = tab[r];
          const bool ok =
              k_ok &&
              static_cast<unsigned>(e.y + ky) < static_cast<unsigned>(a.H) &&
              static_cast<unsigned>(e.z + kx) < static_cast<unsigned>(a.W);
          if (!dropped(kDropX))
            i8mma::cp_async16(dst, ok ? a.x + (e.x + tapoff) : a.x, ok);
        }
      }
    } else {
      int kk = k, y = ky, x = kx, cw = cword;
      uint32_t dst = stage + xrow * rb + xcol * 4;
#pragma unroll 1
      for (int c = 0; c < xn && kk < a.kfill; ++c, ++kk, dst += 4) {
        const bool ok =
            kk < a.kwords &&
            static_cast<unsigned>(xe.y + y) < static_cast<unsigned>(a.H) &&
            static_cast<unsigned>(xe.z + x) < static_cast<unsigned>(a.W);
        if (!dropped(kDropX))
          i8mma::cp_async4(
              dst, ok ? a.x + (xe.x + (y * a.W + x) * a.C32 + cw) : a.x, ok);
        if (++cw == a.C32) {
          cw = 0;
          if (++x == a.ks) {
            x = 0;
            ++y;
          }
        }
      }
    }
    k += a.kstep;
    kb += a.kstep;
    cword += a.kstep;
    while (cword >= a.C32) {
      cword -= a.C32;
      if (++kx == a.ks) {
        kx = 0;
        ++ky;
      }
    }
  }
};

// Wait until at most n (0-2) of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) i8mma::cp_async_wait<0>();
  else if (n == 1) i8mma::cp_async_wait<1>();
  else i8mma::cp_async_wait<2>();
}

// The cluster barrier in two halves (every thread of every block of the
// cluster arrives, then waits), for a wait placed long after the arrive.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Where a block's work lies: its tile (p0, m0), its cluster rank and its K
// steps [s_lo, s_lo + n). The cluster's ranks are the hardware's, and each
// has rank_steps steps, the first rank_extra one more: no division.
struct Work {
  int p0, m0, rank, s_lo, n;
};

template <int TP, int TM>
__device__ __forceinline__ Work block_work(const XnorArgs& a) {
  Work b;
  b.rank = a.split > 1 ? static_cast<int>(cluster_rank()) : 0;
  b.p0 = static_cast<int>(a.split > 1 ? cluster_x() : blockIdx.x) * TP;
  b.m0 = blockIdx.y * TM;
  b.s_lo = b.rank * a.rank_steps + min(b.rank, a.rank_extra);
  b.n = a.rank_steps + (b.rank < a.rank_extra ? 1 : 0);
  return b;
}

// A block's start: the tile's mean and bias and the first steps' weights
// are requested (they land with the first step), the pixel table built,
// and (cluster splits) the block's arrival at the cluster barrier that the
// pushes wait on. The caller's __syncthreads then publishes the table.
template <int TP, int TM>
__device__ __forceinline__ void start_block(const XnorArgs& a,
                                            Gather<TP, TM>& g,
                                            unsigned char* smem,
                                            const Work& b) {
  const uint32_t mb = i8mma::smem_addr(smem + mb_offset(TP));
  for (int i = dropped(kDropStart) ? 2 * TM : threadIdx.x; i < 2 * TM;
       i += kThreads) {
    const int c = i < TM ? i : i - TM;
    const bool ok = b.m0 + c < a.M;
    i8mma::cp_async4(mb + 4 * i,
                     ok ? (i < TM ? a.mean : a.bias) + b.m0 + c : a.mean, ok);
  }
  const uint32_t ring = i8mma::smem_addr(smem + ring_offset(TP, TM));
  for (int d = 0; d + 1 < a.stages && d < b.n && !dropped(kDropStart); ++d)
    g.issue_w(a, ring + d * stage_bytes(TP, TM, a.kstep), b.m0,
              g.kb + d * a.kstep);
  build_table<TP>(a, reinterpret_cast<int4*>(smem), b.p0);
  if (a.split > 1) cluster_arrive_relaxed();
}

// The K loop of one block: its n steps through the ring, one barrier per
// step (start_block requested the first weights). compute(stage, nw)
// reduces ring stage `stage` (its shared-memory address), whose first nw
// words (1 to kstep) lie inside the window; the next ones up to kfill are
// zero.
template <int TP, int TM, class Compute>
__device__ __forceinline__ void k_loop(const XnorArgs& a, Gather<TP, TM>& g,
                                       const int4* tab, uint32_t ring,
                                       const Work& b, Compute&& compute) {
  const uint32_t bytes = stage_bytes(TP, TM, a.kstep);
  const int ahead = a.stages - 1;
  if (a.vec == 1) g.load_row(tab);
  int in = 0, out = 0;   // the stages the next copy and the next reduce use
  for (int d = 0; d < ahead; ++d) {
    if (d < b.n) {
      g.issue_x(a, tab, ring + in * bytes);
      if (++in == a.stages) in = 0;
    }
    i8mma::cp_async_commit();
  }
  int k0 = b.s_lo * a.kstep;
  for (int i = 0; i < b.n; ++i, k0 += a.kstep) {
    cp_async_wait_upto(ahead - 1);
    __syncthreads();   // step i staged; step i-1's stage free
    if (i + ahead < b.n) {
      g.issue_w(a, ring + in * bytes, b.m0, g.kb);
      g.issue_x(a, tab, ring + in * bytes);
      if (++in == a.stages) in = 0;
    }
    i8mma::cp_async_commit();
    const int left = a.kwords - k0;
    if (!dropped(kDropCompute))
      compute(ring + out * bytes, left < a.kstep ? left : a.kstep);
    if (++out == a.stages) out = 0;
  }
  i8mma::cp_async_wait<0>();
}

// The epilogue of four filters m .. m + 3 (tile columns c .. c + 3) of
// output pixel p from their integer sums: a 16-byte store where M % 4 == 0.
// mb: the tile's mean then bias in shared memory.
template <int TM>
__device__ __forceinline__ void store4(const XnorArgs& a, const float* mb,
                                       int p, int m, int c, const int (&s)[4]) {
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = epilogue(a.scale * s[j] + a.offset, mb[c + j], mb[TM + c + j],
                    a.leaky);
  float* dst = a.out + static_cast<size_t>(p) * a.M + m;
  if ((a.M & 3) == 0) {
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m + j < a.M) dst[j] = y[j];
  }
}

// A cluster split's partial sums: block `rank` finishes rows [rank*R,
// rank*R + R) of the tile (R = split_rows). push_row gives the address, in
// the finishing block's buffer, of this block's slot for tile row `row`;
// the caller stores its partial sums there (distributed shared memory),
// then every block passes the cluster barrier and finishes its own rows
// from local shared memory alone, so no block reads a peer and none waits
// for a peer at its exit.
template <int TP, int TM>
__device__ __forceinline__ int* push_row(const XnorArgs& a, int* part,
                                         int rank, int row) {
  const int rows = split_rows(TP, a.split);
  const int owner = row / rows;   // after the K loop, once per row
  return cg::this_cluster().map_shared_rank(part, owner) +
         (rank * rows + row - owner * rows) * (TM + 4);
}

// Sums the cluster split's partial sums of this block's rows and stores
// their epilogue, four filters a thread.
template <int TP, int TM>
__device__ void finish_split(const XnorArgs& a, const int* part,
                             const float* mb, const Work& b) {
  constexpr int kLd = TM + 4;
  constexpr int kCols = TM / 4;          // threads a row
  const int rows = split_rows(TP, a.split);
  const int c = (threadIdx.x % kCols) * 4;
  const int m = b.m0 + c;
  if (m >= a.M) return;
  for (int lr = threadIdx.x / kCols; lr < rows; lr += kThreads / kCols) {
    const int row = b.rank * rows + lr;
    const int p = b.p0 + row;
    if (row >= TP || p >= a.P) break;
    int s[4] = {0, 0, 0, 0};
    for (int r = 0; r < a.split; ++r) {
      const int4 v =
          *reinterpret_cast<const int4*>(part + (r * rows + lr) * kLd + c);
      s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
    }
    store4<TM>(a, mb, p, m, c, s);
  }
}

// The end of a warp split: each warp has written its partial tile (TP rows
// of TM + 4 words) at part + warp * TP * (TM + 4); each thread sums the
// four for four filters of TP * TM / 512 rows, then stores their epilogue
// or, for a cluster split, pushes the sums to the row's finishing block
// (push: the push buffer) and finishes its own rows.
template <int TP, int TM>
__device__ void finish_warp_split(const XnorArgs& a, const int* part,
                                  int* push, const float* mb, const Work& b) {
  constexpr int kLd = TM + 4;
  constexpr int kCols = TM / 4;          // threads a row
  __syncthreads();   // every warp's partial tile is written
  if (a.split > 1) cluster_wait();   // every block of the cluster started
  const int c = (threadIdx.x % kCols) * 4;
  const int m = b.m0 + c;
  for (int row = threadIdx.x / kCols; row < TP; row += kThreads / kCols) {
    const int p = b.p0 + row;
    int s[4] = {0, 0, 0, 0};
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const int4 v = *reinterpret_cast<const int4*>(
          part + (wi * TP + row) * kLd + c);
      s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
    }
    if (a.split > 1)
      *reinterpret_cast<int4*>(push_row<TP, TM>(a, push, b.rank, row) + c) =
          make_int4(s[0], s[1], s[2], s[3]);
    else if (p < a.P && m < a.M)
      store4<TM>(a, mb, p, m, c, s);
  }
  if (a.split > 1) {
    cg::this_cluster().sync();   // every partial sum has arrived
    finish_split<TP, TM>(a, push, mb, b);
  }
}

using Kernel = void (*)(XnorArgs);

#ifdef XNOR_TRACE
// Copies the first n blocks' trace records (kTraceFields words each) to host.
extern "C" int read_trace(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_trace, static_cast<size_t>(n) * kTraceFields * 8));
}
#endif

// Checks a plan and launches the kernel instance of tile (tile_p, tile_m)
// (kernels[i] for tile_p_of(i) x tile_m_of(i)) on `stream` of `device`,
// grid (pixel tiles * split, filter tiles), clusters of `split` along x.
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for a plan the
// kernels do not take).
inline int launch(const Kernel (&kernels)[kTiles],
                  std::atomic<bool> (&configured)[kMaxDevices], XnorArgs a,
                  int tile_p, int tile_m, int device, void* stream) {
  const long long P = static_cast<long long>(a.B) * a.OH * a.OW;
  if (P == 0 || a.M == 0) return 0;
  int which = -1;
  for (int i = 0; i < kTiles; ++i)
    if (tile_p_of(i) == tile_p && tile_m_of(i) == tile_m) which = i;
  a.P = static_cast<int>(P);
  a.kwords = a.ks * a.ks * a.C32;
  if (which < 0 || (a.kstep != 8 && a.kstep != 16 && a.kstep != 32) ||
      a.stages < 2 || a.stages > kMaxStages || a.split < 1 ||
      a.split > kMaxSplit || a.kwords < 1 ||
      (a.split > 1 && !warp_split(tile_p, tile_m)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (a.kwords + a.kstep - 1) / a.kstep;
  a.rank_steps = steps / a.split;
  a.rank_extra = steps % a.split;
  const long long p_tiles = (P + tile_p - 1) / tile_p;
  const long long m_tiles = (a.M + tile_m - 1) / tile_m;
  const int smem = smem_bytes(tile_p, tile_m, a.kstep, a.stages, a.split);
  if (a.split > steps || a.kfill < a.kwords || a.kfill > steps * a.kstep ||
      smem > kMaxSmem || p_tiles * a.split > 0x7fffffffLL || m_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(a.x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(a.w);
  a.vec = a.C32 % 4 == 0 && xa % 16 == 0 && wa % 16 == 0 ? 4 : 1;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices || !configured[device].load()) {
    for (int i = 0; i < kTiles && err == cudaSuccess; ++i)
      err = cudaFuncSetAttribute(kernels[i],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < kMaxDevices) configured[device].store(true);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p_tiles * a.split),
                     static_cast<unsigned>(m_tiles), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernels[which], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xnor
