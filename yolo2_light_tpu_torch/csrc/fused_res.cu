// One darknet53 residual block in one launch, int8-"cpu" semantics:
//
//   xq  = clamp(trunc(x * m1), +-127)                         int8
//   t1  = leaky10(requant(conv1x1(xq, w1)) * alpha1 + b1)     f32, C2 channels
//   t1q = clamp(trunc(t1 * m2), +-127)                        int8
//   y   = leaky10(requant(conv3x3(t1q, w2)) * alpha2 + b2)    f32, C channels
//   out = x + y                                               f32
//
// with requant(acc) = clamp(trunc_div(acc, 2^shift), +-32767) and the 3x3 conv
// zero-padding t1q (not x). Replaces the Pallas kernels
// yolo2_light_tpu/ops/pallas_fused.py fused_res_stage (K chained blocks, the
// whole trunk VMEM-resident) and fused_res_stage_strips (one block over row
// strips with a 1-pixel halo), which compute this function; a K-block stage
// is K launches of this kernel.
//
// Layouts: x, out NHWC float32 [B,H,W,C]; w1 [C2][C] int8 and w2 [C][3][3][C2]
// int8 (the [M,kh,kw,Cin] layout params.layer_to_torch gives every int8 conv);
// b1 [C2], b2 [C] float32.
//
// What bounds it on an H100: at yolov3-416's blocks the least time is the
// bytes (the f32 trunk read and written once: 1.2-6.6 us a block at
// 3.35 TB/s); the int8 tensor cores need a fifth of that. Neither sets the
// time (scripts/trace_fused_res.py, NVIDIA H100 80GB HBM3, 700 W: copies
// that read nothing, or no MMAs at all, save at most 12% of a launch). A
// block spends 600-1,600 cycles on each step of its two K loops (barrier,
// copies issued, ldmatrix, and in phase 1 the quantize of the f32 halo,
// whose conversions run at a quarter rate), 14-18k cycles on its
// prologues, epilogues and the cluster barrier, and runs 8 warps: 2 a
// scheduler. A
// 104x104x128 f32 trunk is 5.5 MB, far beyond one SM's 227 KB of shared
// memory, so the TPU kernel's whole-image residency does not carry over;
// its strips idea is taken down to tiles. What the design does:
//
// * Each cluster of CS thread blocks (CS = ceil(C / 64), at most 16: above 8
//   a non-portable cluster size, which Hopper takes) owns an 8x8 tile of
//   output pixels of one image. Block r of the cluster computes its share of
//   the C2 t1 channels (a multiple of 16) over the tile and its 1-pixel halo,
//   quantizes them at m2 and stores them, 16 bytes at a time, as int8 rows
//   into the shared memory of every block of the cluster (distributed
//   shared memory), between two cluster barriers; so every block holds the
//   whole t1q halo tile (10*10 rows of C2 bytes: at most 52 KB on yolov3).
//   Stores, unlike loads, do not wait on the cluster's network: fetching
//   the other shares after phase 1 took 9,600 cycles at the 13x13 stage,
//   storing them takes about 4,500 inside phase 1. Block r then computes its
//   share of the C output channels. yolov3-416's stages launch 676, 338,
//   196, 128 and 64 blocks.
// * Both products run on the int8 tensor cores: mma.sync m16n8k32 s8 from
//   ldmatrix fragments (int8_mma.cuh), int32 accumulators in registers.
//   The 1x1 is a GEMM of the 100 halo pixels (one m16 tile per warp) by this
//   block's t1 channels in chunks of 32, K = C in slabs of 32 channels. The
//   3x3 is a GEMM of the 64 output pixels (2x2 m16n8 tiles per warp, as in
//   int8_conv.cu) by 64 output channels, K = 9*C2: each lane gathers its
//   pixel's t1q row at tap (ky, kx) straight from the resident tile, and
//   loads the next K step's fragments before this step's MMAs.
// * Operands stream in by cp.async into rings of 2-4 stages, copies up to
//   three stages ahead, one __syncthreads per stage. Phase 1's stage is one
//   slab of the f32 trunk halo (16-byte copies) and of w1; each thread
//   quantizes, with quantize_pack4, the chunks its own copies brought (no
//   barrier between copy and quantize) into a double buffer of int8 A rows,
//   as int8_conv.cu's f32 entry does. Phase 2's stage is one tap by up to
//   256 bytes of C2 of w2 for 64 channels; its first stages are issued
//   before the second cluster barrier. Weights take 16-byte copies where
//   their rows are multiples of 16 bytes, else 4-byte copies; out-of-image
//   halo pixels and ragged rows, channels and filters are zero-filled by
//   src-size 0. Every row in shared memory is padded to an odd number of
//   16-byte units, so ldmatrix is free of bank conflicts. A thread's copy
//   addresses are set up once per pass, and the loops carry their ring
//   slots and taps as counters: no division in a K loop.
// * Each product's accumulators go through an int32 tile in shared memory
//   (overlaying the ring): phase 1's epilogue writes 4 t1q bytes a thread,
//   phase 2's loads a float4 of x, adds and stores a float4 of out.
// * The 1x1 is computed once per tile; what is recomputed is the halo ring,
//   which neighbouring tiles also compute: (10*10)/(8*8) = 1.56x of the
//   1x1's work, which is 1/9 of the 3x3's. Device memory sees the f32 trunk
//   read (tile plus halo) and the f32 output written once, plus the
//   weights; t1 never leaves the SM.
// * Shared memory: the t1q tile plus the larger of the two phases' rings.
//   The host takes the deepest ring that fits; at C2 = 2048 (t1q alone
//   206 KB) phase 1 stages the halo in two passes of 64 rows and both rings
//   are 2 deep.
//
// Traps handled here: the halo mask (a halo pixel outside the image gets
// t1 = 0, not leaky10(b1), before it is quantized: the 3x3 pads t1q with
// zeros); every float step is an explicitly rounded intrinsic
// (int8_epilogue.cuh) and the residual add is __fadd_rn, so no FMA
// contraction can move t1 by 1 ULP and flip a t1q bin; int32 sums are exact
// in any order, so the MMA's order is free; out of place (the tiles read
// each other's halo trunk pixels, so in-place would race); a K step may read
// t1q bytes past C2 (the next row's, or the tile's 32 bytes of slack), which
// meet zero-filled weights; C % 4 == 0 and C2 % 4 == 0, x and out 16-byte
// aligned; the entry point returns cudaGetLastError() so a refused launch is
// reported.

#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "int8_epilogue.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kMinBlocks = 2;   // blocks an SM must hold: <= 128 registers
constexpr int kTH = 8;                  // output tile rows
constexpr int kTW = 8;                  // output tile columns
constexpr int kHW = kTW + 2;            // halo tile width
constexpr int kNH = (kTH + 2) * kHW;    // halo pixels
constexpr int kKC = 32;   // K bytes of an MMA step; channels of a phase-1 slab
constexpr int kArow = kKC + 16;  // phase-1 A and w1 row stride (3 units)
constexpr int kFrow = kKC * 4;   // f32 row of a phase-1 slab
constexpr int kN1 = 32;          // t1 channels per phase-1 chunk
constexpr int kTile1Ld = 40;     // int32 words per row of phase 1's acc tile
constexpr int kMC = 64;          // output channels per phase-2 chunk
constexpr int kTile2Ld = 72;     // int32 words per row of phase 2's acc tile
constexpr int kMaxKW2 = 256;     // K bytes of w2 per phase-2 stage
constexpr int kSlack = 32;       // t1q bytes past the last row a K step reads
constexpr int kMaxCluster = 16;  // non-portable above 8; H100 takes 16
constexpr int kMaxC2 = 2048;     // largest t1 width the tile is sized for
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct ResArgs {
  const float* x;
  const int8_t* w1;
  const float* b1;
  const int8_t* w2;
  const float* b2;
  float* out;
  int H, W, C, C2;
  float m1, alpha1, m2, alpha2;
  int shift;
  int rs;           // t1q row stride, bytes (odd number of 16-byte units)
  int t1q_bytes;    // the t1q tile and its slack; the rings follow
  int rows1;        // halo rows per phase-1 pass (100, or 64 at wide C2)
  int st1, st2;     // ring depths of phase 1 and phase 2
  int kw2;          // K bytes of w2 per phase-2 stage (32 to 256)
  int vec1, vec2;   // w1 / w2 rows take 16-byte copies
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fused_res_kernel(const ResArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* t1q = smem;                    // [kNH][rs] int8 + slack
  unsigned char* pipe = smem + a.t1q_bytes;     // the phases' rings

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int img = blockIdx.z;
  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int y0 = (blockIdx.y / tiles_x) * kTH;
  const int x0 = (blockIdx.y % tiles_x) * kTW;
  // Phase 1 stores its t1q bytes into every block of the cluster, which
  // may only be written once it has started: the first of the two cluster
  // barriers around the exchange, waited on just before the first store.
  bool peers_unknown = CS > 1;
  if (peers_unknown) cluster_arrive_relaxed();

  // ---- phase 1: t1q over the tile and its halo, this block's t1 channels --
  const int s1 = ((a.C2 + CS - 1) / CS + 15) & ~15;
  const int t_lo = min(a.C2, rank * s1);
  const int t_hi = min(a.C2, t_lo + s1);
  const int slabs1 = (a.C + kKC - 1) / kKC;
  const int st1 = a.st1;
  const int ahead1 = st1 - 1;
  const uint32_t fbuf = i8mma::smem_addr(pipe);           // f32 halo stages
  const int fstage = a.rows1 * kFrow;
  const uint32_t wbuf1 = fbuf + st1 * fstage;              // w1 stages
  unsigned char* abuf = pipe + st1 * (fstage + kN1 * kArow);  // int8 A, 2 bufs
  const int astage = a.rows1 * kArow;
  int* tile1 = reinterpret_cast<int*>(pipe);

  // This thread's share of a slab, the same in every slab: f32 halo chunks
  // e = tid + 256 j (halo row frow + 32 j, channels fq .. fq+3), which it
  // copies, quantizes and, after the K loop, finishes as t1q bytes; and at
  // most one w1 chunk (row wn1, K bytes wcb ..).
  constexpr int kFC = (kNH * (kKC / 4) + kThreads - 1) / kThreads;
  const int frow = tid >> 3;
  const int fq = (tid & 7) << 2;
  const int c1sh = a.vec1 ? 1 : 3;   // log2 copies per 32-byte w1 row
  const int u1sh = a.vec1 ? 4 : 2;   // log2 bytes per copy
  const bool w1_copier = tid < (kN1 << c1sh);
  const int wn1 = tid >> c1sh;
  const int wcb = (tid & ((1 << c1sh) - 1)) << u1sh;

  const uint32_t a_lane = i8mma::a_lane_offset(lane);
  const uint32_t b1_lane =
      i8mma::b_lane_row(lane) * kArow + i8mma::b_lane_offset(lane);
  for (int n0 = t_lo; n0 < t_hi; n0 += kN1) {
    const bool w1_row = w1_copier && n0 + wn1 < t_hi;
    const int8_t* w1_src = a.w1 + static_cast<size_t>(n0 + wn1) * a.C + wcb;
    const uint32_t w1_dst = wbuf1 + wn1 * kArow + wcb;
    const bool q_ok = n0 + fq < t_hi;   // this thread's epilogue channels
    float bq1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bq1[j] = q_ok ? __ldg(a.b1 + n0 + fq + j) : 0.f;
    for (int hp0 = 0; hp0 < kNH; hp0 += a.rows1) {
      const int nrows = min(a.rows1, kNH - hp0);
      const int nj = max(0, (nrows - frow + 31) >> 5);   // chunks it owns
      long long xoff[kFC];   // element offset of chunk j, -1 outside
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        const int hp = hp0 + frow + 32 * j;
        const int iy = y0 - 1 + hp / kHW;
        const int ix = x0 - 1 + hp % kHW;
        xoff[j] = (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
                      ? ((static_cast<long long>(img) * a.H + iy) * a.W +
                         ix) * a.C + fq
                      : -1;
      }
      auto load_slab = [&](int slab, int slot) {
        const int c = slab * kKC;
        if (w1_copier) {
          const bool valid = w1_row && c + wcb < a.C;
          const uint32_t dst = w1_dst + slot * kN1 * kArow;
          const int8_t* src = valid ? w1_src + c : a.w1;
          if (a.vec1) i8mma::cp_async16(dst, src, valid);
          else i8mma::cp_async4(dst, src, valid);
        }
        const uint32_t dst = fbuf + slot * fstage + tid * 16;
#pragma unroll
        for (int j = 0; j < kFC; ++j) {
          if (j < nj) {
            const bool valid = xoff[j] >= 0 && c + fq < a.C;
            i8mma::cp_async16(dst + j * kThreads * 16,
                              valid ? a.x + xoff[j] + c : a.x, valid);
          }
        }
      };
      // the chunks this thread's own copies brought, quantized into A rows
      auto quantize_own = [&](int slot, int buf) {
        const unsigned char* src = pipe + slot * fstage + tid * 16;
        unsigned char* dst = abuf + buf * astage + frow * kArow + fq;
        float4 v[kFC];
#pragma unroll
        for (int j = 0; j < kFC; ++j)
          if (j < nj)
            v[j] = *reinterpret_cast<const float4*>(src + j * kThreads * 16);
#pragma unroll
        for (int j = 0; j < kFC; ++j)
          if (j < nj)
            *reinterpret_cast<int32_t*>(dst + j * 32 * kArow) =
                quantize_pack4(v[j], a.m1);
      };

      const bool active = warp * 16 < nrows;   // warp-uniform
      const int arow = warp * 16 + (lane & 15);
      const uint32_t a_off = (arow < nrows ? arow : 0) * kArow + a_lane;
      int acc[1][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[0][j][r] = 0;

      for (int d = 0; d < ahead1; ++d) {
        if (d < slabs1) load_slab(d, d);
        i8mma::cp_async_commit();
      }
      cp_async_wait_upto(ahead1 - 1);   // this thread's copies of slab 0
      quantize_own(0, 0);
      int slot = 0;                      // slab i's ring slot
      for (int i = 0; i < slabs1; ++i) {
        __syncthreads();   // slab i quantized; slab i-1's buffers free
        const int ld_slot = slot == 0 ? st1 - 1 : slot - 1;   // (i+ahead1)
        if (i + ahead1 < slabs1) load_slab(i + ahead1, ld_slot);
        i8mma::cp_async_commit();
        if (active) {
          const uint32_t aa[1] = {
              i8mma::smem_addr(abuf + (i & 1) * astage) + a_off};
          i8mma::warp_tile_k32<1, 4>(acc, aa,
                                     wbuf1 + slot * kN1 * kArow + b1_lane,
                                     16 * kArow);
        }
        slot = slot + 1 == st1 ? 0 : slot + 1;
        if (i + 1 < slabs1) {
          cp_async_wait_upto(ahead1 - 1);   // this thread's copies of i+1
          quantize_own(slot, (i + 1) & 1);
        }
      }
      i8mma::cp_async_wait<0>();
      __syncthreads();   // every warp is done with the ring
      if (active)
        i8mma::store_acc<1, 4>(tile1, kTile1Ld, warp * 16, 0, acc, lane);
      __syncthreads();
      if (peers_unknown) {
        cluster_wait();   // every block of the cluster has started
        peers_unknown = false;
      }
      // requant, leaky, halo mask, quantize at m2: 4 t1q bytes a thread; a
      // quad of lanes gathers its 16 bytes and stores them into the t1q
      // tile of every block of the cluster (lane k: ranks k, k+4, ...)
      const int quad = (lane & ~3);
      const int qcol = n0 + (fq & ~15);   // the quad's first channel
#pragma unroll
      for (int j = 0; j < kFC; ++j) {
        const int r = frow + 32 * j;
        uint32_t word = 0;   // t1 = 0 outside the image: quantizes to 0
        if (q_ok && j < nj && xoff[j] >= 0) {
          const int4 v =
              *reinterpret_cast<const int4*>(tile1 + r * kTile1Ld + fq);
          const int sv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float t =
                requant_epilogue(sv[k], a.shift, a.alpha1, bq1[k], true);
            word |= static_cast<uint32_t>(quantize_i8(t, a.m2) & 0xff)
                    << (8 * k);
          }
        }
        int4 chunk;
        chunk.x = __shfl_sync(0xffffffffu, word, quad);
        chunk.y = __shfl_sync(0xffffffffu, word, quad + 1);
        chunk.z = __shfl_sync(0xffffffffu, word, quad + 2);
        chunk.w = __shfl_sync(0xffffffffu, word, quad + 3);
        if (j < nj && qcol < t_hi) {
          const int at = (hp0 + r) * a.rs + qcol;
          for (int dst = lane & 3; dst < CS; dst += 4)
            *reinterpret_cast<int4*>(
                (dst == rank ? t1q : cluster.map_shared_rank(t1q, dst)) +
                at) = chunk;
        }
      }
      __syncthreads();   // the acc tile overlays the next pass's ring
    }
  }

  // ---- phase 2 set-up; its first w2 stages are copied before the barrier
  const int s2 = ((a.C + CS - 1) / CS + 15) & ~15;
  const int m_lo = min(a.C, rank * s2);
  const int m_hi = min(a.C, m_lo + s2);
  const int ws2 = a.kw2 + 16;                    // w2 row stride (odd units)
  const int kc2 = (a.C2 + a.kw2 - 1) / a.kw2;   // stages per tap
  const int n2 = 9 * kc2;
  const int st2 = a.st2;
  const int ahead2 = st2 - 1;
  const uint32_t wbuf2 = i8mma::smem_addr(pipe);
  int* tile2 = reinterpret_cast<int*>(pipe);
  const int u2sh = a.vec2 ? 4 : 2;
  const int csh2 = 31 - __clz(a.kw2 >> u2sh);   // log2 copies per stage row
  const int n_w2 = kMC << csh2;                  // copies per stage

  int ld_tap = 0, ld_c0 = 0;   // the next stage to load
  auto load_w2 = [&](int m0, int slot) {
    const uint32_t dst0 = wbuf2 + slot * kMC * ws2;
    for (int e = tid; e < n_w2; e += kThreads) {
      const int n = e >> csh2;
      const int c = ld_c0 + ((e & ((1 << csh2) - 1)) << u2sh);
      const bool valid = m0 + n < m_hi && c < a.C2;
      const int8_t* src =
          valid ? a.w2 + (static_cast<size_t>(m0 + n) * 9 + ld_tap) * a.C2 + c
                : a.w2;
      const uint32_t dst = dst0 + n * ws2 + (c - ld_c0);
      if (a.vec2) i8mma::cp_async16(dst, src, valid);
      else i8mma::cp_async4(dst, src, valid);
    }
    ld_c0 += a.kw2;
    if (ld_c0 >= a.C2) { ld_c0 = 0; ++ld_tap; }
  };
  auto prologue2 = [&](int m0) {
    ld_tap = 0;
    ld_c0 = 0;
    for (int d = 0; d < ahead2; ++d) {
      if (d < n2) load_w2(m0, d);
      i8mma::cp_async_commit();
    }
  };
  if (m_lo < m_hi) prologue2(m_lo);

  // ---- exchange: the second cluster barrier; after it every block's t1q
  // tile is whole, and no block writes into another any more
  if (peers_unknown) cluster_wait();   // a block without t1 channels
  if (CS > 1) cluster.sync();
  else __syncthreads();

  // ---- phase 2: 3x3 conv of t1q, epilogue, residual add ----
  const int wp = warp >> 2;   // 32-pixel half of the tile
  const int wn = warp & 3;    // 16-channel quarter of the 64
  uint32_t a_row[2];          // this lane's t1q row address at tap (0, 0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = wp * 32 + 16 * i + (lane & 15);
    a_row[i] = i8mma::smem_addr(t1q) +
               ((p / kTW) * kHW + p % kTW) * a.rs + a_lane;
  }
  const uint32_t b2_lane =
      (wn * 16 + i8mma::b_lane_row(lane)) * ws2 + i8mma::b_lane_offset(lane);
  const int q4 = (tid & 15) << 2;   // epilogue: channels q4 .. +3 of a chunk
  const int prow = tid >> 4;        // and pixels prow + 16 it
  constexpr int kSteps = kMaxKW2 / kKC;
  for (int m0 = m_lo; m0 < m_hi; m0 += kMC) {
    if (m0 != m_lo) prologue2(m0);
    const bool m_ok = m0 + q4 < m_hi;
    float bq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bq[j] = m_ok ? __ldg(a.b2 + m0 + q4 + j) : 0.f;
    int acc[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
    int tap = 0, c0 = 0, slot = 0;
    for (int i = 0; i < n2; ++i) {
      cp_async_wait_upto(ahead2 - 1);   // this thread's copies of stage i
      __syncthreads();   // stage i staged; stage i-1's slot free
      if (i + ahead2 < n2) load_w2(m0, slot == 0 ? st2 - 1 : slot - 1);
      i8mma::cp_async_commit();

      const uint32_t a0 =
          ((tap / 3) * kHW + tap % 3) * a.rs + static_cast<uint32_t>(c0);
      const uint32_t b_base = wbuf2 + slot * kMC * ws2 + b2_lane;
      const int nk = (min(a.kw2, a.C2 - c0) + kKC - 1) / kKC;
      // the next K step's fragments load before this step's MMAs
      i8mma::Frags<2, 2> f[2];
      {
        const uint32_t aa[2] = {a_row[0] + a0, a_row[1] + a0};
        i8mma::load_frags<2, 2>(f[0], aa, b_base, 16 * ws2);
      }
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (kk >= nk) break;
        if (kk + 1 < nk) {
          const uint32_t k1 = (kk + 1) * kKC;
          const uint32_t aa[2] = {a_row[0] + a0 + k1, a_row[1] + a0 + k1};
          i8mma::load_frags<2, 2>(f[(kk + 1) & 1], aa, b_base + k1,
                                  16 * ws2);
        }
        i8mma::mma_frags<2, 2>(acc, f[kk & 1]);
      }
      c0 += a.kw2;
      if (c0 >= a.C2) { c0 = 0; ++tap; }
      slot = slot + 1 == st2 ? 0 : slot + 1;
    }
    i8mma::cp_async_wait<0>();
    // x for the epilogue, loaded now so its latency overlaps the acc tile
    float4 xv[4];
    size_t at[4];
    bool ok[4];
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int p = prow + 16 * it;
      const int oy = y0 + p / kTW;
      const int ox = x0 + p % kTW;
      ok[it] = m_ok && oy < a.H && ox < a.W;
      at[it] = ((static_cast<size_t>(img) * a.H + oy) * a.W + ox) * a.C + m0 +
               q4;
      xv[it] = ok[it] ? __ldg(reinterpret_cast<const float4*>(a.x + at[it]))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();   // every warp is done with the ring
    i8mma::store_acc<2, 2>(tile2, kTile2Ld, wp * 32, wn * 16, acc, lane);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      if (!ok[it]) continue;
      const int4 v = *reinterpret_cast<const int4*>(
          tile2 + (prow + 16 * it) * kTile2Ld + q4);
      float4 o;
      o.x = __fadd_rn(xv[it].x,
                      requant_epilogue(v.x, a.shift, a.alpha2, bq[0], true));
      o.y = __fadd_rn(xv[it].y,
                      requant_epilogue(v.y, a.shift, a.alpha2, bq[1], true));
      o.z = __fadd_rn(xv[it].z,
                      requant_epilogue(v.z, a.shift, a.alpha2, bq[2], true));
      o.w = __fadd_rn(xv[it].w,
                      requant_epilogue(v.w, a.shift, a.alpha2, bq[3], true));
      *reinterpret_cast<float4*>(a.out + at[it]) = o;
    }
    __syncthreads();   // the acc tile overlays the next chunk's ring
  }
}

// The shared-memory layout of a block for widths C -> C2 -> C: the t1q tile,
// then the deepest rings (at most 4 stages, at most one per K step) that
// fit beside it, with 256-byte phase-2 stages where they fit, else 128; at
// C2 = 2048 phase 1 takes its halo in two passes of 64 rows. Returns the
// dynamic shared memory in bytes, 0 if nothing fits.
int plan_smem(int C, int C2, ResArgs& a) {
  a.rs = (((C2 + 15) / 16) | 1) * 16;
  a.t1q_bytes = kNH * a.rs + kSlack;
  int kw2 = kKC;   // the smallest power of two >= C2, from 32 to 256
  while (kw2 < C2 && kw2 < kMaxKW2) kw2 *= 2;
  const int slabs1 = (C + kKC - 1) / kKC;
  for (int rows1 : {kNH, 64}) {
    for (int st = 4; st >= 2; --st) {
      for (int kw : {kw2, std::min(kw2, 128)}) {
        const int n2 = 9 * ((C2 + kw - 1) / kw);
        a.kw2 = kw;
        a.rows1 = rows1;
        a.st1 = std::min(st, std::max(2, slabs1));
        a.st2 = std::min(st, std::max(2, n2));
        const int tile1 = (rows1 + 15) / 16 * 16 * kTile1Ld * 4;
        const int p1 = std::max(
            tile1, a.st1 * (rows1 * kFrow + kN1 * kArow) + 2 * rows1 * kArow);
        const int p2 = std::max(kMC * kTile2Ld * 4, a.st2 * kMC * (kw + 16));
        const int smem = a.t1q_bytes + std::max(p1, p2);
        if (smem <= kMaxSmem) return smem;
      }
    }
  }
  return 0;
}

int cluster_size(int C) {
  return std::min(kMaxCluster, (C + kMC - 1) / kMC);
}

// The kernel's function attributes, set once per device (not per launch):
// room for the largest block, and clusters above 8 blocks.
std::atomic<bool> g_configured[kMaxDevices];

cudaError_t configure(int device) {
  if (device >= 0 && device < kMaxDevices && g_configured[device].load())
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_res_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fused_res_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_configured[device].store(true);
  return err;
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                   int cs, unsigned tiles, unsigned B, int smem,
                   cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs), tiles, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

}  // namespace

// Launches one residual block on `stream` of CUDA device `device`. Pointers
// are device pointers to contiguous tensors: x and out [B,H,W,C] f32 (both
// 16-byte aligned, out a separate buffer), w1 [C2,1,1,C] int8, b1 [C2] f32,
// w2 [C,3,3,C2] int8, b2 [C] f32 (w1, w2 4-byte aligned). Requires
// C % 4 == 0, C2 % 4 == 0, C2 <= 2048, B <= 65535 and
// ceil(H/8)*ceil(W/8) <= 65535.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fused_res_block_nhwc(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* out, int B, int H,
                                    int W, int C, int C2, float m1,
                                    float alpha1, float m2, float alpha2,
                                    int shift, int device, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (C % 4 || C2 % 4 || C2 == 0 || C2 > kMaxC2 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((H + kTH - 1) / kTH) *
                          ((W + kTW - 1) / kTW);
  if (B > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  ResArgs a = {};
  const int smem = plan_smem(C, C2, a);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(x);
  a.w1 = static_cast<const int8_t*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const int8_t*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<float*>(out);
  a.H = H; a.W = W; a.C = C; a.C2 = C2;
  a.m1 = m1; a.alpha1 = alpha1; a.m2 = m2; a.alpha2 = alpha2;
  a.shift = shift;
  a.vec1 = C % 16 == 0 && reinterpret_cast<uintptr_t>(w1) % 16 == 0;
  a.vec2 = C2 % 16 == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;

  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, cluster_size(C), static_cast<unsigned>(tiles),
                static_cast<unsigned>(B), smem,
                static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, fused_res_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What fused_res_block_nhwc launches for widths C -> C2 -> C on CUDA device
// `device`, written to info[0..5]: the cluster size, the dynamic shared
// memory per block in bytes, how many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), the ring depths of phase 1 and phase 2,
// and the halo rows per phase-1 pass. Returns a cudaError_t (0 on success).
extern "C" int fused_res_occupancy(int C, int C2, int device, int* info) {
  if (C <= 0 || C % 4 || C2 % 4 || C2 <= 0 || C2 > kMaxC2)
    return static_cast<int>(cudaErrorInvalidValue);
  ResArgs a = {};
  const int smem = plan_smem(C, C2, a);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cs = cluster_size(C);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  launch_config(cfg, attr, cs, 1, 1, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fused_res_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = cs;
  info[1] = smem;
  info[2] = clusters;
  info[3] = a.st1;
  info[4] = a.st2;
  info[5] = a.rows1;
  return 0;
}
