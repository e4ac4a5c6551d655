// bfloat16 implicit-GEMM convolution on the tensor cores with a float32 sum
// and the conv's bias and leaky in its store: the float convs of -bf16.
//
// Not a TPU kernel: it replaces XLA's bf16 convolution of the JAX package,
// yolo2_light_tpu/models/layers.py conv2d_fp32 with compute_dtype=bfloat16
// (lax.conv_general_dilated(x.astype(bf16), w.astype(bf16),
// preferred_element_type=float32), then BN, bias and the activation in
// float32). The function:
//
//   y[b,oy,ox,m] = sum_{ky,kx,c} bf16(x[b, oy*s-pad+ky, ox*s-pad+kx, c])
//                                * w[m, ky, kx, c]
//   (float32 x rounded to bfloat16 to nearest even, as .to(torch.bfloat16)
//   rounds it; bfloat16 w; the exact products summed in float32; 0 outside
//   the image), then, each step one rounded operation as the PyTorch ops of
//   models/layers.conv2d_fp32 take it on the card:
//   bias (optional) y = __fadd_rn(y, bias[m])
//   leaky           y = y > 0 ? y : __fmul_rn(0.1f, y)    (or linear: y)
//   stored as float32 NHWC. BN is folded into the weights and the bias
//   before the forward (weights.fuse_conv_batchnorm, on every app path), so
//   the store has none; an unfused BN runs as PyTorch ops after the bare
//   conv (models/layers.conv2d_fp32).
//
// Layouts: x NHWC float32, w [M][ks][ks][C] bfloat16 (K contiguous per
// output channel; the c3 form: [M][32], the 27 K values of a 3x3x3 row and
// 5 zeros), out NHWC float32.
//
// Batch invariance (the reason the kernel exists: PyTorch's bfloat16
// convolution rounds its sum to bfloat16, and how it tiles and splits K
// follows the batch): every output's sum runs in one order fixed by C, ks
// and the split, and the planner (ops/bf16_conv.plan_launch) picks the
// split from one image's shape, never from the batch. Within a block's K
// range: for each slab of 16 (or 32) channels in order, for each 16-channel
// half, for each tap in order, one mma.sync m16n8k16 adds 16 products to
// the float32 accumulator. A cluster of `split` blocks shares one output
// tile: rank r sums slabs [r*S/split, (r+1)*S/split) into its own
// accumulators and stages them in shared memory; the block that owns a row
// then reads every rank's partial over distributed shared memory and sums
// them as ((p0 + p1) + p2) + ..., rank 0 first, whichever block it is. No
// atomics, and where a pixel sits in its tile changes no operand of its
// sum, so an image's outputs are bit-identical at any batch.
//
// What bounds it on an H100: at yolov3-416's shapes the least time is the
// bytes (the float32 input and output, the bf16 weights: 1-20 us a conv at
// 3.35 TB/s) at 21 of 23 shapes, the MACs at 989 TFLOP/s at the other two.
// The first design (one block per 64x64 output tile, 16-channel slabs, the
// epilogue as PyTorch ops) was bound by per-block latency: at 13x13 a conv
// had 12-64 blocks walking 32-64 slabs each, one barrier a slab, and the
// first conv (C = 3) issued 144 products per output for 27 real ones. What
// each part of this design does about it, by shape class (the planner's
// rules were chosen by timing every plan at each shape,
// scripts/trace_bf16_conv.py --plans):
//
// * 13x13 and 26x26 (few tiles, deep K): the K split across a cluster of
//   2, 4 or 8 blocks (the smallest that gives one image half the card's
//   block slots, each block two slabs or more) fills the card; the partials
//   meet in distributed shared memory, not device memory, and the combine
//   is the store's own pass: each thread loads every rank's partial of its
//   row before it adds them. Measured, what bounds them now: the 3x3
//   convs' main loop pulls 25-50 KB of weights and halo a slab from L2,
//   each weight slab once per pixel tile (1.6-1.9 TB/s over the card); the
//   1x1 convs' blocks spend 30-50% of their time in the split store (two
//   cluster barriers, the DSMEM loads).
// * 104x104 and larger (many tiles): split 1 (but 2 at the 104x104 1x1);
//   an unsplit block's fragments go through the epilogue straight to
//   device memory. Per-block latency bounds them, as it bounded the first
//   design.
// * The 1x1 convs and the 3x3 convs of C >= 512: 32-channel slabs, two k16
//   MMAs per tap between barriers, half the barriers and ring turns of 16.
//   Below C = 512 a 3x3 conv keeps 16: the wider weight ring would leave
//   one block an SM where 16 channels leave three.
// * The first conv (C = 3, 3x3): the c3 form packs the 27 products of an
//   output into one k32 step (two m16n8k16 MMAs): thread (ky, pixel) loads
//   the 9 contiguous floats of the pixel's input row ky, rounds them and
//   stores them at K 9ky..9ky+8; the weights are one 16-byte copy per
//   quarter row. Its blocks are short, so five share an SM. It is bound by
//   its 22 MB float32 store.
// * Every conv: bias and leaky/linear in the store (one pass over the
//   output instead of two to four PyTorch launches that each read and
//   write the float32 map again).
//
// The skeleton is K1's (csrc/int8_conv.cu): output tiles of 64 pixels x 64
// channels, eight warps of 32x16, fragments by ldmatrix (16 bf16 channels
// are the 32 bytes a row of K1's int8 slab has, so int8_mma.cuh's ldmatrix
// addressing holds unchanged). A 1x1/s1/p0 conv tiles the pixels flat;
// every other conv takes an 8x8 (or 4x8, 4x4) spatial tile whose input
// halo is staged once per slab and read by every tap. The weights (16-byte
// cp.async copies of 8 channels where C % 8 == 0) and the float32 halo
// (16-byte copies of 4 channels where C % 4 == 0) arrive into a ring of 2-4
// stages, up to three slabs ahead; after the current slab's MMAs each
// thread rounds the 16-byte chunks of the next slab that its own copies
// brought into a double buffer of bf16 rows (__floats2bfloat162_rn). Where
// C is not a multiple of 4 or 8 the copies are single elements, zero past
// C. Ragged pixels and output channels (the heads' M = 255) are zero-filled
// on the way in and masked at the store.
//
// The launch allocates nothing, goes through cudaLaunchKernelEx (with the
// cluster attribute where split > 1, so it is captured in CUDA graphs) and
// the entry point returns cudaGetLastError(), so a refused launch is
// reported to the caller.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 (pixels) x 4 (channels)
constexpr int kMinBlocks = 3;   // blocks an SM must hold at once
constexpr int kC3MinBlocks = 5; // the same, for the c3 form's short blocks
constexpr int kBP = 64;         // output pixels per block
constexpr int kBM = 64;         // output channels per block
constexpr int kTileLd = 72;     // floats per row of the partial tile
constexpr int kTileBytes = kBP * kTileLd * 4;
constexpr int kMaxStages = 4;
constexpr int kMaxSplit = 8;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kC3K = 32;        // the c3 form's K, 27 products padded
constexpr int kC3Row = kC3K * 2 + 16;   // bytes per c3 A or B row

enum Form { kHalo = 0, kFlat = 1, kC3 = 2 };
enum Act { kLinear = 0, kLeaky = 1 };

struct ConvArgs {
  const float* x;           // [B][H][W][C]
  const uint16_t* w;        // [M][ks][ks][C] bf16 bits (c3: [M][32])
  float* out;               // [B][OH][OW][M]
  const float* bias;        // [M] or null
  int act;                  // kLinear or kLeaky
  int B, H, W, C, M, OH, OW, ks, stride, pad;
  int tile_h, tile_w;       // 0, 0: flat pixel tiles (1x1/s1/p0, c3)
  int halo_h, halo_w, nhr;  // halo rows staged per slab
  int tiles_y, tiles_x;     // spatial tiles per image
  int slabs, split, stages, xvec, wvec, ovec, ovec2;
  int tab_bytes, a_bytes, w_bytes;   // shared-memory layout
};

__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) i8mma::cp_async_wait<0>();
  else if (n == 1) i8mma::cp_async_wait<1>();
  else i8mma::cp_async_wait<2>();
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One k16 step of a warp's 32x16 tile: A rows at a_addr[0..1] (this lane's
// ldmatrix addresses), the B pair at b_addr.
__device__ __forceinline__ void warp_k16(float (&acc)[2][2][4],
                                         uint32_t a0, uint32_t a1,
                                         uint32_t b_addr) {
  uint32_t af[2][4], bf[4];
  i8mma::ldmatrix_x4(af[0], a0);
  i8mma::ldmatrix_x4(af[1], a1);
  i8mma::ldmatrix_x4(bf, b_addr);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      mma_bf16(acc[mi][nj], af[mi], bf[2 * nj], bf[2 * nj + 1]);
}

// The warp's accumulators into the float32 partial tile (rows: pixels of
// the block, columns: its 64 channels).
__device__ __forceinline__ void stage_acc(float* tile,
                                          const float (&acc)[2][2][4],
                                          int wp, int wn, int lane) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {
      float* p = tile + (wp * 32 + 16 * mi + gid) * kTileLd + wn * 16 +
                 8 * nj + 2 * tig;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mi][nj][0],
                                                  acc[mi][nj][1]);
      *reinterpret_cast<float2*>(p + 8 * kTileLd) =
          make_float2(acc[mi][nj][2], acc[mi][nj][3]);
    }
}

// The biases of the four channels a thread stores, c0, c0 + 1, c1 and
// c1 + 1, loaded before the store pass so that their latency hides behind
// the barrier in front of it.
struct EpiVec {
  float bias[4];
};

__device__ __forceinline__ EpiVec load_epilogue(const ConvArgs& a, int c0,
                                                int c1) {
  EpiVec e;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = (j < 2 ? c0 : c1) + (j & 1);
    e.bias[j] = m < a.M && a.bias ? __ldg(a.bias + m) : 0.f;
  }
  return e;
}

__device__ __forceinline__ float epilogue(float y, const ConvArgs& a,
                                          const EpiVec& e, int j) {
  if (a.bias != nullptr) y = __fadd_rn(y, e.bias[j]);
  if (a.act == kLeaky) y = y > 0.f ? y : __fmul_rn(0.1f, y);
  return y;
}

__device__ __forceinline__ float4 add4(float4 s, float4 v) {
  return make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                     __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
}

// The output pixel of tile row `row`, or -1 past the map.
__device__ __forceinline__ int out_pixel(const ConvArgs& a, int row,
                                         bool flat, int p0, int img,
                                         int oy0, int ox0) {
  if (flat) {
    const int gp = p0 + row;
    return gp < a.B * a.OH * a.OW ? gp : -1;
  }
  if (row >= a.tile_h * a.tile_w) return -1;
  const int r = row / a.tile_w;
  const int oy = oy0 + r;
  const int ox = ox0 + (row - r * a.tile_w);
  if (oy >= a.OH || ox >= a.OW) return -1;
  return (img * a.OH + oy) * a.OW + ox;
}

// split == 1: one block sums the whole K, so its fragments go through the
// epilogue straight to device memory (rows gid / gid + 8 of each m16 tile,
// two channels at a time where M is even). e: channels c0 = m0 + wn*16 +
// 2*tig and c0 + 8.
__device__ __forceinline__ void store_frags(const ConvArgs& a,
                                            const EpiVec& e,
                                            const float (&acc)[2][2][4],
                                            int wp, int wn, int lane,
                                            bool flat, int p0, int img,
                                            int oy0, int ox0, int m0) {
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gp = out_pixel(a, wp * 32 + 16 * mi + gid + 8 * h, flat, p0,
                               img, oy0, ox0);
      if (gp < 0) continue;
      float* dst = a.out + static_cast<size_t>(gp) * a.M;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = m0 + wn * 16 + 8 * nj + 2 * tig;
        const float v0 = epilogue(acc[mi][nj][2 * h], a, e, 2 * nj);
        const float v1 = epilogue(acc[mi][nj][2 * h + 1], a, e, 2 * nj + 1);
        if (a.ovec2 && n + 1 < a.M) {
          *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
        } else {
          if (n < a.M) dst[n] = v0;
          if (n + 1 < a.M) dst[n + 1] = v1;
        }
      }
    }
}

// The store pass of a split tile (and of the c3 form's staged one): of the
// tile's n rows (64, or a spatial tile's pixels) this block's rank owns
// rows [rank*n/split, (rank+1)*n/split). For each of its rows a thread
// loads every rank's partial of channels m..m+3 (16 threads a row) before
// it sums them in rank order, then runs the epilogue and stores. S: the
// split, 1, 2, 4 or 8 (at most 8 partials a thread, all in registers).
// e: channels m and m + 2.
template <int S>
__device__ __forceinline__ void store_tile(const ConvArgs& a,
                                           const EpiVec& e, float* tile,
                                           int rank, bool flat, int p0,
                                           int img, int oy0, int ox0,
                                           int m0) {
  constexpr int kRows = S >= 4 ? 1 : 4 / S;   // rows a thread sums
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rows = flat ? kBP : a.tile_h * a.tile_w;
  const int row_lo = rank * rows / S;
  const int row_hi = (rank + 1) * rows / S;
  const int col = (tid & 15) * 4;
  const int m = m0 + col;
  if (m >= a.M) return;
  float4 v[kRows][S];
#pragma unroll
  for (int it = 0; it < kRows; ++it) {
    const int row = row_lo + (tid >> 4) + 16 * it;
    if (row >= row_hi) continue;
#pragma unroll
    for (int k = 0; k < S; ++k)
      v[it][k] = *reinterpret_cast<const float4*>(
          (S == 1 ? tile : cluster.map_shared_rank(tile, k)) +
          row * kTileLd + col);
  }
  float4 sum[kRows];
#pragma unroll
  for (int it = 0; it < kRows; ++it) {
    sum[it] = v[it][0];
#pragma unroll
    for (int k = 1; k < S; ++k) sum[it] = add4(sum[it], v[it][k]);
  }
#pragma unroll
  for (int it = 0; it < kRows; ++it) {
    const int row = row_lo + (tid >> 4) + 16 * it;
    if (row >= row_hi) continue;
    const int gp = out_pixel(a, row, flat, p0, img, oy0, ox0);
    if (gp < 0) continue;
    const float y[4] = {epilogue(sum[it].x, a, e, 0),
                        epilogue(sum[it].y, a, e, 1),
                        epilogue(sum[it].z, a, e, 2),
                        epilogue(sum[it].w, a, e, 3)};
    float* dst = a.out + static_cast<size_t>(gp) * a.M + m;
    if (a.ovec) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m + j < a.M) dst[j] = y[j];
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bf16_conv_kernel(const ConvArgs a) {
  constexpr int kArow = KC * 2 + 16;   // bf16 A row stride in shared memory
  constexpr int kFrow = KC * 4;        // f32 row of a slab in shared memory
  constexpr int kChunks = KC / 4;      // 16-byte f32 chunks of a halo row
  constexpr int kChunkShift = KC == 32 ? 3 : 2;   // log2(kChunks)
  constexpr int kHalves = KC / 16;     // k16 MMAs per tap
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);          // halo row -> pixel or -1
  unsigned char* pipe = smem + a.tab_bytes;
  unsigned char* abuf = pipe;                       // 2 x bf16 A rows
  unsigned char* wbuf = abuf + a.a_bytes;           // weight stages
  unsigned char* fbuf = wbuf + a.w_bytes;           // f32 halo stages

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wp = warp >> 2;          // pixel half of the tile
  const int wn = warp & 3;           // 16-channel quarter of the tile
  const int split = a.split;
  const int rank = static_cast<int>(blockIdx.x) % split;
  const int tile = static_cast<int>(blockIdx.x) / split;
  const int m0 = blockIdx.y * kBM;
  const int taps = a.ks * a.ks;
  const int wstride = taps * KC * 2 + 16;   // bytes per output channel's row
  const bool flat = a.tile_h == 0;
  const int P = a.B * a.OH * a.OW;
  const int s_lo = rank * a.slabs / split;  // this rank's K slabs
  const int n_slabs = (rank + 1) * a.slabs / split - s_lo;

  int img = 0, oy0 = 0, ox0 = 0, p0 = 0;
  if (flat) {
    p0 = tile * kBP;
  } else {
    const int per_img = a.tiles_y * a.tiles_x;
    img = tile / per_img;
    const int rem = tile - img * per_img;
    oy0 = (rem / a.tiles_x) * a.tile_h;
    ox0 = (rem % a.tiles_x) * a.tile_w;
  }

  // This lane's A rows (halo row of its pixel's (0, 0) tap) in its two m16
  // tiles; pixels past the tile read row 0 and are never stored.
  int hb[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = wp * 32 + 16 * i + (lane & 15);
    if (flat) {
      hb[i] = p;
    } else if (p < a.tile_h * a.tile_w) {
      const int r = p / a.tile_w;
      hb[i] = r * a.stride * a.halo_w + (p - r * a.tile_w) * a.stride;
    } else {
      hb[i] = 0;
    }
  }

  // a slab's weights: [kBM][taps][KC channels], 16-byte copies of 8
  // channels, or single elements where C % 8 != 0
  auto load_w = [&](int slab, int slot) {
    unsigned char* dst0 = wbuf + slot * kBM * wstride;
    if (a.wvec) {
      constexpr int kPerShift = KC == 32 ? 2 : 1;   // 8-channel copies a tap
      const int per_n = taps << kPerShift;
      for (int e = tid; e < kBM * per_n; e += kThreads) {
        const int n = e / per_n;
        const int r = e - n * per_n;
        const int t = r >> kPerShift;
        const int cb = (r & ((1 << kPerShift) - 1)) * 8;
        const int c = slab * KC + cb;
        const bool valid = m0 + n < a.M && c < a.C;
        const uint16_t* src =
            valid ? a.w + (static_cast<size_t>(m0 + n) * taps + t) * a.C + c
                  : a.w;
        i8mma::cp_async16(
            i8mma::smem_addr(dst0 + n * wstride + t * KC * 2 + cb * 2), src,
            valid);
      }
    } else {
      const int per_n = taps * KC;
      for (int e = tid; e < kBM * per_n; e += kThreads) {
        const int n = e / per_n;
        const int r = e - n * per_n;
        const int t = r / KC;
        const int cc = r - t * KC;
        const int c = slab * KC + cc;
        uint16_t v = 0;
        if (m0 + n < a.M && c < a.C)
          v = a.w[(static_cast<size_t>(m0 + n) * taps + t) * a.C + c];
        *reinterpret_cast<uint16_t*>(dst0 + n * wstride + t * KC * 2 +
                                     cc * 2) = v;
      }
    }
  };
  // a slab's f32 halo, chunk e = (row e / kChunks, channels
  // 4 (e % kChunks)..+3): always copied, and later rounded, by thread
  // e % kThreads
  auto load_f = [&](int slab, int stage) {
    unsigned char* dst0 = fbuf + stage * a.nhr * kFrow;
    for (int e = tid; e < a.nhr * kChunks; e += kThreads) {
      const int pix = tab[e >> kChunkShift];
      const int c = slab * KC + (e & (kChunks - 1)) * 4;
      if (a.xvec) {
        const bool valid = pix >= 0 && c < a.C;
        const float* src =
            valid ? a.x + static_cast<size_t>(pix) * a.C + c : a.x;
        i8mma::cp_async16(i8mma::smem_addr(dst0 + e * 16), src, valid);
      } else {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = pix >= 0 && c + j < a.C
                     ? a.x[static_cast<size_t>(pix) * a.C + c + j]
                     : 0.f;
        *reinterpret_cast<float4*>(dst0 + e * 16) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };
  auto round_own = [&](int stage, int buf) {
    unsigned char* dst = abuf + buf * a.nhr * kArow;
    for (int e = tid; e < a.nhr * kChunks; e += kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(
          fbuf + stage * a.nhr * kFrow + e * 16);
      *reinterpret_cast<uint2*>(dst + (e >> kChunkShift) * kArow +
                                (e & (kChunks - 1)) * 8) =
          make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
    }
  };

  const int stages = a.stages;
  const int ahead = stages - 1;

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // The first slabs' weights do not need the halo table: their copies
  // start before it is built and join slab 0's copy group.
  for (int d = 0; d < ahead && d < n_slabs; ++d) load_w(s_lo + d, d);
  for (int r = tid; r < a.nhr; r += kThreads) {
    int v = -1;
    if (flat) {
      if (p0 + r < P) v = p0 + r;
    } else {
      const int hy = r / a.halo_w;
      const int iy = oy0 * a.stride - a.pad + hy;
      const int ix = ox0 * a.stride - a.pad + (r - hy * a.halo_w);
      if (iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        v = (img * a.H + iy) * a.W + ix;
    }
    tab[r] = v;
  }

  __syncthreads();   // the halo table
  for (int d = 0; d < ahead; ++d) {
    if (d < n_slabs) load_f(s_lo + d, d);
    i8mma::cp_async_commit();
  }
  if (n_slabs > 0) {
    cp_async_wait_upto(ahead - 1);   // this thread's copies of slab 0
    round_own(0, 0);
  }

  const uint32_t a_lane = i8mma::a_lane_offset(lane);
  const uint32_t b_lane =
      (wn * 16 + i8mma::b_lane_row(lane)) * wstride + i8mma::b_lane_offset(lane);
  for (int i = 0; i < n_slabs; ++i) {
    __syncthreads();   // slab i rounded and staged; slab i-1's buffers free
    const int nx = i + ahead;
    if (nx < n_slabs) {
      load_w(s_lo + nx, nx % stages);
      load_f(s_lo + nx, nx % stages);
    }
    i8mma::cp_async_commit();

    const uint32_t a_base =
        i8mma::smem_addr(abuf + (i & 1) * a.nhr * kArow) + a_lane;
    const uint32_t b_base =
        i8mma::smem_addr(wbuf + (i % stages) * kBM * wstride) + b_lane;
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      int ky = 0, kx = 0;
      for (int t = 0; t < taps; ++t) {
        const int toff = flat ? 0 : ky * a.halo_w + kx;
        warp_k16(acc, a_base + (hb[0] + toff) * kArow + h * 32,
                 a_base + (hb[1] + toff) * kArow + h * 32,
                 b_base + t * KC * 2 + h * 32);
        if (++kx == a.ks) { kx = 0; ++ky; }
      }
    }
    if (i + 1 < n_slabs) {
      cp_async_wait_upto(ahead - 1);   // this thread's copies of slab i+1
      round_own((i + 1) % stages, (i + 1) & 1);
    }
  }
  i8mma::cp_async_wait<0>();   // the main loop's copies, all landed
  if (split == 1) {
    const int c0 = m0 + wn * 16 + 2 * (lane & 3);
    store_frags(a, load_epilogue(a, c0, c0 + 8), acc, wp, wn, lane, flat, p0,
                img, oy0, ox0, m0);
  } else {
    // ---- the partial tile in shared memory, summed over the cluster ----
    const int m = m0 + (tid & 15) * 4;
    const EpiVec ep = load_epilogue(a, m, m + 2);
    __syncthreads();   // every warp is done with the pipeline buffers
    float* acc_tile = reinterpret_cast<float*>(pipe);
    stage_acc(acc_tile, acc, wp, wn, lane);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (split == 2)
      store_tile<2>(a, ep, acc_tile, rank, flat, p0, img, oy0, ox0, m0);
    else if (split == 4)
      store_tile<4>(a, ep, acc_tile, rank, flat, p0, img, oy0, ox0, m0);
    else
      store_tile<8>(a, ep, acc_tile, rank, flat, p0, img, oy0, ox0, m0);
    // no block may leave while a peer still reads its partial tile
    cluster.sync();
  }  // the store
}

// The first conv (C = 3, ks <= 3): one k32 step of K = ks*ks*3 <= 27 real
// products, in the order of the [M, ks, ks, C] weight row, zero-padded.
// Flat tiles of 64 pixels over the batch; no split, no ring. Thread
// (ky, pixel) of the first 64*KS loads the pixel's input row iy = oy*s -
// pad + ky, KS*3 contiguous floats from ix = ox*s - pad, and stores them
// rounded at K ky*KS*3..; the next 64 threads zero each row's padding.
// Short blocks, so more of them share an SM (kC3MinBlocks).
template <int KS>
__global__ void __launch_bounds__(kThreads, kC3MinBlocks)
bf16_conv_kernel_c3(const ConvArgs a) {
  constexpr int kRow = KS * 3;          // K values of one input row
  constexpr int kReal = KS * kRow;      // K values of a pixel
  __shared__ __align__(16) unsigned char arow[kBP * kC3Row];
  __shared__ __align__(16) unsigned char wrow[kBM * kC3Row];
  __shared__ __align__(16) float tile[kBP * kTileLd];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wp = warp >> 2;
  const int wn = warp & 3;
  const int p0 = static_cast<int>(blockIdx.x) * kBP;
  const int m0 = blockIdx.y * kBM;
  const int P = a.B * a.OH * a.OW;

  // weights: 64 rows of 32 bf16, one 16-byte copy per quarter row
  {
    const int n = tid >> 2;
    const int q = tid & 3;
    const bool valid = m0 + n < a.M;
    const uint16_t* src =
        valid ? a.w + static_cast<size_t>(m0 + n) * kC3K + q * 8 : a.w;
    i8mma::cp_async16(i8mma::smem_addr(wrow + n * kC3Row + q * 16), src,
                      valid);
    i8mma::cp_async_commit();
  }
  const int mq = m0 + (tid & 15) * 4;
  const EpiVec ep = load_epilogue(a, mq, mq + 2);
  {
    const int p = tid & (kBP - 1);
    const int ky = tid >> 6;
    uint16_t* dst = reinterpret_cast<uint16_t*>(arow + p * kC3Row);
    if (ky < KS) {
      const int gp = p0 + p;
      float v[kRow];
#pragma unroll
      for (int j = 0; j < kRow; ++j) v[j] = 0.f;
      if (gp < P) {
        const int img = gp / (a.OH * a.OW);
        const int rem = gp - img * a.OH * a.OW;
        const int oy = rem / a.OW;
        const int ox = rem - oy * a.OW;
        const int iy = oy * a.stride - a.pad + ky;
        const int ix0 = ox * a.stride - a.pad;
        if (iy >= 0 && iy < a.H) {
          const float* src =
              a.x + (static_cast<size_t>(img * a.H + iy) * a.W + ix0) * 3;
#pragma unroll
          for (int j = 0; j < kRow; ++j) {
            const int ix = ix0 + j / 3;
            if (ix >= 0 && ix < a.W) v[j] = __ldg(src + j);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRow; ++j) {
        const __nv_bfloat16 b = __float2bfloat16_rn(v[j]);
        dst[ky * kRow + j] = *reinterpret_cast<const uint16_t*>(&b);
      }
    } else if (ky == KS) {
#pragma unroll
      for (int k = kReal; k < kC3K; ++k) dst[k] = 0;
    }
  }
  i8mma::cp_async_wait<0>();
  __syncthreads();

  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
  const uint32_t a_base = i8mma::smem_addr(arow) + i8mma::a_lane_offset(lane);
  const uint32_t b_base =
      i8mma::smem_addr(wrow) +
      (wn * 16 + i8mma::b_lane_row(lane)) * kC3Row + i8mma::b_lane_offset(lane);
  const int r0 = wp * 32 + (lane & 15);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    warp_k16(acc, a_base + r0 * kC3Row + h * 32,
             a_base + (r0 + 16) * kC3Row + h * 32, b_base + h * 32);
  stage_acc(tile, acc, wp, wn, lane);
  __syncthreads();
  store_tile<1>(a, ep, tile, 0, true, p0, 0, 0, 0, m0);
}

std::atomic<bool> g_configured[kMaxDevices];

cudaError_t configure(int device) {
  if (device >= 0 && device < kMaxDevices && g_configured[device].load())
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      bf16_conv_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bf16_conv_kernel<32>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_configured[device].store(true);
  return err;
}

}  // namespace

// Launches one convolution on `stream` of CUDA device `device`. Pointers are
// device pointers to contiguous tensors: x [B,H,W,C] float32 (4-byte
// aligned), w [M,ks,ks,C] bfloat16 (2-byte aligned; form 2: [M,32],
// 16-byte aligned), out [B,OH,OW,M] float32 (4-byte aligned); bias [M]
// float32 or null; act 0 (linear) or 1 (leaky). The plan comes from ops/bf16_conv.plan_launch: form 0
// (halo: tile_h x tile_w output tiles), 1 (flat 64-pixel tiles, for
// 1x1/s1/p0 only) or 2 (c3: C = 3, ks*ks*3 <= 32, flat, split 1); kc 16 or
// 32 channels per K slab; split 1, 2, 4 or 8 blocks of a cluster sharing a
// tile's K
// (at most the slab count); `stages` ring stages (2-4). Requires B*H*W,
// B*OH*OW < 2^31. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int bf16_conv_nhwc(const void* x, const void* w, void* out,
                              const void* bias, int act,
                              int B, int H, int W, int C, int M, int OH,
                              int OW, int ks, int stride, int pad, int form,
                              int tile_h, int tile_w, int kc, int split,
                              int stages, int device, void* stream) {
  const bool flat = form != kHalo;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (B < 0 || H < 1 || W < 1 || C < 1 || M < 0 || OH < 0 || OW < 0 ||
      ks < 1 || stride < 1 || pad < 0 || form < kHalo || form > kC3 ||
      (act != kLinear && act != kLeaky) ||
      (form == kFlat && (ks != 1 || stride != 1 || pad != 0)) ||
      (form == kC3 && (C != 3 || ks * ks * C > kC3K || split != 1 ||
                       wa % 16)) ||
      (form == kHalo && (tile_h < 1 || tile_w < 1 || tile_h * tile_w > kBP)) ||
      (form != kC3 && (kc != 16 && kc != 32)) ||
      (form != kC3 && (stages < 2 || stages > kMaxStages)) ||
      (split != 1 && split != 2 && split != 4 && split != kMaxSplit) ||
      xa % 4 || wa % 2 || oa % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  ConvArgs a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const uint16_t*>(w);
  a.out = static_cast<float*>(out);
  a.bias = static_cast<const float*>(bias);
  a.act = act;
  a.B = B; a.H = H; a.W = W; a.C = C; a.M = M; a.OH = OH; a.OW = OW;
  a.ks = ks; a.stride = stride; a.pad = pad;
  a.tile_h = flat ? 0 : tile_h;
  a.tile_w = flat ? 0 : tile_w;
  a.halo_h = flat ? 1 : (tile_h - 1) * stride + ks;
  a.halo_w = flat ? kBP : (tile_w - 1) * stride + ks;
  a.nhr = a.halo_h * a.halo_w;
  a.tiles_y = flat ? 0 : (OH + tile_h - 1) / tile_h;
  a.tiles_x = flat ? 0 : (OW + tile_w - 1) / tile_w;
  a.slabs = form == kC3 ? 1 : (C + kc - 1) / kc;
  a.split = split;
  a.stages = stages;
  a.xvec = C % 4 == 0 && xa % 16 == 0;
  a.wvec = C % 8 == 0 && wa % 16 == 0;
  a.ovec = M % 4 == 0 && oa % 16 == 0;
  a.ovec2 = M % 2 == 0 && oa % 8 == 0;
  const long long tiles =
      flat ? (P + kBP - 1) / kBP
           : static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  long long smem = 0;
  if (form != kC3) {
    const int wstride = ks * ks * kc * 2 + 16;
    a.tab_bytes = (a.nhr * 4 + 15) / 16 * 16;
    a.a_bytes = 2 * a.nhr * (kc * 2 + 16);
    a.w_bytes = stages * kBM * wstride;
    const long long pipe = static_cast<long long>(a.a_bytes) + a.w_bytes +
                           static_cast<long long>(stages) * a.nhr * kc * 4;
    smem = a.tab_bytes + (pipe > kTileBytes ? pipe : kTileBytes);
  }
  if (smem > kMaxSmem || split > a.slabs || tiles * split > 0x7fffffffLL ||
      (M + kBM - 1) / kBM > 65535 ||
      static_cast<long long>(B) * H * W >= 0x7fffffffLL ||
      P >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * split),
                     static_cast<unsigned>((M + kBM - 1) / kBM), 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  if (form == kC3 && ks == 3)
    err = cudaLaunchKernelEx(&cfg, bf16_conv_kernel_c3<3>, a);
  else if (form == kC3 && ks == 2)
    err = cudaLaunchKernelEx(&cfg, bf16_conv_kernel_c3<2>, a);
  else if (form == kC3)
    err = cudaLaunchKernelEx(&cfg, bf16_conv_kernel_c3<1>, a);
  else if (kc == 32)
    err = cudaLaunchKernelEx(&cfg, bf16_conv_kernel<32>, a);
  else
    err = cudaLaunchKernelEx(&cfg, bf16_conv_kernel<16>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
