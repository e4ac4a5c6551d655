// The body of K1, the int8 implicit-GEMM convolution of csrc/int8_conv.cu
// (its design is set out there), and its launcher, shared by the two
// libraries that instantiate it: csrc/int8_conv.cu (the epilogue's
// activation leaky or linear, read at run time) and csrc/int8_conv_mish.cu
// (mish, fixed at compile time, under a kernel name of its own).

#pragma once

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_epilogue.cuh"
#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 (pixels) x 4 (channels)
// blocks an SM must hold at once: caps the registers at 80 a thread
constexpr int kMinBlocks = 3;
constexpr int kBP = 64;         // output pixels per block
constexpr int kBM = 64;         // output channels per block
constexpr int kKC = 32;         // channels (int8 bytes) per K slab
constexpr int kArow = kKC + 16; // A row stride in shared memory (3 units)
constexpr int kTileLd = 72;     // int32 words per row of the epilogue tile
constexpr int kFrow = kKC * 4;  // f32 row of a slab in shared memory
constexpr int kHrow = kKC * 2;  // bf16 row of a slab in shared memory
constexpr int kMaxStages = 4;   // ring stages: weights, halo (int8 or f32)
constexpr int kMaxSmem = 232448;
constexpr int kMaxSplit = 8;
constexpr int kMaxDevices = 64;

// input forms (the kernel's template argument) and stores
enum { kInI8 = 0, kInF32 = 1, kInBf16 = 2 };
enum { kStoreF32 = 0, kStoreBf16 = 1, kStoreI8 = 2, kStoreF32I8 = 3 };
enum { kCpu = 0, kGpu = 1, kOld = 2 };   // the epilogues

struct ConvArgs {
  const void* x;            // int8, f32 or bf16 NHWC
  const int8_t* w;          // [M][ks][ks][C]
  const float* bias;        // [M]
  void* out;                // [B][OH][OW][M] in the store's type
  int8_t* out2;             // kStoreF32I8's int8 output, [B][OH][OW][M]
  int B, H, W, C, M, OH, OW, ks, stride, pad;
  float in_mult, alpha;     // alpha: the "gpu" epilogue's inv, the "old"
                            // one's output_multipler
  int shift, leaky, semantics, store;
  float out_mult;           // the int8 store's multiplier (1 for "old")
  int tile_h, tile_w;       // 0, 0: flat pixel tiles (1x1/s1/p0)
  int halo_h, halo_w, nhr;  // halo rows staged per slab
  int tiles_y, tiles_x;     // spatial tiles per image
  int slabs, split, vec16, stages;
  int tab_bytes, a_bytes, w_bytes;   // shared-memory layout
};

// Wait until at most n (0-2) of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) i8mma::cp_async_wait<0>();
  else if (n == 1) i8mma::cp_async_wait<1>();
  else i8mma::cp_async_wait<2>();
}

// Four epilogue values of channels m..m+3 stored at element `o` of `out`
// in the type of `store` (kStoreF32, kStoreBf16 or kStoreI8 at out_mult):
// one 16-, 8- or 4-byte store where M % 4 == 0, else one element at a time
// up to M.
__device__ __forceinline__ void store4(const ConvArgs& a, int store,
                                       void* out, size_t o, int m,
                                       const float (&y)[4]) {
  const bool vec = (a.M & 3) == 0;
  if (store == kStoreF32) {
    float* dst = static_cast<float*>(out) + o;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m + j < a.M) dst[j] = y[j];
    }
  } else if (store == kStoreBf16) {
    uint16_t* dst = static_cast<uint16_t*>(out) + o;
    if (vec) {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(bf16_bits(y[0]) | bf16_bits(y[1]) << 16,
                     bf16_bits(y[2]) | bf16_bits(y[3]) << 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m + j < a.M) dst[j] = static_cast<uint16_t>(bf16_bits(y[j]));
    }
  } else {
    int8_t* dst = static_cast<int8_t*>(out) + o;
    if (vec) {
      *reinterpret_cast<int32_t*>(dst) = quantize_pack4(
          make_float4(y[0], y[1], y[2], y[3]), a.out_mult);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (m + j < a.M)
          dst[j] = static_cast<int8_t>(quantize_i8(y[j], a.out_mult));
    }
  }
}

// the epilogue's activation: read from a.leaky (leaky or linear), or mish
enum { kActFlag = 0, kActMish = 1 };
// the activation codes of the C entry points (ops/int8_conv._EPILOGUES)
enum { kLinear = 0, kLeaky = 1, kMish = 2 };

// The kernel, one block of it: a tile of output pixels x 64 channels.
template <int kIn, int kAct>
__device__ __forceinline__ void conv_block(const ConvArgs& a) {
  // the float forms stage their halo in a ring and quantize it into a
  // double buffer of int8 rows
  constexpr bool kFloat = kIn != kInI8;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);          // halo row -> pixel or -1
  unsigned char* pipe = smem + a.tab_bytes;
  unsigned char* abuf = pipe;                       // int8 A rows
  unsigned char* wbuf = pipe + a.a_bytes;           // weight stages
  unsigned char* fbuf = wbuf + a.w_bytes;           // float halo stages

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
  const int wstride = taps * kKC + 16;
  const bool flat = a.tile_h == 0;
  const int P = a.B * a.OH * a.OW;

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

  // This thread's four epilogue channels and their biases, loaded now so
  // their latency hides behind the main loop.
  const int q4 = tid & 15;
  const int m = m0 + q4 * 4;
  float bq[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bq[j] = m + j < a.M ? __ldg(a.bias + m + j) : 0.f;

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

  // Copy geometry: 16-byte chunks (2 per 32-byte row) or 4-byte (8 per row).
  const int csh = a.vec16 ? 1 : 3;
  const int ush = a.vec16 ? 4 : 2;
  const int wtc = taps << csh;                 // weight chunks per row
  const int w_step_n = kThreads / wtc;
  const int w_step_r = kThreads - w_step_n * wtc;
  const int w_n0 = tid / wtc;
  const int w_r0 = tid - w_n0 * wtc;
  const int8_t* x8 = static_cast<const int8_t*>(a.x);
  const float* x32 = static_cast<const float*>(a.x);
  const uint16_t* x16 = static_cast<const uint16_t*>(a.x);

  auto load_w = [&](int slab, int slot) {
    const uint32_t dst0 = i8mma::smem_addr(wbuf + slot * kBM * wstride);
    int n = w_n0, r = w_r0;
    for (int e = tid; e < kBM * wtc; e += kThreads) {
      const int t = r >> csh;
      const int cb = (r & ((1 << csh) - 1)) << ush;
      const int c = slab * kKC + cb;
      const bool valid = m0 + n < a.M && c < a.C;
      const int8_t* src =
          valid ? a.w + (static_cast<size_t>(m0 + n) * taps + t) * a.C + c
                : a.w;
      const uint32_t dst = dst0 + n * wstride + t * kKC + cb;
      if (a.vec16) i8mma::cp_async16(dst, src, valid);
      else i8mma::cp_async4(dst, src, valid);
      n += w_step_n;
      r += w_step_r;
      if (r >= wtc) { r -= wtc; ++n; }
    }
  };
  auto load_a8 = [&](int slab, int slot) {
    const uint32_t dst0 = i8mma::smem_addr(abuf + slot * a.nhr * kArow);
    for (int e = tid; e < (a.nhr << csh); e += kThreads) {
      const int hr = e >> csh;
      const int cb = (e & ((1 << csh) - 1)) << ush;
      const int c = slab * kKC + cb;
      const int pix = tab[hr];
      const bool valid = pix >= 0 && c < a.C;
      const int8_t* src = valid ? x8 + static_cast<size_t>(pix) * a.C + c : x8;
      const uint32_t dst = dst0 + hr * kArow + cb;
      if (a.vec16) i8mma::cp_async16(dst, src, valid);
      else i8mma::cp_async4(dst, src, valid);
    }
  };
  // f32 halo of a slab, 16 bytes per copy: chunk e (row e / 8) is always
  // copied, and later quantized, by thread e % kThreads
  auto load_f = [&](int slab, int stage) {
    const uint32_t dst0 = i8mma::smem_addr(fbuf + stage * a.nhr * kFrow);
    for (int e = tid; e < a.nhr * (kKC / 4); e += kThreads) {
      const int pix = tab[e >> 3];
      const int c = slab * kKC + ((e & 7) << 2);
      const bool valid = pix >= 0 && c < a.C;
      const float* src = valid ? x32 + static_cast<size_t>(pix) * a.C + c : x32;
      i8mma::cp_async16(dst0 + e * 16, src, valid);
    }
  };
  // bf16 halo of a slab, 8 bytes (four channels) per copy, chunk e
  // likewise copied and quantized by thread e % kThreads
  auto load_h = [&](int slab, int stage) {
    const uint32_t dst0 = i8mma::smem_addr(fbuf + stage * a.nhr * kHrow);
    for (int e = tid; e < a.nhr * (kKC / 4); e += kThreads) {
      const int pix = tab[e >> 3];
      const int c = slab * kKC + ((e & 7) << 2);
      const bool valid = pix >= 0 && c < a.C;
      const uint16_t* src =
          valid ? x16 + static_cast<size_t>(pix) * a.C + c : x16;
      i8mma::cp_async8(dst0 + e * 8, src, valid);
    }
  };
  auto load_float = [&](int slab, int stage) {
    if (kIn == kInF32) load_f(slab, stage);
    else load_h(slab, stage);
  };
  auto quantize_own = [&](int stage, int buf) {
    unsigned char* dst = abuf + buf * a.nhr * kArow;
    for (int e = tid; e < a.nhr * (kKC / 4); e += kThreads) {
      float4 v;
      if (kIn == kInF32) {
        v = *reinterpret_cast<const float4*>(fbuf + stage * a.nhr * kFrow +
                                             e * 16);
      } else {
        v = bf16x4_to_float4(*reinterpret_cast<const uint2*>(
            fbuf + stage * a.nhr * kHrow + e * 8));
      }
      *reinterpret_cast<int32_t*>(dst + (e >> 3) * kArow + ((e & 7) << 2)) =
          quantize_pack4(v, a.in_mult);
    }
  };
  auto load_slab = [&](int slab, int stage) {
    load_w(slab, stage);
    if (kFloat) load_float(slab, stage);
    else load_a8(slab, stage);
  };

  const int s_lo = rank * a.slabs / split;
  const int n_slabs = (rank + 1) * a.slabs / split - s_lo;
  const int stages = a.stages;
  const int ahead = stages - 1;

  int acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // The first slabs' weights do not need the halo table: their copies
  // start before it is built and join slab 0's copy group.
  for (int d = 0; d < ahead && d < n_slabs; ++d) load_w(s_lo + d, d);
  // The halo table: the input pixel of every staged row, -1 outside.
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
    if (d < n_slabs) {
      if (kFloat) load_float(s_lo + d, d);
      else load_a8(s_lo + d, d);
    }
    i8mma::cp_async_commit();
  }
  if (kFloat && n_slabs > 0) {
    cp_async_wait_upto(ahead - 1);   // this thread's copies of slab 0
    quantize_own(0, 0);
  }

  const uint32_t a_lane = i8mma::a_lane_offset(lane);
  const uint32_t b_lane =
      (wn * 16 + i8mma::b_lane_row(lane)) * wstride + i8mma::b_lane_offset(lane);
  for (int i = 0; i < n_slabs; ++i) {
    // slab i's copies are done (a float form waited before quantizing it)
    if (!kFloat) cp_async_wait_upto(ahead - 1);
    __syncthreads();   // slab i staged; slab i-1's buffers free
    const int nx = i + ahead;
    if (nx < n_slabs) load_slab(s_lo + nx, nx % stages);
    i8mma::cp_async_commit();

    const int slot = i % stages;
    const uint32_t a_base =
        i8mma::smem_addr(abuf + (kFloat ? (i & 1) : slot) * a.nhr * kArow) +
        a_lane;
    const uint32_t b_base =
        i8mma::smem_addr(wbuf + slot * kBM * wstride) + b_lane;
    int ky = 0, kx = 0;
    for (int t = 0; t < taps; ++t) {
      const int toff = flat ? 0 : ky * a.halo_w + kx;
      const uint32_t aa[2] = {a_base + (hb[0] + toff) * kArow,
                              a_base + (hb[1] + toff) * kArow};
      i8mma::warp_tile_k32<2, 2>(acc, aa, b_base + t * kKC, 16 * wstride);
      if (++kx == a.ks) { kx = 0; ++ky; }
    }
    if (kFloat && i + 1 < n_slabs) {
      cp_async_wait_upto(ahead - 1);   // this thread's copies of slab i+1
      quantize_own((i + 1) % stages, (i + 1) & 1);
    }
  }
  i8mma::cp_async_wait<0>();
  __syncthreads();   // every warp is done with the pipeline buffers

  // ---- epilogue: int32 tile in shared memory, summed over the cluster ----
  int* acc_tile = reinterpret_cast<int*>(pipe);
  i8mma::store_acc<2, 2>(acc_tile, kTileLd, wp * 32, wn * 16, acc, lane);
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) cluster.sync();
  else __syncthreads();

  // Each thread writes channels m..m+3 of up to 4 rows of this block's
  // share (16 threads a row); all their partial sums are read before any
  // is used, so the shared and distributed shared loads overlap.
  const int row_lo = rank * kBP / split;
  const int row_hi = (rank + 1) * kBP / split;
  const int col = q4 * 4;
  int4 sum[4];
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int row = row_lo + (tid >> 4) + 16 * it;
    sum[it] = row < row_hi
                  ? *reinterpret_cast<const int4*>(acc_tile + row * kTileLd + col)
                  : make_int4(0, 0, 0, 0);
  }
  for (int k = 1; k < split; ++k) {
    const int* remote = cluster.map_shared_rank(acc_tile, (rank + k) % split);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int row = row_lo + (tid >> 4) + 16 * it;
      if (row < row_hi) {
        const int4 v =
            *reinterpret_cast<const int4*>(remote + row * kTileLd + col);
        sum[it].x += v.x; sum[it].y += v.y;
        sum[it].z += v.z; sum[it].w += v.w;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int row = row_lo + (tid >> 4) + 16 * it;
    if (row >= row_hi || m >= a.M) continue;
    int gp;
    if (flat) {
      gp = p0 + row;
      if (gp >= P) continue;
    } else {
      if (row >= a.tile_h * a.tile_w) continue;
      const int r = row / a.tile_w;
      const int oy = oy0 + r;
      const int ox = ox0 + (row - r * a.tile_w);
      if (oy >= a.OH || ox >= a.OW) continue;
      gp = (img * a.OH + oy) * a.OW + ox;
    }
    const int sv[4] = {sum[it].x, sum[it].y, sum[it].z, sum[it].w};
    const size_t o = static_cast<size_t>(gp) * a.M + m;
    float y[4];
    if (kAct == kActFlag && a.semantics == kOld) {
      // q: the int8 store takes it at multiplier 1, the f32 store q / 16
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = old_epilogue(sv[j], a.shift, a.alpha, bq[j], a.leaky);
      if (a.store == kStoreI8 || a.store == kStoreF32I8)
        store4(a, kStoreI8, a.store == kStoreI8 ? a.out : a.out2, o, m, y);
      if (a.store != kStoreI8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) y[j] = __fmul_rn(y[j], 0.0625f);
        store4(a, kStoreF32, a.out, o, m, y);
      }
      continue;
    }
    // mish follows the linear epilogue, in float32 before the store
    const bool leaky = kAct == kActMish ? false : a.leaky;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = a.semantics == kGpu
                 ? gpu_epilogue(sv[j], a.alpha, bq[j], leaky)
                 : requant_epilogue(sv[j], a.shift, a.alpha, bq[j], leaky);
      if (kAct == kActMish) y[j] = mish(y[j]);
    }
    store4(a, a.store, a.out, o, m, y);
  }
  // no block may leave while a peer still reads its partial tile
  if (split > 1) cluster.sync();
}

// A library's kernel of each input form (kInI8, kInF32, kInBf16); nullptr
// where it builds none.
using Kernel = void (*)(ConvArgs);

std::atomic<bool> g_configured[kMaxDevices];

cudaError_t configure(const Kernel (&kernels)[3], int device) {
  if (device >= 0 && device < kMaxDevices && g_configured[device].load())
    return cudaSuccess;
  cudaError_t err = cudaSuccess;
  for (int f = 0; f < 3 && err == cudaSuccess; ++f)
    if (kernels[f] != nullptr)
      err = cudaFuncSetAttribute(kernels[f],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_configured[device].store(true);
  return err;
}

// The C entry points' work, for the kernels of the library whose
// activation is kAct (see int8_conv_nhwc in csrc/int8_conv.cu).
template <int kAct>
int launch_conv(const Kernel (&kernels)[3], const void* x, int x_form,
                float input_mult, const void* w, const void* bias, void* out,
                void* out2, int B, int H, int W, int C, int M, int OH, int OW,
                int ks, int stride, int pad, float alpha, int shift, int act,
                int semantics, int store, float out_mult, int tile_h,
                int tile_w, int split, int stages, int device,
                void* stream) {
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  ConvArgs a = {};
  a.x = x;
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.out2 = static_cast<int8_t*>(out2);
  a.B = B; a.H = H; a.W = W; a.C = C; a.M = M; a.OH = OH; a.OW = OW;
  a.ks = ks; a.stride = stride; a.pad = pad;
  a.in_mult = input_mult; a.alpha = alpha; a.shift = shift;
  a.leaky = act == kLeaky;
  a.semantics = semantics; a.store = store;
  a.out_mult = semantics == kOld ? 1.0f : out_mult;
  const bool flat = tile_h == 0 && tile_w == 0;
  const bool x_float = x_form != kInI8;
  if (C % 4 || ks < 1 || stride < 1 || split < 1 || split > kMaxSplit ||
      x_form < kInI8 || x_form > kInBf16 || kernels[x_form] == nullptr ||
      act < kLinear || act > kMish || (act == kMish) != (kAct == kActMish) ||
      (kAct == kActMish && (semantics == kOld || store != kStoreF32)) ||
      store < kStoreF32 ||
      store > kStoreF32I8 || semantics < kCpu || semantics > kOld ||
      (semantics == kOld && store == kStoreBf16) ||
      (store == kStoreF32I8 && (semantics != kOld || out2 == nullptr)) ||
      stages < 2 || stages > kMaxStages ||
      (flat && (ks != 1 || stride != 1 || pad != 0)) ||
      (!flat && (tile_h < 1 || tile_w < 1 || tile_h * tile_w > kBP)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.tile_h = flat ? 0 : tile_h;
  a.tile_w = flat ? 0 : tile_w;
  a.halo_h = flat ? 1 : (tile_h - 1) * stride + ks;
  a.halo_w = flat ? kBP : (tile_w - 1) * stride + ks;
  a.nhr = a.halo_h * a.halo_w;
  a.tiles_y = flat ? 0 : (OH + tile_h - 1) / tile_h;
  a.tiles_x = flat ? 0 : (OW + tile_w - 1) / tile_w;
  a.slabs = (C + kKC - 1) / kKC;
  a.split = split;
  a.stages = stages;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  a.vec16 = C % 16 == 0 && (x_float || xa % 16 == 0) && wa % 16 == 0;
  const long long tiles =
      flat ? (P + kBP - 1) / kBP
           : static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  const int wstride = ks * ks * kKC + 16;
  a.tab_bytes = (a.nhr * 4 + 15) / 16 * 16;
  a.a_bytes = (x_float ? 2 : stages) * a.nhr * kArow;
  a.w_bytes = stages * kBM * wstride;
  const int f_row = x_form == kInF32 ? kFrow : x_form == kInBf16 ? kHrow : 0;
  const long long pipe_bytes = static_cast<long long>(a.a_bytes) +
                               a.w_bytes +
                               static_cast<long long>(stages) * a.nhr * f_row;
  const long long tile_bytes = static_cast<long long>(kBP) * kTileLd * 4;
  const long long smem =
      a.tab_bytes + (pipe_bytes > tile_bytes ? pipe_bytes : tile_bytes);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (smem > kMaxSmem || split > a.slabs ||
      tiles * split > 0x7fffffffLL || (M + kBM - 1) / kBM > 65535 ||
      (x_form == kInF32 && xa % 16) || (x_form == kInBf16 && xa % 8) ||
      oa % (store == kStoreF32 || store == kStoreF32I8 ? 16
            : store == kStoreBf16 ? 8 : 4) ||
      reinterpret_cast<uintptr_t>(out2) % 4)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(kernels, device);
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
  err = cudaLaunchKernelEx(&cfg, kernels[x_form], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
