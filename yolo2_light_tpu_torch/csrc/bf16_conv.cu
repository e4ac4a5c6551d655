// bfloat16 implicit-GEMM convolution on the tensor cores with a float32 sum:
// the float convs of -bf16.
//
// Not a TPU kernel: it replaces XLA's bf16 convolution of the JAX package,
// yolo2_light_tpu/models/layers.py conv2d_fp32 with compute_dtype=bfloat16
// (lax.conv_general_dilated(x.astype(bf16), w.astype(bf16),
// preferred_element_type=float32)). The function:
//
//   y[b,oy,ox,m] = sum_{ky,kx,c} bf16(x[b, oy*s-pad+ky, ox*s-pad+kx, c])
//                                * w[m, ky, kx, c]
//   (float32 x rounded to bfloat16 to nearest even, as .to(torch.bfloat16)
//   rounds it; bfloat16 w; the exact products summed in float32; 0 outside
//   the image), stored as float32 NHWC. BN, bias and the activation stay
//   with the caller (models/layers.conv2d_fp32).
//
// Layouts: x NHWC float32, w [M][ks][ks][C] bfloat16 (K contiguous per
// output channel), out NHWC float32.
//
// Batch invariance (the reason the kernel exists: PyTorch's bfloat16
// convolution rounds its sum to bfloat16, and how it tiles and splits K
// follows the batch): every output's sum runs in one order that depends on
// C and ks alone: for each 16-channel slab in order, for each tap in order,
// one mma.sync m16n8k16 adds the slab's 16 products to the float32
// accumulator. K is never split across blocks, nothing is summed with
// atomics, and where an output pixel sits in its tile changes no operand of
// its sum, so an image's outputs are bit-identical at any batch.
//
// What bounds it on an H100: at yolov3-416's shapes the least time is the
// bytes (the float32 input and output, the bf16 weights: 1-20 us a conv at
// 3.35 TB/s) at the 1x1 and deep 3x3 convs, the MACs at 989 TFLOP/s for the
// wide 3x3 ones. The design is K1's (csrc/int8_conv.cu), right before fast:
//
// * Output tiles of 64 pixels x 64 channels, eight warps of 32x16, each K
//   step one mma.sync m16n8k16 bf16 per m16n8 tile from ldmatrix fragments
//   (16 bf16 channels are 32 bytes, the row K1's int8 slabs have, so
//   int8_mma.cuh's ldmatrix addressing holds unchanged). A 1x1/s1/p0 conv
//   tiles the pixels flat; every other conv takes an 8x8 (or 4x8, 4x4)
//   spatial tile whose input halo is staged once per slab and read by every
//   tap.
// * K runs in slabs of 16 channels. The weights (16-byte cp.async copies of
//   8 channels where C % 8 == 0) and the float32 halo (16-byte copies of 4
//   channels where C % 4 == 0) arrive into a ring of 2-4 stages, up to three
//   slabs ahead. After the current slab's MMAs each thread rounds the
//   16-byte chunks of the next slab that its own copies brought into a
//   double buffer of bf16 rows (__floats2bfloat162_rn), so the rounding
//   costs no launch and no trip through device memory. Where C is not a
//   multiple of 4 or 8 (the first conv, C = 3) the copies are plain loads of
//   single elements, zero past C: the slab is zero-padded to the MMA's k16.
// * Ragged pixels and output channels (the heads' M = 255) are zero-filled
//   on the way in and masked at the store, which writes the accumulators
//   straight from the fragments (two float32 channels at a time where M is
//   even).
//
// The launch allocates nothing and the entry point returns
// cudaGetLastError(), so a refused launch is reported to the caller.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 2 (pixels) x 4 (channels)
constexpr int kMinBlocks = 3;   // blocks an SM must hold at once
constexpr int kBP = 64;         // output pixels per block
constexpr int kBM = 64;         // output channels per block
constexpr int kKC = 16;         // channels per K slab (32 bytes of bf16)
constexpr int kArow = 48;       // bf16 A row stride in shared memory
constexpr int kFrow = kKC * 4;  // f32 row of a slab in shared memory
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

struct ConvArgs {
  const float* x;           // [B][H][W][C]
  const uint16_t* w;        // [M][ks][ks][C] bf16 bits
  float* out;               // [B][OH][OW][M]
  int B, H, W, C, M, OH, OW, ks, stride, pad;
  int tile_h, tile_w;       // 0, 0: flat pixel tiles (1x1/s1/p0)
  int halo_h, halo_w, nhr;  // halo rows staged per slab
  int tiles_y, tiles_x;     // spatial tiles per image
  int slabs, stages, xvec, wvec, ovec;
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bf16_conv_kernel(const ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);          // halo row -> pixel or -1
  unsigned char* abuf = smem + a.tab_bytes;         // 2 x bf16 A rows
  unsigned char* wbuf = abuf + a.a_bytes;           // weight stages
  unsigned char* fbuf = wbuf + a.w_bytes;           // f32 halo stages

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wp = warp >> 2;          // pixel half of the tile
  const int wn = warp & 3;           // 16-channel quarter of the tile
  const int tile = static_cast<int>(blockIdx.x);
  const int m0 = blockIdx.y * kBM;
  const int taps = a.ks * a.ks;
  const int wstride = taps * 32 + 16;   // bytes per output channel's row
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

  // a slab's weights: [kBM][taps][16 channels], 16-byte copies of 8
  // channels, or single elements where C % 8 != 0
  auto load_w = [&](int slab, int slot) {
    unsigned char* dst0 = wbuf + slot * kBM * wstride;
    if (a.wvec) {
      const int per_n = taps * 2;
      for (int e = tid; e < kBM * per_n; e += kThreads) {
        const int n = e / per_n;
        const int r = e - n * per_n;
        const int t = r >> 1;
        const int cb = (r & 1) * 8;
        const int c = slab * kKC + cb;
        const bool valid = m0 + n < a.M && c < a.C;
        const uint16_t* src =
            valid ? a.w + (static_cast<size_t>(m0 + n) * taps + t) * a.C + c
                  : a.w;
        i8mma::cp_async16(i8mma::smem_addr(dst0 + n * wstride + t * 32 + cb * 2),
                          src, valid);
      }
    } else {
      const int per_n = taps * kKC;
      for (int e = tid; e < kBM * per_n; e += kThreads) {
        const int n = e / per_n;
        const int r = e - n * per_n;
        const int t = r / kKC;
        const int cc = r - t * kKC;
        const int c = slab * kKC + cc;
        uint16_t v = 0;
        if (m0 + n < a.M && c < a.C)
          v = a.w[(static_cast<size_t>(m0 + n) * taps + t) * a.C + c];
        *reinterpret_cast<uint16_t*>(dst0 + n * wstride + t * 32 + cc * 2) = v;
      }
    }
  };
  // a slab's f32 halo, chunk e = (row e / 4, channels 4 (e % 4)..+3):
  // always copied, and later rounded, by thread e % kThreads
  auto load_f = [&](int slab, int stage) {
    unsigned char* dst0 = fbuf + stage * a.nhr * kFrow;
    for (int e = tid; e < a.nhr * 4; e += kThreads) {
      const int pix = tab[e >> 2];
      const int c = slab * kKC + ((e & 3) << 2);
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
    for (int e = tid; e < a.nhr * 4; e += kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(
          fbuf + stage * a.nhr * kFrow + e * 16);
      *reinterpret_cast<uint2*>(dst + (e >> 2) * kArow + ((e & 3) << 3)) =
          make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
    }
  };

  const int n_slabs = a.slabs;
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
  for (int d = 0; d < ahead && d < n_slabs; ++d) load_w(d, d);
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
    if (d < n_slabs) load_f(d, d);
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
      load_w(nx, nx % stages);
      load_f(nx, nx % stages);
    }
    i8mma::cp_async_commit();

    const uint32_t a_base =
        i8mma::smem_addr(abuf + (i & 1) * a.nhr * kArow) + a_lane;
    const uint32_t b_base =
        i8mma::smem_addr(wbuf + (i % stages) * kBM * wstride) + b_lane;
    int ky = 0, kx = 0;
    for (int t = 0; t < taps; ++t) {
      const int toff = flat ? 0 : ky * a.halo_w + kx;
      uint32_t af[2][4], bf[4];
      i8mma::ldmatrix_x4(af[0], a_base + (hb[0] + toff) * kArow);
      i8mma::ldmatrix_x4(af[1], a_base + (hb[1] + toff) * kArow);
      i8mma::ldmatrix_x4(bf, b_base + t * 32);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 2; ++nj)
          mma_bf16(acc[mi][nj], af[mi], bf[2 * nj], bf[2 * nj + 1]);
      if (++kx == a.ks) { kx = 0; ++ky; }
    }
    if (i + 1 < n_slabs) {
      cp_async_wait_upto(ahead - 1);   // this thread's copies of slab i+1
      round_own((i + 1) % stages, (i + 1) & 1);
    }
  }
  i8mma::cp_async_wait<0>();

  // ---- store: rows gid / gid + 8 of each m16 tile, channel pairs ----
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wp * 32 + 16 * mi + gid + 8 * h;
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
      float* dst = a.out + static_cast<size_t>(gp) * a.M;
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = m0 + wn * 16 + 8 * nj + 2 * tig;
        const float v0 = acc[mi][nj][2 * h];
        const float v1 = acc[mi][nj][2 * h + 1];
        if (a.ovec && n + 1 < a.M) {
          *reinterpret_cast<float2*>(dst + n) = make_float2(v0, v1);
        } else {
          if (n < a.M) dst[n] = v0;
          if (n + 1 < a.M) dst[n + 1] = v1;
        }
      }
    }
}

std::atomic<bool> g_configured[kMaxDevices];

cudaError_t configure(int device) {
  if (device >= 0 && device < kMaxDevices && g_configured[device].load())
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      bf16_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_configured[device].store(true);
  return err;
}

}  // namespace

// Launches one convolution on `stream` of CUDA device `device`. Pointers are
// device pointers to contiguous tensors: x [B,H,W,C] float32 (4-byte
// aligned), w [M,ks,ks,C] bfloat16 (2-byte aligned), out [B,OH,OW,M]
// float32 (4-byte aligned). The plan comes from ops/bf16_conv.plan_launch:
// tile_h x tile_w output tiles (0 x 0: flat 64-pixel tiles, for 1x1/s1/p0
// only) and `stages` ring stages (2-4). Requires B*H*W, B*OH*OW < 2^31.
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for arguments or a plan the kernel does not take.
extern "C" int bf16_conv_nhwc(const void* x, const void* w, void* out, int B,
                              int H, int W, int C, int M, int OH, int OW,
                              int ks, int stride, int pad, int tile_h,
                              int tile_w, int stages, int device,
                              void* stream) {
  const bool flat = tile_h == 0 && tile_w == 0;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (B < 0 || H < 1 || W < 1 || C < 1 || M < 0 || OH < 0 || OW < 0 ||
      ks < 1 || stride < 1 || pad < 0 || stages < 2 || stages > kMaxStages ||
      (flat && (ks != 1 || stride != 1 || pad != 0)) ||
      (!flat && (tile_h < 1 || tile_w < 1 || tile_h * tile_w > kBP)) ||
      xa % 4 || wa % 2 || oa % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  ConvArgs a = {};
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const uint16_t*>(w);
  a.out = static_cast<float*>(out);
  a.B = B; a.H = H; a.W = W; a.C = C; a.M = M; a.OH = OH; a.OW = OW;
  a.ks = ks; a.stride = stride; a.pad = pad;
  a.tile_h = flat ? 0 : tile_h;
  a.tile_w = flat ? 0 : tile_w;
  a.halo_h = flat ? 1 : (tile_h - 1) * stride + ks;
  a.halo_w = flat ? kBP : (tile_w - 1) * stride + ks;
  a.nhr = a.halo_h * a.halo_w;
  a.tiles_y = flat ? 0 : (OH + tile_h - 1) / tile_h;
  a.tiles_x = flat ? 0 : (OW + tile_w - 1) / tile_w;
  a.slabs = (C + kKC - 1) / kKC;
  a.stages = stages;
  a.xvec = C % 4 == 0 && xa % 16 == 0;
  a.wvec = C % 8 == 0 && wa % 16 == 0;
  a.ovec = M % 2 == 0 && oa % 8 == 0;
  const long long tiles =
      flat ? (P + kBP - 1) / kBP
           : static_cast<long long>(B) * a.tiles_y * a.tiles_x;
  const int wstride = ks * ks * 32 + 16;
  a.tab_bytes = (a.nhr * 4 + 15) / 16 * 16;
  a.a_bytes = 2 * a.nhr * kArow;
  a.w_bytes = stages * kBM * wstride;
  const long long smem = static_cast<long long>(a.tab_bytes) + a.a_bytes +
                         a.w_bytes +
                         static_cast<long long>(stages) * a.nhr * kFrow;
  if (smem > kMaxSmem || tiles > 0x7fffffffLL ||
      (M + kBM - 1) / kBM > 65535 ||
      static_cast<long long>(B) * H * W >= 0x7fffffffLL ||
      P >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((M + kBM - 1) / kBM), 1);
  bf16_conv_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
