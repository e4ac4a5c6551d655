// INT8 implicit-GEMM convolution with the reference's int8-"cpu" epilogue.
//
// Replaces the Pallas kernels yolo2_light_tpu/ops/pallas_int8.py
// conv3x3_int8_fused (v1) and conv3x3_int8_tiled (v2), and extends them to
// every int8-eligible conv of a darknet net: size 1 or 3, stride 1 or 2, any
// pad. Both Pallas kernels compute the same function:
//
//   acc = sum_{ky,kx,c} x[b, oy*s-pad+ky, ox*s-pad+kx, c] * w[m, ky, kx, c]
//         (int8 x int8, int32 accumulation, zero padding)
//   q   = clamp(trunc_div(acc, 2^shift), +-32767)     (int16 store in the C)
//   y   = q * alpha + bias[m]                         (two roundings, no FMA)
//   y   = y > 0 ? y : y / 10                          (leaky, IEEE division)
//
// Layouts: x NHWC int8, w [M][ks][ks][C] int8 (laid out once at load time so
// the reduction runs along contiguous channels), out NHWC float32.
//
// What bounds it on an H100: at yolov3-416's shapes (b=1) every conv does
// 100-500 int8 ops per byte of device memory it touches, so the limit is the
// arithmetic throughput of __dp4a on the CUDA cores (4 MACs per instruction),
// not HBM; the 13x13 1x1 convs also launch too few blocks to fill 132 SMs.
// What the design does about it: each 256-thread block owns a 64-pixel x
// 64-channel output tile and streams the K = ks*ks*C reduction through shared
// memory 32 bytes at a time, so each loaded byte feeds 64 multiply-adds; every
// thread keeps a 4x4 register tile of int32 accumulators that never leaves
// registers, reads its operands as 16-byte shared-memory vectors, and runs the
// whole epilogue in registers, so device memory sees one read of each operand
// tile and one f32 write of the output. Tensor-core MMA (wgmma) and TMA
// pipelining are the next steps.
//
// Traps handled here: the epilogue (int8_epilogue.cuh) uses
// __fmul_rn/__fadd_rn/__fdiv_rn so nvcc cannot contract q*alpha+bias into an
// FMA (one rounding instead of two would move y by up to 1 ULP and can flip
// the next layer's quantization bin); C must be a multiple of 4 (one 32-bit
// word = 4 channels of one tap), which the Python wrapper checks; the launch
// allocates nothing and the entry point returns cudaGetLastError() so a
// refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;    // output pixels per block
constexpr int kTileM = 64;    // output channels per block
constexpr int kStepW = 8;     // K words (4 int8 each) per shared-memory step
constexpr int kPad = 4;       // row padding (words): conflict-free tile stores

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int B, int H, int W, int C, int M, int OH, int OW, int ks,
                 int stride, int pad, float alpha, int shift, int leaky) {
  __shared__ __align__(16) int32_t a_tile[kStepW][kTileP + kPad];
  __shared__ __align__(16) int32_t b_tile[kStepW][kTileM + kPad];

  const int tid = threadIdx.x;
  const int P = B * OH * OW;
  const int cw = C >> 2;             // words per pixel
  const int kwords = ks * ks * cw;   // words per output channel (K / 4)
  const int p0 = blockIdx.x * kTileP;
  const int m0 = blockIdx.y * kTileM;

  // Loader role: word `lw` of the step for tile rows `lr` and `lr + 32`.
  const int lw = tid % kStepW;
  const int lr = tid / kStepW;
  int img[2], iy0[2], ix0[2];
  bool pix_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = p0 + lr + 32 * r;
    pix_ok[r] = p < P;
    const int pp = pix_ok[r] ? p : 0;
    const int ohw = OH * OW;
    img[r] = pp / ohw;
    const int rem = pp - img[r] * ohw;
    const int oy = rem / OW;
    iy0[r] = oy * stride - pad;
    ix0[r] = (rem - oy * OW) * stride - pad;
  }

  // Compute role: pixels ty*4 .. +3, channels tx*4 .. +3 of the tile.
  const int tx = tid % 16;
  const int ty = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kwords; k0 += kStepW) {
    const int kw = k0 + lw;
    const bool k_ok = kw < kwords;
    int ky = 0, kx = 0, cword = 0;
    if (k_ok) {
      const int tap = kw / cw;
      cword = kw - tap * cw;
      ky = tap / ks;
      kx = tap - ky * ks;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int v = 0;
      const int iy = iy0[r] + ky;
      const int ix = ix0[r] + kx;
      if (k_ok && pix_ok[r] && iy >= 0 && iy < H && ix >= 0 && ix < W)
        v = x[((static_cast<size_t>(img[r]) * H + iy) * W + ix) * cw + cword];
      a_tile[lw][lr + 32 * r] = v;
      const int m = m0 + lr + 32 * r;
      b_tile[lw][lr + 32 * r] =
          (k_ok && m < M) ? w[static_cast<size_t>(m) * kwords + kw] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStepW; ++kk) {
      const int4 a = *reinterpret_cast<const int4*>(&a_tile[kk][ty * 4]);
      const int4 b = *reinterpret_cast<const int4*>(&b_tile[kk][tx * 4]);
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tx * 4 + j;
      if (m >= M) continue;
      out[static_cast<size_t>(p) * M + m] =
          requant_epilogue(acc[i][j], shift, alpha, bias[m], leaky);
    }
  }
}

}  // namespace

// Launches one convolution on `stream` of CUDA device `device`. Pointers are
// device pointers to contiguous tensors: x [B,H,W,C] int8, w [M,ks,ks,C]
// int8, bias [M] f32, out [B,OH,OW,M] f32. Requires C % 4 == 0, 4-byte-aligned
// x and w, and B*OH*OW < 2^31.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int int8_conv_nhwc(const void* x, const void* w, const void* bias,
                              void* out, int B, int H, int W, int C, int M,
                              int OH, int OW, int ks, int stride, int pad,
                              float alpha, int shift, int leaky, int device,
                              void* stream) {
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((M + kTileM - 1) / kTileM));
  int8_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, M,
      OH, OW, ks, stride, pad, alpha, shift, leaky);
  return static_cast<int>(cudaGetLastError());
}
