// XNOR (BIT1) convolution by xnor + popcount on bit-packed operands.
//
// Replaces the Pallas kernel yolo2_light_tpu/ops/pallas_xnor.py xnor_gemm
// (_xnor_kernel), the -xnor_kernel pallas engine, and its patch gather:
//
//   cnt = sum_{k < kwords} popc(~(x_word[p, k] ^ w_word[m, k]))
//   y   = (2 * cnt - adjust) * mean[m] + bias[m]     (two roundings, no FMA)
//   y   = y > 0 ? y : 0.1f * y                       (leaky; linear skips it)
//
// with adjust = 2 * ks*ks*C32*32 - ks*ks*C: the channel-pad bits are 0 in both
// operands, so they always match and are removed as a constant, and
// 2 * cnt - adjust is the +-1 dot over the real channels (the reference's
// gemm_nn_custom_bin_mean_transposed, src/additionally.c:1185-1242, and its
// CUDA popcount GEMM, src/gpu.cu:1566-1741). Layouts in xnor_common.cuh.
//
// What bounds it on an H100: the popcount issue rate. Each __popc covers 32
// binary multiply-adds, and an SM retires 16 a cycle; tiny-yolo-obj_xnor's
// 13x13 convs (M = 169 pixels, K up to 9*1024 bits) have too few output
// tiles to fill 132 SMs evenly, while device memory is far from busy (a
// 1024-filter conv reads 1.2 MB of packed weights). What the design does
// about it: an implicit GEMM that gathers its taps from the packed map (no
// patch matrix in device memory), 32x32 output tiles, and a 4-way split of K
// inside the block (four groups of 64 threads, each a 4x4 register tile over
// every fourth word, summed through shared memory at the end), so even the
// 13x13 convs launch 192 blocks of 8 warps. Each thread does 16 independent
// popcounts per pair of 16-byte shared-memory loads, and each 32-word step's
// successor is fetched into registers while it is reduced. Binary tensor
// cores (mma .b1) and a split of K across blocks are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "xnor_common.cuh"

namespace {

using namespace xnor;

constexpr int kGroupThreads = (kTileP / 4) * (kTileM / 4);   // 4x4 per thread
constexpr int kThreads = kGroupThreads * kSplit;             // 256

__global__ void __launch_bounds__(kThreads)
xnor_popcount_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ w,
                     const float* __restrict__ mean,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int B, int H, int W, int C32, int M, int OH, int OW,
                     int ks, int stride, int pad, int adjust, int leaky) {
  __shared__ __align__(16) uint32_t a_tile[kStepW][kTileP + kPad];
  __shared__ __align__(16) uint32_t b_tile[kStepW][kTileM + kPad];
  __shared__ int red[kSplit][kTileP][kTileM + 1];

  const int tid = threadIdx.x;
  const int P = B * OH * OW;
  const int kwords = ks * ks * C32;
  const int p0 = blockIdx.x * kTileP;
  const int m0 = blockIdx.y * kTileM;
  StepLoader<kThreads> loader(tid, p0, P, OH, OW, stride, pad);

  // Compute role: group g, pixels ty*4 .. +3, filters tx*4 .. +3.
  const int g = tid / kGroupThreads;
  const int t = tid % kGroupThreads;
  const int tx = t % (kTileM / 4);
  const int ty = t / (kTileM / 4);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  loader.fetch(x, w, 0, kwords, H, W, C32, ks, m0, M);
  for (int k0 = 0; k0 < kwords; k0 += kStepW) {
    loader.store(a_tile, b_tile);
    __syncthreads();
    if (k0 + kStepW < kwords)   // the next step's loads fly during this one
      loader.fetch(x, w, k0 + kStepW, kwords, H, W, C32, ks, m0, M);
#pragma unroll
    for (int s = 0; s < kStepW / kSplit; ++s) {
      const int kk = g + kSplit * s;
      if (k0 + kk >= kwords) continue;   // uniform over each group's warps
      const uint4 a = *reinterpret_cast<const uint4*>(&a_tile[kk][ty * 4]);
      const uint4 b = *reinterpret_cast<const uint4*>(&b_tile[kk][tx * 4]);
      const uint32_t av[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(~(av[i] ^ bv[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[g][ty * 4 + i][tx * 4 + j] = acc[i][j];
  __syncthreads();
  reduce_store<kThreads>(red, mean, bias, out, p0, m0, P, M, 2, adjust,
                         leaky);
}

}  // namespace

// Launches one XNOR convolution on `stream` of CUDA device `device`.
// Pointers are device pointers to contiguous tensors: x [B,H,W,C32] int32,
// w [M,ks,ks,C32] int32, mean and bias [M] f32, out [B,OH,OW,M] f32.
// Requires B*OH*OW < 2^31. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int xnor_gemm_nhwc(const void* x, const void* w, const void* mean,
                              const void* bias, void* out, int B, int H, int W,
                              int C32, int M, int OH, int OW, int ks,
                              int stride, int pad, int adjust, int leaky,
                              int device, void* stream) {
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((M + kTileM - 1) / kTileM));
  xnor_popcount_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(bias),
      static_cast<float*>(out), B, H, W, C32, M, OH, OW, ks, stride, pad,
      adjust, leaky);
  return static_cast<int>(cudaGetLastError());
}
