// Shared by the two XNOR bit kernels (xnor_gemm.cu, xnor_gemm_mxu.cu): the
// output tiling, the implicit-GEMM gather of bit words into shared memory,
// and the epilogue.
//
// Operands: x is a packed NHWC map [B][H][W][C32] of int32 words (bit b of
// word j = channel 32*j + b, set iff the activation is > 0); w is
// [M][ks][ks][C32] (tap-major). The reduction runs over the kwords =
// ks*ks*C32 words of one output pixel's window, in the weights' (tap, word)
// order. Taps outside the image read as 0 words: -1 activations, the
// reference's bit-path border.

#pragma once

#include <cstdint>

namespace xnor {

constexpr int kTileP = 32;   // output pixels per block
constexpr int kTileM = 32;   // filters per block
constexpr int kStepW = 32;   // K words staged in shared memory per step
constexpr int kSplit = 4;    // K-split groups: group g reduces words g, g+4, ..
constexpr int kPad = 4;      // row padding (words), keeps 16-byte rows

static_assert(kTileP == kTileM, "one loader row serves both operands");
static_assert(kStepW % kSplit == 0, "each group takes whole words");

// y = dot * mean + bias with two roundings (explicit intrinsics, so nvcc
// cannot contract an FMA), then leaky y > 0 ? y : 0.1 * y (the XNOR path's
// slope, not the int8 path's y / 10).
__device__ __forceinline__ float epilogue(int dot, float mean, float bias,
                                          int leaky) {
  float y = __fadd_rn(__fmul_rn(static_cast<float>(dot), mean), bias);
  if (leaky && !(y > 0.0f)) y = __fmul_rn(0.1f, y);
  return y;
}

// Each thread of a kThreads block loads word `lw` of a step for tile rows
// lr, lr + kRows, ...: the activation word of output pixel p0 + row and the
// weight word of filter m0 + row. fetch() reads a step from device memory
// into registers and store() writes it to shared memory, so a kernel can
// keep the next step's loads in flight while it reduces the current one.
template <int kThreads>
struct StepLoader {
  static constexpr int kRows = kThreads / kStepW;
  static constexpr int kPasses = kTileP / kRows;
  static_assert(kThreads % kStepW == 0 && kTileP % kRows == 0,
                "the block loads whole steps");

  int lw, lr;
  int img[kPasses], iy0[kPasses], ix0[kPasses];
  bool pix_ok[kPasses];
  uint32_t av[kPasses], bv[kPasses];   // the fetched step

  __device__ StepLoader(int tid, int p0, int P, int OH, int OW, int stride,
                        int pad)
      : lw(tid % kStepW), lr(tid / kStepW) {
#pragma unroll
    for (int r = 0; r < kPasses; ++r) {
      const int p = p0 + lr + kRows * r;
      pix_ok[r] = p < P;
      const int pp = pix_ok[r] ? p : 0;
      img[r] = pp / (OH * OW);
      const int rem = pp - img[r] * OH * OW;
      const int oy = rem / OW;
      iy0[r] = oy * stride - pad;
      ix0[r] = (rem - oy * OW) * stride - pad;
    }
  }

  __device__ void fetch(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ w, int k0, int kwords,
                        int H, int W, int C32, int ks, int m0, int M) {
    const int kw = k0 + lw;
    const bool k_ok = kw < kwords;
    int ky = 0, kx = 0, cword = 0;
    if (k_ok) {
      const int tap = kw / C32;
      cword = kw - tap * C32;
      ky = tap / ks;
      kx = tap - ky * ks;
    }
#pragma unroll
    for (int r = 0; r < kPasses; ++r) {
      const int iy = iy0[r] + ky;
      const int ix = ix0[r] + kx;
      av[r] = 0;
      if (k_ok && pix_ok[r] && iy >= 0 && iy < H && ix >= 0 && ix < W)
        av[r] = x[((static_cast<size_t>(img[r]) * H + iy) * W + ix) * C32 +
                  cword];
      const int m = m0 + lr + kRows * r;
      bv[r] = (k_ok && m < M) ? w[static_cast<size_t>(m) * kwords + kw] : 0u;
    }
  }

  __device__ void store(uint32_t (*a)[kTileP + kPad],
                        uint32_t (*b)[kTileM + kPad]) const {
#pragma unroll
    for (int r = 0; r < kPasses; ++r) {
      a[lw][lr + kRows * r] = av[r];
      b[lw][lr + kRows * r] = bv[r];
    }
  }
};

// Sums the kSplit groups' partial dots of the block's tile (red[g][row][col])
// and writes the epilogue, dot = scale * sum - corr.
template <int kThreads>
__device__ void reduce_store(const int (*red)[kTileP][kTileM + 1],
                             const float* __restrict__ mean,
                             const float* __restrict__ bias,
                             float* __restrict__ out, int p0, int m0, int P,
                             int M, int scale, int corr, int leaky) {
  for (int o = threadIdx.x; o < kTileP * kTileM; o += kThreads) {
    const int r = o / kTileM;
    const int c = o - r * kTileM;
    const int p = p0 + r;
    const int m = m0 + c;
    if (p >= P || m >= M) continue;
    int sum = 0;
#pragma unroll
    for (int g = 0; g < kSplit; ++g) sum += red[g][r][c];
    out[static_cast<size_t>(p) * M + m] =
        epilogue(scale * sum - corr, mean[m], bias[m], leaky);
  }
}

}  // namespace xnor
