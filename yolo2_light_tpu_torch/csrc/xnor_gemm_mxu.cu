// XNOR (BIT1) convolution on the int8 tensor cores: bit-packed operands
// unpacked to +-1 int8 in registers and contracted with mma.sync.
//
// Replaces the Pallas kernel yolo2_light_tpu/ops/pallas_xnor.py
// xnor_gemm_mxu (_xnor_mxu_kernel, _unpack_pm1, _auto_tiles), the
// -xnor_kernel pallas_mxu engine, and its patch gather:
//
//   dot = sum_{k < kwords*32} pm1(x_bit[p, k]) * pm1(w_bit[m, k])   (s32)
//   y   = (dot - pad_bits) * mean[m] + bias[m]       (two roundings, no FMA)
//   y   = y > 0 ? y : 0.1f * y                       (leaky; linear skips it)
//
// pm1(bit) = 2*bit - 1. The channel-pad bits are 0 in both operands, so each
// adds (-1)*(-1) = +1 and pad_bits = ks*ks*(C32*32 - C) removes them; the
// result equals the popcount kernel's bit for bit. Layouts in
// xnor_common.cuh. The weights stay bit-packed in device memory (1/8 of the
// int8 bytes) and are unpacked once per use in registers, where the TPU
// kernel unpacks a weight tile into VMEM once per filter tile.
//
// One 32-bit word holds exactly the k = 32 of an m16n8k32 int8 MMA, so a
// thread takes its fragment's four channels straight from the word: for A
// (row-major 16x32, pixels x channels) bits 4*tig .. +3 and 16 + 4*tig .. +3
// of the words of pixels gid and gid + 8; for B (col-major 32x8) the same
// bits of the word of filter gid (gid = lane / 4, tig = lane % 4, PTX ISA
// fragment layouts of mma.m16n8k32 .s8). Four bits become four +-1 bytes
// with one multiply-and-mask spread.
//
// What bounds it on an H100: the integer unpack (five ALU instructions per
// four channels of each operand, at half the float issue rate) and, at
// tiny-yolo-obj_xnor's 13x13 convs, too few output tiles to fill 132 SMs
// evenly; the tensor cores and device memory are far from busy. What the
// design does about it: each bit word is unpacked once per block, 32x32
// output tiles, and a 4-way split of K inside the block (each warp the whole
// tile over every fourth word, 2x4 MMA tiles, summed through shared memory),
// so the 13x13 convs launch 192 blocks of 4 warps; each 32-word step's
// successor is fetched into registers while it is reduced. A cheaper unpack
// (larger tiles, or binary MMA), wgmma and TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "xnor_common.cuh"

namespace {

using namespace xnor;

constexpr int kThreads = 32 * kSplit;   // one warp per K-split group

// Bits 0..3 of n -> four bytes of +-1 (bit i in byte i: 0x01 if set, else
// 0xff): the multiply moves bit i to bit 8*i (no two partial products
// overlap), the mask keeps those bits, and ~(t * 0xfe) maps each 0/1 byte to
// 0xff/0x01.
__device__ __forceinline__ uint32_t pm1_bytes(uint32_t n) {
  const uint32_t t = ((n & 0xfu) * 0x00204081u) & 0x01010101u;
  return ~(t * 0xfeu);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
xnor_mma_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                const float* __restrict__ mean, const float* __restrict__ bias,
                float* __restrict__ out, int B, int H, int W, int C32, int M,
                int OH, int OW, int ks, int stride, int pad, int pad_bits,
                int leaky) {
  __shared__ __align__(16) uint32_t a_tile[kStepW][kTileP + kPad];
  __shared__ __align__(16) uint32_t b_tile[kStepW][kTileM + kPad];
  __shared__ int red[kSplit][kTileP][kTileM + 1];

  const int tid = threadIdx.x;
  const int P = B * OH * OW;
  const int kwords = ks * ks * C32;
  const int p0 = blockIdx.x * kTileP;
  const int m0 = blockIdx.y * kTileM;
  StepLoader<kThreads> loader(tid, p0, P, OH, OW, stride, pad);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int sh = 4 * (lane % 4);
  constexpr int kMt = kTileP / 16;   // m16 tiles (pixels)
  constexpr int kNt = kTileM / 8;    // n8 tiles (filters)
  int acc[kMt][kNt][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  loader.fetch(x, w, 0, kwords, H, W, C32, ks, m0, M);
  for (int k0 = 0; k0 < kwords; k0 += kStepW) {
    loader.store(a_tile, b_tile);
    __syncthreads();
    if (k0 + kStepW < kwords)   // the next step's loads fly during this one
      loader.fetch(x, w, k0 + kStepW, kwords, H, W, C32, ks, m0, M);
#pragma unroll
    for (int s = 0; s < kStepW / kSplit; ++s) {
      const int kk = warp + kSplit * s;
      if (k0 + kk >= kwords) continue;   // uniform over the warp
      uint32_t a[kMt][4], b[kNt][2];
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
        const uint32_t lo = a_tile[kk][16 * i + gid];
        const uint32_t hi = a_tile[kk][16 * i + gid + 8];
        a[i][0] = pm1_bytes(lo >> sh);
        a[i][1] = pm1_bytes(hi >> sh);
        a[i][2] = pm1_bytes(lo >> (16 + sh));
        a[i][3] = pm1_bytes(hi >> (16 + sh));
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const uint32_t v = b_tile[kk][8 * j + gid];
        b[j][0] = pm1_bytes(v >> sh);
        b[j][1] = pm1_bytes(v >> (16 + sh));
      }
#pragma unroll
      for (int i = 0; i < kMt; ++i)
#pragma unroll
        for (int j = 0; j < kNt; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  // C fragment: c0, c1 at row gid, columns 2*(lane%4) + 0/1; c2, c3 at
  // row gid + 8.
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const int r = 16 * i + gid;
      const int c = 8 * j + 2 * (lane % 4);
      red[warp][r][c] = acc[i][j][0];
      red[warp][r][c + 1] = acc[i][j][1];
      red[warp][r + 8][c] = acc[i][j][2];
      red[warp][r + 8][c + 1] = acc[i][j][3];
    }
  __syncthreads();
  reduce_store<kThreads>(red, mean, bias, out, p0, m0, P, M, 1, pad_bits,
                         leaky);
}

}  // namespace

// Launches one XNOR convolution on `stream` of CUDA device `device`.
// Pointers are device pointers to contiguous tensors: x [B,H,W,C32] int32,
// w [M,ks,ks,C32] int32, mean and bias [M] f32, out [B,OH,OW,M] f32.
// Requires B*OH*OW < 2^31. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int xnor_gemm_mxu_nhwc(const void* x, const void* w,
                                  const void* mean, const void* bias,
                                  void* out, int B, int H, int W, int C32,
                                  int M, int OH, int OW, int ks, int stride,
                                  int pad, int pad_bits, int leaky, int device,
                                  void* stream) {
  const long long P = static_cast<long long>(B) * OH * OW;
  if (P == 0 || M == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((M + kTileM - 1) / kTileM));
  xnor_mma_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<const float*>(mean), static_cast<const float*>(bias),
      static_cast<float*>(out), B, H, W, C32, M, OH, OW, ks, stride, pad,
      pad_bits, leaky);
  return static_cast<int>(cudaGetLastError());
}
