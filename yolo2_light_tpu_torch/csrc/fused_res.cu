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
// strips with a 1-row halo), which compute this function; a K-block stage is
// K launches of this kernel.
//
// Layouts: x, out NHWC float32 [B,H,W,C]; w1 [C2][C] int8 and w2 [C][3][3][C2]
// int8 (the [M,kh,kw,Cin] layout params.layer_to_torch gives every int8 conv);
// b1 [C2], b2 [C] float32.
//
// What bounds it on an H100: like int8_conv.cu, the __dp4a issue rate on the
// CUDA cores (yolov3's blocks do 100-600 int8 ops per byte of device memory
// they must touch), and at the 13x13 and 26x26 stages, filling 132 SMs. A
// 104x104x128 f32 trunk is 5.5 MB, far beyond one SM's 227 KB of shared
// memory, so the TPU kernel's whole-image residency does not carry over; its
// strips idea is taken down to tiles. What the design does:
//
// * Each cluster of CS thread blocks (CS = ceil(C / 64), at most 16: above 8
//   a non-portable cluster size, which Hopper takes) owns an 8x8 tile of
//   output pixels of one image. Block r of the cluster computes its share of
//   the C2 t1 channels over the tile and its 1-pixel halo, quantizes them at
//   m2 and keeps them in shared memory; the blocks then copy each other's
//   shares through distributed shared memory, so every block holds the whole
//   int8 t1q halo tile (10*10*C2 bytes: at most 51 KB on yolov3). Block r
//   then computes its share of the C output channels. yolov3-416's stages
//   launch 676, 338, 196, 128 and 64 blocks. At the 13x13 stage, clusters of
//   at most 8 (on 4x4 tiles, 128 blocks of twice the channels) took 0.232 ms
//   against 0.159 ms (NVIDIA H100 80GB HBM3, 700 W).
// * The 1x1 conv is thus computed once per tile; what is recomputed is the
//   halo ring, which neighbouring tiles also compute: (10*10)/(8*8) = 1.56x
//   of the 1x1's work. The 1x1 does 1/9 of the 3x3's multiply-adds, so the
//   block does 5.6% more than the unfused pair, before tile padding at the
//   image edge (13x13 pads to 16x16).
// * Both convs are int8 GEMMs on __dp4a with int32 accumulators in registers;
//   the weights stream through shared memory 32 bytes of K at a time, as in
//   int8_conv.cu. The 1x1 quantizes the f32 trunk while loading it; the 3x3
//   reads its operand straight from the t1q tile (row stride padded to an odd
//   word count, so a warp's pixel rows fall in different banks).
// * Device memory sees the f32 trunk read (tile plus halo) and the f32 output
//   written once, plus the weights; t1 never leaves the SM. Unfused, a block
//   moves about 27 bytes per trunk element (two quantize passes, two conv
//   outputs, the shortcut add); fused, about 8.
//
// Traps handled here: the halo mask (a halo pixel outside the image gets
// t1 = 0, not leaky10(b1), before it is quantized: the 3x3 pads t1q with
// zeros); every float step is an explicitly rounded intrinsic
// (int8_epilogue.cuh) and the residual add is __fadd_rn, so no FMA
// contraction can move t1 by 1 ULP and flip a t1q bin; out of place (the
// tiles read each other's halo trunk pixels, so in-place would race);
// C % 4 == 0 and C2 % 4 == 0 and x 16-byte aligned (one word = 4 channels);
// the entry point returns cudaGetLastError() so a refused launch is reported.
// Tensor cores (wgmma), TMA and a stage-level persistent schedule are later
// steps.

#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_epilogue.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStepW = 8;      // K words (4 int8 each) per shared-memory step
constexpr int kPad = 4;        // row padding (words) of the staged tiles
constexpr int kN1 = 32;        // t1 channels per phase-1 chunk
constexpr int kMC = 64;        // output channels per phase-2 chunk
constexpr int kMaxCluster = 16; // non-portable above 8; H100 takes 16
constexpr int kMaxC2 = 2048;    // largest t1 width the dynamic tile is sized for
constexpr int kMaxDevices = 64;

constexpr int kTH = 8;                      // output tile rows
constexpr int kTW = 8;                      // output tile columns
constexpr int kHW = kTW + 2;                // halo tile width
constexpr int kNH = (kTH + 2) * kHW;        // halo pixels
constexpr int kNHP = (kNH + 31) / 32 * 32;  // padded to 32 thread rows
constexpr int kR1 = kNHP / 32;              // halo pixels per thread (1x1)
constexpr int kRP = kTH * kTW / 16;         // output pixels per thread (3x3)

__global__ void __launch_bounds__(kThreads)
fused_res_kernel(const float* __restrict__ x, const int32_t* __restrict__ w1,
                 const float* __restrict__ b1, const int32_t* __restrict__ w2,
                 const float* __restrict__ b2, float* __restrict__ out, int H,
                 int W, int C, int C2, float m1, float alpha1, float m2,
                 float alpha2, int shift) {
  __shared__ __align__(16) int32_t a_tile[kStepW][kNHP + kPad];
  __shared__ __align__(16) int32_t b1_tile[kStepW][kN1 + kPad];
  __shared__ __align__(16) int32_t b2_tile[kStepW][kMC + kPad];
  extern __shared__ __align__(16) int32_t t1q[];   // [NH][rs] words

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cw = C >> 2;          // trunk words per pixel
  const int c2w = C2 >> 2;        // t1 words per pixel
  const int rs = c2w | 1;         // t1q row stride (odd: no bank conflicts)
  const int img = blockIdx.z;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int y0 = (blockIdx.y / tiles_x) * kTH;
  const int x0 = (blockIdx.y % tiles_x) * kTW;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  // ---- phase 1: t1q over the tile and its halo, this block's t1 words ----
  const int s1 = (c2w + CS - 1) / CS;
  const int t_lo = min(c2w, rank * s1);
  const int t_hi = min(c2w, t_lo + s1);
  // loader role: word lw of a step, halo pixels lr + 32 * r
  const int lw = tid % kStepW;
  const int lr = tid / kStepW;
  long long src[kR1];   // float4 offset of the pixel's row, -1 outside
#pragma unroll
  for (int r = 0; r < kR1; ++r) {
    const int hp = lr + 32 * r;
    const int iy = y0 - 1 + hp / kHW;
    const int ix = x0 - 1 + hp % kHW;
    src[r] = (hp < kNH && iy >= 0 && iy < H && ix >= 0 && ix < W)
                 ? ((static_cast<long long>(img) * H + iy) * W + ix) * cw
                 : -1;
  }
  // compute role: channels tx1*4 .. +3 of a chunk, halo pixels ty1*R1 .. +R1-1
  const int tx1 = tid % (kN1 / 4);
  const int ty1 = tid / (kN1 / 4);
  for (int n0 = t_lo; n0 < t_hi; n0 += kN1 / 4) {
    int acc[kR1][4];
#pragma unroll
    for (int i = 0; i < kR1; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0 = 0; k0 < cw; k0 += kStepW) {
      const int kw = k0 + lw;
#pragma unroll
      for (int r = 0; r < kR1; ++r)
        a_tile[lw][lr + 32 * r] =
            (kw < cw && src[r] >= 0) ? quantize_pack4(x4[src[r] + kw], m1) : 0;
      const int nw = n0 + lr / 4;   // t1 word of the channel row this thread loads
      b1_tile[lw][lr] =
          (kw < cw && nw < t_hi) ? w1[static_cast<size_t>(n0 * 4 + lr) * cw + kw]
                                 : 0;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStepW; ++kk) {
        const int4 b = *reinterpret_cast<const int4*>(&b1_tile[kk][tx1 * 4]);
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kR1; ++i) {
          const int a = a_tile[kk][ty1 * kR1 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, bv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
    const int wq = n0 + tx1;
    if (wq < t_hi) {
#pragma unroll
      for (int i = 0; i < kR1; ++i) {
        const int hp = ty1 * kR1 + i;
        if (hp >= kNH) continue;
        const int iy = y0 - 1 + hp / kHW;
        const int ix = x0 - 1 + hp % kHW;
        uint32_t word = 0;   // t1 = 0 outside the image: quantizes to 0
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float t = requant_epilogue(acc[i][j], shift, alpha1,
                                             b1[wq * 4 + j], true);
            word |= static_cast<uint32_t>(quantize_i8(t, m2) & 0xff) << (8 * j);
          }
        }
        t1q[hp * rs + wq] = static_cast<int32_t>(word);
      }
    }
  }

  // ---- exchange: every block gathers the other blocks' t1 words ----
  cluster.sync();
  for (int r = 0; r < CS; ++r) {
    if (r == rank) continue;
    const int lo = min(c2w, r * s1);
    const int n = min(c2w, lo + s1) - lo;
    if (n <= 0) continue;
    const int32_t* remote = cluster.map_shared_rank(t1q, r);
    for (int e = tid; e < kNH * n; e += kThreads) {
      const int at = (e / n) * rs + lo + e % n;
      t1q[at] = remote[at];
    }
  }
  // no block may leave (or read its own t1q) while another still copies
  cluster.sync();

  // ---- phase 2: 3x3 conv of t1q, epilogue, residual add ----
  const int s2 = (C + CS - 1) / CS;
  const int m_lo = min(C, rank * s2);
  const int m_hi = min(C, m_lo + s2);
  const int tx = tid % 16;
  const int ty = tid / 16;
  int hbase[kRP];   // halo index of each output pixel's (0, 0) tap
#pragma unroll
  for (int i = 0; i < kRP; ++i) {
    const int p = ty * kRP + i;
    hbase[i] = (p / kTW) * kHW + p % kTW;
  }
  for (int m0 = m_lo; m0 < m_hi; m0 += kMC) {
    int acc[kRP][4];
#pragma unroll
    for (int i = 0; i < kRP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * kHW + tap % 3;
      for (int c0 = 0; c0 < c2w; c0 += kStepW) {
        const int kw = c0 + lw;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + lr + 32 * r;
          b2_tile[lw][lr + 32 * r] =
              (kw < c2w && m < m_hi)
                  ? w2[(static_cast<size_t>(m) * 9 + tap) * c2w + kw]
                  : 0;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kStepW; ++kk) {
          // words past c2w meet zero weights; the t1q buffer has slack for them
          const int4 b = *reinterpret_cast<const int4*>(&b2_tile[kk][tx * 4]);
          const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < kRP; ++i) {
            const int a = t1q[(hbase[i] + toff) * rs + c0 + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, bv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int p = ty * kRP + i;
      const int oy = y0 + p / kTW;
      const int ox = x0 + p % kTW;
      if (oy >= H || ox >= W) continue;
      const size_t row = ((static_cast<size_t>(img) * H + oy) * W + ox) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + tx * 4 + j;
        if (m >= m_hi) continue;
        const float y =
            requant_epilogue(acc[i][j], shift, alpha2, b2[m], true);
        out[row + m] = __fadd_rn(x[row + m], y);
      }
    }
  }
}

// Dynamic shared memory of the t1q tile for C2 t1 channels: + kStepW words,
// because the 3x3 reads up to a step past the last row's words.
size_t t1q_bytes(int C2) {
  return (static_cast<size_t>(kNH) * ((C2 >> 2) | 1) + kStepW) * 4;
}

// The kernel's function attributes, set once per device (not per launch):
// room for the largest t1q tile, and clusters above 8 blocks.
std::atomic<bool> g_configured[kMaxDevices];

cudaError_t configure(int device) {
  if (device >= 0 && device < kMaxDevices && g_configured[device].load())
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_res_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(t1q_bytes(kMaxC2)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fused_res_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    g_configured[device].store(true);
  return err;
}

cudaError_t launch(const float* x, const int32_t* w1, const float* b1,
                   const int32_t* w2, const float* b2, float* out, int B,
                   int H, int W, int C, int C2, float m1, float alpha1,
                   float m2, float alpha2, int shift, int cs,
                   cudaStream_t stream) {
  const size_t smem = t1q_bytes(C2);
  const unsigned tiles = static_cast<unsigned>(((H + kTH - 1) / kTH) *
                                               ((W + kTW - 1) / kTW));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs), tiles,
                     static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err =
      cudaLaunchKernelEx(&cfg, fused_res_kernel, x, w1, b1, w2, b2, out, H, W,
                         C, C2, m1, alpha1, m2, alpha2, shift);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Launches one residual block on `stream` of CUDA device `device`. Pointers
// are device pointers to contiguous tensors: x and out [B,H,W,C] f32 (x
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
  if (C % 4 || C2 % 4 || C2 == 0 || C2 > kMaxC2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int cs = std::min(kMaxCluster, (C + kMC - 1) / kMC);
  const long long tiles = static_cast<long long>((H + kTH - 1) / kTH) *
                          ((W + kTW - 1) / kTW);
  if (B > 65535 || tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(
      static_cast<const float*>(x), static_cast<const int32_t*>(w1),
      static_cast<const float*>(b1), static_cast<const int32_t*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, H, W, C, C2,
      m1, alpha1, m2, alpha2, shift, cs, static_cast<cudaStream_t>(stream)));
}
