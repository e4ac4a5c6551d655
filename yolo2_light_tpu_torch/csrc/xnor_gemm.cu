// XNOR (BIT1) convolution by xnor + popcount on bit-packed operands, on the
// CUDA cores.
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
// CUDA popcount GEMM, src/gpu.cu:1566-1741). Layouts and the launch geometry
// in xnor_common.cuh. This engine stays on the CUDA cores, as the TPU kernel
// stays on the VPU; the binary tensor cores are the other engine's
// (xnor_gemm_mxu.cu), which is what -xnor_kernel chooses between.
//
// What bounds it on an H100: the popcount issue rate, 16 __popc an SM a
// clock (32 binary multiply-adds each): P*M*kwords / (132 * 16) cycles, 27
// us over tiny-yolo-obj_xnor-416's seven convs at 1.98 GHz; then, as for the
// other engine, a launch's fixed latencies (3.8-5.7 us with no copies and
// no popcounts, scripts/trace_xnor_gemm.py). What the design does: each
// thread holds an 8x4 register tile (pixels tp + GP*i, filters tm + GM*j),
// and each 4-word K chunk costs it twelve 16-byte shared loads for 128
// popcounts (LOP3 ~(a^b), POPC, IADD, nothing else in the loop); K runs
// over exactly kwords words (full chunks, then single words), so the
// padding of a step costs no popcount; the shared core (xnor_common.cuh)
// with the planner's tile and cp.async ring; where the 64x64-class tiles
// would leave SMs idle, 32x32 tiles whose four warps split each K step,
// with, at the 13x13 convs of 144 and 288 words, K also split across a
// cluster of 2 so the 384 blocks load the SMs evenly; without a split the
// epilogue runs from the registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "xnor_common.cuh"

namespace {

using namespace xnor;

constexpr int kRp = 8;   // pixels a thread
constexpr int kRm = 4;   // filters a thread

template <int TP, int TM>
__global__ void __launch_bounds__(kThreads)
xnor_popcount_kernel(const XnorArgs a) {
  constexpr bool kWs = warp_split(TP, TM);
  // threads that share the tile's register tiles: the block, or with the
  // warp split each warp
  constexpr int kGroup = kWs ? 32 : kThreads;
  constexpr int kGm = TM / kRm;   // filter groups
  constexpr int kGp = TP / kRp;   // pixel groups
  static_assert(kGm * kGp == kGroup, "one 8x4 register tile a thread");
  Trace trace;
  extern __shared__ __align__(16) unsigned char smem[];
  const int4* tab = reinterpret_cast<const int4*>(smem);
  const float* mb = reinterpret_cast<const float*>(smem + mb_offset(TP));
  const uint32_t ring = i8mma::smem_addr(smem + ring_offset(TP, TM));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int tm = tid % kGroup % kGm;
  const int tp = tid % kGroup / kGm;
  const Work b = block_work<TP, TM>(a);
  Gather<TP, TM> g(a, b.s_lo * a.kstep);
  start_block<TP, TM>(a, g, smem, b);
  __syncthreads();   // the pixel table
  trace.set_up_done();

  int acc[kRp][kRm];
#pragma unroll
  for (int i = 0; i < kRp; ++i)
#pragma unroll
    for (int j = 0; j < kRm; ++j) acc[i][j] = 0;
  const uint32_t rb = row_words(a.kstep) * 4;
  const uint32_t a_off = tp * rb;
  const uint32_t b_off = (TP + tm) * rb;
  // 4-word chunks of a step; with the warp split, warp w takes chunks w,
  // w + 4, ...
  const int c0 = kWs ? 4 * warp : 0;
  const int dc = kWs ? 4 * kWarps : 4;

  k_loop<TP, TM>(a, g, tab, ring, b, [&](uint32_t stage, int nw) {
    const unsigned char* base =
        smem + (stage - ring) + ring_offset(TP, TM);
    const unsigned char* pa = base + a_off;
    const unsigned char* pb = base + b_off;
    int c = c0;
#pragma unroll 1
    for (; c + 4 <= nw; c += dc) {
      uint4 av[kRp], bv[kRm];
#pragma unroll
      for (int i = 0; i < kRp; ++i)
        av[i] = *reinterpret_cast<const uint4*>(pa + i * kGp * rb + c * 4);
#pragma unroll
      for (int j = 0; j < kRm; ++j)
        bv[j] = *reinterpret_cast<const uint4*>(pb + j * kGm * rb + c * 4);
#pragma unroll
      for (int i = 0; i < kRp; ++i)
#pragma unroll
        for (int j = 0; j < kRm; ++j)
          acc[i][j] += __popc(~(av[i].x ^ bv[j].x)) +
                       __popc(~(av[i].y ^ bv[j].y)) +
                       __popc(~(av[i].z ^ bv[j].z)) +
                       __popc(~(av[i].w ^ bv[j].w));
    }
#pragma unroll 1
    for (; c < nw; ++c) {   // the window's last 1-3 words (one thread group)
      uint32_t av[kRp], bv[kRm];
#pragma unroll
      for (int i = 0; i < kRp; ++i)
        av[i] = *reinterpret_cast<const uint32_t*>(pa + i * kGp * rb + c * 4);
#pragma unroll
      for (int j = 0; j < kRm; ++j)
        bv[j] = *reinterpret_cast<const uint32_t*>(pb + j * kGm * rb + c * 4);
#pragma unroll
      for (int i = 0; i < kRp; ++i)
#pragma unroll
        for (int j = 0; j < kRm; ++j) acc[i][j] += __popc(~(av[i] ^ bv[j]));
    }
  });
  trace.k_loop_done();

  if (kWs) {   // the warps' partial tiles, summed in shared memory
    int* part =
        reinterpret_cast<int*>(smem + part_offset(TP, TM, a.kstep, a.stages));
#pragma unroll
    for (int i = 0; i < kRp; ++i)
#pragma unroll
      for (int j = 0; j < kRm; ++j)
        part[(warp * TP + tp + kGp * i) * (TM + 4) + tm + kGm * j] =
            acc[i][j];
    finish_warp_split<TP, TM>(a, part, part + warp_part_bytes(TP, TM) / 4,
                              mb, b);
    trace.finish();
    return;
  }
  // lanes run along the filters, so each store row is coalesced
#pragma unroll
  for (int j = 0; j < kRm; ++j) {
    const int m = b.m0 + tm + kGm * j;
    if (m >= a.M) continue;
    const float mv = mb[tm + kGm * j], bv = mb[TM + tm + kGm * j];
#pragma unroll
    for (int i = 0; i < kRp; ++i) {
      const int p = b.p0 + tp + kGp * i;
      if (p < a.P)
        a.out[static_cast<size_t>(p) * a.M + m] =
            epilogue(2 * acc[i][j] + a.offset, mv, bv, a.leaky);
    }
  }
  trace.finish();
}

const Kernel kKernels[kTiles] = {
    xnor_popcount_kernel<tile_p_of(0), tile_m_of(0)>,
    xnor_popcount_kernel<tile_p_of(1), tile_m_of(1)>,
    xnor_popcount_kernel<tile_p_of(2), tile_m_of(2)>};
std::atomic<bool> g_configured[kMaxDevices];

}  // namespace

// Launches one XNOR convolution on `stream` of CUDA device `device`.
// Pointers are device pointers to contiguous tensors: x [B,H,W,C32] int32,
// w [M,ks,ks,C32] int32, mean and bias [M] f32, out [B,OH,OW,M] f32. The
// plan comes from ops/xnor_gemm.plan_launch (see xnor_gemm_mxu_nhwc).
// Requires B*OH*OW and B*H*W*C32 below 2^31. Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for a plan the kernel does
// not take).
extern "C" int xnor_gemm_nhwc(const void* x, const void* w, const void* mean,
                              const void* bias, void* out, int B, int H,
                              int W, int C32, int M, int OH, int OW, int ks,
                              int stride, int pad, int adjust, int leaky,
                              int tile_p, int tile_m, int kstep, int stages,
                              int split, int device, void* stream) {
  XnorArgs a = {};
  a.x = static_cast<const uint32_t*>(x);
  a.w = static_cast<const uint32_t*>(w);
  a.mean = static_cast<const float*>(mean);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B; a.H = H; a.W = W; a.C32 = C32; a.M = M; a.OH = OH; a.OW = OW;
  a.ks = ks; a.stride = stride; a.pad = pad; a.leaky = leaky;
  a.scale = 2;
  a.offset = -adjust;
  a.kfill = ks * ks * C32;   // the popcount loop reads exactly the window
  a.kstep = kstep; a.stages = stages; a.split = split;
  return launch(kKernels, g_configured, a, tile_p, tile_m, device, stream);
}
