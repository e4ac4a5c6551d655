// XNOR (BIT1) convolution on the binary tensor cores: the bit-packed
// operands are contracted as they are, with
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
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
// result equals the popcount kernel's bit for bit. Layouts and the launch
// geometry in xnor_common.cuh.
//
// Where the TPU kernel (and this kernel before) unpacked the bits to +-1
// int8 and ran an int8 dot, the binary MMA takes the packed words: for +-1
// operands over the kwords*32 stored bits,
//
//   dot = 4*popc(a & b) - 2*popc(a) - 2*popc(b) + kwords*32,
//
// where popc(a & b) is the MMA's sum, popc(a) a pixel window's set bits and
// popc(b) a filter's. Both come from the tensor cores too: one extra MMA a
// K step against an all-ones B gives every row's popc(a) in the rows of the
// C fragment a thread holds, one against an all-ones A every column's
// popc(b), so no shuffle is needed. K is zero-padded to whole 256-bit MMA
// steps (kwords = 9 runs as 16 words); zero words add to none of the three
// counts, so the constant is the real kwords*32, not the padded width.
//
// Fragments are whole words of the [pixel][word] and [filter][word] tiles:
// A a0..a3 = words tig, tig (row + 8), 4 + tig, 4 + tig (row + 8) of pixel
// gid; B b0, b1 = words tig and 4 + tig of filter gid (gid = lane / 4, tig =
// lane % 4). They are exactly ldmatrix.x4's m8n8 b16 fragments of a 32-byte
// K step, so the int8 kernels' ldmatrix helpers load them (int8_mma.cuh).
//
// What bounds it on an H100: not the MMAs. The card issues 0.66 binary
// MMAs an SM a cycle, the same rate as m16n8k32 s8 with 8x the bits
// (scripts/trace_xnor_gemm.py), and tiny-yolo-obj_xnor's convs need at most
// about 400 an SM. At b = 1 every conv's blocks fit on the card at once, so
// a launch is a chain of latencies: the launch itself, a block's set-up, the
// gather's round trips to L2, the epilogue's stores (1.4-5.5 MB of f32 at
// the three large maps). A copy of the kernel with no copies and no MMAs
// (the trace's skeleton variant) takes 3.7-5.2 us of the 5.5-9 us a launch
// takes. What the design does: one shared core (xnor_common.cuh) with the
// planner's tile, a cp.async ring whose first weights and the tile's mean
// and bias are requested before anything else, and, where the 64x64-class
// tiles would leave SMs idle (52x52 down to 13x13), 32x32 tiles whose four
// warps split each K step (up to 384 blocks; the 288-word conv also splits
// K across a cluster of 2, pushing its partial rows into the finishing
// block's shared memory). Without a split the epilogue runs from the
// accumulators with 8-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

#include "xnor_common.cuh"

namespace {

using namespace xnor;

__device__ __forceinline__ void mma_b1(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int TP, int TM>
__global__ void __launch_bounds__(kThreads)
xnor_mma_kernel(const XnorArgs a) {
  constexpr bool kWs = warp_split(TP, TM);
  constexpr int kWm = kWs ? 1 : TM / 32;   // warps along the filters
  Trace trace;
  extern __shared__ __align__(16) unsigned char smem[];
  const int4* tab = reinterpret_cast<const int4*>(smem);
  const float* mb = reinterpret_cast<const float*>(smem + mb_offset(TP));
  const uint32_t ring = i8mma::smem_addr(smem + ring_offset(TP, TM));

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wp = kWs ? 0 : warp / kWm;
  const int wn = kWs ? 0 : warp % kWm;
  const Work b = block_work<TP, TM>(a);
  Gather<TP, TM> g(a, b.s_lo * a.kstep);
  start_block<TP, TM>(a, g, smem, b);
  __syncthreads();   // the pixel table
  trace.set_up_done();

  int acc[2][4][4], pa[2][4], pb[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pa[i][r] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][r] = 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) pb[j][r] = 0;
  }
  const uint32_t rb = row_words(a.kstep) * 4;
  const uint32_t a_off[2] = {
      (wp * 32 + (lane & 15)) * rb + i8mma::a_lane_offset(lane),
      (wp * 32 + 16 + (lane & 15)) * rb + i8mma::a_lane_offset(lane)};
  const uint32_t b_off = (TP + wn * 32 + i8mma::b_lane_row(lane)) * rb +
                         i8mma::b_lane_offset(lane);
  const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
  // one 256-bit MMA step a pass; with the warp split, warp w takes the
  // step's slices w, w + 4, ...
  const int kk0 = kWs ? 8 * warp : 0;
  const int dkk = kWs ? 8 * kWarps : 8;

  k_loop<TP, TM>(a, g, tab, ring, b, [&](uint32_t stage, int nw) {
#pragma unroll 1
    for (int kk = kk0; kk < nw; kk += dkk) {
      const uint32_t base = stage + kk * 4;
      i8mma::Frags<2, 4> f;
      const uint32_t aa[2] = {base + a_off[0], base + a_off[1]};
      i8mma::load_frags(f, aa, base + b_off, 16 * rb);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_b1(acc[i][j], f.a[i], f.b[j / 2][2 * (j & 1)],
                 f.b[j / 2][2 * (j & 1) + 1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) mma_b1(pa[i], f.a[i], ~0u, ~0u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_b1(pb[j], ones, f.b[j / 2][2 * (j & 1)],
               f.b[j / 2][2 * (j & 1) + 1]);
    }
  });
  trace.k_loop_done();

  // C fragment of m16 tile i, n8 tile j: r = 0, 1 at row gid, columns
  // 2*tig, 2*tig + 1; r = 2, 3 at row gid + 8. pa[i][r] is popc(a) of r's
  // row, pb[j][r] popc(b) of r's column, so each sum is elementwise.
  const int gid = lane >> 2;
  const int tig = lane & 3;
  if (kWs) {   // the warps' partial tiles, summed in shared memory
    int* part =
        reinterpret_cast<int*>(smem + part_offset(TP, TM, a.kstep, a.stages));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int* dst = part + (warp * TP + 16 * i + gid + 8 * h) * (TM + 4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 2 * h + c;
            v[c] = 4 * acc[i][j][r] - 2 * pa[i][r] - 2 * pb[j][r];
          }
          *reinterpret_cast<int2*>(dst + 8 * j + 2 * tig) =
              make_int2(v[0], v[1]);
        }
      }
    finish_warp_split<TP, TM>(a, part, part + warp_part_bytes(TP, TM) / 4,
                              mb, b);
    trace.finish();
    return;
  }
  const bool even = (a.M & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + 8 * j + 2 * tig;
    const int m = b.m0 + col;
    if (m >= a.M) continue;
    const float mv[2] = {mb[col], mb[col + 1]};
    const float bv[2] = {mb[TM + col], mb[TM + col + 1]};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = b.p0 + wp * 32 + 16 * i + gid + 8 * h;
        if (p >= a.P) continue;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 2 * h + c;
          y[c] = epilogue(4 * acc[i][j][r] - 2 * pa[i][r] - 2 * pb[j][r] +
                              a.offset,
                          mv[c], bv[c], a.leaky);
        }
        float* dst = a.out + static_cast<size_t>(p) * a.M + m;
        if (even) {
          *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
        } else {
          dst[0] = y[0];
          if (m + 1 < a.M) dst[1] = y[1];
        }
      }
  }
  trace.finish();
}

const Kernel kKernels[kTiles] = {
    xnor_mma_kernel<tile_p_of(0), tile_m_of(0)>,
    xnor_mma_kernel<tile_p_of(1), tile_m_of(1)>,
    xnor_mma_kernel<tile_p_of(2), tile_m_of(2)>};
std::atomic<bool> g_configured[kMaxDevices];

}  // namespace

// Launches one XNOR convolution on `stream` of CUDA device `device`.
// Pointers are device pointers to contiguous tensors: x [B,H,W,C32] int32,
// w [M,ks,ks,C32] int32, mean and bias [M] f32, out [B,OH,OW,M] f32
// (8-byte aligned). The plan comes from ops/xnor_gemm.plan_launch: a tile of
// tile_p x tile_m outputs (128x32, 64x64, or 32x32 with the warp split), K
// steps of kstep words (8, 16 or 32), `stages` ring stages (2-4), `split`
// blocks per cluster (1-8, at most the K steps; above 1 only with the warp
// split). Requires B*OH*OW and B*H*W*C32 below 2^31. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a plan
// the kernel does not take).
extern "C" int xnor_gemm_mxu_nhwc(const void* x, const void* w,
                                  const void* mean, const void* bias,
                                  void* out, int B, int H, int W, int C32,
                                  int M, int OH, int OW, int ks, int stride,
                                  int pad, int pad_bits, int leaky,
                                  int tile_p, int tile_m, int kstep,
                                  int stages, int split, int device,
                                  void* stream) {
  XnorArgs a = {};
  a.x = static_cast<const uint32_t*>(x);
  a.w = static_cast<const uint32_t*>(w);
  a.mean = static_cast<const float*>(mean);
  a.bias = static_cast<const float*>(bias);
  a.out = static_cast<float*>(out);
  a.B = B; a.H = H; a.W = W; a.C32 = C32; a.M = M; a.OH = OH; a.OW = OW;
  a.ks = ks; a.stride = stride; a.pad = pad; a.leaky = leaky;
  a.scale = 1;
  a.offset = ks * ks * C32 * 32 - pad_bits;
  a.kfill = (ks * ks * C32 + 7) / 8 * 8;   // whole 256-bit MMA steps
  a.kstep = kstep; a.stages = stages; a.split = split;
  return launch(kKernels, g_configured, a, tile_p, tile_m, device, stream);
}
