// The rank walk of exact greedy NMS, for Hopper (sm_90a).
//
// Replaces the lax.while_loop of yolo2_light_tpu/post/device_nms.py:93-109
// (nms_probs_with_order), an XLA loop and not a Pallas kernel:
//
//   for t while t < K and rank_has_work[t] > 0:
//     for every class c:
//       cur = order[c][t]
//       if probs[cur][c] != 0:                       // survived ranks < t
//         probs[j][c] = 0 for every j with over[cur][j] and rank_c(j) > t
//
// Class c's walk reads and writes column c only, so the classes are
// independent: one warp walks one (image, class), and a block takes one
// image and a group of eight classes. A lane keeps its share of the class's
// state in registers, one bit per candidate: the nonzero probs at the start
// (`init`), the negative ones (`neg`), the entries zeroed so far (`zeroed`)
// and the candidates kept so far (`kept`). Word w of a bit row lives in
// lane w % 32, slot w / 32.
//
// Bound: a walk is a chain of dependent steps, one per live rank; each step
// reads one overlap row (K/8 bytes) from L2. What the design does about it:
// - the block finds the image's stop rank once, with every thread's loads in
//   flight together, and reads its classes' probs as one coalesced row of
//   eight floats a candidate (the column of one class, strided by the row,
//   was one dependent L2 round trip per 32 candidates); the output is
//   written the same way;
// - a window of 32 ranks costs one ballot of which candidates are still
//   alive; dead ranks cost nothing more, and the overlap rows of up to
//   32 / WPL alive candidates are requested together.
// Skipping dead ranks is exact: `zeroed |= row & ~kept` may re-zero an entry
// already zeroed (no change), and the only entries of an earlier rank that
// are neither kept nor zeroed are the zero probs, which a positive candidate
// precedes (it may zero them: -0.0 becomes +0.0, as the plain walk does)
// and a negative one follows (its row loses them: `row &= init`).
//
// Inputs (device pointers): over [B][K][W] uint32 bit rows (W = ceil(K/32),
// bit b of word w of row i = over(i, 32w+b)), order [B][C][K] int32,
// rank_has_work [B][K] float, contiguous; probs [B][K][C] float with batch
// and row strides `psb`, `psk` in floats (the packed buffer's view). out
// [B][K][C] float, contiguous, written whole (probs itself is not written).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 8;        // classes a block, one warp each
constexpr int kThreads = kGroup * 32;
constexpr unsigned kFull = 0xffffffffu;

// With NMS_TRACE each warp records in g_trace the clock at its start, after
// the block's set-up (stop rank, bit rows), after its walk and at its end,
// and how many windows and candidate rows it walked (read_trace copies the
// records out; scripts/trace_nms.py reads them).
#ifdef NMS_TRACE
constexpr int kTraceRecords = 1 << 16;
constexpr int kTraceFields = 6;
__device__ long long g_trace[kTraceRecords * kTraceFields];
#endif

struct Trace {
#ifdef NMS_TRACE
  long long t[4];
  int windows = 0, rows = 0;
  __device__ void mark(int i) { t[i] = clock64(); }
  __device__ void window() { ++windows; }
  __device__ void row() { ++rows; }
  __device__ void finish(int rec) {
    if ((threadIdx.x & 31) || rec >= kTraceRecords) return;
    long long* r = g_trace + static_cast<size_t>(rec) * kTraceFields;
    r[0] = t[1] - t[0];
    r[1] = t[2] - t[1];
    r[2] = t[3] - t[2];
    r[3] = windows;
    r[4] = rows;
    r[5] = t[3] - t[0];
  }
#else
  __device__ void mark(int) {}
  __device__ void window() {}
  __device__ void row() {}
  __device__ void finish(int) {}
#endif
};

// Is bit `j` set in the bit row held across the warp in `v`? Every lane must
// call it (it shuffles); each lane gets the answer for its own `j`.
template <int WPL>
__device__ __forceinline__ bool bit_of(const uint32_t (&v)[WPL], int j) {
  const int w = j >> 5;
  uint32_t word = 0;
#pragma unroll
  for (int s = 0; s < WPL; ++s) {
    const uint32_t got = __shfl_sync(kFull, v[s], w & 31);
    if (s == (w >> 5)) word = got;
  }
  return (word >> (j & 31)) & 1u;
}

template <int WPL>
__device__ __forceinline__ void alive_of(const uint32_t (&init)[WPL],
                                         const uint32_t (&zeroed)[WPL],
                                         uint32_t (&alive)[WPL]) {
#pragma unroll
  for (int s = 0; s < WPL; ++s) alive[s] = init[s] & ~zeroed[s];
}

template <int WPL>
__global__ void __launch_bounds__(kThreads)
nms_walk_kernel(const uint32_t* __restrict__ over,
                const int* __restrict__ order,
                const float* __restrict__ rank_has_work,
                const float* __restrict__ probs, long long psb,
                long long psk, float* __restrict__ out, int K, int C) {
  constexpr int kAhead = 32 / WPL;       // rows requested together
  extern __shared__ uint32_t sm[];       // [2][kGroup][W] bit rows
  __shared__ int s_stop;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * kGroup;
  const int W = (K + 31) >> 5;
  uint32_t* s_nz = sm;
  uint32_t* s_neg = s_nz + kGroup * W;
  // a warp reads its class's row of s_nz before it writes the same row of
  // s_zero, and touches no other row until the barrier
  uint32_t* s_zero = s_nz;
  const float* pb = probs + static_cast<long long>(b) * psb;
  Trace tr;
  tr.mark(0);

  // the image's stop rank: the first t with !(rank_has_work[t] > 0)
  if (threadIdx.x == 0) s_stop = K;
  __syncthreads();
  int first = K;
  for (int t = threadIdx.x; t < K; t += kThreads)
    if (!(rank_has_work[static_cast<size_t>(b) * K + t] > 0.0f))
      first = min(first, t);
  if (first < K) atomicMin(&s_stop, first);

  // the group's nonzero and negative probs, one coalesced row a candidate
  for (int w = warp; w < W; w += kGroup) {
    const int j = (w << 5) + lane;
    float v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      v[g] = (j < K && c0 + g < C)
                 ? pb[static_cast<long long>(j) * psk + c0 + g] : 0.0f;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const unsigned nz = __ballot_sync(kFull, v[g] != 0.0f);
      const unsigned ng = __ballot_sync(kFull, v[g] < 0.0f);
      if (lane == g) {
        s_nz[g * W + w] = nz;
        s_neg[g * W + w] = ng;
      }
    }
  }
  __syncthreads();
  tr.mark(1);

  const int T = s_stop;
  const int c = c0 + warp;
  if (c < C) {                           // whole warps; no barrier inside
    uint32_t init[WPL], neg[WPL], zeroed[WPL], kept[WPL], alive[WPL];
    bool has_neg = false;
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const int w = (s << 5) + lane;
      init[s] = w < W ? s_nz[warp * W + w] : 0u;
      neg[s] = w < W ? s_neg[warp * W + w] : 0u;
      zeroed[s] = kept[s] = 0u;
      has_neg |= neg[s] != 0u;
    }
    has_neg = __any_sync(kFull, has_neg);
    const uint32_t* ovb = over + static_cast<size_t>(b) * K * W;
    const int* ord = order + (static_cast<size_t>(b) * C + c) * K;
    int next = lane < T ? ord[lane] : 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
      // window [t0, t0 + 32): lane p holds the candidate at rank t0 + p
      const int cur = next;
      const bool in = t0 + lane < T;
      next = t0 + 32 + lane < T ? ord[t0 + 32 + lane] : 0;
      alive_of<WPL>(init, zeroed, alive);
      const bool al = bit_of<WPL>(alive, cur);
      unsigned live = __ballot_sync(kFull, in && al);  // lanes to decide
      tr.window();
      while (live) {
        // the next alive candidates of the window, and their overlap rows
        int curs[kAhead];
        uint32_t rows[kAhead][WPL];
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
          curs[d] = -1;
          if (live) {                    // uniform across the warp
            curs[d] = __shfl_sync(kFull, cur, __ffs(live) - 1);
            live &= live - 1;
          }
          const uint32_t* row =
              ovb + static_cast<size_t>(max(curs[d], 0)) * W;
#pragma unroll
          for (int s = 0; s < WPL; ++s) {
            const int w = (s << 5) + lane;
            rows[d][s] = curs[d] >= 0 && w < W ? __ldg(row + w) : 0u;
          }
        }
#pragma unroll
        for (int d = 0; d < kAhead; ++d) {
          const int cj = curs[d];
          if (cj < 0) break;             // uniform
          tr.row();
          // still alive (not suppressed meanwhile)? The same answer in every
          // lane; applied without a branch where a row is one word a lane
          // (measured faster at K <= 1024, slower at K = 4096)
          alive_of<WPL>(init, zeroed, alive);
          const bool act = bit_of<WPL>(alive, cj);
          if (WPL > 1 && !act) continue;
          const int wc = cj >> 5;
#pragma unroll
          for (int s = 0; s < WPL; ++s)
            if (act && lane == (wc & 31) && s == (wc >> 5))
              kept[s] |= 1u << (cj & 31);
          const bool cneg = has_neg && bit_of<WPL>(neg, cj);
#pragma unroll
          for (int s = 0; s < WPL; ++s) {
            const uint32_t r = cneg ? rows[d][s] & init[s] : rows[d][s];
            zeroed[s] |= act ? r & ~kept[s] : 0u;
          }
        }
        if (live) {                      // the rest of the window
          alive_of<WPL>(init, zeroed, alive);
          const bool still = bit_of<WPL>(alive, cur);
          live &= __ballot_sync(kFull, still);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const int w = (s << 5) + lane;
      if (w < W) s_zero[warp * W + w] = zeroed[s];
    }
  }
  tr.mark(2);
  __syncthreads();

  // write the columns: suppressed entries become +0, the rest are copied;
  // a full group of a row is two 16-byte stores where C % 4 == 0 (scattered
  // 4-byte stores cost the L2 a request each)
  static_assert(kGroup == 8, "a row's group is two float4 stores");
  const bool vec = C % 4 == 0 && c0 + kGroup <= C;
  for (int w = warp; w < W; w += kGroup) {
    const int j = (w << 5) + lane;
    if (j >= K) continue;
    float* row = out + (static_cast<size_t>(b) * K + j) * C + c0;
    const float* src = pb + static_cast<long long>(j) * psk + c0;
    float v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      v[g] = c0 + g < C ? src[g] : 0.0f;
      if ((s_zero[g * W + w] >> lane) & 1u) v[g] = 0.0f;
    }
    if (vec) {
      reinterpret_cast<float4*>(row)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(row)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (c0 + g < C) row[g] = v[g];
    }
  }
  tr.mark(3);
  tr.finish((blockIdx.y * gridDim.x + blockIdx.x) * kGroup + warp);
}

template <int WPL>
cudaError_t launch(const void* over, const void* order, const void* rhw,
                   const void* probs, long long psb, long long psk,
                   void* out, int B, int K, int C, cudaStream_t stream) {
  const dim3 grid((C + kGroup - 1) / kGroup, B);
  const size_t smem = 2 * kGroup * ((K + 31) / 32) * sizeof(uint32_t);
  nms_walk_kernel<WPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(over), static_cast<const int*>(order),
      static_cast<const float*>(rhw), static_cast<const float*>(probs), psb,
      psk, static_cast<float*>(out), K, C);
  return cudaGetLastError();
}

}  // namespace

#ifdef NMS_TRACE
// Copies the first n warps' trace records (kTraceFields words each) to host.
extern "C" int read_trace(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_trace, static_cast<size_t>(n) * kTraceFields * 8));
}
#endif

// Launches one walk per (image, class) on `stream` of CUDA device `device`.
// Requires 1 <= K <= 8192, B <= 65535, C >= 1.
extern "C" int nms_walk(const void* over, const void* order, const void* rhw,
                        const void* probs, long long psb, long long psk,
                        void* out, int B, int K, int C, int device,
                        void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 8192 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wpl = ((K + 31) / 32 + 31) / 32;
  if (wpl <= 1)
    err = launch<1>(over, order, rhw, probs, psb, psk, out, B, K, C, s);
  else if (wpl <= 2)
    err = launch<2>(over, order, rhw, probs, psb, psk, out, B, K, C, s);
  else if (wpl <= 4)
    err = launch<4>(over, order, rhw, probs, psb, psk, out, B, K, C, s);
  else
    err = launch<8>(over, order, rhw, probs, psb, psk, out, B, K, C, s);
  return static_cast<int>(err);
}
