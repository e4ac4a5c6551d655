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
// independent: one warp walks one (image, class), four warps a block. A
// lane keeps its share of the class's state in registers, one bit per
// candidate: the nonzero probs at the start (`init`), the entries zeroed so
// far (`zeroed`) and the candidates already walked (`visited`, so rank_c(j)
// > t is "not visited" once cur is marked). Word w of a bit row lives in
// lane w % 32, slot w / 32. A step is one shuffle (is cur still alive?) and,
// where it is, one and-not per word of cur's overlap row.
//
// Bound: a walk is a chain of dependent steps, one per rank up to the last
// rank of the class with a nonzero prob; each live step reads one overlap
// row (K/8 bytes) from L2. The rows of eight ranks are requested together,
// and only for candidates still alive when the eight start, so the load
// latency is paid once per eight ranks and suppressed candidates cost no
// traffic.
//
// Inputs (device pointers, contiguous): over [B][K][W] uint32 bit rows
// (W = ceil(K/32), bit b of word w of row i = over(i, 32w+b)), order
// [B][C][K] int32, rank_has_work [B][K] float, probs [B][K][C] float; out
// [B][K][C] float, written whole (probs itself is not written).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;        // classes a block
constexpr int kAhead = 8;        // ranks whose rows are requested together
constexpr unsigned kFull = 0xffffffffu;

// Is bit `j` set in the bit row held across the warp in `v`? Every lane must
// call it (it shuffles); all lanes get the answer for their own `j`.
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
__global__ void __launch_bounds__(kWarps * 32)
nms_walk_kernel(const uint32_t* __restrict__ over,
                const int* __restrict__ order,
                const float* __restrict__ rank_has_work,
                const float* __restrict__ probs, float* __restrict__ out,
                int K, int C) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= C) return;                    // whole warps; no block barrier
  const int W = (K + 31) >> 5;
  const float* pb = probs + static_cast<size_t>(b) * K * C + c;
  float* ob = out + static_cast<size_t>(b) * K * C + c;
  const int* ord = order + (static_cast<size_t>(b) * C + c) * K;
  const uint32_t* ovb = over + static_cast<size_t>(b) * K * W;

  // the image's stop rank: the first t with !(rank_has_work[t] > 0)
  int T = K;
  for (int t0 = 0; t0 < K; t0 += 32) {
    const int t = t0 + lane;
    const bool stop = t < K && !(rank_has_work[static_cast<size_t>(b) * K + t]
                                 > 0.0f);
    const unsigned m = __ballot_sync(kFull, stop);
    if (m) {
      T = t0 + __ffs(m) - 1;
      break;
    }
  }

  // nonzero probs of this class, one bit per candidate
  uint32_t init[WPL], zeroed[WPL], visited[WPL];
#pragma unroll
  for (int s = 0; s < WPL; ++s) init[s] = zeroed[s] = visited[s] = 0u;
  for (int w = 0; w < W; ++w) {
    const int j = (w << 5) + lane;
    const bool nz = j < K && pb[static_cast<size_t>(j) * C] != 0.0f;
    const unsigned m = __ballot_sync(kFull, nz);
#pragma unroll
    for (int s = 0; s < WPL; ++s)
      if (lane == (w & 31) && s == (w >> 5)) init[s] = m;
  }

  // ranks past the class's last nonzero candidate cannot be active
  int t_end = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int cur = t < T ? ord[t] : 0;
    const bool has = bit_of<WPL>(init, cur) && t < T;
    const unsigned m = __ballot_sync(kFull, has);
    if (m) t_end = t0 + 32 - __clz(m);
  }

  for (int t0 = 0; t0 < t_end; t0 += kAhead) {
    // the next ranks' candidates, and the overlap rows of those still alive
    const int my_t = t0 + (lane & (kAhead - 1));
    const int my_cur = my_t < t_end ? ord[my_t] : 0;
    int curs[kAhead];
    uint32_t rows[kAhead][WPL];
    uint32_t alive0[WPL];
#pragma unroll
    for (int s = 0; s < WPL; ++s) alive0[s] = init[s] & ~zeroed[s];
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      curs[d] = __shfl_sync(kFull, my_cur, d);
      const bool live = bit_of<WPL>(alive0, curs[d]) && t0 + d < t_end;
      const uint32_t* row = ovb + static_cast<size_t>(curs[d]) * W;
#pragma unroll
      for (int s = 0; s < WPL; ++s) {
        const int w = (s << 5) + lane;
        rows[d][s] = live && w < W ? __ldg(row + w) : 0u;
      }
    }
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      if (t0 + d >= t_end) break;        // uniform across the warp
      const int cur = curs[d];
      const int wc = cur >> 5;
      const uint32_t bit = 1u << (cur & 31);
      uint32_t alive[WPL];
#pragma unroll
      for (int s = 0; s < WPL; ++s) alive[s] = init[s] & ~zeroed[s];
      const bool active = bit_of<WPL>(alive, cur);
#pragma unroll
      for (int s = 0; s < WPL; ++s)
        if (lane == (wc & 31) && s == (wc >> 5)) visited[s] |= bit;
      if (active) {
#pragma unroll
        for (int s = 0; s < WPL; ++s) zeroed[s] |= rows[d][s] & ~visited[s];
      }
    }
  }

  // write the column: suppressed entries become +0, the rest are copied
  for (int w = 0; w < W; ++w) {
    uint32_t z = 0;
#pragma unroll
    for (int s = 0; s < WPL; ++s) {
      const uint32_t got = __shfl_sync(kFull, zeroed[s], w & 31);
      if (s == (w >> 5)) z = got;
    }
    const int j = (w << 5) + lane;
    if (j < K) {
      const size_t at = static_cast<size_t>(j) * C;
      ob[at] = (z >> lane) & 1u ? 0.0f : pb[at];
    }
  }
}

template <int WPL>
cudaError_t launch(const void* over, const void* order, const void* rhw,
                   const void* probs, void* out, int B, int K, int C,
                   cudaStream_t stream) {
  const dim3 grid((C + kWarps - 1) / kWarps, B);
  nms_walk_kernel<WPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(over), static_cast<const int*>(order),
      static_cast<const float*>(rhw), static_cast<const float*>(probs),
      static_cast<float*>(out), K, C);
  return cudaGetLastError();
}

}  // namespace

// Launches one walk per (image, class) on `stream` of CUDA device `device`.
// Requires 1 <= K <= 8192, B <= 65535, C >= 1.
extern "C" int nms_walk(const void* over, const void* order, const void* rhw,
                        const void* probs, void* out, int B, int K, int C,
                        int device, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 8192 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wpl = ((K + 31) / 32 + 31) / 32;
  if (wpl <= 1) err = launch<1>(over, order, rhw, probs, out, B, K, C, s);
  else if (wpl <= 2) err = launch<2>(over, order, rhw, probs, out, B, K, C, s);
  else if (wpl <= 4) err = launch<4>(over, order, rhw, probs, out, B, K, C, s);
  else err = launch<8>(over, order, rhw, probs, out, B, K, C, s);
  return static_cast<int>(err);
}
