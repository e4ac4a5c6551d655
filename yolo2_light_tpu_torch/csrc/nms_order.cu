// K7: everything the NMS rank walk reads, in one launch, for Hopper (sm_90a).
//
// Replaces XLA ops and no Pallas kernel: pairwise_iou, `iou > thresh`, the
// lax.scan of stable argsorts and rank_has_work of
// yolo2_light_tpu/post/device_nms.py:66-93 (nms_probs_with_order), which the
// port's plain version (ops/nms_order.nms_order_plain) runs as about 700
// small dependent PyTorch ops at C = 80. For boxes [B][K][4] and probs
// [B][K][C] (any batch and row stride, the packed candidate buffer's views)
// it writes, bit for bit what the plain version returns:
//
//   over  [B][K][W] uint32  bit b of word w of row i = IoU(i, 32w+b) > thresh
//   order [B][C][K] int32   order[c] = stable descending argsort of class c's
//                           probs over order[c-1] (order[-1] = identity)
//   rhw   [B][K] float      max over classes of the t-th value of order[c]
//   perm  [B][K] int64      order[C-1] (the identity when C = 0)
//
// Bound: not bytes (about 0.8 MB at B = 1, K = 1024, C = 80: 0.24 us) but
// the chain's depth: C dependent sort steps an image. So the grid is
// heterogeneous. Blocks [0, B) run one image's chain each on one SM, its
// order, column and keys in shared memory; the remaining blocks write the
// overlap bit rows, one word per __ballot_sync of 32 columns, a 32 x 1024
// tile a block, in parallel with the chains.
//
// One class step needs no general sort. Class c's stable descending argsort
// over the previous order is: the entries with p > 0 by (p descending,
// previous position ascending), then the +-0 entries in their previous
// order (-0.0 == +0.0 ties), then the negative ones, descending. The zeros
// take their place from a block-wide prefix sum; the n nonzero entries are
// compacted in previous order under a 64-bit key (p's descending bits, its
// compacted index), unique, so each one's new position is the count of keys
// below its own. Where n <= count_max the warps sort runs of 32 keys in
// registers and each key adds its place in its run to a binary search in
// every other run; busier classes sort the keys (bitonic) in shared memory.
// The next class's column (strided by the row stride) is requested two
// steps ahead, so its loads never stall a step. rhw is a running maximum
// over the values each step places at each rank.
//
// The overlap test is the plain path's float32 arithmetic step by step
// (`x - w/2`, `min - max`, `iw*ih` under the `iw < 0 | ih < 0` mask, the
// areas `w*h`, `(a_i + a_j) - inter`, IEEE division where union > 0, then
// `> thresh` in float32), each step an __f*_rn intrinsic so that nvcc
// contracts nothing into an FMA.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;       // a block
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kWarps;    // bit rows of a bits block, one a warp
constexpr int kTileWords = 32;       // words of a bits block's rows
constexpr int kTileCols = kTileWords * 32;
constexpr unsigned kFull = 0xffffffffu;

// With NMS_TRACE thread 0 of each block records in g_trace its cycles and,
// for a chain block, those of its steps' three phases summed over the
// classes (gather and prefix, compaction, ranking) and how many classes it
// ranked by runs and by the bitonic sort, and their nonzero probs (read_trace
// copies the records out; scripts/trace_nms.py reads them).
#ifdef NMS_TRACE
constexpr int kTraceRecords = 1 << 16;
constexpr int kTraceFields = 7;
__device__ long long g_trace[kTraceRecords * kTraceFields];
#endif

struct Trace {
#ifdef NMS_TRACE
  long long start, last, acc[3] = {0, 0, 0};
  int by_runs = 0, sorted = 0, nonzero = 0;
  __device__ Trace() {
    start = clock64();
    last = start;
  }
  __device__ void lap(int i) {
    const long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
  __device__ void ranked(int n, bool by_sort) {
    by_sort ? ++sorted : ++by_runs;
    nonzero += n;
  }
  __device__ void finish(int rec) {
    if (threadIdx.x || rec >= kTraceRecords) return;
    long long* r = g_trace + static_cast<size_t>(rec) * kTraceFields;
    r[0] = clock64() - start;
    r[1] = acc[0];
    r[2] = acc[1];
    r[3] = acc[2];
    r[4] = by_runs;
    r[5] = sorted;
    r[6] = nonzero;
  }
#else
  __device__ void lap(int) {}
  __device__ void ranked(int, bool) {}
  __device__ void finish(int) {}
#endif
};

// shared memory of a chain block over kp = E * kThreads ranks: keys, column,
// values, two orders, candidates, warp totals (a bits block needs less)
constexpr size_t chain_smem(int kp) {
  return static_cast<size_t>(kp) * (8 + 4 + 4 + 2 * 2 + 2) + kWarps * 8;
}
static_assert(chain_smem(kThreads) >= 5 * kTileCols * sizeof(float),
              "a bits block's column boxes fit a chain block's memory");

__device__ __forceinline__ uint32_t desc_key(float v) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ~ordered;                   // larger v -> smaller key
}

__device__ __forceinline__ float from_desc(uint32_t d) {
  const uint32_t ordered = ~d;
  return __uint_as_float((ordered & 0x80000000u) ? (ordered & 0x7fffffffu)
                                                 : ~ordered);
}

// IoU(i, j) > thresh as pairwise_iou computes it (module note)
__device__ __forceinline__ bool overlaps(float x1i, float x2i, float y1i,
                                         float y2i, float ai, float x1j,
                                         float x2j, float y1j, float y2j,
                                         float aj, float th, bool zero_over) {
  const float iw = __fsub_rn(fminf(x2i, x2j), fmaxf(x1i, x1j));
  const float ih = __fsub_rn(fminf(y2i, y2j), fmaxf(y1i, y1j));
  if (iw < 0.0f || ih < 0.0f) return zero_over;
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  if (!(uni > 0.0f)) return zero_over;
  return __fdiv_rn(inter, uni) > th;
}

struct Box {
  float x1, x2, y1, y2, a;
};

__device__ __forceinline__ Box corners(const float* p) {
  const float x = p[0], y = p[1], w = p[2], h = p[3];
  const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
  return {__fsub_rn(x, hw), __fadd_rn(x, hw), __fsub_rn(y, hh),
          __fadd_rn(y, hh), __fmul_rn(w, h)};
}

struct Args {
  const float* boxes;
  long long box_sb, box_sk;
  const float* probs;
  long long prob_sb, prob_sk;
  uint32_t* over;
  int* order;
  float* rhw;
  long long* perm;
  int B, K, C;
  float thresh;
  int count_max;
};

// ---- the overlap bit rows ------------------------------------------------

__device__ __forceinline__ void bits_block(const Args a, int id, float* sm) {
  const int K = a.K, W = (K + 31) >> 5;
  const int tiles_r = (K + kTileRows - 1) / kTileRows;
  const int tiles_c = (W + kTileWords - 1) / kTileWords;
  const int b = id / (tiles_r * tiles_c);
  const int rt = (id / tiles_c) % tiles_r, ct = id % tiles_c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* sx1 = sm;
  float* sx2 = sx1 + kTileCols;
  float* sy1 = sx2 + kTileCols;
  float* sy2 = sy1 + kTileCols;
  float* sa = sy2 + kTileCols;
  const float* bb = a.boxes + static_cast<long long>(b) * a.box_sb;
  for (int jl = threadIdx.x; jl < kTileCols; jl += kThreads) {
    const int j = ct * kTileCols + jl;
    if (j < K) {
      const Box q = corners(bb + static_cast<long long>(j) * a.box_sk);
      sx1[jl] = q.x1;
      sx2[jl] = q.x2;
      sy1[jl] = q.y1;
      sy2[jl] = q.y2;
      sa[jl] = q.a;
    }
  }
  __syncthreads();
  const float th = a.thresh;
  const bool zero_over = 0.0f > th;
  for (int r = warp; r < kTileRows; r += kWarps) {
    const int i = rt * kTileRows + r;
    if (i >= K) break;                               // uniform in the warp
    const Box p = corners(bb + static_cast<long long>(i) * a.box_sk);
    uint32_t mine = 0;
    for (int g = 0; g < kTileWords; ++g) {
      if (ct * kTileWords + g >= W) break;           // uniform
      const int jl = g * 32 + lane;
      const bool o = ct * kTileCols + jl < K &&
                     overlaps(p.x1, p.x2, p.y1, p.y2, p.a, sx1[jl], sx2[jl],
                              sy1[jl], sy2[jl], sa[jl], th, zero_over);
      const unsigned m = __ballot_sync(kFull, o);
      if (lane == g) mine = m;
    }
    const int wd = ct * kTileWords + lane;
    if (wd < W) a.over[(static_cast<size_t>(b) * K + i) * W + wd] = mine;
  }
}

// ---- one image's chain ---------------------------------------------------

template <int E>
struct Chain {
  const Args a;
  const int b, tid, lane, warp;
  const float* pb;                 // probs of image b
  uint64_t* key;                   // [kp] compacted nonzero entries
  float* col;                      // [kp] class column by candidate
  float* val;                      // [kp] the class's values at the new ranks
  int16_t* ord0;                   // [kp] the order before / after a step,
  int16_t* ord1;                   // by the step's parity
  int16_t* cand;                   // [kp] candidate of a compacted entry
  int2* scan;                      // [kWarps] warp totals
  float best[E];                   // running rhw of this thread's ranks
  Trace tr;

  __device__ __forceinline__ Chain(const Args& args, char* sm)
      : a(args), b(blockIdx.x), tid(threadIdx.x), lane(threadIdx.x & 31),
        warp(threadIdx.x >> 5),
        pb(args.probs + static_cast<long long>(blockIdx.x) * args.prob_sb) {
    constexpr int kp = E * kThreads;
    key = reinterpret_cast<uint64_t*>(sm);
    col = reinterpret_cast<float*>(key + kp);
    val = col + kp;
    ord0 = reinterpret_cast<int16_t*>(val + kp);
    ord1 = ord0 + kp;
    cand = ord1 + kp;
    scan = reinterpret_cast<int2*>(cand + kp);
  }

  __device__ __forceinline__ void request(float (&buf)[E], int c) const {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * kThreads + tid;
      buf[e] = (c < a.C && j < a.K)
                   ? pb[static_cast<long long>(j) * a.prob_sk + c] : 0.0f;
    }
  }

  __device__ __forceinline__ void store(const float (&buf)[E]) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = e * kThreads + tid;
      if (j < a.K) col[j] = buf[e];
    }
  }

  // the values class c-1 left at this thread's ranks join the running max
  __device__ __forceinline__ void fold(int t, int e, int c) {
    const float v = val[t];
    best[e] = (c == 1 || v > best[e]) ? v : best[e];
  }

  // the nonzero probs at the ranks of the threads before this one, and the
  // block's nonzero and positive ones: ballots within the warp, one
  // reduction across the warps (barrier inside)
  __device__ __forceinline__ void prefix(const float (&v)[E], int& nz_before,
                                         int& n_nz, int& n_pos) {
    const unsigned below = (1u << lane) - 1u;
    int nz_w = 0, pos_w = 0, nz_lane = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned nz = __ballot_sync(kFull, v[e] != 0.0f);
      const unsigned pos = __ballot_sync(kFull, v[e] > 0.0f);
      nz_lane += __popc(nz & below);
      nz_w += __popc(nz);
      pos_w += __popc(pos);
    }
    if (lane == 0) scan[warp] = make_int2(nz_w, pos_w);
    __syncthreads();
    const int2 t = lane < kWarps ? scan[lane] : make_int2(0, 0);
    nz_before = __reduce_add_sync(kFull, lane < warp ? t.x : 0) + nz_lane;
    n_nz = __reduce_add_sync(kFull, t.x);
    n_pos = __reduce_add_sync(kFull, t.y);
  }

  // the compacted entry of key k takes new rank `rank`
  __device__ __forceinline__ void place(uint64_t k, int rank, int n_zero,
                                        int16_t* out) {
    const uint32_t d = static_cast<uint32_t>(k >> 32);
    const int at = rank + ((d >> 31) ? n_zero : 0);   // negatives after zeros
    out[at] = cand[static_cast<uint32_t>(k)];
    val[at] = from_desc(d);
  }

  // the new rank of each of the n compacted keys, the count of keys below
  // its own: each warp sorts runs of 32 keys in registers (a bitonic
  // network over shuffles) and writes them back in place; then a key's rank
  // is its place in its run plus, for every other run, how many of that
  // run's keys are below it (a binary search, four runs at a time)
  __device__ __forceinline__ void rank_by_runs(int n, int n_zero,
                                               int16_t* out) {
    const int runs = (n + 31) >> 5;
    for (int r = warp; r < runs; r += kWarps) {
      const int i = (r << 5) + lane;
      uint64_t x = i < n ? key[i] : ~0ull;             // padding sorts last
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
          const uint64_t y = __shfl_xor_sync(kFull, x, j);
          x = (((lane & j) == 0) == ((lane & k) == 0)) ? min(x, y) : max(x, y);
        }
      }
      key[i] = x;
    }
    __syncthreads();
    for (int r = warp; r < runs; r += kWarps) {
      const uint64_t ki = key[(r << 5) + lane];
      int rank = lane;
      for (int q0 = 0; q0 < runs; q0 += 4) {
        int lo[4] = {0, 0, 0, 0};
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int q = q0 + u;
            if (q < runs && q != r && key[(q << 5) + lo[u] + step - 1] < ki)
              lo[u] += step;
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int q = q0 + u;
          if (q < runs && q != r)
            rank += lo[u] + (key[(q << 5) + lo[u]] < ki);
        }
      }
      if (ki != ~0ull) place(ki, rank, n_zero, out);
    }
  }

  // the same by a bitonic sort of the keys, padded to a power of two
  __device__ __forceinline__ void rank_by_sort(int n, int n_zero,
                                               int16_t* out) {
    int p = 1;
    while (p < n) p <<= 1;
    for (int i = n + tid; i < p; i += kThreads) key[i] = ~0ull;
    __syncthreads();
    for (int k = 2; k <= p; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = tid; q < (p >> 1); q += kThreads) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const uint64_t x = key[i], y = key[i + j];
          if ((x > y) == ((i & k) == 0)) {
            key[i] = y;
            key[i + j] = x;
          }
        }
        __syncthreads();
      }
    }
    for (int r = tid; r < n; r += kThreads) place(key[r], r, n_zero, out);
  }

  // class c: order[c & 1] -> order[(c + 1) & 1]; `ahead` receives the
  // column of class c + 2, `next` (class c + 1's) goes to shared memory
  __device__ __forceinline__ void step(int c, float (&ahead)[E],
                                       const float (&next)[E]) {
    const int K = a.K;
    int16_t* cur = (c & 1) ? ord1 : ord0;
    int16_t* out = (c & 1) ? ord0 : ord1;
    request(ahead, c + 2);
    float v[E];
    int16_t who[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = tid * E + e;
      v[e] = 0.0f;
      who[e] = 0;
      if (t < K) {
        who[e] = cur[t];
        if (c > 0) {
          a.order[(static_cast<size_t>(b) * a.C + c - 1) * K + t] = who[e];
          fold(t, e, c);
        }
        v[e] = col[who[e]];
      }
    }
    int nz_before, n, n_pos;
    prefix(v, nz_before, n, n_pos);                   // barrier inside
    tr.lap(0);
    const int n_zero = K - n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = tid * E + e;
      if (t >= K) continue;
      if (v[e] != 0.0f) {
        key[nz_before] = (static_cast<uint64_t>(desc_key(v[e])) << 32) |
                         nz_before;
        cand[nz_before] = who[e];
        ++nz_before;
      } else {
        const int at = n_pos + t - nz_before;
        out[at] = who[e];
        val[at] = v[e];
      }
    }
    if (c + 1 < a.C) store(next);
    __syncthreads();
    tr.lap(1);
    if (n <= a.count_max) rank_by_runs(n, n_zero, out);
    else rank_by_sort(n, n_zero, out);
    __syncthreads();
    tr.lap(2);
    tr.ranked(n, n > a.count_max);
  }

  __device__ __forceinline__ void run() {
    const int K = a.K, C = a.C;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = tid * E + e;
      if (t < K) ord0[t] = static_cast<int16_t>(t);
      best[e] = 0.0f;
    }
    float even[E], odd[E];
    request(even, 0);
    store(even);
    request(odd, 1);
    __syncthreads();
    for (int c = 0; c < C; c += 2) {
      step(c, even, odd);                    // class c + 2 into `even`
      if (c + 1 < C) step(c + 1, odd, even);
    }
    const int16_t* last = (C & 1) ? ord1 : ord0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int t = tid * E + e;
      if (t >= K) continue;
      const int who = last[t];
      if (C > 0) {
        a.order[(static_cast<size_t>(b) * C + C - 1) * K + t] = who;
        fold(t, e, C);
      }
      a.perm[static_cast<size_t>(b) * K + t] = who;
      // +0.0 turns a -0.0 maximum into +0.0, as the plain version does
      a.rhw[static_cast<size_t>(b) * K + t] = __fadd_rn(best[e], 0.0f);
    }
    tr.finish(b);
  }
};

template <int E>
__global__ void __launch_bounds__(kThreads, 1) nms_order_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  if (blockIdx.x < a.B) {
    Chain<E> chain(a, smem);
    chain.run();
  } else {
    Trace tr;
    bits_block(a, blockIdx.x - a.B, reinterpret_cast<float*>(smem));
    tr.finish(blockIdx.x);
  }
}

template <int E>
cudaError_t prepare_one() {
  return cudaFuncSetAttribute(nms_order_kernel<E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(chain_smem(E * kThreads)));
}

template <int E>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int W = (a.K + 31) >> 5;
  const long long bits = static_cast<long long>(a.B) *
                         ((a.K + kTileRows - 1) / kTileRows) *
                         ((W + kTileWords - 1) / kTileWords);
  nms_order_kernel<E><<<static_cast<unsigned>(a.B + bits), kThreads,
                        chain_smem(E * kThreads), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

#ifdef NMS_TRACE
// Copies the first n blocks' trace records (kTraceFields words each) to
// host: the chain blocks', then the bits blocks'.
extern "C" int read_trace(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_trace, static_cast<size_t>(n) * kTraceFields * 8));
}
#endif

// Sets each instance's dynamic shared memory limit on CUDA device `device`:
// once, before any launch or capture.
extern "C" int nms_order_prepare(int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare_one<1>();
  if (err == cudaSuccess) err = prepare_one<2>();
  if (err == cudaSuccess) err = prepare_one<4>();
  if (err == cudaSuccess) err = prepare_one<8>();
  return static_cast<int>(err);
}

// Launches K7 on `stream` of CUDA device `device`. Strides in floats.
// Requires 1 <= K <= 8192, 1 <= B <= 65535, 0 <= C <= 65535.
extern "C" int nms_order(const void* boxes, long long box_sb,
                         long long box_sk, const void* probs,
                         long long prob_sb, long long prob_sk, void* over,
                         void* order, void* rhw, void* perm, int B, int K,
                         int C, float thresh, int count_max, int device,
                         void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 8192 || C < 0 || C > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<const float*>(boxes), box_sb, box_sk,
               static_cast<const float*>(probs), prob_sb, prob_sk,
               static_cast<uint32_t*>(over), static_cast<int*>(order),
               static_cast<float*>(rhw), static_cast<long long*>(perm),
               B, K, C, thresh, count_max};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = (K + kThreads - 1) / kThreads;
  if (e <= 1) err = launch<1>(a, s);
  else if (e <= 2) err = launch<2>(a, s);
  else if (e <= 4) err = launch<4>(a, s);
  else err = launch<8>(a, s);
  return static_cast<int>(err);
}
