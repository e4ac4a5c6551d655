// Mirrors yolo2_light_tpu/native/nms.cpp: a copy for the port.
// Native exact greedy per-class NMS + darknet box utilities.
//
// Semantics match the reference do_nms_sort (src/box.c:296-328) and box_iou
// (src/box.c:70-97) INCLUDING tie order: per class, walk detections in
// descending class-prob; each surviving box zeroes the class-prob of any
// later box with IoU > thresh. Zero-objectness detections are excluded by
// the reference's swap-compaction loop (box.c:299-309), which sets the
// pre-sort order; each class's qsort permutes the array the NEXT class's
// sort sees (box.c:310-317), and glibc's qsort is a stable mergesort with a
// comparator that returns 0 on equal probs (probed stable up to 100k in
// tests/test_nms_tie_order.py). On tie-free workloads this reduces to an
// independent per-class stable sort; on tie-degenerate ones (random weights
// emit thousands of exact-duplicate probs) the surviving-box choice — and
// through transitive suppression the detection COUNT — depends on it
// (found by the generative fuzz campaign: detections_count 52207 vs 52209).
//
// Exposed C ABI (ctypes):
//   nms_sort(bbox[N*4], prob[N*C], objectness[N], N, C, thresh, out_order[N])
//     - in-place on prob; out_order (nullable) receives the reference's
//       POST-NMS array order as original det indices (live perm then the
//       compacted zero-objectness tail)
//   box_iou_matrix(a[N*4], b[M*4], out[N*M], N, M)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Box {
  float x, y, w, h;
};

inline float overlap(float x1, float w1, float x2, float w2) {
  float l1 = x1 - w1 / 2;
  float l2 = x2 - w2 / 2;
  float left = l1 > l2 ? l1 : l2;
  float r1 = x1 + w1 / 2;
  float r2 = x2 + w2 / 2;
  float right = r1 < r2 ? r1 : r2;
  return right - left;
}

inline float box_intersection(const Box& a, const Box& b) {
  float w = overlap(a.x, a.w, b.x, b.w);
  float h = overlap(a.y, a.h, b.y, b.h);
  if (w < 0 || h < 0) return 0;
  return w * h;
}

inline float box_iou(const Box& a, const Box& b) {
  float i = box_intersection(a, b);
  float u = a.w * a.h + b.w * b.h - i;
  return u > 0 ? i / u : 0.0f;
}

}  // namespace

extern "C" {

void box_iou_matrix(const float* a, const float* b, float* out,
                    int64_t n, int64_t m) {
  const Box* ba = reinterpret_cast<const Box*>(a);
  const Box* bb = reinterpret_cast<const Box*>(b);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < m; ++j) out[i * m + j] = box_iou(ba[i], bb[j]);
}

void nms_sort(const float* bbox, float* prob, const float* objectness,
              int64_t n, int64_t classes, float thresh, int32_t* out_order) {
  const Box* boxes = reinterpret_cast<const Box*>(bbox);
  // the reference's zero-objectness swap-compaction (box.c:299-309): each
  // zero det swaps with the current end and the swapped-in det is
  // re-examined; this permutation is the order class 0's sort sees
  std::vector<int32_t> arr(n);
  std::iota(arr.begin(), arr.end(), 0);
  int64_t k_end = n - 1;
  for (int64_t i = 0; i <= k_end;) {
    if (objectness[arr[i]] == 0.0f) {
      std::swap(arr[i], arr[k_end]);
      --k_end;
    } else {
      ++i;
    }
  }
  const int64_t nl = k_end + 1;
  if (nl > 0) {
    // The IoU>thresh relation is class-independent: precompute it ONCE as a
    // symmetric bitset and reuse it for every class. One O(nl^2/2) IoU pass
    // replaces up to `classes` of them (dense 1024x80: 360 ms -> ~10 ms).
    // Rows are keyed by position in the INITIAL live order (the per-class
    // permutation evolves).
    std::vector<int32_t> row(n, -1);
    for (int64_t ii = 0; ii < nl; ++ii) row[arr[ii]] = static_cast<int32_t>(ii);
    const int64_t words = (nl + 63) / 64;
    const bool use_adj = nl <= 16384;  // 32 MB bitset cap
    std::vector<uint64_t> adj;
    if (use_adj) {
      adj.assign(static_cast<size_t>(nl) * words, 0);
      for (int64_t ii = 0; ii < nl; ++ii) {
        const Box& a_ = boxes[arr[ii]];
        for (int64_t jj = ii + 1; jj < nl; ++jj) {
          if (box_iou(a_, boxes[arr[jj]]) > thresh) {
            adj[ii * words + (jj >> 6)] |= (uint64_t(1) << (jj & 63));
            adj[jj * words + (ii >> 6)] |= (uint64_t(1) << (ii & 63));
          }
        }
      }
    }

    for (int64_t k = 0; k < classes; ++k) {
      bool any = false;
      for (int64_t ii = 0; ii < nl; ++ii)
        if (prob[arr[ii] * classes + k] > 0) { any = true; break; }
      if (!any) continue;  // all keys equal(0): the reference's sort is a no-op
      // the reference re-sorts the WHOLE (mutated) array each class; with a
      // stable sort, ties keep the PREVIOUS class's order, not decode order
      std::stable_sort(arr.begin(), arr.begin() + nl,
                       [&](int32_t a_, int32_t b_) {
                         return prob[a_ * classes + k] >
                                prob[b_ * classes + k];
                       });
      // descending sort puts every positive in the prefix; zero-prob dets
      // neither suppress (the reference `continue`s) nor change when
      // re-zeroed, so suppression scans the prefix only
      int64_t npos = 0;
      while (npos < nl && prob[arr[npos] * classes + k] > 0) ++npos;
      for (int64_t oi = 0; oi < npos; ++oi) {
        const int32_t d = arr[oi];
        if (prob[d * classes + k] == 0.0f) continue;
        if (use_adj) {
          const uint64_t* r = &adj[static_cast<size_t>(row[d]) * words];
          for (int64_t oj = oi + 1; oj < npos; ++oj) {
            const int32_t e = arr[oj];
            if (r[row[e] >> 6] & (uint64_t(1) << (row[e] & 63)))
              prob[e * classes + k] = 0.0f;
          }
        } else {
          const Box& a_ = boxes[d];
          for (int64_t oj = oi + 1; oj < npos; ++oj) {
            const int32_t e = arr[oj];
            float* pj = &prob[e * classes + k];
            if (*pj != 0.0f && box_iou(a_, boxes[e]) > thresh) *pj = 0.0f;
          }
        }
      }
    }
  }
  if (out_order)
    for (int64_t t = 0; t < n; ++t) out_order[t] = arr[t];
}

}  // extern "C"
