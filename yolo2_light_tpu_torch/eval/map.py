# Mirrors yolo2_light_tpu/eval/map.py: a copy, so that the port imports
# nothing of the JAX package.
"""mAP evaluation core (reference: validate_detector_map, src/additionally.c:4541-4898).

Exact reproduction of the reference's accounting:

* per-image decode at thresh=0.005, NMS 0.45 (do_nms_sort_v3 == do_nms_sort)
* every (detection, class) with prob>0 becomes a ranked record; matched to the
  best-IoU same-class truth above ``iou_thresh``; unmatched detections overlapping a
  "difficult" truth are dropped entirely
* TP/FP/avg-IoU at the CLI threshold with per-image truth-index dedupe
* global rank sweep with per-truth dedupe -> PR curves -> 11-point interpolated AP
  per class -> mAP

The detection records are produced by the caller (so the network/batching strategy is
decoupled); this module owns matching + curve math and the printed report.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..post.boxes import Detections, box_iou


@dataclass
class MapAccumulator:
    classes: int
    iou_thresh: float = 0.5
    thresh_calc_avg_iou: float = 0.25

    det_p: list = field(default_factory=list)
    det_class: list = field(default_factory=list)
    det_truth_flag: list = field(default_factory=list)
    det_truth_index: list = field(default_factory=list)

    unique_truth_count: int = 0
    truth_classes_count: np.ndarray = None
    avg_iou_sum: float = 0.0
    tp_for_thresh: int = 0
    fp_for_thresh: int = 0

    def __post_init__(self):
        self.truth_classes_count = np.zeros(self.classes, np.int64)

    def add_image(self, dets: Detections, truth: np.ndarray,
                  truth_dif: np.ndarray | None = None) -> None:
        """``truth``: [T,5] rows (class_id, x, y, w, h) relative; ``truth_dif``:
        difficult boxes, same layout. ``dets``: post-NMS detections (relative).

        Vectorized over the (detections x classes x truths) cube; semantics match
        the reference's per-record loop (src/additionally.c:4702-4767) exactly:

        * one ranked record per (det, class) with prob > 0, det-major order
        * matched to the best-IoU same-class truth above ``iou_thresh`` (first of
          equal maxima, like the strict ``>`` running max)
        * unmatched records overlapping a same-class "difficult" truth are dropped
          from the ranked list but still count as threshold-level FPs
        * threshold-level TP requires being the image's FIRST kept record (any
          prob) matched to that truth (the checkpoint rescan at :4752-4756)
        """
        # the reference's record loop walks the POST-NMS qsort-permuted dets
        # array (additionally.c:4702 iterates the array do_nms_sort left
        # behind); record insertion order feeds the stable global rank sort,
        # the per-image first-match dedupe, and the sequential-f32 avg_iou
        # adds — on exact-prob ties each differs between decode order and the
        # reference's order (post.in_reference_order)
        from ..post.boxes import in_reference_order
        dets = in_reference_order(dets)
        truth = np.asarray(truth, np.float32).reshape(-1, 5)
        tboxes = truth[:, 1:5]
        tids = truth[:, 0].astype(np.int64)
        np.add.at(self.truth_classes_count, tids, 1)
        dif = (np.asarray(truth_dif, np.float32).reshape(-1, 5)
               if truth_dif is not None else np.zeros((0, 5), np.float32))

        if dets.n == 0:
            self.unique_truth_count += len(tboxes)
            return
        # records: (det i, class c) with prob > 0, i-major (reference loop order)
        ii, cc = np.nonzero(dets.prob > 0)
        if ii.size == 0:
            self.unique_truth_count += len(tboxes)
            return
        pp = dets.prob[ii, cc].astype(np.float32)

        # best same-class truth above iou_thresh per record
        if len(tboxes):
            iou_t = box_iou(dets.bbox, tboxes)                    # [N,T]
            elig = ((iou_t[ii] > self.iou_thresh)
                    & (tids[None, :] == cc[:, None]))             # [R,T]
            masked = np.where(elig, iou_t[ii], -1.0)
            best_j = np.argmax(masked, axis=1)                    # first max
            has = elig.any(axis=1)
            max_iou = np.where(has, masked[np.arange(ii.size), best_j], 0.0)
            tidx = np.where(has, self.unique_truth_count + best_j, -1)
        else:
            max_iou = np.zeros(ii.size, np.float32)
            tidx = np.full(ii.size, -1, np.int64)

        # unmatched + difficult overlap -> dropped from the ranked list
        if len(dif):
            iou_d = box_iou(dets.bbox, dif[:, 1:5])
            dif_ids = dif[:, 0].astype(np.int64)
            dif_hit = ((iou_d[ii] > self.iou_thresh)
                       & (dif_ids[None, :] == cc[:, None])).any(axis=1)
            dropped = (tidx == -1) & dif_hit
        else:
            dropped = np.zeros(ii.size, bool)
        kept = ~dropped

        # threshold-level TP/FP with per-image first-match dedupe
        over = pp > self.thresh_calc_avg_iou
        first_kept = np.zeros(ii.size, bool)
        kpos = np.nonzero(kept)[0]
        if kpos.size:
            _, first = np.unique(tidx[kpos], return_index=True)
            first_kept[kpos[first]] = True
        tp_rec = kept & over & (tidx > -1) & first_kept
        fp_rec = over & ~tp_rec          # dropped, unmatched, or duplicate match
        self.tp_for_thresh += int(tp_rec.sum())
        self.fp_for_thresh += int(fp_rec.sum())
        # sequential float32 adds in detection order, like the reference's
        # `avg_iou += max_iou` (additionally.c:4759) — numpy's pairwise f32
        # .sum() can land one %2.2f digit off at a rounding boundary (caught
        # by the generative map fuzz: 0.06 vs 0.05)
        acc = np.float32(self.avg_iou_sum)
        for v in max_iou[tp_rec]:
            acc = np.float32(acc + np.float32(v))
        self.avg_iou_sum = float(acc)

        self.det_p.append(pp[kept])
        self.det_class.append(cc[kept].astype(np.int64))
        self.det_truth_flag.append((tidx[kept] > -1).astype(np.int64))
        self.det_truth_index.append(tidx[kept].astype(np.int64))
        self.unique_truth_count += len(tboxes)

    def compute(self) -> dict:
        """Rank sweep + 11-point AP (reference: src/additionally.c:4779-4861).

        Vectorized: the global-rank sweep only changes a class's running (tp, fp)
        at that class's own records, so each per-class PR curve is a cumsum over
        the class's records in global rank order — identical values to the
        reference's full [rank, class] table without materializing it. A
        duplicate match of an already-claimed truth (in rank order) counts
        neither as TP nor FP (:4816-4826)."""
        p = (np.concatenate(self.det_p) if self.det_p
             else np.zeros(0, np.float32))
        n = p.size
        cls = (np.concatenate(self.det_class) if self.det_class
               else np.zeros(0, np.int64))
        tflag = (np.concatenate(self.det_truth_flag) if self.det_truth_flag
                 else np.zeros(0, np.int64))
        tidx = (np.concatenate(self.det_truth_index) if self.det_truth_index
                else np.zeros(0, np.int64))
        order = np.argsort(-p, kind="stable")
        scls, stflag, stidx = cls[order], tflag[order], tidx[order]

        # TP increment: matched record that is the first (in rank order) to claim
        # its truth; later claims of the same truth increment nothing
        tp_inc = np.zeros(n, np.int64)
        mpos = np.nonzero(stflag == 1)[0]
        if mpos.size:
            _, first = np.unique(stidx[mpos], return_index=True)
            tp_inc[mpos[first]] = 1
        fp_inc = (stflag == 0).astype(np.int64)

        ap = np.zeros(self.classes)
        if n:
            for i in range(self.classes):
                sel = scls == i
                if not sel.any():
                    continue          # no records of this class -> ap 0
                tp_c = np.cumsum(tp_inc[sel])
                fp_c = np.cumsum(fp_inc[sel])
                denom = tp_c + fp_c
                prec = np.where(denom > 0, tp_c / np.maximum(denom, 1), 0.0)
                tcnt = self.truth_classes_count[i]
                rec = (tp_c / tcnt if tcnt > 0
                       else np.zeros_like(prec))
                s = 0.0
                for point in range(11):
                    cur_recall = point * 0.1
                    mask = rec >= cur_recall
                    s += prec[mask].max() if mask.any() else 0.0
                ap[i] = s / 11.0

        tp, fp = self.tp_for_thresh, self.fp_for_thresh
        fn = self.unique_truth_count - tp
        # the reference computes these UNGUARDED in float32
        # (additionally.c:4779,4871-4873): degenerate denominators produce the
        # hardware QNaN (sign bit set), which glibc prints as "-nan" — e.g.
        # F1 with tp==0 is 0/0. Reproduce the NaNs; _c_float_fmt prints them.
        with np.errstate(divide="ignore", invalid="ignore"):
            tpf, fpf = np.float32(tp), np.float32(fp)
            # avg_iou's division alone is GUARDED in the reference
            # (additionally.c:4778-4780): 0.00 when tp+fp==0, while
            # precision/recall/F1 are unguarded f32 (-nan) — oracle-verified
            # by the generative map fuzz
            avg_iou = (float(np.float32(self.avg_iou_sum) / (tpf + fpf))
                       if tp + fp > 0 else 0.0)
            precision = float(tpf / (tpf + fpf))
            recall = float(tpf / (tpf + np.float32(fn)))
            f1 = float(np.float32(2.0) * np.float32(precision)
                       * np.float32(recall)
                       / (np.float32(precision) + np.float32(recall)))
        return {
            "ap": ap,
            "mAP": float(ap.mean()) if self.classes else 0.0,
            "detections_count": n,
            "unique_truth_count": self.unique_truth_count,
            "tp": tp, "fp": fp, "fn": fn,
            "precision": precision, "recall": recall, "f1": f1,
            "avg_iou": avg_iou,
        }


def read_truth_boxes(label_path: str) -> np.ndarray:
    """darknet label file: rows ``class x y w h`` relative
    (reference: read_boxes, src/additionally.c:4441-4469). Missing file -> empty."""
    try:
        rows = []
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 5:
                    rows.append([float(parts[0])] + [float(v) for v in parts[1:5]])
        return np.asarray(rows, np.float32).reshape(-1, 5)
    except FileNotFoundError:
        return np.zeros((0, 5), np.float32)


def label_path_for(image_path: str) -> str:
    """Path rewriting (reference: src/additionally.c:4668-4675): replace first
    'images'->'labels', 'JPEGImages'->'labels', extension -> .txt."""
    p = image_path.replace("images", "labels", 1)
    p = p.replace("JPEGImages", "labels", 1)
    for ext in (".jpg", ".png", ".bmp", ".JPG", ".JPEG"):
        if p.endswith(ext):
            p = p[: -len(ext)] + ".txt"
            break
    return p


def _c_float_fmt(v: float, spec: str = "1.2f") -> str:
    """C printf float formatting including glibc's NaN spelling: the x86
    default QNaN has its sign bit set, so the reference's degenerate 0/0
    metrics print as ``-nan`` (observed vs the compiled oracle)."""
    if np.isnan(v):
        return "-nan" if np.signbit(v) else "nan"
    return format(float(v), spec)


def format_map_report(result: dict, names, iou_thresh: float,
                      thresh: float) -> str:
    """Reproduce the reference's printed block (src/additionally.c:4846-4895),
    including the rank-sweep progress markers (one per 100 ranks,
    ``\\r``-terminated in the reference, :4803-4806) and C NaN formatting."""
    lines = [f"detections_count = {result['detections_count']}, "
             f"unique_truth_count = {result['unique_truth_count']}  "]
    n = result["detections_count"]
    # every rank marker ENDS with \r (additionally.c:4805 has no trailing
    # \n), so the first class_id line follows the last marker after a bare
    # carriage return — byte-exact junction caught by the generative fuzzer
    # (the earlier \n-joined form only matched oracles with n == 0)
    pending = ("".join(f" rank = {r} of ranks = {n} \r"
                       for r in range(0, n, 100)) if n else "")
    for i, a in enumerate(result["ap"]):
        name = names[i] if i < len(names) else str(i)
        lines.append(pending + f"class_id = {i}, name = {name}, "
                     f"\t ap = {a * 100:2.2f} % ")
        pending = ""
    lines.append(pending + f" for thresh = {thresh:1.2f}, precision = "
                 f"{_c_float_fmt(result['precision'])}, recall = "
                 f"{_c_float_fmt(result['recall'])}, "
                 f"F1-score = {_c_float_fmt(result['f1'])} ")
    lines.append(f" for thresh = {thresh:0.2f}, TP = {result['tp']}, "
                 f"FP = {result['fp']}, FN = {result['fn']}, "
                 f"average IoU = {_c_float_fmt(result['avg_iou'] * 100, '2.2f')} % ")
    if iou_thresh == 0.5:
        lines.append(f"\n mean average precision (mAP) = {result['mAP']:f}, "
                     f"or {result['mAP'] * 100:2.2f} % ")
    else:
        lines.append(f"\n average precision (AP) = {result['mAP']:f}, "
                     f"or {result['mAP'] * 100:2.2f} % "
                     f"for IoU threshold = {iou_thresh:f} ")
    return "\n".join(lines)
