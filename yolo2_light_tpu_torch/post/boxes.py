# Mirrors yolo2_light_tpu/post/boxes.py: a copy, so that the port imports
# nothing of the JAX package; the yolo decode adds yolov4's scale_x_y.
"""Detection decode + NMS (host reference implementation, NumPy).

Exact value/order parity with the reference decode stack:

* ``get_network_boxes`` / ``fill_network_boxes`` (src/additionally.c:4386-4408)
* yolo decode: ``get_yolo_detections`` + ``get_yolo_box`` (src/additionally.c:4317-4360)
* region decode: ``custom_get_region_detections`` -> ``get_region_boxes_cpu``
  (src/additionally.c:4363-4384, src/yolov2_forward_network.c:653-726)
* letterbox/stretch coordinate correction: ``correct_yolo_boxes``
  (src/additionally.c:4281-4314)
* NMS: ``do_nms_sort`` (src/box.c:296-328) with ``box_iou`` (src/box.c:94)

Detections are held as a struct-of-arrays :class:`Detections` batch; iteration order
matches the reference (heads in network order; cells row-major; anchors inner), so
downstream sorts/prints line up with the reference byte-for-byte modulo float tolerance.

A fused on-device decode lives in post/device_decode.py; this module is the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Detections:
    """Struct-of-arrays detection set for a single image."""
    bbox: np.ndarray        # [N,4] x,y,w,h (relative)
    objectness: np.ndarray  # [N]
    prob: np.ndarray        # [N,classes]

    @property
    def n(self) -> int:
        return self.bbox.shape[0]

    @classmethod
    def empty(cls, classes: int) -> "Detections":
        return cls(np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
                   np.zeros((0, classes), np.float32))

    @classmethod
    def concat(cls, parts: list) -> "Detections":
        return cls(np.concatenate([p.bbox for p in parts], 0),
                   np.concatenate([p.objectness for p in parts], 0),
                   np.concatenate([p.prob for p in parts], 0))


def correct_boxes(bbox: np.ndarray, w: int, h: int, netw: int, neth: int,
                  relative: bool, letter: bool) -> np.ndarray:
    """Undo network-input letterbox/stretch into original-image coordinates
    (reference: correct_yolo_boxes, src/additionally.c:4281-4314)."""
    if letter:
        if (netw / w) < (neth / h):
            new_w = netw
            new_h = (h * netw) // w
        else:
            new_h = neth
            new_w = (w * neth) // h
    else:
        new_w, new_h = netw, neth
    b = bbox.copy()
    b[:, 0] = (b[:, 0] - (netw - new_w) / 2.0 / netw) / (new_w / netw)
    b[:, 1] = (b[:, 1] - (neth - new_h) / 2.0 / neth) / (new_h / neth)
    b[:, 2] *= netw / new_w
    b[:, 3] *= neth / new_h
    if not relative:
        b[:, [0, 2]] *= w
        b[:, [1, 3]] *= h
    return b


def get_yolo_detections(head: np.ndarray, mask, anchors, classes: int,
                        w: int, h: int, netw: int, neth: int, thresh: float,
                        relative: bool = True, letter: bool = False,
                        scale_x_y: float = 1.0) -> Detections:
    """Decode one yolo head (reference: get_yolo_detections, src/additionally.c:4328).

    ``head``: [H,W,n,5+classes] post-activation (x,y sigmoid; w,h raw; obj/cls sigmoid).
    Box: x=(col+sx)/W, y=(row+sy)/H, w=exp(tw)*anchor_w/netw, h=exp(th)*anchor_h/neth
    (reference: get_yolo_box, src/additionally.c:4317-4325).
    prob_j = objectness*class_j, zeroed when <= thresh.
    ``scale_x_y`` (a port extension: AlexeyAB/darknet's yolov4 heads) maps
    sx and sy to ``sx * s - 0.5 * (s - 1)`` first, in float32
    (``device_decode.scale_xy_terms``); at 1 the decode is unchanged.
    """
    lh, lw, n = head.shape[:3]
    obj = head[..., 4]
    # iteration order: cell (row-major), then anchor — build full grids then select
    cols = np.arange(lw, dtype=np.float32)[None, :, None]
    rows = np.arange(lh, dtype=np.float32)[:, None, None]
    anchors = np.asarray(anchors, dtype=np.float32)
    aw = anchors[2 * np.asarray(mask)]
    ah = anchors[2 * np.asarray(mask) + 1]
    sx, sy = head[..., 0], head[..., 1]
    if scale_x_y != 1.0:
        from .device_decode import scale_xy_terms
        s, b = scale_xy_terms(scale_x_y)
        sx, sy = sx * s + b, sy * s + b
    bx = (cols + sx) / lw
    by = (rows + sy) / lh
    bw = np.exp(head[..., 2]) * aw[None, None, :] / netw
    bh = np.exp(head[..., 3]) * ah[None, None, :] / neth
    keep = obj > thresh
    sel = np.nonzero(keep.reshape(lh * lw, n))  # (cell, anchor), cell-major ✔ order
    cells, anchs = sel
    flat = lambda a: a.reshape(lh * lw, n)[cells, anchs]
    bbox = np.stack([flat(bx), flat(by), flat(bw), flat(bh)], axis=-1)
    objectness = flat(obj)
    probs = head[..., 5:].reshape(lh * lw, n, classes)[cells, anchs]
    probs = probs * objectness[:, None]
    probs[probs <= thresh] = 0.0
    # dtype follows the head: f32 everywhere in production; an f64 head keeps
    # f64 through correct_boxes/NMS/print (the fuzz noise-confirmation
    # oracle, tests/fuzz_confirm.py)
    dt = np.float64 if head.dtype == np.float64 else np.float32
    bbox = correct_boxes(bbox.astype(dt), w, h, netw, neth, relative, letter)
    return Detections(bbox.astype(dt), objectness.astype(dt),
                      probs.astype(dt))


def get_region_detections(head: np.ndarray, anchors, classes: int, coords: int,
                          classfix: int, w: int, h: int, netw: int, neth: int,
                          thresh: float, relative: bool = True,
                          letter: bool = False, tree=None,
                          class_map=None) -> Detections:
    """Decode a region (YOLOv2) head
    (reference: custom_get_region_detections, src/additionally.c:4363-4384, and
    get_region_boxes_cpu, src/yolov2_forward_network.c:664-726).

    ``head``: [H,W,n,coords+1+classes]; x,y raw (logistic applied here), t0/classes
    already activated. Every cell*anchor becomes a detection (objectness := 1);
    prob_j = t0*class_j zeroed at <= thresh; anchors are in grid units.
    """
    lh, lw, n = head.shape[:3]
    anchors = np.asarray(anchors, dtype=np.float32)
    cols = np.arange(lw, dtype=np.float32)[None, :, None]
    rows = np.arange(lh, dtype=np.float32)[:, None, None]

    def logistic(v):
        return 1.0 / (1.0 + np.exp(-v))

    bx = (cols + logistic(head[..., 0])) / lw
    by = (rows + logistic(head[..., 1])) / lh
    bw = np.exp(head[..., 2]) * anchors[0::2][None, None, :n] / lw
    bh = np.exp(head[..., 3]) * anchors[1::2][None, None, :n] / lh
    scale = head[..., coords].copy()
    if classfix == -1:
        scale[scale < 0.5] = 0.0
    if tree is not None:
        # YOLO9000 hierarchy decode (reference: get_region_boxes_cpu,
        # src/yolov2_forward_network.c:688-716)
        from ..tree import hierarchy_predictions
        preds = hierarchy_predictions(head[..., coords + 1:], tree)
        if class_map is not None:
            # map-file path (reference: src/yolov2_forward_network.c:694-698):
            # prob_j = scale * preds[map[j]] for j < len(map), zeroed at <= thresh;
            # columns past the map stay zero (reference rows are l.classes wide
            # with only the mapped prefix written)
            cm = np.asarray(class_map)
            sel = preds[..., cm] * scale[..., None]
            sel[sel <= thresh] = 0.0
            probs = np.zeros(preds.shape[:-1] + (classes,), np.float32)
            probs[..., : cm.size] = sel
        else:
            # keep only the deepest (highest-index) node with pred > 0.5 per box;
            # prob_j = (scale > thresh) ? pred_j : 0
            keep_idx = np.where(
                (preds > 0.5).any(-1),
                preds.shape[-1] - 1 - np.argmax((preds > 0.5)[..., ::-1], axis=-1),
                -1)
            probs = np.zeros_like(preds)
            has = keep_idx >= 0
            idx = np.nonzero(has)
            probs[idx + (keep_idx[has],)] = preds[idx + (keep_idx[has],)]
            probs = np.where((scale > thresh)[..., None], probs, 0.0)
    else:
        probs = head[..., coords + 1:] * scale[..., None]
        probs[probs <= thresh] = 0.0

    # order: cell-major, anchor inner (index = cell*n + anchor) ✔
    bbox = np.stack([bx, by, bw, bh], axis=-1).reshape(lh * lw * n, 4)
    probs = probs.reshape(lh * lw * n, classes)
    dt = np.float64 if head.dtype == np.float64 else np.float32  # see yolo path
    objectness = np.ones(lh * lw * n, dt)
    bbox = correct_boxes(bbox.astype(dt), w, h, netw, neth, relative, letter)
    return Detections(bbox.astype(dt), objectness,
                      probs.astype(dt))


def get_network_boxes(head_outputs, head_specs, w: int, h: int,
                      netw: int, neth: int, thresh: float,
                      relative: bool = True, letter: bool = False,
                      class_map=None) -> Detections:
    """Decode all heads of one image (reference: get_network_boxes,
    src/additionally.c:4403). ``head_outputs``: list of np arrays [H,W,n,entries]
    (batch already sliced); ``head_specs``: matching YoloSpec/RegionSpec list.

    ``class_map`` mirrors the reference's caller-supplied ``map`` argument (every
    reference CLI call site passes 0, src/main.c:228); when None, a region head's
    cfg-parsed ``map=`` list (spec.class_map) is used, making the cfg option
    reachable. The yolo decode accepts but ignores map, like the reference
    (get_yolo_detections never reads it, src/additionally.c:4328-4358)."""
    from ..cfg import RegionSpec, YoloSpec
    parts = []
    for out, spec in zip(head_outputs, head_specs):
        if isinstance(spec, YoloSpec):
            parts.append(get_yolo_detections(
                out, spec.mask, spec.anchors, spec.classes, w, h, netw, neth,
                thresh, relative, letter, spec.scale_x_y))
        elif isinstance(spec, RegionSpec):
            cm = class_map if class_map is not None else spec.class_map
            parts.append(get_region_detections(
                out, spec.anchors, spec.classes, spec.coords, spec.classfix,
                w, h, netw, neth, thresh, relative, letter,
                tree=spec.softmax_tree, class_map=cm))
    if not parts:
        return Detections.empty(0)
    return Detections.concat(parts)


# ---------------------------------------------------------------------------
# IoU + NMS
# ---------------------------------------------------------------------------


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of center-format boxes [N,4] x [M,4] -> [N,M]
    (reference: box_iou/box_intersection/overlap, src/box.c:70-97).
    Negative-overlap => intersection 0; IoU = inter/union with no epsilon."""
    ax1 = a[:, 0] - a[:, 2] / 2
    ax2 = a[:, 0] + a[:, 2] / 2
    ay1 = a[:, 1] - a[:, 3] / 2
    ay2 = a[:, 1] + a[:, 3] / 2
    bx1 = b[:, 0] - b[:, 2] / 2
    bx2 = b[:, 0] + b[:, 2] / 2
    by1 = b[:, 1] - b[:, 3] / 2
    by2 = b[:, 1] + b[:, 3] / 2
    iw = np.minimum(ax2[:, None], bx2[None, :]) - np.maximum(ax1[:, None], bx1[None, :])
    ih = np.minimum(ay2[:, None], by2[None, :]) - np.maximum(ay1[:, None], by1[None, :])
    inter = np.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


# cache the nl x nl IoU matrix only up to this many live rows (matches
# native/nms.cpp's 16384-row adjacency-bitset cap); beyond it, rows are
# computed on the fly — O(nl) memory instead of O(nl^2)
_IOU_CACHE_MAX_ROWS = 16384


def _nms_compaction_order(objectness: np.ndarray):
    """The reference's zero-objectness swap loop (box.c:299-309): scanning
    from the front, each zero det swaps with the current end (the swapped-in
    det is re-examined). Returns the full permutation (original det indices
    in the reference's array order) and the live count."""
    idx = np.arange(objectness.shape[0])
    k = idx.size - 1
    i = 0
    while i <= k:
        if objectness[idx[i]] == 0:
            idx[i], idx[k] = idx[k], idx[i]
            k -= 1
        else:
            i += 1
    return idx, k + 1


def do_nms_sort(dets: Detections, classes: int, thresh: float) -> Detections:
    """Per-class greedy NMS, in place on ``prob``
    (reference: do_nms_sort, src/box.c:296-328).

    Semantics: per class, walk detections in descending prob; a surviving box zeroes
    the class-prob of any later box with IoU > thresh. Zero-objectness detections are
    excluded entirely (the reference swaps them past the end first).

    Tie order matches the reference exactly: glibc's qsort is a stable
    mergesort (probed in tests/test_nms_tie_order.py) with a comparator that
    returns 0 on equal probs (box.c:280-294), the swap-compaction loop sets
    the pre-sort order, and each class's sort permutes the array the NEXT
    class's stable sort sees (box.c:310-317 re-sorts the mutated array). On
    tie-free workloads this reduces to independent per-class stable sorts;
    on tie-degenerate ones (random weights emit thousands of exact-duplicate
    probs) the surviving-box choice — and through transitive suppression the
    detection COUNT — depends on it (found by the generative map fuzz:
    detections_count 52207 vs 52209 on a 55k-box net).

    Sets ``dets.nms_order``: original det indices in the reference's
    POST-NMS array order (live permutation, then the compacted
    zero-objectness tail) for consumers that must iterate like the
    reference (map record insertion, print/draw tie order).
    """
    if dets.n == 0:
        dets.nms_order = np.zeros(0, np.int64)
        return dets
    from ..native import nms_sort_native
    if dets.prob.flags["C_CONTIGUOUS"] and dets.prob.dtype == np.float32:
        order = nms_sort_native(dets.bbox, dets.prob, dets.objectness, thresh)
        if order is not None:
            dets.nms_order = order
            return dets
    idx, nl = _nms_compaction_order(dets.objectness)
    live0 = idx[:nl].copy()          # initial live order (fixed IoU rows)
    perm = live0.copy()              # evolves class by class
    prob = dets.prob
    row = np.full(dets.n, -1, np.int64)
    row[live0] = np.arange(nl)
    # The cached nl x nl matrix is O(nl^2) f32 — the tie-degenerate fuzz nets
    # reach ~55k live dets (~12 GB). Mirror the native path's cap
    # (native/nms.cpp): above it, IoU rows are computed on the fly instead.
    use_cache = nl <= _IOU_CACHE_MAX_ROWS
    iou_cache = None                 # class-independent, built once
    for k in range(classes):
        col = prob[perm, k]
        if not (col > 0).any():
            continue                 # all keys equal: the sort is a no-op
        perm = perm[np.argsort(-col, kind="stable")]
        if use_cache and iou_cache is None:
            iou_cache = box_iou(dets.bbox[live0], dets.bbox[live0])
        # descending sort puts positives in the prefix; zero-prob dets
        # neither suppress nor change when re-zeroed
        npos = int((prob[perm, k] > 0).sum())
        for oi in range(npos):
            i = perm[oi]
            if prob[i, k] == 0:
                continue
            rest = perm[oi + 1:npos]
            if use_cache:
                ious = iou_cache[row[i], row[rest]]
            else:
                ious = box_iou(dets.bbox[i: i + 1], dets.bbox[rest])[0]
            prob[rest[ious > thresh], k] = 0.0
    dets.nms_order = np.concatenate([perm, idx[nl:]])
    return dets


def do_nms_sort_v2(boxes: np.ndarray, probs: np.ndarray, classes: int,
                   thresh: float) -> None:
    """Legacy sorted NMS over a dense (boxes, probs-matrix) pair, in place
    (reference: do_nms_sort_v2, src/box.c:249-277 — dead from the reference CLI,
    kept for component parity like the old INT8 pipeline).

    Differs from :func:`do_nms_sort` in that there is no objectness prefilter:
    every box participates, per class, in descending-prob order."""
    total = boxes.shape[0]
    if total == 0:
        return
    iou = box_iou(boxes, boxes)
    for k in range(classes):
        order = np.argsort(-probs[:, k], kind="stable")
        for oi in range(total):
            i = order[oi]
            if probs[i, k] == 0:
                continue
            rest = order[oi + 1:]
            probs[rest[iou[i, rest] > thresh], k] = 0.0


def do_nms(boxes: np.ndarray, probs: np.ndarray, classes: int,
           thresh: float) -> None:
    """Legacy unsorted pairwise NMS, in place (reference: do_nms,
    src/box.c:330-348 — dead from the reference CLI, kept for component parity).

    For each overlapping pair (i, j<i...N), the smaller per-class prob is zeroed
    (ties zero the later box); box i is skipped entirely only when all its probs
    are already zero when its turn comes."""
    total = boxes.shape[0]
    if total == 0:
        return
    iou = box_iou(boxes, boxes)
    for i in range(total):
        if not (probs[i] > 0).any():
            continue
        for j in range(i + 1, total):
            if iou[i, j] > thresh:
                i_smaller = probs[i] < probs[j]
                probs[i, i_smaller] = 0.0
                probs[j, ~i_smaller] = 0.0


def in_reference_order(dets: Detections) -> Detections:
    """``dets`` permuted to the reference's POST-NMS array order
    (``do_nms_sort``'s ``nms_order``). The reference's print/draw/map loops
    all iterate the qsort-permuted array, so stable downstream sorts break
    ties by THAT order, not decode order. Identity when NMS never ran
    (decode order IS the reference order there) and on the device-NMS path,
    whose rows arrive pre-suppressed AND pre-permuted: the chip computes the
    carried-qsort permutation itself (post/device_nms.py, round 5)."""
    order = getattr(dets, "nms_order", None)
    if order is None or dets.n == 0:
        return dets
    return Detections(dets.bbox[order], dets.objectness[order],
                      dets.prob[order])


# ---------------------------------------------------------------------------
# Text output (parity with draw_detections_v3 stdout, src/main.c:80-103)
# ---------------------------------------------------------------------------


def _c_round(v: float) -> float:
    """C99 ``round()``: half away from zero, SIGN-PRESERVING — a left_x in
    (-0.5, 0) prints as ``-0`` under the reference's ``%4.0f`` (main.c:93).
    Python's ``round`` is banker's rounding and returns int 0 there, which
    printed as ``0`` (caught by a CLI diff against the oracle). The floor
    formulation backs off the one float where ``|v|+0.5`` rounds up past the
    true half (0.49999999999999994)."""
    import math
    r = math.floor(abs(v) + 0.5)
    if r - 0.5 > abs(v):   # r-0.5 is exact for integral r, unlike r-abs(v)
        r -= 1.0
    return math.copysign(r, v)


def format_detections(dets: Detections, names, thresh: float, im_w: int, im_h: int,
                      ext_output: bool = True) -> str:
    """Reference print: best-class detections sorted by left edge; line
    ``name: P%\\t(left_x: ... top_y: ... width: ... height: ...)`` plus extra lines for
    other classes above thresh (src/main.c:38-103). The left-edge qsort is
    stable, so equal-left boxes print in the POST-NMS array order."""
    dets = in_reference_order(dets)
    lines = []
    best_class = np.full(dets.n, -1)
    best_prob = np.full(dets.n, thresh,
                        dets.prob.dtype if dets.n else np.float32)
    for j in range(dets.prob.shape[1]):
        better = dets.prob[:, j] > best_prob
        best_class[better] = j
        best_prob[better] = dets.prob[better, j]
    sel = np.nonzero(best_class >= 0)[0]
    lefts = dets.bbox[sel, 0] - dets.bbox[sel, 2] / 2
    for i in sel[np.argsort(lefts, kind="stable")]:
        bc = best_class[i]
        x, y, bw, bh = dets.bbox[i]
        line = f"{names[bc]}: {dets.prob[i, bc] * 100:.0f}%"
        if ext_output:
            line += ("\t(left_x: {:4.0f}   top_y: {:4.0f}   width: {:4.0f}   "
                     "height: {:4.0f})").format(
                _c_round((x - bw / 2) * im_w), _c_round((y - bh / 2) * im_h),
                _c_round(bw * im_w), _c_round(bh * im_h))
        lines.append(line)
        for j in range(dets.prob.shape[1]):
            if dets.prob[i, j] > thresh and j != bc:
                lines.append(f"{names[j]}: {dets.prob[i, j] * 100:.0f}%")
    return "\n".join(lines)
