"""On-device exact greedy NMS.

Counterpart of ``yolo2_light_tpu/post/device_nms.py`` (``pairwise_iou``,
``nms_probs_with_order``, ``nms_probs``, ``nms_packed``), the device form of
``do_nms_sort`` (src/box.c:296-328): per class, walk candidates in
descending-prob order; a surviving box zeroes the class-prob of any later
box with IoU > thresh. The packed candidate buffer that leaves the card is
then already suppressed.

Semantics (each matches the host oracle in post/boxes.py):

* The sequential-greedy recurrence is exact: a *suppressed* box never
  suppresses. The walk over ranks (``ops/nms_walk``: a hand kernel on the
  card, its plain twin on the CPU) runs all classes at once after one [K, K]
  IoU matrix.
* Tie order is qsort-CARRY exact: the reference re-sorts the SAME array class
  after class (box.c:310-317), so class c's stable sort tie-breaks on the
  permutation classes 0..c-1 left behind. Every sort key is an ORIGINAL prob,
  so the whole chain of stable argsorts is computed up front and the
  per-class walks stay independent. Given rows in the reference's pre-NMS
  array order (``decode_and_compact(decode_order=True)``), the surviving set
  AND the post-NMS array order (``perm``) match the host path on exact-prob
  ties.
* NMS here runs BEFORE ``correct_boxes`` (the reference corrects first,
  src/additionally.c:4403-4407). The correction is a per-axis affine scale,
  under which IoU is invariant, so the suppressed set is identical (modulo
  float rounding at exact ``iou == thresh`` boundaries).
* A candidate with zero objectness has all-zero probs (probs are
  objectness-scaled at decode), so it neither suppresses nor changes when
  "suppressed": the reference's swap-to-end prefilter needs no handling.

Everything here is device ops of fixed shapes with no host sync, so it runs
inside a captured CUDA graph. Memory: the [B, K, K] IoU matrix, 64 MB an
image at K = 4096 (the pipeline's device-NMS ceiling).
"""

from __future__ import annotations

import torch

from ..ops.nms_walk import nms_walk, pack_rows


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """[..., K, 4] center-format (x,y,w,h) -> [..., K, K] IoU (reference math:
    box_iou/box_intersection/overlap, src/box.c:70-97: negative overlap =>
    intersection 0; union <= 0 => IoU 0; no epsilon)."""
    x, y, w, h = boxes.unbind(-1)
    x1, x2 = x - w / 2, x + w / 2
    y1, y2 = y - h / 2, y + h / 2
    iw = (torch.minimum(x2[..., :, None], x2[..., None, :])
          - torch.maximum(x1[..., :, None], x1[..., None, :]))
    ih = (torch.minimum(y2[..., :, None], y2[..., None, :])
          - torch.maximum(y1[..., :, None], y1[..., None, :]))
    inter = torch.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    area = w * h
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def walk_inputs(boxes: torch.Tensor, probs: torch.Tensor, thresh: float):
    """What the rank walk (``ops/nms_walk``) reads, for boxes [B,K,4] and
    probs [B,K,C]: (over_bits [B,K,W] int32, order [B,C,K] int32,
    rank_has_work [B,K] f32, perm [B,K]), ``perm`` being the post-NMS array
    order."""
    b, k, c = probs.shape
    over = pairwise_iou(boxes) > thresh
    # order[:, c, t] = candidate at sorted position t of class c: class c's
    # order is the stable descending sort of the order class c-1 left
    # behind (the carried qsort); all keys are original probs
    perm = torch.arange(k, device=probs.device).expand(b, k)
    orders = []
    for ci in range(c):
        col = torch.take_along_dim(probs[..., ci], perm, dim=1)
        perm = torch.take_along_dim(
            perm, torch.argsort(-col, dim=1, stable=True), dim=1)
        orders.append(perm)
    order = (torch.stack(orders, dim=1) if c
             else torch.zeros((b, 0, k), dtype=torch.int64,
                              device=probs.device))
    # ranks past the last nonzero prob (in EVERY class) are padding or
    # sub-threshold slots: the walk stops at the first of them
    rank_has_work = torch.sort(probs, dim=1, descending=True).values.amax(
        dim=2) if c else torch.zeros((b, k), device=probs.device)
    return (pack_rows(over), order.to(torch.int32).contiguous(),
            rank_has_work.contiguous(), perm)


def _nms_batch(boxes: torch.Tensor, probs: torch.Tensor, thresh: float):
    """:func:`nms_probs_with_order` over a batch: boxes [B,K,4], probs
    [B,K,C] -> (probs [B,K,C], perm [B,K])."""
    over_bits, order, rank_has_work, perm = walk_inputs(boxes, probs, thresh)
    return nms_walk(over_bits, order, rank_has_work, probs.contiguous()), perm


def nms_probs_with_order(boxes, probs, thresh: float):
    """Greedy per-class NMS over one image's candidates.

    ``boxes``: [K,4]; ``probs``: [K,C]. Returns ``(probs, perm)``: probs with
    suppressed entries zeroed, in the ORIGINAL row order (do_nms_sort's
    in-place semantics), and ``perm`` = the reference's post-NMS array order
    (original row indices after the last class's qsort — what
    ``Detections.nms_order`` is on the host path)."""
    out, perm = _nms_batch(torch.as_tensor(boxes)[None],
                           torch.as_tensor(probs)[None], thresh)
    return out[0], perm[0]


def nms_probs(boxes, probs, thresh: float):
    """:func:`nms_probs_with_order` without the permutation (suppressed
    probs only, original row order)."""
    return nms_probs_with_order(boxes, probs, thresh)[0]


def nms_packed(packed, thresh: float, reorder: bool = True):
    """Apply the NMS to a packed [B, K, 4+1+classes] candidate buffer
    (columns: box(4), objectness, probs...). Returns the buffer with
    suppressed probs zeroed. With ``reorder`` (default) rows additionally
    leave in the reference's POST-NMS array order (the host path's
    ``nms_order``), given the buffer was built with ``decode_order=True``."""
    packed = torch.as_tensor(packed)
    new_probs, perm = _nms_batch(packed[..., :4], packed[..., 5:], thresh)
    out = torch.cat([packed[..., :5], new_probs], dim=-1)
    if reorder:
        out = torch.take_along_dim(out, perm[..., None], dim=1)
    return out
