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
  card, its plain twin on the CPU) runs all classes at once after the
  overlap bits of every pair.
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

On the card the stage is two hand kernels, K7 (``ops/nms_order``: the overlap
bits, every class's order, the highest prob at each rank) and the walk, both
reading the packed buffer's views in place; no IoU matrix or argsort runs.
Everything is of fixed shapes with no host sync, so it runs inside a
captured CUDA graph. Memory: the bit rows, K*K/8 bytes an image (2 MB at
K = 4096, the pipeline's device-NMS ceiling), and C*K int32 of order; the
plain version on the CPU builds the [B, K, K] IoU matrix.
"""

from __future__ import annotations

import torch

from ..ops import nms_order as _order
from ..ops import nms_walk as _walk
from ..ops.nms_order import pairwise_iou  # noqa: F401  (the module's API)


def load_kernels(device) -> None:
    """Build and bind both kernels and set K7's shared memory limit on
    ``device``, before any capture."""
    dev = torch.device(device)
    _walk.load_kernel()
    _order.prepare(torch.cuda.current_device() if dev.index is None
                   else dev.index)


def walk_inputs(boxes: torch.Tensor, probs: torch.Tensor, thresh: float):
    """What the rank walk (``ops/nms_walk``) reads, for boxes [B,K,4] and
    probs [B,K,C]: (over_bits [B,K,W] int32, order [B,C,K] int32,
    rank_has_work [B,K] f32, perm [B,K]), ``perm`` being the post-NMS array
    order (``ops/nms_order``)."""
    return _order.nms_order(boxes, probs, thresh)


def _nms_batch(boxes: torch.Tensor, probs: torch.Tensor, thresh: float):
    """:func:`nms_probs_with_order` over a batch: boxes [B,K,4], probs
    [B,K,C] -> (probs [B,K,C], perm [B,K])."""
    over_bits, order, rank_has_work, perm = walk_inputs(boxes, probs, thresh)
    return _walk.nms_walk(over_bits, order, rank_has_work, probs), perm


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
