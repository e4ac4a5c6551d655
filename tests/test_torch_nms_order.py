"""K7's plain version (``ops/nms_order.nms_order_plain``, what the rank walk
reads: the overlap bit rows, the carried chain of stable argsorts, the
highest prob at each rank and the post-NMS order) against the JAX package's
chain, and both against a reference shaped as the kernel computes it
(partition each class into nonzero and zero probs, then rank the nonzero
ones by counting on a unique composite key), on the CPU.

The JAX chain is computed by the same ``jnp`` calls as
``yolo2_light_tpu/post/device_nms.nms_probs_with_order``; every comparison
is exact (order, perm and bit rows equal; rank_has_work equal as values,
where -0.0 == +0.0). The card's kernel is held to the plain version bit for
bit in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo2_light_tpu.post import device_nms as JDN
from yolo2_light_tpu_torch.ops import nms_order as NO
from yolo2_light_tpu_torch.ops import nms_walk as NW
from yolo2_light_tpu_torch.post import device_nms as TDN

THRESH = 0.45


def _inputs(seed, b, k, c, flavour):
    """Clustered boxes and thresholded probs with trailing zero rows (as the
    device-NMS tests of the JAX package build them), then ``flavour``."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, k, 4).astype(np.float32)
    boxes[..., 2:] = 0.05 + 0.3 * boxes[..., 2:]
    centers = rng.rand(b, max(1, k // 8), 2)
    which = rng.randint(0, centers.shape[1], (b, k))
    boxes[..., :2] = (np.take_along_axis(centers, which[..., None], 1)
                      + 0.02 * rng.randn(b, k, 2))
    probs = rng.rand(b, k, c).astype(np.float32)
    probs[probs < 0.6] = 0.0
    probs[:, k - k // 5:] = 0.0
    if flavour != "plain":
        probs = (np.round(probs * 8) / 8).astype(np.float32)   # exact ties
    if flavour == "signed_zeros":
        probs = np.where((probs == 0) & (rng.rand(b, k, c) < 0.5),
                         np.float32(-0.0), probs)
    elif flavour == "negatives":
        neg = rng.rand(b, k, c) < 0.15
        probs = np.where(neg, -np.round(rng.rand(b, k, c) * 4) / 4,
                         probs).astype(np.float32)
        probs = np.where(probs == 0, np.float32(-0.0), probs)
    elif flavour == "zero_class":
        probs[:, :, c // 2] = 0.0
        probs[0] = 0.0                                # an all-zero image
    elif flavour == "dense":
        probs[:, :, 0] = 0.125 + np.round(rng.rand(b, k) * 4) / 8  # n_c = K
    return boxes, probs.astype(np.float32)


def _jax_chain(boxes, probs, thresh):
    """One image through the JAX package's own calls (device_nms.py:66-93):
    (over [K,K] bool, order [C,K], perm [K], rank_has_work [K])."""
    k, c = probs.shape
    boxes, probs = jnp.asarray(boxes), jnp.asarray(probs)
    over = np.asarray(JDN.pairwise_iou(boxes) > thresh)

    def sort_step(perm, p_col):
        new = perm[jnp.argsort(-p_col[perm], stable=True)]
        return new, new

    perm, order = jax.lax.scan(sort_step, jnp.arange(k, dtype=jnp.int32),
                               probs.T)
    if c:
        sorted_desc = -jnp.sort(-probs, axis=0)
        rhw = np.asarray(jnp.max(sorted_desc, axis=1))
    else:
        rhw = np.zeros(k, np.float32)
    return over, np.asarray(order), np.asarray(perm), rhw


def _desc_key(v):
    """The kernel's sort key of nonzero floats: ascending key = descending
    value (csrc/nms_order.cu, desc_key)."""
    u = v.astype(np.float32).view(np.uint32)
    ordered = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return (~ordered).astype(np.uint32)


def _kernel_chain(probs):
    """One image's chain as K7 computes it: for each class, the zeros keep
    their previous order after the positives (a prefix count); the nonzero
    entries, compacted in previous order, take as new rank the count of
    composite keys (desc_key << 32 | compacted index) below their own, the
    negatives placed after the zeros. rank_has_work is the running maximum
    of the values placed at each rank, made +0.0 where it is -0.0."""
    k, c = probs.shape
    order = np.arange(k)
    orders, best = [], np.zeros(k, np.float32)
    for ci in range(c):
        v = probs[order, ci]
        nz = v != 0
        n_pos, n_zero = int((v > 0).sum()), int(k - nz.sum())
        new = np.empty(k, np.int64)
        vals = np.empty(k, np.float32)
        zi = np.flatnonzero(~nz)
        new[n_pos + np.arange(zi.size)] = order[zi]
        vals[n_pos + np.arange(zi.size)] = v[zi]
        ni = np.flatnonzero(nz)
        d = _desc_key(v[ni])
        keys = (d.astype(np.uint64) << np.uint64(32)) | np.arange(
            ni.size, dtype=np.uint64)
        rank = (keys[None, :] < keys[:, None]).sum(1)
        at = rank + np.where(d >> 31, n_zero, 0)
        new[at] = order[ni]
        vals[at] = v[ni]
        best = vals if ci == 0 else np.where(vals > best, vals, best)
        order = new
        orders.append(order)
    return (np.stack(orders) if c else np.zeros((0, k), np.int64), order,
            (best + np.float32(0.0)).astype(np.float32))


def _kernel_bits(boxes, thresh):
    """IoU > thresh as K7's bits blocks compute it: float32 steps in the
    plain path's order, the division only where the boxes intersect."""
    f = np.float32
    x, y, w, h = (boxes[:, i].astype(f) for i in range(4))
    hw, hh = w * f(0.5), h * f(0.5)
    x1, x2, y1, y2, a = x - hw, x + hw, y - hh, y + hh, w * h
    th = f(thresh)
    iw = np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None])
    ih = np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None])
    cut = (iw < 0) | (ih < 0)
    inter = np.where(cut, f(0), iw * ih)
    uni = (a[:, None] + a[None]) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou_over = np.where(uni > 0, inter / uni, f(0)) > th
    return np.where(cut | ~(uni > 0), f(0) > th, iou_over)


CASES = [(2, 64, 3, "plain"), (1, 37, 1, "ties"), (3, 100, 20, "ties"),
         (2, 256, 7, "signed_zeros"), (2, 96, 5, "negatives"),
         (3, 33, 20, "zero_class"), (2, 128, 4, "dense"), (1, 1, 1, "ties"),
         (2, 200, 20, "negatives"), (1, 255, 2, "dense")]


@pytest.mark.parametrize("b,k,c,flavour", CASES,
                         ids=[f"{b}x{k}x{c}-{f}" for b, k, c, f in CASES])
def test_plain_matches_jax_chain_and_kernel_shaped_reference(b, k, c,
                                                             flavour):
    boxes, probs = _inputs(b * 1000 + k + c, b, k, c, flavour)
    over, order, rhw, perm = NO.nms_order_plain(
        torch.from_numpy(boxes), torch.from_numpy(probs), THRESH)
    assert over.dtype == torch.int32 and order.dtype == torch.int32
    assert rhw.dtype == torch.float32 and perm.dtype == torch.int64
    for i in range(b):
        j_over, j_order, j_perm, j_rhw = _jax_chain(boxes[i], probs[i],
                                                    THRESH)
        np.testing.assert_array_equal(NW.unpack_rows(over, k)[i].numpy(),
                                      j_over)
        np.testing.assert_array_equal(order[i].numpy(), j_order)
        np.testing.assert_array_equal(perm[i].numpy(), j_perm)
        np.testing.assert_array_equal(rhw[i].numpy(), j_rhw)
        k_order, k_perm, k_rhw = _kernel_chain(probs[i])
        np.testing.assert_array_equal(order[i].numpy(), k_order)
        np.testing.assert_array_equal(perm[i].numpy(), k_perm)
        # the kernel's rank_has_work bit for bit (signed zeros included)
        np.testing.assert_array_equal(rhw[i].numpy().view(np.int32),
                                      k_rhw.view(np.int32))
        np.testing.assert_array_equal(
            NW.unpack_rows(over, k)[i].numpy(), _kernel_bits(boxes[i],
                                                             THRESH))


def test_no_classes_gives_the_identity():
    boxes, probs = _inputs(5, 2, 40, 1, "plain")
    over, order, rhw, perm = NO.nms_order_plain(
        torch.from_numpy(boxes), torch.from_numpy(probs[..., :0]), THRESH)
    assert order.shape == (2, 0, 40)
    assert torch.equal(perm, torch.arange(40).expand(2, 40))
    assert torch.equal(rhw.view(torch.int32), torch.zeros((2, 40),
                                                          dtype=torch.int32))
    k_order, k_perm, k_rhw = _kernel_chain(probs[0, :, :0])
    np.testing.assert_array_equal(k_perm, np.arange(40))
    assert k_order.shape == (0, 40) and not k_rhw.any()


def _boundary_boxes():
    """Pairs of boxes whose IoU in float32 is exactly 1/3 (rounded up from
    the exact value) or 0.5, beside pairs just inside and outside, and
    touching, disjoint and degenerate boxes."""
    rows = []
    for dx in (0.5, 0.5 + 2 ** -20, 0.5 - 2 ** -20):
        rows += [[0.5, 0.5, 1.0, 1.0], [0.5 + dx, 0.5, 1.0, 1.0]]
    rows += [[2.0, 2.0, 1.0, 1.0], [2.0, 2.0 + 1 / 3, 1.0, 1.0],
             [4.0, 4.0, 1.0, 1.0], [5.0, 4.0, 1.0, 1.0],     # touching
             [7.0, 7.0, 0.0, 1.0], [7.0, 7.0, 0.0, 1.0],     # zero area
             [9.0, 9.0, 0.5, 0.5], [9.0, 9.0, 0.25, 0.25]]   # nested: 1/4
    return np.asarray(rows, np.float32)


@pytest.mark.parametrize("thresh", [1 / 3, float(np.float32(1 / 3)),
                                    float(np.nextafter(np.float32(1 / 3),
                                                       np.float32(0))),
                                    0.25, 0.0, -1.0])
def test_bit_rows_at_iou_equal_to_thresh(thresh):
    """IoU == thresh in float32 is no overlap, with thresh rounded to float32
    as PyTorch's and JAX's scalar comparisons round it (f32(1/3) is above
    1/3, the IoU of the first pair)."""
    boxes = _boundary_boxes()
    k = boxes.shape[0]
    over = NO.nms_order_plain(torch.from_numpy(boxes)[None],
                              torch.ones((1, k, 1)), thresh)[0]
    got = NW.unpack_rows(over, k)[0].numpy()
    want = np.asarray(JDN.pairwise_iou(jnp.asarray(boxes)) > thresh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _kernel_bits(boxes, thresh))
    np.testing.assert_array_equal(
        got, (TDN.pairwise_iou(torch.from_numpy(boxes)) > thresh).numpy())
    iou = np.asarray(JDN.pairwise_iou(jnp.asarray(boxes)))
    if thresh in (1 / 3, 0.25):
        assert (iou == np.float32(thresh)).any()      # a pair sits on it


def test_walk_inputs_dispatch_to_the_plain_version_on_the_cpu():
    boxes, probs = _inputs(11, 2, 80, 6, "ties")
    got = TDN.walk_inputs(torch.from_numpy(boxes), torch.from_numpy(probs),
                          THRESH)
    want = NO.nms_order_plain(torch.from_numpy(boxes),
                              torch.from_numpy(probs), THRESH)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_packed_buffer_views_give_what_contiguous_copies_give():
    """nms_packed hands K7 and the walk views of the packed buffer (batch
    and row strides of 5 + C floats); the result is that of copies."""
    boxes, probs = _inputs(12, 2, 64, 5, "ties")
    packed = torch.from_numpy(np.concatenate(
        [boxes, np.ones((2, 64, 1), np.float32), probs], axis=-1))
    got = TDN.nms_packed(packed, THRESH, reorder=False)
    new, _ = TDN._nms_batch(torch.from_numpy(boxes), torch.from_numpy(probs),
                            THRESH)
    assert torch.equal(got[..., 5:], new)
    assert torch.equal(got[..., :5], packed[..., :5])


def test_nms_order_refuses_another_device():
    meta = torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        NO.nms_order(meta, torch.empty((1, 8, 2), device="meta"), THRESH)
