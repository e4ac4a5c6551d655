"""``-bf16``'s float conv (``ops/bf16_conv``, kernel K6 on the card) on the
CPU: its plain twin against the JAX package's bfloat16 conv
(``conv2d_fp32(compute_dtype=bfloat16)``, ``preferred_element_type=
float32``), its batch invariance, the launch planner, the weight layout,
and the ``-bf16`` Predictor and ``detector test`` against JAX at b=1 and
b=2.

Tolerances, each with its reason:
* a conv: 1e-5 of the conv's largest magnitude, as
  tests/test_torch_precision_yolov3.py holds yolov3's convs (the float32
  sums of the same exact bfloat16 products, in another order);
* the Predictor's heads: test_torch_precision.py's ``bf16`` bound (rtol and
  atol 0.1, mean error below 2e-2: a sum within an ULP of a bfloat16
  boundary of the next conv's input rounds the other way, one bfloat16
  step that travels downstream), and 1e-4 / 1e-5 where only layer 0 and
  the heads are bfloat16 convs (int8 mode);
* batch invariance: bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_parity import assert_streams_match, parse_detection_lines
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models.network import Predictor as JaxPredictor
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.models import layers as TL
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.ops import bf16_conv as B
from yolo2_light_tpu_torch.ops import int8_conv as K
from yolo2_light_tpu_torch.params import layer_to_torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
IMAGE = os.path.join(DATA, "dog160.png")


def _operands(seed, b, h, w, c, m, ks):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(ks, ks, c, m) / np.sqrt(ks * ks * c)).astype(
        np.float32)
    return x, w_hwio


# (B, H, W, C, M, ks, stride, pad): 1x1, 3x3/s1, 3x3/s2, the first conv's
# C = 3, and ragged channel counts (C not a multiple of the 16-channel
# slab, M of the 64-channel tile)
SHAPES = [(2, 13, 13, 64, 255, 1, 1, 0), (1, 20, 18, 32, 48, 3, 1, 1),
          (2, 21, 17, 16, 40, 3, 2, 1), (1, 33, 31, 3, 32, 3, 1, 1),
          (2, 9, 11, 20, 70, 3, 1, 1), (1, 8, 8, 6, 5, 1, 2, 0)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("act", ["leaky", "linear"])
def test_plain_twin_matches_jax_bf16_conv(shape, act):
    """``layers.conv2d_fp32(compute_dtype=bfloat16)`` (the plain twin on the
    CPU, with BN, bias and the activation) against JAX's."""
    b, h, w, c, m, ks, stride, pad = shape
    x, w_hwio = _operands(h * c + m, b, h, w, c, m, ks)
    rng = np.random.RandomState(m)
    bias = rng.randn(m).astype(np.float32)
    bn = (rng.rand(m).astype(np.float32) + 0.5,
          rng.randn(m).astype(np.float32) * 0.1,
          rng.rand(m).astype(np.float32) + 0.5)
    ref = np.asarray(JL.conv2d_fp32(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(bias), stride, pad,
        act, bn=tuple(map(jnp.asarray, bn)), compute_dtype=jnp.bfloat16))
    wt = layer_to_torch({"weights": w_hwio}, "cpu",
                        weights_dtype=torch.bfloat16)["weights"]
    out = TL.conv2d_fp32(torch.from_numpy(x), wt, torch.from_numpy(bias),
                         stride, pad, act, bn=tuple(map(torch.from_numpy, bn)),
                         compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES[:4],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_twin_batch_invariant(shape):
    """The plain twin's result for image 0 of a batch of 2 equals its
    result for that image alone, bit for bit (the property K6 pins on the
    card)."""
    b, h, w, c, m, ks, stride, pad = shape
    x, w_hwio = _operands(7, 2, h, w, c, m, ks)
    wt = B.kernel_weights(torch.from_numpy(w_hwio).permute(3, 2, 0, 1))
    xt = torch.from_numpy(x)
    two = B.conv2d_bf16(xt, wt, stride, pad)
    one = B.conv2d_bf16(xt[:1].contiguous(), wt, stride, pad)
    assert torch.equal(two[:1], one)


def test_cpu_dispatch_is_the_plain_twin_and_counts_no_launch():
    x, w_hwio = _operands(3, 1, 10, 10, 8, 16, 3)
    wt = B.kernel_weights(torch.from_numpy(w_hwio).permute(3, 2, 0, 1))
    K.reset_launch_counts()
    a = B.conv2d_bf16(torch.from_numpy(x), wt, 1, 1)
    assert not K.LAUNCH_COUNTS
    assert torch.equal(a, B.conv2d_bf16_plain(torch.from_numpy(x), wt, 1, 1))
    # the plain twin convolves the bfloat16-rounded operands in float32
    xr = torch.from_numpy(x).to(torch.bfloat16).to(torch.float32)
    ref = torch.nn.functional.conv2d(
        xr.permute(0, 3, 1, 2), wt.permute(0, 3, 1, 2).to(torch.float32),
        padding=1).permute(0, 2, 3, 1)
    assert torch.equal(a, ref)


def test_bf16_weights_are_laid_out_once_for_the_kernel():
    """-bf16's float weights: PyTorch's [O, I, kh, kw] shape in
    channels-last memory, whose [M, ks, ks, C] view the kernel reads
    without a copy; float32 weights keep the dense layout."""
    _, w_hwio = _operands(1, 1, 1, 1, 5, 7, 3)
    bf = layer_to_torch({"weights": w_hwio}, "cpu",
                        weights_dtype=torch.bfloat16)["weights"]
    f32 = layer_to_torch({"weights": w_hwio}, "cpu")["weights"]
    assert bf.shape == f32.shape == (7, 5, 3, 3)
    assert bf.dtype == torch.bfloat16 and f32.is_contiguous()
    view = B.kernel_weights(bf)
    assert view.data_ptr() == bf.data_ptr()
    assert torch.equal(view, torch.from_numpy(w_hwio).permute(3, 0, 1, 2).to(
        torch.bfloat16))
    assert torch.equal(bf, f32.to(torch.bfloat16))


def _cfg_shapes(name="yolov3"):
    """The distinct conv shapes (H, W, C, M, ks, stride, pad) of a cfg of
    tests/data at 416."""
    from yolo2_light_tpu_torch.cfg import ConvSpec
    from yolo2_light_tpu_torch.cfg import parse_network_cfg as tparse
    spec = tparse(os.path.join(DATA, f"{name}.cfg"), batch=1)
    return sorted({(l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
                   for l in spec.layers if isinstance(l, ConvSpec)})


def _yolov3_shapes():
    return _cfg_shapes("yolov3")


def test_planner_never_splits_k_and_ignores_the_batch():
    """At every yolov3-416 conv shape: no field of the plan but the tile
    and block counts changes with the batch (the split of K across a
    cluster is one image's, so the sum order never follows the batch), one
    to three blocks fit an SM, the shared memory fits a
    block, the first conv (C = 3) takes the c3 form, the 3x3 convs the 8x8
    tile, 32-channel slabs at the 1x1 convs and where C >= 512; a 9x9 conv
    fits no tile."""
    shapes = _yolov3_shapes()
    assert len(shapes) == 23
    for h, w, c, m, ks, stride, pad in shapes:
        plans = [B.plan_launch(b, h, w, c, m, ks, stride, pad)
                 for b in (1, 2, 8, 64)]
        assert {p._replace(tiles=0, blocks=0) for p in plans} == {
            plans[0]._replace(tiles=0, blocks=0)}
        assert plans[0].smem <= B.MAX_SMEM
        assert B.blocks_per_sm(plans[0].smem) >= 1
        flat = ks == 1 and stride == 1 and pad == 0
        form = "c3" if c == 3 else "flat" if flat else "halo"
        assert plans[0].form == form
        assert (plans[0].tile_h == 0) == (form != "halo")
        if form != "c3":
            assert plans[0].kc == (32 if c % 32 == 0 and (flat or c >= 512)
                                   else 16)
            assert (plans[0].tile_h, plans[0].tile_w) in ((0, 0), (8, 8))
            assert plans[0].slabs == -(-c // plans[0].kc)
            assert 1 <= plans[0].split <= min(8, plans[0].slabs)
        assert plans[2].blocks == 8 * plans[0].blocks or form != "halo"
    with pytest.raises(ValueError, match="no tile"):
        B.plan_launch(1, 16, 16, 8, 8, 9, 1, 4)


@pytest.mark.parametrize("name", ["yolov3", "yolov2-voc"])
def test_plan_is_the_same_at_b_1_8_128(name):
    """The planner's form, tile, slab width, split and ring depth at b = 1,
    8 and 128 are equal at every conv shape of the cfg at 416: every field
    of the plan but the counts of tiles and blocks comes from one image's
    shape."""
    for shape in _cfg_shapes(name):
        plans = [B.plan_launch(b, *shape) for b in (1, 8, 128)]
        keys = {(p.form, p.tile_h, p.tile_w, p.kc, p.split, p.stages,
                 p.halo_rows, p.m_tiles, p.slabs, p.smem) for p in plans}
        assert len(keys) == 1, (shape, plans)


@pytest.mark.parametrize("name", ["yolov3", "yolov2-voc"])
def test_every_plan_fits_shared_memory(name):
    for shape in _cfg_shapes(name):
        plan = B.plan_launch(1, *shape)
        assert 0 < plan.smem <= 232448, (shape, plan)


def test_split_fills_the_card_at_13x13():
    """At b=1 every 13x13 conv of yolov3-416 reaches the card's 132 SMs in
    blocks, or the split cap (8, or half its slab count), or half the
    card's block slots at its plan's shared memory (where doubling the
    split would take a second wave: the 3x3 512->1024 conv's 128 blocks at
    one block an SM); and every conv whose input is 13x13 or 26x26 splits
    K, in a power of two."""
    tested = 0
    for h, w, c, m, ks, stride, pad in _yolov3_shapes():
        plan = B.plan_launch(1, h, w, c, m, ks, stride, pad)
        if h == 13:
            slots = 132 * B.blocks_per_sm(plan.smem)
            assert (plan.blocks >= 132 or 2 * plan.blocks >= slots
                    or plan.split == min(8, plan.slabs // 2)), plan
            tested += 1
        assert plan.split in (1, 2, 4, 8)
        if h in (13, 26):
            assert plan.split > 1, (h, c, m, ks, stride, plan)
    assert tested >= 4


@pytest.mark.parametrize("slabs,split", [(1, 1), (2, 2), (3, 2), (16, 3),
                                         (32, 6), (32, 8), (40, 7), (5, 5)])
def test_slab_ranges_cover_k_once_in_order(slabs, split):
    ranges = B.slab_ranges(slabs, split)
    assert len(ranges) == split
    assert ranges[0][0] == 0 and ranges[-1][1] == slabs
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo < hi == lo2
    assert [s for lo, hi in ranges for s in range(lo, hi)] == list(
        range(slabs))


@pytest.mark.parametrize("ks", [1, 3])
def test_c3_weight_padding_is_exact(ks):
    """The c3 form's ``[M, 32]`` rows: each filter's ks*ks*3 bfloat16 values
    in the order of its ``[ks, ks, C]`` row, then zeros; ``params`` keeps
    them beside -bf16's weights of a first conv only."""
    _, w_hwio = _operands(4, 1, 1, 1, 3, 32, ks)
    p = layer_to_torch({"weights": w_hwio}, "cpu",
                       weights_dtype=torch.bfloat16)
    k32 = p["weights_k32"]
    assert k32.shape == (32, 32) and k32.dtype == torch.bfloat16
    assert k32.is_contiguous()
    rows = torch.from_numpy(w_hwio).permute(3, 0, 1, 2).reshape(32, -1).to(
        torch.bfloat16)
    assert torch.equal(k32[:, :ks * ks * 3], rows)
    assert not k32[:, ks * ks * 3:].any()
    assert torch.equal(B.pad_k32(B.kernel_weights(p["weights"])), k32)
    assert B.plan_launch(1, 16, 16, 3, 32, ks, 1, ks // 2).form == "c3"
    _, w8 = _operands(4, 1, 1, 1, 8, 32, 3)
    assert "weights_k32" not in layer_to_torch(
        {"weights": w8}, "cpu", weights_dtype=torch.bfloat16)
    assert "weights_k32" not in layer_to_torch({"weights": w_hwio}, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        B.pad_k32(torch.zeros(4, 5, 5, 3, dtype=torch.bfloat16))


def _epilogue_inputs(m, bn_on):
    rng = np.random.RandomState(m + bn_on)
    bias = torch.from_numpy(rng.randn(m).astype(np.float32))
    bn = None
    if bn_on:
        bn = (torch.from_numpy(rng.rand(m).astype(np.float32) + 0.5),
              torch.from_numpy(rng.randn(m).astype(np.float32) * 0.1),
              torch.from_numpy(rng.rand(m).astype(np.float32) + 0.5))
    return bias, bn


@pytest.mark.parametrize("act", ["leaky", "linear", "logistic"])
@pytest.mark.parametrize("bn_on", [False, True], ids=["bias", "bn"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3], SHAPES[4]],
                         ids=lambda s: "x".join(map(str, s)))
def test_epilogue_plain_after_twin_equals_conv2d_fp32_bf16(shape, bn_on,
                                                           act):
    """The fused conv's twin, ``conv2d_bf16_plain`` then ``epilogue_plain``
    (then the activation where the kernel's store has none; an unfused BN
    between the two as PyTorch ops, as ``conv2d_fp32`` runs it), is
    bit-equal to ``layers.conv2d_fp32(compute_dtype=bfloat16)`` on the CPU
    and to the chain conv2d_fp32 ran before the epilogue moved into the
    kernel: the f32 conv of the bf16-rounded operands, ``(y - mean) /
    (sqrt(var) + 1e-6) * scales``, ``+ bias``, the activation."""
    b, h, w, c, m, ks, stride, pad = shape
    x, w_hwio = _operands(h + m, b, h, w, c, m, ks)
    bias, bn = _epilogue_inputs(m, bn_on)
    p = layer_to_torch({"weights": w_hwio}, "cpu",
                       weights_dtype=torch.bfloat16)
    xt = torch.from_numpy(x)
    xr = xt.to(torch.bfloat16).to(torch.float32).permute(0, 3, 1, 2)
    ref = torch.nn.functional.conv2d(
        xr, p["weights"].to(torch.float32), stride=stride,
        padding=pad).permute(0, 2, 3, 1).contiguous()
    if bn is not None:
        denom = torch.sqrt(bn[2]) + 1e-6
        ref = (ref - bn[1]) / denom * bn[0]
    ref = TL.activate(ref + bias, act)
    wk = B.kernel_weights(p["weights"])
    twin = B.conv2d_bf16_plain(xt, wk, stride, pad)
    if bn is not None:
        twin = (twin - bn[1]) / (torch.sqrt(bn[2]) + 1e-6) * bn[0]
    twin = B.epilogue_plain(twin, bias, act)
    if act not in B.STORE_ACTIVATIONS:
        twin = TL.activate(twin, act)
    got = TL.conv2d_fp32(xt, p["weights"], bias, stride, pad, act, bn=bn,
                         compute_dtype=torch.bfloat16,
                         weights_k32=p.get("weights_k32"))
    assert torch.equal(twin, ref)
    assert torch.equal(got, ref)


def _tiny_cfg_params(name, quantized):
    path = os.path.join(DATA, f"{name}.cfg")
    jspec, jparams, mode = jax_build_params(path, None, quantized=quantized,
                                            seed=3, echo=False)
    spec, params, _ = build_params(path, None, quantized=quantized, seed=3,
                                   echo=False)
    return jspec, jparams, spec, params, mode


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2"])
def test_bf16_predictor_matches_jax(name, quantized, batch):
    jspec, jparams, spec, params, mode = _tiny_cfg_params(name, quantized)
    x = np.random.RandomState(7).rand(batch, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    ref = JaxPredictor(jspec, jparams, mode, compute_dtype=jnp.bfloat16)(x)
    out = Predictor(spec, params, mode, device="cpu",
                    compute_dtype=torch.bfloat16)(x)
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        d, rr = o.data.numpy(), np.asarray(r.data)
        if quantized:
            np.testing.assert_allclose(d, rr, rtol=1e-4, atol=1e-5)
        else:
            gap = B.heads_gap(o.data, torch.tensor(rr))
            assert gap.within == 1.0 and gap.mean < B.HEADS_MEAN, gap


@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2"])
def test_bf16_predictor_batch_rows_equal_single_images(name):
    """Each image of a batch of 2 gives the heads it gives alone, bit for
    bit: the port's -bf16 forward is batch-invariant on the CPU."""
    _, _, spec, params, mode = _tiny_cfg_params(name, False)
    pred = Predictor(spec, params, mode, device="cpu",
                     compute_dtype=torch.bfloat16)
    x = np.random.RandomState(8).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    both = pred(x)
    for i in range(2):
        for a, b in zip(both, pred(x[i:i + 1])):
            assert torch.equal(a.data[i:i + 1], b.data)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2"])
def test_bf16_detector_test_streams_match_jax_cli(tmp_path, capsys, name,
                                                  quantized):
    cfg = os.path.join(DATA, f"{name}.cfg")
    spec = parse_network_cfg(cfg, batch=1)
    weights = str(tmp_path / "w.weights")
    save_weights(spec, random_params(spec, seed=1), weights)
    names = str(tmp_path / "n.names")
    with open(names, "w") as f:
        f.write("\n".join(f"c{i}" for i in range(20)) + "\n")
    args = ["detector", "test", names, cfg, weights, IMAGE, "-thresh",
            "0.1" if quantized else "0.3", "-dont_show",
            "-bf16"] + (["-quantized"] if quantized else [])
    capsys.readouterr()
    rc_j = jax_main(args + ["-save", str(tmp_path / "jax")])
    out_j, err_j = capsys.readouterr()
    rc_t = torch_main(args + ["-save", str(tmp_path / "torch"), "-device",
                              "cpu"])
    out_t, err_t = capsys.readouterr()
    assert rc_j == rc_t == 0, err_t[-2000:]
    assert parse_detection_lines(out_t)[0]
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")
