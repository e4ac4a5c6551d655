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


def _yolov3_shapes():
    from yolo2_light_tpu_torch.cfg import ConvSpec
    from yolo2_light_tpu_torch.cfg import parse_network_cfg as tparse
    spec = tparse(os.path.join(DATA, "yolov3.cfg"), batch=1)
    return sorted({(l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
                   for l in spec.layers if isinstance(l, ConvSpec)})


def test_planner_never_splits_k_and_ignores_the_batch():
    """At every yolov3-416 conv shape: the tile and ring depth do not
    change with the batch, no plan splits K, two or three blocks fit an SM,
    and the shared memory fits a block; a 9x9 conv fits no tile."""
    shapes = _yolov3_shapes()
    assert len(shapes) == 23
    for h, w, c, m, ks, stride, pad in shapes:
        plans = [B.plan_launch(b, h, w, c, m, ks, stride, pad)
                 for b in (1, 2, 8, 64)]
        assert {(p.tile_h, p.tile_w, p.stages, p.smem) for p in plans} == {
            (plans[0].tile_h, plans[0].tile_w, plans[0].stages,
             plans[0].smem)}
        assert "split" not in B.Plan._fields
        assert plans[0].smem <= B.MAX_SMEM
        assert B.blocks_per_sm(plans[0].smem) >= 2
        assert plans[0].slabs == -(-c // B.SLAB)
        flat = ks == 1 and stride == 1 and pad == 0
        assert (plans[0].tile_h == 0) == flat
        assert plans[2].blocks == 8 * plans[0].blocks or flat
    with pytest.raises(ValueError, match="no tile"):
        B.plan_launch(1, 16, 16, 8, 8, 9, 1, 4)


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
