"""Tests of the port that need an NVIDIA GPU: the int8 conv kernel (both
input entries, every cluster split and ring depth), the fused residual-block
kernel and the two XNOR bit kernels against their plain PyTorch versions on
the card, the wrappers' refusals, and the Predictor's kernel paths against
its plain path and the CPU.

They skip without a CUDA device. This file imports neither JAX nor the JAX
package's tests, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.models import layers as L
from yolo2_light_tpu_torch.ops import fused_res as FR
from yolo2_light_tpu_torch.ops import int8_conv as K
from yolo2_light_tpu_torch.ops import xnor_gemm as XG
from yolo2_light_tpu_torch.xnor import pack_sign_weights

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(dev, seed, b, h, w, c, m, ks):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randint(-127, 128, (b, h, w, c)).astype(np.int8))
    wt = torch.from_numpy(rng.randint(-127, 128, (m, ks, ks, c)).astype(
        np.int8))
    bias = torch.from_numpy(rng.randn(m).astype(np.float32))
    return x.to(dev), wt.to(dev), bias.to(dev)


@pytest.mark.parametrize("b,h,w,c,m,ks,stride,pad", [
    (1, 52, 52, 128, 256, 3, 1, 1),      # yolov3 3x3/s1
    (1, 416, 416, 32, 64, 3, 2, 1),      # yolov3 3x3/s2 downsample
    (1, 13, 13, 1024, 512, 1, 1, 0),     # yolov3 1x1
    (3, 11, 9, 36, 70, 3, 2, 1),         # ragged tiles, K not a step multiple
    (2, 7, 5, 4, 3, 3, 1, 1),            # C = 4, M < one channel tile
    (1, 1, 1, 4, 1, 1, 1, 0),
    (5, 6, 6, 12, 65, 1, 2, 0),
])
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_kernel_bit_identical_to_plain(dev, b, h, w, c, m, ks, stride, pad,
                                       activation):
    x, wt, bias = _operands(dev, h * c + m, b, h, w, c, m, ks)
    alpha = K.alpha_f32(40.0, 16.0)
    out = K.conv2d_int8_cuda(x, wt, bias, alpha, stride, pad, activation)
    ref = K.conv2d_int8_plain(x, wt, bias, alpha, stride, pad, activation)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)
    cpu = K.conv2d_int8_plain(x.cpu(), wt.cpu(), bias.cpu(), alpha, stride,
                              pad, activation)
    assert torch.equal(out.cpu(), cpu)


# yolov3-416's int8 conv classes (size, stride, output size), at the widths
# yolov3 gives them: (b, h, w, c, m, ks, stride, pad)
YOLOV3_CLASSES = [
    (1, 208, 208, 64, 32, 1, 1, 0), (1, 104, 104, 128, 64, 1, 1, 0),
    (1, 52, 52, 256, 128, 1, 1, 0), (1, 26, 26, 512, 256, 1, 1, 0),
    (1, 13, 13, 1024, 512, 1, 1, 0),
    (1, 208, 208, 32, 64, 3, 1, 1), (1, 104, 104, 64, 128, 3, 1, 1),
    (1, 52, 52, 128, 256, 3, 1, 1), (1, 26, 26, 256, 512, 3, 1, 1),
    (1, 13, 13, 512, 1024, 3, 1, 1),
    (1, 416, 416, 32, 64, 3, 2, 1), (1, 208, 208, 64, 128, 3, 2, 1),
    (1, 104, 104, 128, 256, 3, 2, 1), (1, 52, 52, 256, 512, 3, 2, 1),
    (1, 26, 26, 512, 1024, 3, 2, 1),
]
RAGGED = [
    (3, 11, 9, 36, 70, 3, 2, 1),
    (2, 7, 5, 4, 3, 3, 1, 1),
    (1, 1, 1, 4, 1, 1, 1, 0),
    (5, 6, 6, 12, 65, 1, 2, 0),
]


def _f32_operands(dev, seed, b, h, w, c, m, ks):
    """An f32 map whose quantized values cover the int8 range, with exact
    zeros and values on bin edges, and int8 weights."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32) * 4
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[1::11] = 2.5          # 2.5 * 40 = 100 exactly
    wt = rng.randint(-127, 128, (m, ks, ks, c)).astype(np.int8)
    bias = rng.randn(m).astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(wt).to(dev),
            torch.from_numpy(bias).to(dev))


@pytest.mark.parametrize("shape", YOLOV3_CLASSES + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_f32_entry_bit_identical_to_plain(dev, shape, activation):
    """The f32-input entry (input quantize in the kernel's loader) against
    quantize_i8 + the plain int8 conv, on the card and on the CPU."""
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, bias = _f32_operands(dev, h * c + m, b, h, w, c, m, ks)
    alpha = K.alpha_f32(40.0, 16.0)
    K.reset_launch_counts()
    out = K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, alpha, stride, pad,
                                 activation)
    assert K.PRE_LAUNCHES["quantize"] == 0
    ref = K.conv2d_int8_f32_plain(x, wt, bias, 40.0, alpha, stride, pad,
                                  activation)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)
    cpu = K.conv2d_int8_f32_plain(x.cpu(), wt.cpu(), bias.cpu(), 40.0, alpha,
                                  stride, pad, activation)
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("shape", YOLOV3_CLASSES,
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_entry_bit_identical_at_yolov3_classes(dev, shape):
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, bias = _operands(dev, h * c + m, b, h, w, c, m, ks)
    alpha = K.alpha_f32(40.0, 16.0)
    out = K.conv2d_int8_cuda(x, wt, bias, alpha, stride, pad, "leaky")
    ref = K.conv2d_int8_plain(x, wt, bias, alpha, stride, pad, "leaky")
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", [
    (1, 13, 13, 1024, 512, 1, 1, 0), (1, 13, 13, 512, 1024, 3, 1, 1),
    (1, 26, 26, 512, 1024, 3, 2, 1), (3, 11, 9, 36, 70, 3, 2, 1),
    (2, 7, 5, 260, 20, 1, 1, 0),
], ids=lambda s: "x".join(map(str, s)))
def test_every_cluster_split_bit_identical(dev, shape):
    """Each split of K across a cluster, 1 to 8 blocks (as many as there
    are slabs), in both input forms, against the plain version."""
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, bias = _f32_operands(dev, c + m, b, h, w, c, m, ks)
    x8 = K.quantize_i8(x, 40.0)
    alpha = K.alpha_f32(40.0, 16.0)
    ref = K.conv2d_int8_plain(x8, wt, bias, alpha, stride, pad, "leaky")
    for f32 in (True, False):
        base = K.plan_launch(b, h, w, c, m, ks, stride, pad, f32)
        for split in range(1, min(K.MAX_SPLIT, base.slabs) + 1):
            plan = base._replace(split=split)
            if f32:
                out = K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, alpha, stride,
                                             pad, "leaky", plan=plan)
            else:
                out = K.conv2d_int8_cuda(x8, wt, bias, alpha, stride, pad,
                                         "leaky", plan=plan)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (f32, split)


@pytest.mark.parametrize("shape", [
    (1, 13, 13, 512, 1024, 3, 1, 1), (1, 26, 26, 256, 512, 3, 2, 1),
    (2, 7, 5, 260, 20, 1, 1, 0), (3, 11, 9, 36, 70, 3, 2, 1),
], ids=lambda s: "x".join(map(str, s)))
def test_every_ring_depth_bit_identical(dev, shape):
    """Each depth of the copy ring that fits shared memory (2 to 4 slabs),
    in both input forms, with and without a split, against the plain
    version."""
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, bias = _f32_operands(dev, c + 3 * m, b, h, w, c, m, ks)
    x8 = K.quantize_i8(x, 40.0)
    alpha = K.alpha_f32(40.0, 16.0)
    ref = K.conv2d_int8_plain(x8, wt, bias, alpha, stride, pad, "linear")
    for f32 in (True, False):
        base = K.plan_launch(b, h, w, c, m, ks, stride, pad, f32)
        for stages in K.STAGES:
            if K._smem_bytes(base.halo_rows, ks * ks, f32,
                             stages) > K.MAX_SMEM:
                continue
            for split in {1, min(2, base.slabs), base.split}:
                plan = base._replace(stages=stages, split=split)
                if f32:
                    out = K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, alpha,
                                                 stride, pad, "linear",
                                                 plan=plan)
                else:
                    out = K.conv2d_int8_cuda(x8, wt, bias, alpha, stride, pad,
                                             "linear", plan=plan)
                torch.cuda.synchronize()
                assert torch.equal(out, ref), (f32, stages, split)


def test_5x5_conv_takes_smaller_tiles_bit_identical(dev):
    """5x5 convs: where two blocks of 8x8 tiles do not fit an SM, the planner
    takes 4x8 tiles (the f32-input entry at stride 2, whose f32 halo stages
    are large; the int8-input entry at stride 1, whose four-stage weight
    ring is); every plan stays exact."""
    for stride, f32_tile, int8_tile in ((2, (4, 8), (8, 8)),
                                        (1, (8, 8), (4, 8))):
        b, h, w, c, m, ks, pad = 2, 12, 10, 48, 40, 5, 2
        assert K.plan_launch(b, h, w, c, m, ks, stride, pad,
                             True)[:2] == f32_tile
        assert K.plan_launch(b, h, w, c, m, ks, stride, pad,
                             False)[:2] == int8_tile
        x, wt, bias = _f32_operands(dev, 5, b, h, w, c, m, ks)
        out = K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, 0.05, stride, pad)
        ref = K.conv2d_int8_f32_plain(x, wt, bias, 40.0, 0.05, stride, pad)
        out8 = K.conv2d_int8_cuda(K.quantize_i8(x, 40.0), wt, bias, 0.05,
                                  stride, pad)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and torch.equal(out8, ref)


def test_saturating_requant_on_card(dev):
    """All-127 operands over K = 9 * 1024 drive the accumulator far past the
    int16 clamp, in both signs."""
    x = torch.full((1, 5, 5, 1024), 127, dtype=torch.int8, device=dev)
    wt = torch.full((8, 3, 3, 1024), 127, dtype=torch.int8, device=dev)
    wt[4:] = -127
    bias = torch.zeros(8, device=dev)
    out = K.conv2d_int8_cuda(x, wt, bias, 1.0, 1, 1, "linear")
    ref = K.conv2d_int8_plain(x, wt, bias, 1.0, 1, 1, "linear")
    assert torch.equal(out, ref)
    assert out[0, 2, 2, 0].item() == 32767 and out[0, 2, 2, 4].item() == -32767


def test_wrapper_counts_launches_and_dispatches_to_kernel(dev):
    x, wt, bias = _operands(dev, 1, 1, 8, 8, 16, 16, 3)
    K.reset_launch_counts()
    K.conv2d_int8(x, wt, bias, 0.05, 1, 1)
    K.conv2d_int8_plain(x, wt, bias, 0.05, 1, 1)
    assert K.LAUNCH_COUNTS["int8_conv"] == 1
    xf = x.float() / 40
    K.conv2d_int8_f32(xf, wt, bias, 40.0, 0.05, 1, 1)
    assert K.LAUNCH_COUNTS["int8_conv"] == 2
    assert sum(K.PRE_LAUNCHES.values()) == 0
    K.conv2d_int8_f32_plain(xf, wt, bias, 40.0, 0.05, 1, 1)
    assert K.LAUNCH_COUNTS["int8_conv"] == 2
    assert K.PRE_LAUNCHES["quantize"] == 1


def test_int8_layer_on_card_is_one_launch(dev):
    """layers.conv2d_int8 on a CUDA tensor: one kernel launch, no quantize
    launch, and a strided input made dense (counted)."""
    x = torch.rand(1, 16, 9, 7, device=dev).permute(0, 2, 3, 1)
    wt = torch.randint(-127, 128, (24, 3, 3, 16), dtype=torch.int8,
                       device=dev)
    bias = torch.zeros(24, device=dev)
    K.reset_launch_counts()
    out = L.conv2d_int8(x, wt, bias, 1, 1, "leaky", 40.0, 0.05)
    assert K.LAUNCH_COUNTS["int8_conv"] == 1
    assert dict(K.PRE_LAUNCHES) == {"input_copy": 1}
    ref = L.conv2d_int8(x, wt, bias, 1, 1, "leaky", 40.0, 0.05, plain=True)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["channels", "dtype", "contiguity",
                                  "device", "shape"])
def test_f32_wrapper_refuses_what_the_kernel_does_not_take(dev, case):
    x, wt, bias = _f32_operands(dev, 2, 1, 6, 6, 8, 8, 3)
    if case == "channels":
        x, wt = x[..., :6].contiguous(), wt[..., :6].contiguous()
        err = ValueError
    elif case == "dtype":
        x, err = x.to(torch.int8), TypeError
    elif case == "contiguity":
        x, err = x.permute(0, 2, 1, 3), ValueError
    elif case == "device":
        bias, err = bias.cpu(), ValueError
    else:
        wt, err = wt[:, :, :2].contiguous(), ValueError
    K.reset_launch_counts()
    with pytest.raises(err):
        K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, 0.05, 1, 1)
    assert K.LAUNCH_COUNTS["int8_conv"] == 0


@pytest.mark.parametrize("case", ["channels", "dtype", "contiguity",
                                  "device", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(dev, case):
    x, wt, bias = _operands(dev, 2, 1, 6, 6, 8, 8, 3)
    if case == "channels":
        x, wt = x[..., :6].contiguous(), wt[..., :6].contiguous()
        err = ValueError
    elif case == "dtype":
        x, err = x.to(torch.int32), TypeError
    elif case == "contiguity":
        x, err = x.permute(0, 2, 1, 3), ValueError
    elif case == "device":
        bias, err = bias.cpu(), ValueError
    else:
        wt, err = wt[:, :, :2].contiguous(), ValueError
    K.reset_launch_counts()
    with pytest.raises(err):
        K.conv2d_int8_cuda(x, wt, bias, 0.05, 1, 1)
    assert K.LAUNCH_COUNTS["int8_conv"] == 0


@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2", "mini-res"])
def test_int8_kernel_path_equals_plain_path(dev, name):
    spec, params, _ = build_params(os.path.join(DATA, f"{name}.cfg"), None,
                                   quantized=True, echo=False)
    x = np.random.RandomState(3).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    kernel = Predictor(spec, params, "int8", device=dev)(x)
    plain = Predictor(spec, params, "int8", device=dev,
                      int8_impl="plain")(x)
    for a, b in zip(kernel, plain):
        assert torch.equal(a.data, b.data)


def test_int8_forward_of_an_image_batch_makes_no_launch_in_front(dev):
    """``detector test`` feeds ``im[None]``, a batch of one whose batch
    stride is 0: the forward still launches K1 once per int8 conv and
    nothing to quantize or densify its inputs."""
    spec, params, _ = build_params(os.path.join(DATA, "mini-yolo3.cfg"), None,
                                   quantized=True, echo=False)
    im = np.random.RandomState(5).rand(spec.net.h, spec.net.w,
                                       3).astype(np.float32)
    pred = Predictor(spec, params, "int8", device=dev)
    K.reset_launch_counts()
    heads = pred(im[None])
    n_int8 = sum(1 for l in spec.conv_layers()
                 if l.index >= 1 and l.activation != "linear")
    assert K.LAUNCH_COUNTS["int8_conv"] == n_int8 >= 1
    assert not any(K.PRE_LAUNCHES.values()), dict(K.PRE_LAUNCHES)
    for a, b in zip(heads, pred(np.ascontiguousarray(im[None]).copy())):
        assert torch.equal(a.data, b.data)


@pytest.mark.parametrize("name", ["mini-yolo3", "mini-yolo2", "mini-res"])
def test_fp32_card_matches_cpu(dev, name):
    spec, params, _ = build_params(os.path.join(DATA, f"{name}.cfg"), None,
                                   echo=False)
    x = np.random.RandomState(4).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    on_card = Predictor(spec, params, device=dev)(x)
    on_cpu = Predictor(spec, params, device="cpu")(x)
    assert not torch.backends.cudnn.allow_tf32
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(a.data.cpu(), b.data, rtol=1e-4,
                                   atol=1e-5)


def _block(dev, seed, b, h, w, c, c2, b1_shift=2.0):
    """A trunk and one residual block's kernel arguments; b1 > 0 so a wrong
    halo mask (quantizing the zero-padded trunk) shows on the border."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32) * 4)
    m1, m2 = np.float32(rng.uniform(8, 24)), np.float32(rng.uniform(8, 24))
    args = dict(
        w1=torch.from_numpy(rng.randint(-127, 128, (c2, 1, 1, c)).astype(
            np.int8)).to(dev),
        b1=torch.from_numpy((rng.randn(c2) + b1_shift).astype(
            np.float32)).to(dev),
        m1=float(m1), alpha1=K.alpha_f32(m1, rng.uniform(64, 256)),
        w2=torch.from_numpy(rng.randint(-127, 128, (c, 3, 3, c2)).astype(
            np.int8)).to(dev),
        b2=torch.from_numpy(rng.randn(c).astype(np.float32)).to(dev),
        m2=float(m2), alpha2=K.alpha_f32(m2, rng.uniform(64, 256)))
    return x.to(dev), args


@pytest.mark.parametrize("b,h,w,c,c2", [
    (1, 208, 208, 64, 32),        # yolov3-416's five residual stages
    (1, 104, 104, 128, 64),
    (1, 52, 52, 256, 128),
    (1, 26, 26, 512, 256),
    (1, 13, 13, 1024, 512),       # clusters of 16 (non-portable size)
    (2, 11, 9, 36, 20),           # ragged tiles, C2 words not a step multiple
    (3, 5, 7, 8, 4),
    (1, 1, 1, 4, 4),
    (2, 30, 17, 200, 100),        # C not a multiple of the 64-channel slab
    (1, 13, 13, 96, 48),          # C2 % 32 != 0, C2 % 16 == 0
    (2, 10, 12, 132, 68),         # C % 16 != 0 (4-byte copies), cluster of 3
    (1, 9, 9, 64, 2048),          # the widest t1 the kernel takes
    (2, 13, 13, 1024, 512),       # b = 2 at yolov3's 13x13 stage
])
def test_fused_kernel_bit_identical_to_plain(dev, b, h, w, c, c2):
    x, args = _block(dev, h * c + c2, b, h, w, c, c2)
    keep = x.clone()
    out = FR.fused_res_block_cuda(x, **args)
    ref = FR.res_block_plain(x, **args)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert torch.equal(x, keep)
    cpu = FR.res_block_plain(x.cpu(), **{k: v.cpu() if torch.is_tensor(v)
                                         else v for k, v in args.items()})
    assert torch.equal(out.cpu(), cpu)


@pytest.mark.parametrize("b,h,c,c2", [(1, 104, 128, 64), (2, 13, 64, 32)])
def test_fused_chain_of_two_alternates_buffers(dev, b, h, c, c2):
    x, a1 = _block(dev, 11, b, h, h, c, c2)
    _, a2 = _block(dev, 12, b, h, h, c, c2, b1_shift=-1.0)
    keep = x.clone()
    K.reset_launch_counts()
    out = FR.run_blocks(x, [a1, a2])
    assert K.LAUNCH_COUNTS["fused_res_block"] == 2
    ref = FR.res_block_plain(FR.res_block_plain(x, **a1), **a2)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(x, keep)


@pytest.mark.parametrize("case", ["device", "dtype", "channels", "c2",
                                  "contiguity", "in_place"])
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(dev, case):
    x, args = _block(dev, 3, 1, 6, 6, 8, 4)
    out, err = None, ValueError
    if case == "device":
        x = x.cpu()
    elif case == "dtype":
        x, err = x.to(torch.int8), TypeError
    elif case == "channels":
        x = x[..., :6].contiguous()
        args["w1"] = args["w1"][..., :6].contiguous()
        args["w2"], args["b2"] = args["w2"][:6].contiguous(), args["b2"][:6]
    elif case == "c2":
        args["w1"], args["b1"] = args["w1"][:3].contiguous(), args["b1"][:3]
        args["w2"] = args["w2"][..., :3].contiguous()
    elif case == "contiguity":
        x = x.permute(0, 2, 1, 3)
    else:
        out = x
    K.reset_launch_counts()
    with pytest.raises(err):
        FR.fused_res_block_cuda(x, out=out, **args)
    assert K.LAUNCH_COUNTS["fused_res_block"] == 0


@pytest.mark.parametrize("c,c2", [(64, 32), (1024, 512), (64, 2048)])
def test_fused_occupancy_reports_a_launch_that_fits(dev, c, c2):
    occ = FR.occupancy(c, c2, dev.index or 0)
    assert occ["cluster"] == min(16, -(-c // 64))
    assert 0 < occ["smem_bytes"] <= 232448
    assert occ["max_active_clusters"] >= 1
    assert 2 <= occ["stages1"] <= 4 and 2 <= occ["stages2"] <= 4
    assert occ["halo_rows_per_pass"] == (64 if c2 == 2048 else 100)


@pytest.mark.parametrize("name", ["mini-res", "mini-yolo3"])
def test_fused_predictor_on_card_equals_k1_and_plain_paths(dev, name):
    """On the card the fused path equals the int8 conv path and the plain
    path bit for bit. Against the CPU it is held to the bound of
    test_fp32_card_matches_cpu: layer 0 is a float32 conv, which cuDNN sums
    in another order than the CPU."""
    spec, params, _ = build_params(os.path.join(DATA, f"{name}.cfg"), None,
                                   quantized=True, echo=False)
    x = np.random.RandomState(5).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    K.reset_launch_counts()
    fused = Predictor(spec, params, "int8", device=dev, int8_impl="fused")(x)
    n_blocks = K.LAUNCH_COUNTS["fused_res_block"]
    k1 = Predictor(spec, params, "int8", device=dev)(x)
    plain = Predictor(spec, params, "int8", device=dev, int8_impl="plain")(x)
    cpu = Predictor(spec, params, "int8", device="cpu",
                    int8_impl="fused")(x)
    assert n_blocks == (3 if name == "mini-res" else 0)
    for a, b, c, d in zip(fused, k1, plain, cpu):
        assert torch.equal(a.data, b.data) and torch.equal(a.data, c.data)
        torch.testing.assert_close(a.data.cpu(), d.data, rtol=1e-4,
                                   atol=1e-5)


def _xnor_operands(dev, seed, b, h, w, c, m, ks=3):
    """Packed input bits, packed and +-1 weights, mean and bias of one XNOR
    conv."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    sign = np.where(rng.randn(ks, ks, c, m) > 0, 1, -1).astype(np.int8)
    mean = torch.from_numpy(rng.uniform(0.01, 0.2, m).astype(np.float32))
    bias = torch.from_numpy(rng.randn(m).astype(np.float32))
    return (x, torch.from_numpy(pack_sign_weights(sign)).to(dev),
            torch.from_numpy(sign).permute(3, 2, 0, 1).float().contiguous().to(
                dev), mean.to(dev), bias.to(dev))


@pytest.mark.parametrize("b,h,w,c,m", [
    (1, 208, 208, 16, 32),        # tiny-yolo-obj_xnor-416's XNOR convs
    (1, 104, 104, 32, 64),
    (1, 52, 52, 64, 128),
    (1, 26, 26, 128, 256),
    (1, 13, 13, 256, 512),
    (1, 13, 13, 512, 1024),
    (1, 13, 13, 1024, 1024),
    (2, 11, 9, 48, 40),           # half-padded words, M not a tile multiple
    (2, 7, 5, 16, 3),             # C = 16, M below one n8 tile
    (3, 1, 1, 33, 70),
    (2, 13, 13, 1024, 1024),      # b = 2 at the widest conv
    (1, 13, 13, 512, 1000),       # M = 1000: a ragged filter tile
    (4, 104, 104, 32, 64),        # P = 43,264 above one image's 104x104
    (2, 9, 9, 40, 24),            # C = 40: kwords = 18, not whole MMA steps
])
@pytest.mark.parametrize("activation", ["leaky", "linear"])
def test_xnor_kernels_bit_identical_to_plain(dev, b, h, w, c, m, activation):
    x, wp, ws, mean, bias = _xnor_operands(dev, h * c + m, b, h, w, c, m)
    xp = XG.pack_activations(x, c)
    k3 = XG.xnor_gemm_cuda(xp, wp, mean, bias, c, 1, 1, activation)
    k4 = XG.xnor_gemm_mxu_cuda(xp, wp, mean, bias, c, 1, 1, activation)
    p3 = XG.xnor_gemm_plain(xp, wp, mean, bias, c, 1, 1, activation)
    p4 = XG.xnor_gemm_mxu_plain(xp, wp, mean, bias, c, 1, 1, activation)
    dense = L.conv2d_xnor(x, ws, mean, bias, 1, 1, activation)
    torch.cuda.synchronize()
    assert k3.shape == (b, h, w, m)
    assert torch.equal(k3, p3) and torch.equal(k4, p4)
    assert torch.equal(k3, dense) and torch.equal(k4, dense)
    cpu = XG.xnor_gemm_plain(xp.cpu(), wp.cpu(), mean.cpu(), bias.cpu(), c, 1,
                             1, activation)
    assert torch.equal(k3.cpu(), cpu)


@pytest.mark.parametrize("name", ["xnor_gemm", "xnor_gemm_mxu"])
@pytest.mark.parametrize("b,h,w,c,m", [
    (1, 26, 26, 128, 256),        # 16-byte copies (C32 % 4 == 0)
    (2, 11, 9, 48, 40),           # 4-byte copies, ragged tiles
])
def test_xnor_every_plan_bit_identical(dev, name, b, h, w, c, m):
    """Every plan kind the kernels take: each 4096-output tile (128x32,
    64x64), and the warp split's 32x32 tile with no split and with
    a split of K across a cluster (2 blocks, and as many as there are
    steps, up to 8); each K step and ring depth, leaky and linear, against
    the plain version."""
    x, wp, _, mean, bias = _xnor_operands(dev, c + 5 * m, b, h, w, c, m)
    xp = XG.pack_activations(x, c)
    c32 = xp.shape[-1]
    kwords = 9 * c32
    engine = "popcount" if name == "xnor_gemm" else "mxu"
    cuda = XG.xnor_gemm_cuda if engine == "popcount" else XG.xnor_gemm_mxu_cuda
    plain = XG.xnor_gemm_plain if engine == "popcount" else \
        XG.xnor_gemm_mxu_plain
    base = XG.plan_launch(b, h, w, c32, m, 3, 1, 1, engine)
    refs = {act: plain(xp, wp, mean, bias, c, 1, 1, act)
            for act in ("leaky", "linear")}
    K.reset_launch_counts()
    n = 0
    for tile_p, tile_m in XG.TILES + (XG.WARP_SPLIT_TILE,):
        for kstep in XG.KSTEPS:
            steps = -(-kwords // kstep)
            splits = {1, min(2, steps), min(XG.MAX_SPLIT, steps)}
            if (tile_p, tile_m) != XG.WARP_SPLIT_TILE:
                splits = {1}
            for split in sorted(splits):
                for stages in (2, XG.MAX_STAGES):
                    plan = XG.make_plan(b * h * w, m, kwords,
                                        (tile_p, tile_m), kstep,
                                        split)._replace(stages=stages)
                    act = ("leaky", "linear")[n % 2]
                    out = cuda(xp, wp, mean, bias, c, 1, 1, act, plan=plan)
                    torch.cuda.synchronize()
                    assert torch.equal(out, refs[act]), plan
                    n += 1
    assert K.LAUNCH_COUNTS[name] == n


@pytest.mark.parametrize("name", ["xnor_gemm", "xnor_gemm_mxu"])
def test_xnor_kernel_refuses_a_plan_it_does_not_take(dev, name):
    x, wp, _, mean, bias = _xnor_operands(dev, 3, 1, 6, 6, 40, 8)
    xp = XG.pack_activations(x, 40)
    engine = "popcount" if name == "xnor_gemm" else "mxu"
    cuda = XG.xnor_gemm_cuda if engine == "popcount" else XG.xnor_gemm_mxu_cuda
    base = XG.plan_launch(1, 6, 6, 2, 8, 3, 1, 1, engine)
    for bad in (base._replace(tile_p=16), base._replace(kstep=24),
                base._replace(split=base.steps + 1),
                base._replace(stages=XG.MAX_STAGES + 1),
                base._replace(tile_p=32, tile_m=64),
                base._replace(tile_p=32, tile_m=128),
                base._replace(tile_p=64, tile_m=64, split=2, kstep=8),
                base._replace(split=XG.MAX_SPLIT + 1)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            cuda(xp, wp, mean, bias, 40, 1, 1, plan=bad)


@pytest.mark.parametrize("ks,stride,pad", [(3, 2, 1), (1, 1, 0), (3, 1, 0)])
def test_xnor_kernels_other_geometries_match_plain(dev, ks, stride, pad):
    """The kernels take any size, stride and pad with 0-bit borders, as
    conv2d_xnor_pallas does (the network gives them stride 1, pad 1 only)."""
    x, wp, _, mean, bias = _xnor_operands(dev, 9, 2, 9, 8, 40, 24, ks)
    xp = XG.pack_activations(x, 40)
    for cuda, plain in ((XG.xnor_gemm_cuda, XG.xnor_gemm_plain),
                        (XG.xnor_gemm_mxu_cuda, XG.xnor_gemm_mxu_plain)):
        out = cuda(xp, wp, mean, bias, 40, stride, pad)
        assert torch.equal(out, plain(xp, wp, mean, bias, 40, stride, pad))


@pytest.mark.parametrize("name", ["xnor_gemm", "xnor_gemm_mxu"])
@pytest.mark.parametrize("case", ["device", "dtype", "mean_dtype", "words",
                                  "contiguity", "activation"])
def test_xnor_wrappers_refuse_what_the_kernel_does_not_take(dev, name, case):
    x, wp, _, mean, bias = _xnor_operands(dev, 4, 1, 6, 6, 40, 8)
    xp = XG.pack_activations(x, 40)
    c, act, err = 40, "leaky", ValueError
    if case == "device":
        xp = xp.cpu()
    elif case == "dtype":
        xp, err = xp.to(torch.int64), TypeError
    elif case == "mean_dtype":
        mean, err = mean.double(), TypeError
    elif case == "words":
        c = 80                    # 3 words per tap, the map holds 2
    elif case == "contiguity":
        xp = xp.permute(0, 2, 1, 3)
    else:
        act = "relu"
    fn = XG.xnor_gemm_cuda if name == "xnor_gemm" else XG.xnor_gemm_mxu_cuda
    K.reset_launch_counts()
    with pytest.raises(err):
        fn(xp, wp, mean, bias, c, 1, 1, act)
    assert K.LAUNCH_COUNTS[name] == 0


@pytest.mark.parametrize("engine", ["int8", "pallas", "pallas_mxu", "auto"])
def test_xnor_predictor_launch_counts_and_heads(dev, engine):
    """One forward of tiny-yolo-obj_xnor-416 launches each bit kernel at the
    seven XNOR convs its engine gives it, and every engine's head map equals
    the dense engine's and the plain versions'."""
    cfg = os.path.join(DATA, "tiny-yolo-obj_xnor.cfg")
    spec, params, _ = build_params(cfg, None, echo=False)
    convs = [l for l in spec.conv_layers() if l.xnor]
    x = np.random.RandomState(6).rand(1, 416, 416, 3).astype(np.float32)
    pred = Predictor(spec, params, device=dev, xnor_impl=engine)
    K.reset_launch_counts()
    heads = pred(x)
    n_auto = sum(XG.auto_prefers_mxu(l.out_h * l.out_w) for l in convs)
    expect = {"int8": (0, 0), "pallas": (7, 0), "pallas_mxu": (0, 7),
              "auto": (0, n_auto)}[engine]
    assert (K.LAUNCH_COUNTS["xnor_gemm"],
            K.LAUNCH_COUNTS["xnor_gemm_mxu"]) == expect
    dense = Predictor(spec, params, device=dev)(x)
    plain = Predictor(spec, params, device=dev, int8_impl="plain",
                      xnor_impl="pallas" if engine == "int8" else engine)(x)
    assert torch.equal(heads[0].data, dense[0].data)
    assert torch.equal(heads[0].data, plain[0].data)


# ---------------------------------------------------------------------------
# The NMS rank walk and the serving pipeline's CUDA graphs
# ---------------------------------------------------------------------------


def _walk_operands(dev, seed, b, k, c, tie_steps=8):
    """Clustered candidates (overlap galore) with quantized probs (exact ties
    galore) and zero-prob padding rows, as the device-NMS tests of the JAX
    package build them; the walk's inputs on ``dev``."""
    from yolo2_light_tpu_torch.post.device_nms import walk_inputs
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, k, 4).astype(np.float32)
    boxes[..., 2:] = 0.05 + 0.3 * boxes[..., 2:]
    centers = rng.rand(b, max(1, k // 8), 2)
    which = rng.randint(0, centers.shape[1], (b, k))
    boxes[..., :2] = (np.take_along_axis(centers, which[..., None], 1)
                      + 0.02 * rng.randn(b, k, 2))
    probs = rng.rand(b, k, c).astype(np.float32)
    probs[probs < 0.6] = 0.0
    probs = (np.round(probs * tie_steps) / tie_steps).astype(np.float32)
    probs[:, k - k // 5:] = 0.0
    boxes_t = torch.from_numpy(boxes).to(dev)
    probs_t = torch.from_numpy(probs).to(dev)
    over, order, rhw, _ = walk_inputs(boxes_t, probs_t, 0.45)
    return over, order, rhw, probs_t


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("b,k,c", [(8, 256, 80), (8, 1024, 80), (8, 4096, 80),
                                   (3, 1000, 7), (1, 1, 1), (2, 33, 3),
                                   (2, 8192, 2)])
def test_nms_walk_kernel_bit_identical_to_plain(dev, b, k, c):
    from yolo2_light_tpu_torch.ops import nms_walk as NW
    over, order, rhw, probs = _walk_operands(dev, k + c, b, k, c)
    K.reset_launch_counts()
    out = NW.nms_walk_cuda(over, order, rhw, probs)
    assert K.LAUNCH_COUNTS["nms_walk"] == 1
    ref = NW.nms_walk_plain(over, order, rhw, probs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(ref))
    assert bool((ref == 0).sum() > (probs == 0).sum()) or k == 1
    if k <= 1024:
        cpu = NW.nms_walk_plain(over.cpu(), order.cpu(), rhw.cpu(),
                                probs.cpu())
        assert torch.equal(_bits(out.cpu()), _bits(cpu))


def test_nms_walk_keeps_signed_zeros_and_stops_at_the_stop_rank(dev):
    """Entries no step zeroes keep their bits (a -0.0 stays -0.0), and no
    rank at or past the first rank without work is walked."""
    from yolo2_light_tpu_torch.ops import nms_walk as NW
    over, order, rhw, probs = _walk_operands(dev, 3, 2, 96, 5)
    probs = torch.where(probs == 0, -0.0, probs)
    rhw = rhw.clone()
    rhw[0, 20] = 0.0               # image 0 stops at rank 20
    out = NW.nms_walk_cuda(over, order, rhw, probs)
    ref = NW.nms_walk_plain(over, order, rhw, probs)
    assert torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "k"])
def test_nms_walk_wrapper_refuses_what_the_kernel_does_not_take(dev, case):
    from yolo2_light_tpu_torch.ops import nms_walk as NW
    over, order, rhw, probs = _walk_operands(dev, 4, 1, 64, 3)
    err = ValueError
    if case == "device":
        probs = probs.cpu()
    elif case == "dtype":
        order, err = order.long(), TypeError
    elif case == "shape":
        rhw = rhw[:, :32].contiguous()
    else:
        probs = torch.zeros((1, NW.MAX_K + 32, 1), device=dev)
        over = torch.zeros((1, NW.MAX_K + 32, NW.words_for(NW.MAX_K + 32)),
                           dtype=torch.int32, device=dev)
        order = torch.zeros((1, 1, NW.MAX_K + 32), dtype=torch.int32,
                            device=dev)
        rhw = torch.zeros((1, NW.MAX_K + 32), device=dev)
    K.reset_launch_counts()
    with pytest.raises(err):
        NW.nms_walk_cuda(over, order, rhw, probs)
    assert K.LAUNCH_COUNTS["nms_walk"] == 0


def _order_operands(dev, seed, b, k, c, flavour="ties"):
    """K7's inputs as the packed buffer holds them (views with a row stride
    of 5 + C floats): clustered boxes, thresholded probs with exact ties and
    trailing zero rows, then ``flavour``."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(b, k, 4).astype(np.float32)
    boxes[..., 2:] = 0.05 + 0.3 * boxes[..., 2:]
    centers = rng.rand(b, max(1, k // 8), 2)
    which = rng.randint(0, centers.shape[1], (b, k))
    boxes[..., :2] = (np.take_along_axis(centers, which[..., None], 1)
                      + 0.02 * rng.randn(b, k, 2))
    probs = rng.rand(b, k, c).astype(np.float32)
    probs[probs < 0.6] = 0.0
    probs = (np.round(probs * 8) / 8).astype(np.float32)
    probs[:, k - k // 5:] = 0.0
    if flavour == "signed_zeros":
        probs = np.where((probs == 0) & (rng.rand(b, k, c) < 0.5),
                         np.float32(-0.0), probs)
    elif flavour == "negatives":
        probs = np.where(rng.rand(b, k, c) < 0.15,
                         -np.round(rng.rand(b, k, c) * 4) / 4, probs)
        probs = np.where(probs == 0, -0.0, probs)
    elif flavour == "zero_class":
        probs[:, :, c // 2] = 0.0
        probs[0] = 0.0
    elif flavour == "dense":
        probs[:, :, 0] = 0.125 + np.round(rng.rand(b, k) * 4) / 8
    packed = np.concatenate([boxes, np.ones((b, k, 1), np.float32),
                             probs.astype(np.float32)], axis=-1)
    packed = torch.from_numpy(packed).to(dev)
    return packed[..., :4], packed[..., 5:]


def _same_inputs(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.contiguous().view(torch.int8),
                           b.contiguous().view(torch.int8))


@pytest.mark.parametrize("b,k,c", [(8, 256, 80), (8, 1024, 80), (8, 4096, 80),
                                   (1, 8192, 80), (3, 1000, 7), (2, 33, 3),
                                   (1, 1, 1), (2, 1024, 20), (1, 2049, 20)])
def test_nms_order_kernel_bit_identical_to_plain(dev, b, k, c):
    from yolo2_light_tpu_torch.ops import nms_order as NO
    boxes, probs = _order_operands(dev, k + c, b, k, c)
    K.reset_launch_counts()
    got = NO.nms_order_cuda(boxes, probs, 0.45)
    assert K.LAUNCH_COUNTS["nms_order"] == 1
    want = NO.nms_order_plain(boxes, probs, 0.45)
    torch.cuda.synchronize()
    _same_inputs(got, want)
    if k <= 1024:
        _same_inputs([t.cpu() for t in got],
                     NO.nms_order_plain(boxes.cpu(), probs.cpu(), 0.45))


@pytest.mark.parametrize("flavour", ["signed_zeros", "negatives",
                                     "zero_class", "dense"])
@pytest.mark.parametrize("count_max", [None, 0, 8192],
                         ids=["planned", "sorted", "runs"])
def test_nms_order_ranks_signed_zeros_negatives_and_dense_classes(
        dev, flavour, count_max):
    """Both ways of ranking a class (sorted runs of 32 keys and binary
    searches, a bitonic sort of all keys) give the plain chain, with -0.0
    tied to +0.0, negatives after the zeros, empty classes and images, and
    a class whose every entry is positive."""
    from yolo2_light_tpu_torch.ops import nms_order as NO
    kw = {} if count_max is None else {"count_max": count_max}
    for b, k, c in ((4, 300, 20), (2, 2048, 80)):
        boxes, probs = _order_operands(dev, k + len(flavour), b, k, c,
                                       flavour)
        got = NO.nms_order_cuda(boxes, probs, 0.45, **kw)
        _same_inputs(got, NO.nms_order_plain(boxes, probs, 0.45))


def test_nms_order_bit_rows_at_iou_equal_to_thresh(dev):
    """Pairs whose float32 IoU is exactly 1/3 or 1/4: no overlap at that
    thresh (rounded to float32), overlap just below it; as the plain path
    computes it on the card and on the CPU."""
    from yolo2_light_tpu_torch.ops import nms_order as NO
    rows = []
    for dx in (0.5, 0.5 + 2 ** -20, 0.5 - 2 ** -20):
        rows += [[0.5, 0.5, 1.0, 1.0], [0.5 + dx, 0.5, 1.0, 1.0]]
    rows += [[4.0, 4.0, 1.0, 1.0], [5.0, 4.0, 1.0, 1.0],
             [7.0, 7.0, 0.0, 1.0], [7.0, 7.0, 0.0, 1.0],
             [9.0, 9.0, 0.5, 0.5], [9.0, 9.0, 0.25, 0.25]]
    boxes = torch.tensor([rows], dtype=torch.float32, device=dev)
    probs = torch.ones((1, boxes.shape[1], 1), device=dev)
    for thresh in (1 / 3, float(np.nextafter(np.float32(1 / 3),
                                             np.float32(0))), 0.25, 0.0,
                   -1.0):
        got = NO.nms_order_cuda(boxes, probs, thresh)[0]
        assert torch.equal(got, NO.nms_order_plain(boxes, probs, thresh)[0])
        assert torch.equal(got.cpu(), NO.nms_order_plain(
            boxes.cpu(), probs.cpu(), thresh)[0])


@pytest.mark.parametrize("case", ["device", "dtype", "shape", "stride", "k"])
def test_nms_order_wrapper_refuses_what_the_kernel_does_not_take(dev, case):
    from yolo2_light_tpu_torch.ops import nms_order as NO
    boxes, probs = _order_operands(dev, 4, 1, 64, 3)
    err = ValueError
    if case == "device":
        boxes = boxes.cpu()
    elif case == "dtype":
        probs, err = probs.double(), TypeError
    elif case == "shape":
        boxes = boxes[:, :32]
    elif case == "stride":
        probs = probs.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        probs = torch.zeros((1, NO.MAX_K + 32, 1), device=dev)
        boxes = torch.zeros((1, NO.MAX_K + 32, 4), device=dev)
    K.reset_launch_counts()
    with pytest.raises(err):
        NO.nms_order_cuda(boxes, probs, 0.45)
    assert K.LAUNCH_COUNTS["nms_order"] == 0


def _aten_ops(fn):
    """The ATen operators ``fn()`` dispatches (a dispatch mode's record, no
    profiler session), and its result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        out = fn()
    return set(rec.ops), out


def test_nms_stage_runs_two_kernels_and_no_sort(dev):
    """On the card the NMS of a packed buffer is K7, the walk, and the
    concatenation and gather around them: no sort, no IoU matrix."""
    from yolo2_light_tpu_torch.post.device_nms import nms_packed
    boxes, probs = _order_operands(dev, 5, 2, 1024, 80)
    packed = torch.cat([boxes, torch.ones_like(boxes[..., :1]), probs], -1)
    want = nms_packed(packed.cpu(), 0.45)
    K.reset_launch_counts()
    ops, got = _aten_ops(lambda: nms_packed(packed, 0.45))
    assert not {"sort", "argsort", "minimum", "div"} & ops, ops
    assert (K.LAUNCH_COUNTS["nms_order"], K.LAUNCH_COUNTS["nms_walk"]) == (1,
                                                                           1)
    assert torch.equal(_bits(got.cpu()), _bits(want))


PIPELINE_MODES = [("mini-yolo3", True, {}),
                  ("mini-res", True, {"int8_impl": "fused"}),
                  ("mini-yolo3", False, {}),
                  ("mini-xnor", False, {"xnor_impl": "pallas"}),
                  ("mini-xnor", False, {"xnor_impl": "pallas_mxu"}),
                  ("mini-calib", True, {"int8_policy": "cpu_old"})]
_MODE_IDS = ["int8", "int8-fused", "fp32", "xnor-pallas", "xnor-pallas_mxu",
             "int8-cpu_old"]
_MODE_KERNELS = ["int8_conv", "fused_res_block", None, "xnor_gemm",
                 "xnor_gemm_mxu", "int8_conv"]


def _pipelines(dev, name, quantized, kw, **pkw):
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    spec, params, mode = build_params(os.path.join(DATA, f"{name}.cfg"), None,
                                      quantized=quantized, echo=False)
    args = dict(thresh=0.1, nms=0.4, k=512, device=dev, **kw, **pkw)
    return (spec, DetectionPipeline(spec, params, mode, **args),
            DetectionPipeline(spec, params, mode, cuda_graph=False, **args))


@pytest.mark.parametrize("device_nms", [False, True], ids=["host_nms",
                                                           "device_nms"])
@pytest.mark.parametrize("mode", range(len(PIPELINE_MODES)), ids=_MODE_IDS)
def test_pipeline_graph_replay_equals_eager(dev, mode, device_nms):
    """Each replay of the captured graph (uint8 source-size frames resized
    on the card, decode, compaction, device NMS) gives the eager program's
    packed buffer bit for bit, with new data in the static input; the hand
    kernels launch inside the capture."""
    name, quantized, kw = PIPELINE_MODES[mode]
    spec, graphed, eager = _pipelines(dev, name, quantized, kw,
                                      device_nms=device_nms)
    rng = np.random.RandomState(mode)
    K.reset_launch_counts()
    for i in range(3):
        x = (rng.rand(2, 96, 128, 3) * 255).astype(np.uint8)
        a, b = graphed.raw(x), eager.raw(x)
        k = min(512, graphed._total_candidates)
        assert a.shape == (2, k + device_nms, 5 + 3)
        assert torch.equal(_bits(a), _bits(b)), i
        assert bool((a[:, :-1 if device_nms else None, 5:] > 0).any())
    assert len(graphed._graphs) == 1
    kernel = _MODE_KERNELS[mode]
    if kernel is not None:
        assert K.LAUNCH_COUNTS[kernel] > 0
    if device_nms:
        assert K.LAUNCH_COUNTS["nms_walk"] > 0
        assert K.LAUNCH_COUNTS["nms_order"] > 0
        # the NMS stage on the card: no sort (the decode before it sorts)
        from yolo2_light_tpu_torch.post.device_nms import nms_packed
        xd = torch.from_numpy(x).to(dev)
        with torch.inference_mode():
            heads = eager._fwd(eager.params, eager.ingest(xd))[0]
            packed = eager._decoder.packed([h.data for h in heads])
            ops, _ = _aten_ops(lambda: nms_packed(packed, eager.nms))
        assert not {"sort", "argsort"} & ops, ops


def test_pipeline_serve_scan_equals_per_frame_calls(dev):
    spec, graphed, eager = _pipelines(dev, "mini-yolo3", True, {},
                                      device_nms=True)
    frames = (np.random.RandomState(9).rand(5, 80, 96, 3) * 255).astype(
        np.uint8)
    scanned = graphed.serve_scan(frames)
    for i, d in enumerate(scanned):
        for one in (graphed(frames[i:i + 1])[0], eager(frames[i:i + 1])[0]):
            np.testing.assert_array_equal(d.bbox, one.bbox)
            np.testing.assert_array_equal(d.prob, one.prob)
    assert sum(d.n for d in scanned) > 0


def test_pipeline_yuv_and_batch_sizes_each_capture_once(dev):
    spec, graphed, eager = _pipelines(dev, "mini-yolo3", False, {})
    rng = np.random.RandomState(2)
    yuv = (rng.rand(3, 96 * 3 // 2, 128) * 255).astype(np.uint8)
    rgb1 = (rng.rand(1, 64, 64, 3)).astype(np.float32)
    for x in (yuv, rgb1, yuv, rgb1):
        assert torch.equal(_bits(graphed.raw(x)), _bits(eager.raw(x)))
    assert len(graphed._graphs) == 2


def test_pipeline_grown_shares_params_and_graph_pool(dev, capsys):
    """A saturated K=16 buffer grows (same note as the JAX pipeline); the
    grown pipeline holds the same parameter tensors."""
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    spec, params, mode = build_params(os.path.join(DATA, "mini-yolo3.cfg"),
                                      None, echo=False)
    pipe = DetectionPipeline(spec, params, mode, thresh=0.05, nms=0.4, k=16,
                             device=dev)
    big = DetectionPipeline(spec, params, mode, thresh=0.05, nms=0.4,
                            k=4096, device=dev)
    x = np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32)
    got, want = pipe(x)[0], big(x)[0]
    assert "note: candidate buffer K=16 saturated" in capsys.readouterr().err
    assert pipe._promoted is not None
    assert pipe._promoted.params is pipe.params
    np.testing.assert_array_equal(got.prob, want.prob)


def test_pipeline_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA device")
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    spec, params, mode = build_params(os.path.join(DATA, "mini-yolo3.cfg"),
                                      None, echo=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectionPipeline(spec, params, mode)


# ---------------------------------------------------------------------------
# the precision modes: K1's epilogues, input forms and stores, and the modes'
# forwards and graphs
# ---------------------------------------------------------------------------

# (input form, semantics, store): the network's forms under -turbo (bf16 in,
# bf16 out), -turbo_int8 (int8 store; int8 input from the chain), -int8_policy
# gpu and -bf16, and their mixtures
K1_FORMS = [("bf16", "cpu", "bf16"), ("bf16", "cpu", "f32"),
            ("f32", "cpu", "bf16"), ("f32", "cpu", "int8"),
            ("int8", "cpu", "int8"), ("int8", "cpu", "bf16"),
            ("f32", "gpu", "f32"), ("int8", "gpu", "f32"),
            ("bf16", "gpu", "bf16"), ("f32", "gpu", "int8")]
_DT = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("form", K1_FORMS, ids="-".join)
@pytest.mark.parametrize("shape", YOLOV3_CLASSES + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_forms_bit_identical_to_plain(dev, shape, form):
    """Each new form of K1 against its plain twin (quantize of the upcast
    input, exact accumulator, the semantics' epilogue, the store), on the
    card and on the CPU, at yolov3-416's 15 int8 classes and ragged shapes
    (M % 4 != 0 takes the element stores, C % 8 != 0 the bf16 loader's
    unaligned rows)."""
    x_form, semantics, store = form
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, bias = _f32_operands(dev, h * c + m + len(x_form), b, h, w, c, m,
                                ks)
    scale = K.alpha_f32(40.0, 16.0, 32 if semantics == "cpu" else 1)
    kw = dict(semantics=semantics, out_dtype=_DT[store],
              out_mult=1.7 if store == "int8" else None)
    for activation in ("leaky", "linear"):
        K.reset_launch_counts()
        if x_form == "int8":
            xi = K.quantize_i8(x, 40.0)
            out = K.conv2d_int8_cuda(xi, wt, bias, scale, stride, pad,
                                     activation, **kw)
            ref = K.conv2d_int8_plain(xi, wt, bias, scale, stride, pad,
                                      activation, **kw)
            cpu = K.conv2d_int8_plain(xi.cpu(), wt.cpu(), bias.cpu(), scale,
                                      stride, pad, activation, **kw)
        else:
            xi = x.to(_DT[x_form])
            out = K.conv2d_int8_f32_cuda(xi, wt, bias, 40.0, scale, stride,
                                         pad, activation, **kw)
            ref = K.conv2d_int8_f32_plain(xi, wt, bias, 40.0, scale, stride,
                                          pad, activation, **kw)
            cpu = K.conv2d_int8_f32_plain(xi.cpu(), wt.cpu(), bias.cpu(),
                                          40.0, scale, stride, pad,
                                          activation, **kw)
        assert K.FORM_LAUNCHES == {"/".join(form): 1}
        torch.cuda.synchronize()
        assert out.dtype == _DT[store] and out.shape == ref.shape
        assert torch.equal(out, ref), activation
        assert torch.equal(out.cpu(), cpu), activation


def test_k1_refuses_a_bf16_map_at_its_int8_entry(dev):
    x, wt, bias = _f32_operands(dev, 0, 1, 4, 4, 8, 8, 3)
    with pytest.raises(TypeError, match="int8"):
        K.conv2d_int8_cuda(x.to(torch.bfloat16), wt, bias, 0.05, 1, 1)
    with pytest.raises(TypeError, match="store"):
        K.conv2d_int8_f32_cuda(x, wt, bias, 40.0, 0.05, 1, 1,
                               out_dtype=torch.float16)


# name: (cfg, mode, keywords, int8 convs a forward launches K1 for)
PRECISION_MODES = {
    "gpu": ("mini-yolo3", "int8", dict(int8_policy="gpu")),
    "turbo": ("mini-yolo3", "int8", dict(turbo=True)),
    "turbo-fp32": ("mini-yolo3", "fp32", dict(turbo=True)),
    "turbo_int8": ("mini-res", "int8", dict(turbo="int8")),
    "turbo_int8-fused": ("mini-res", "int8",
                         dict(turbo="int8", int8_impl="fused")),
    "bf16": ("mini-yolo3", "fp32", dict(compute_dtype=torch.bfloat16)),
    "bf16-int8": ("mini-res", "int8", dict(compute_dtype=torch.bfloat16)),
    "turbo-xnor": ("mini-xnor", "fp32", dict(turbo=True,
                                             xnor_impl="pallas_mxu")),
}


@pytest.mark.parametrize("name", list(PRECISION_MODES))
def test_precision_mode_kernel_path_equals_plain_path(dev, name,
                                                     monkeypatch):
    """Each mode's kernel path on the card against its plain path on the
    card, head for head, bit for bit; under -turbo in int8 mode K1 reads
    and stores bf16 with nothing launched in front of it. Under -bf16 the
    float convs run K6 against its plain twin, whose float32 sums differ
    in order only: the heads are held at the CPU tests' bf16 bound
    (``bf16_conv.heads_gap``: a sum within an ULP of a bfloat16 boundary of
    the next conv's input rounds the other way, and the step travels
    downstream). Under -quantized -bf16 the plain path runs K6 too, so K1
    is held bit for bit."""
    from yolo2_light_tpu_torch.models import network as TN
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    cfg, mode, kw = PRECISION_MODES[name]
    spec, params, _ = build_params(os.path.join(DATA, f"{cfg}.cfg"), None,
                                   quantized=mode == "int8", echo=False)
    x = np.random.RandomState(2).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    kernel = Predictor(spec, params, mode, device=dev, **kw)
    plain_impl = ("fused_plain" if kw.get("int8_impl") == "fused"
                  else "plain")
    plain = Predictor(spec, params, mode, device=dev, **dict(
        kw, int8_impl=plain_impl))
    K.reset_launch_counts()
    hk = kernel(x)
    torch.cuda.synchronize()
    launches, pre = dict(K.LAUNCH_COUNTS), dict(K.PRE_LAUNCHES)
    bf16 = kw.get("compute_dtype") == torch.bfloat16
    near = bf16 and mode != "int8"
    if bf16 and mode == "int8":
        monkeypatch.setattr(B, "conv2d_bf16_plain", _k6)
    for a, b in zip(hk, plain(x)):
        assert a.data.dtype == torch.float32
        if near:
            gap = B.heads_gap(a.data, b.data)
            assert gap.within == 1.0 and gap.mean < B.HEADS_MEAN, gap
        else:
            assert torch.equal(a.data, b.data), a.index
    if bf16:
        assert launches["bf16_conv"] > 0
    if mode == "int8" and kw.get("int8_impl") != "fused":
        policy = kw.get("int8_policy", "cpu")
        assert launches["int8_conv"] == len(TN._int8_layer_set(spec, policy))
    if name == "turbo":
        assert not any(pre.values()), pre
        assert set(K.FORM_LAUNCHES) == {"bf16/cpu/bf16"}


@pytest.mark.parametrize("name", ["gpu", "turbo", "turbo_int8", "bf16"])
def test_pipeline_graph_replay_equals_eager_in_precision_modes(dev, name):
    """The captured graph of each mode gives its eager program's packed
    buffer bit for bit, on new frames too."""
    cfg, mode, kw = PRECISION_MODES[name]
    spec, graphed, eager = _pipelines(dev, cfg, mode == "int8", kw,
                                      device_nms=True)
    rng = np.random.RandomState(3)
    for i in range(3):
        x = (rng.rand(2, 96, 128, 3) * 255).astype(np.uint8)
        a, b = graphed.raw(x), eager.raw(x)
        assert a.dtype == torch.float32
        assert torch.equal(_bits(a), _bits(b)), i
    assert len(graphed._graphs) == 1


def test_bf16_conv_does_not_depend_on_the_input_layout(dev):
    """The float conv takes an NCHW-strided map (a plain twin's output) as
    the same map laid out NHWC: the bf16 conv kernel reads dense NHWC rows,
    and the wrapper makes a strided map dense first."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(1, 64, 13, 13).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.randn(255, 64, 1, 1).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    b = torch.zeros(255, device=dev)
    strided = x.permute(0, 2, 3, 1)                 # NHWC view of NCHW
    dense = strided.contiguous()
    a = L.conv2d_fp32(strided, w, b, 1, 0, "linear",
                      compute_dtype=torch.bfloat16)
    c = L.conv2d_fp32(dense, w, b, 1, 0, "linear",
                      compute_dtype=torch.bfloat16)
    assert torch.equal(a, c)


# yolov2-voc-416's 12 int8 conv classes under -int8_policy cpu_old
# (B, H, W, C, M, ks, stride, pad); the last one stores float32 on the main
# path, the others int8
YOLOV2_VOC_CLASSES = [
    (1, 208, 208, 32, 64, 3, 1, 1), (1, 104, 104, 64, 128, 3, 1, 1),
    (1, 104, 104, 128, 64, 1, 1, 0), (1, 52, 52, 128, 256, 3, 1, 1),
    (1, 52, 52, 256, 128, 1, 1, 0), (1, 26, 26, 256, 512, 3, 1, 1),
    (1, 26, 26, 512, 256, 1, 1, 0), (1, 13, 13, 512, 1024, 3, 1, 1),
    (1, 13, 13, 1024, 512, 1, 1, 0), (1, 13, 13, 1024, 1024, 3, 1, 1),
    (1, 26, 26, 512, 64, 1, 1, 0), (1, 13, 13, 1280, 1024, 3, 1, 1),
]
_OLD_STORES = {"f32": torch.float32, "int8": torch.int8,
               "f32+int8": K.OLD_BOTH}


@pytest.mark.parametrize("store", list(_OLD_STORES))
@pytest.mark.parametrize("shape", YOLOV2_VOC_CLASSES + RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_old_form_bit_identical_to_plain(dev, shape, store):
    """K1's "old" epilogue (-int8_policy cpu_old) in each store against its
    plain twin on the card and on the CPU, leaky and linear, at yolov2-voc's
    12 int8 classes (K up to 11,520) and ragged shapes; biases_quant and
    output_multipler at quantize_params' scales, so q spans the leaky
    branch, the int8 clamp and zero."""
    b, h, w, c, m, ks, stride, pad = shape
    x, wt, _ = _operands(dev, h * c + m, b, h, w, c, m, ks)
    rng = np.random.RandomState(m)
    bq = torch.from_numpy((rng.randn(m) * 300).astype(np.float32)).to(dev)
    mult = float(np.float32(rng.uniform(0.05, 0.4)) / ks)
    kw = dict(semantics="old", out_dtype=_OLD_STORES[store])
    for activation in ("leaky", "linear"):
        K.reset_launch_counts()
        out = K.conv2d_int8_cuda(x, wt, bq, mult, stride, pad, activation,
                                 **kw)
        assert K.FORM_LAUNCHES == {f"int8/old/{store}": 1}
        ref = K.conv2d_int8_plain(x, wt, bq, mult, stride, pad, activation,
                                  **kw)
        cpu = K.conv2d_int8_plain(x.cpu(), wt.cpu(), bq.cpu(), mult, stride,
                                  pad, activation, **kw)
        torch.cuda.synchronize()
        outs, refs, cpus = ((out, ref, cpu) if store == "f32+int8"
                            else ((out,), (ref,), (cpu,)))
        for o, r, cp in zip(outs, refs, cpus):
            assert o.dtype == r.dtype and o.shape == r.shape
            assert torch.equal(o, r), activation
            assert torch.equal(o.cpu(), cp), activation
        q8 = outs[-1] if store != "f32" else None
        if q8 is not None and q8.numel() >= 4096:
            assert bool((q8 == 127).any() or (q8 == -127).any())


def test_k1_old_form_refuses_a_bf16_store(dev):
    x, wt, bias = _operands(dev, 0, 1, 4, 4, 8, 8, 3)
    with pytest.raises(TypeError, match="old epilogue stores"):
        K.conv2d_int8_cuda(x, wt, bias, 0.1, 1, 1, semantics="old",
                           out_dtype=torch.bfloat16)


def _narrow_yolov2_voc(tmp_path, size=64, width_div=8):
    import importlib.util
    path = os.path.join(os.path.dirname(DATA), "..", "scripts",
                        "gen_yolov2_voc_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_yolov2_voc_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = tmp_path / "yolov2-voc-narrow.cfg"
    p.write_text(mod.render(size, width_div))
    return str(p)


@pytest.mark.parametrize("name", ["mini-calib", "narrow-yolov2-voc"])
def test_cpu_old_kernel_path_equals_plain_path(dev, name, tmp_path):
    """-int8_policy cpu_old on the card: one launch of K1's old form per
    int8 conv, with the stores its readers take, heads equal to the plain
    path's on the card, bit for bit."""
    from yolo2_light_tpu_torch.models import network as TN
    cfg = (os.path.join(DATA, "mini-calib.cfg") if name == "mini-calib"
           else _narrow_yolov2_voc(tmp_path))
    spec, params, _ = build_params(cfg, None, quantized=True, echo=False)
    x = np.random.RandomState(2).rand(2, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    kernel = Predictor(spec, params, "int8", device=dev,
                       int8_policy="cpu_old")
    plain = Predictor(spec, params, "int8", device=dev,
                      int8_policy="cpu_old", int8_impl="plain")
    K.reset_launch_counts()
    hk = kernel(x)
    torch.cuda.synchronize()
    int8_set = TN._int8_layer_set(spec, "cpu_old")
    assert K.LAUNCH_COUNTS["int8_conv"] == len(int8_set)
    want = {}
    for store in TN._old_stores(spec, int8_set).values():
        key = f"int8/old/{K._DTYPE_NAMES[store]}"
        want[key] = want.get(key, 0) + 1
    assert dict(K.FORM_LAUNCHES) == want
    for a, b in zip(hk, plain(x)):
        assert torch.equal(a.data, b.data), a.index


# ---------------------------------------------------------------------------
# K6: the bf16 conv with a float32 sum (-bf16's float convs)
# ---------------------------------------------------------------------------


def _yolov3_float_shapes():
    """yolov3-416's 23 distinct conv shapes (H, W, C, M, ks, stride, pad):
    every conv runs K6 under -bf16."""
    from yolo2_light_tpu_torch.cfg import ConvSpec, parse_network_cfg
    spec = parse_network_cfg(os.path.join(DATA, "yolov3.cfg"), batch=1)
    return list(dict.fromkeys(
        (l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
        for l in spec.layers if isinstance(l, ConvSpec)))


def _bf16_operands(dev, seed, b, h, w, c, m, ks):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32)).to(dev)
    wt = torch.from_numpy((rng.randn(m, ks, ks, c) / np.sqrt(ks * ks * c))
                          .astype(np.float32)).to(dev).to(torch.bfloat16)
    return x, wt


def _k6(x, wt, stride, pad, **kw):
    """K6 through its wrapper, the c3 form's padded weights made here where
    ``wt`` is a first conv's (the network keeps them in its params)."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    if B.c3_form(wt.shape[3], wt.shape[1]):
        kw["w_k32"] = B.pad_k32(wt)
    return B.conv2d_bf16_cuda(x, wt, stride, pad, **kw)


def _voc_float_shapes():
    """yolov2-voc-416's distinct conv shapes, as _yolov3_float_shapes."""
    from yolo2_light_tpu_torch.cfg import ConvSpec, parse_network_cfg
    spec = parse_network_cfg(os.path.join(DATA, "yolov2-voc.cfg"), batch=1)
    return list(dict.fromkeys(
        (l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
        for l in spec.layers if isinstance(l, ConvSpec)))


@pytest.mark.parametrize("shape", _yolov3_float_shapes(),
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_conv_within_bound_of_plain_and_batch_invariant(dev, shape):
    """K6 at each yolov3-416 float conv shape, b=1 and b=8: within the
    float32-accumulate bound of its plain twin (the float32 conv of the same
    bfloat16 operands, TF32 off, cuDNN deterministic), and every image of
    the b=8 result bit-identical to that image alone at b=1 (F14's pin)."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    h, w, c, m, ks, stride, pad = shape
    L.set_fp32_precision()
    x8, wt = _bf16_operands(dev, h * c + m, 8, h, w, c, m, ks)
    K.reset_launch_counts()
    out8 = _k6(x8, wt, stride, pad)
    assert K.LAUNCH_COUNTS == {"bf16_conv": 1}
    ref = B.conv2d_bf16_plain(x8, wt, stride, pad)
    torch.cuda.synchronize()
    assert out8.shape == ref.shape and out8.dtype == torch.float32
    diff = (out8.double() - ref.double()).abs()
    assert bool((diff <= B.sum_bound(x8, wt, stride, pad)).all()), \
        float(diff.max())
    del ref, diff
    for i in range(8):
        xi = x8[i:i + 1].contiguous()
        one = _k6(xi, wt, stride, pad)
        torch.cuda.synchronize()
        assert torch.equal(out8[i:i + 1], one), i
        if i == 0:
            d1 = (one.double() - B.conv2d_bf16_plain(
                xi, wt, stride, pad).double()).abs()
            assert bool((d1 <= B.sum_bound(xi, wt, stride, pad)).all())


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", sorted(set(_yolov3_float_shapes())
                                         | set(_voc_float_shapes())),
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_conv_every_split_within_bound(dev, shape, split):
    """K6 with the K split forced to 1, 2, 4 and 8 blocks of a cluster (at
    most the slab count; the c3 form takes no split) at every yolov3-416
    and yolov2-voc-416 conv shape, b=1: within the float32-accumulate bound
    of the plain twin."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    h, w, c, m, ks, stride, pad = shape
    L.set_fp32_precision()
    x, wt = _bf16_operands(dev, h * c + m + split, 1, h, w, c, m, ks)
    plan = B.plan_launch(1, h, w, c, m, ks, stride, pad)
    if plan.form != "c3":
        plan = plan._replace(split=min(split, plan.slabs))
    out = _k6(x, wt, stride, pad, plan=plan)
    ref = B.conv2d_bf16_plain(x, wt, stride, pad)
    torch.cuda.synchronize()
    diff = (out.double() - ref.double()).abs()
    assert bool((diff <= B.sum_bound(x, wt, stride, pad)).all()), \
        float(diff.max())


@pytest.mark.parametrize("plan", [(8, 8, 2), (4, 8, 3), (4, 4, 4)])
def test_bf16_conv_every_tile_and_depth_bit_identical(dev, plan):
    """The sum order depends on C, ks and the split alone: at a fixed split
    (1 and 2 blocks of a cluster) every tile and ring depth gives the same
    bits, in both slab widths (C = 40: 16 channels, 3 slabs, ranges of
    unequal length at split 2; C = 64: 16 or 32, whose orders agree at
    split 1)."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    th, tw, st = plan
    for c in (40, 64):
        x, wt = _bf16_operands(dev, 5 + c, 2, 19, 23, c, 70, 3)
        base = B.plan_launch(2, 19, 23, c, 70, 3, 1, 1)
        kcs = (16, 32) if c % 32 == 0 else (16,)
        for split in (1, 2):
            want = B.conv2d_bf16_cuda(x, wt, 1, 1, plan=base._replace(
                split=split))
            for kc in kcs:
                if split > 1 and kc != base.kc:
                    continue
                got = B.conv2d_bf16_cuda(x, wt, 1, 1, plan=base._replace(
                    tile_h=th, tile_w=tw, stages=st, split=split, kc=kc))
                torch.cuda.synchronize()
                assert torch.equal(got, want), (c, split, kc)


@pytest.mark.parametrize("act", ["leaky", "linear"])
@pytest.mark.parametrize("bias_on", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape", [
    (2, 416, 416, 3, 32, 3, 1, 1),       # c3 form
    (2, 13, 13, 1024, 255, 1, 1, 0),     # flat, split 8, ragged M
    (1, 26, 26, 512, 1024, 3, 2, 1),     # halo s2, split
    (3, 11, 9, 40, 70, 3, 1, 1),         # 16-channel slabs, ragged
])
def test_bf16_conv_fused_epilogue_equals_bare_conv_then_plain_epilogue(
        dev, shape, bias_on, act):
    """K6 with bias (or none) and leaky or linear in its store is bit-equal
    to K6's bare conv followed by ``epilogue_plain`` (the PyTorch ops
    conv2d_fp32 ran) on the card."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    b, h, w, c, m, ks, stride, pad = shape
    x, wt = _bf16_operands(dev, c + m, b, h, w, c, m, ks)
    bias = None
    if bias_on:
        bias = torch.from_numpy(np.random.RandomState(m).randn(m).astype(
            np.float32)).to(dev)
    K.reset_launch_counts()
    fused = _k6(x, wt, stride, pad, biases=bias, activation=act)
    bare = _k6(x, wt, stride, pad)
    assert K.LAUNCH_COUNTS == {"bf16_conv": 2}
    want = B.epilogue_plain(bare, bias, act)
    torch.cuda.synchronize()
    assert torch.equal(fused, want)


def test_bf16_conv_c3_form_within_bound_at_416(dev):
    """The first conv of yolov3-416 and yolov2-voc-416 (416x416x3 -> 32,
    3x3/s1) runs the c3 form from the weights ``pad_k32`` pads (which it
    requires: ``params`` makes them once), within the float32-accumulate
    bound of the twin."""
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    L.set_fp32_precision()
    x, wt = _bf16_operands(dev, 3, 1, 416, 416, 3, 32, 3)
    assert B.plan_launch(1, 416, 416, 3, 32, 3, 1, 1).form == "c3"
    with pytest.raises(ValueError, match="w_k32"):
        B.conv2d_bf16_cuda(x, wt, 1, 1)
    B.reset_plan_launches()
    out = B.conv2d_bf16_cuda(x, wt, 1, 1, w_k32=B.pad_k32(wt))
    assert dict(B.PLAN_LAUNCHES) == {"c3/kc32/split1": 1}
    ref = B.conv2d_bf16_plain(x, wt, 1, 1)
    torch.cuda.synchronize()
    diff = (out.double() - ref.double()).abs()
    assert bool((diff <= B.sum_bound(x, wt, 1, 1)).all()), float(diff.max())


def test_bf16_conv_refuses_what_the_kernel_does_not_take(dev):
    from yolo2_light_tpu_torch.ops import bf16_conv as B
    x, wt = _bf16_operands(dev, 0, 1, 16, 16, 64, 64, 7)
    plan = B.plan_launch(1, 16, 16, 64, 64, 7, 1, 3)
    with pytest.raises(RuntimeError, match="cudaError"):
        # 8x8 tiles of a 7x7 conv do not fit in shared memory
        B.conv2d_bf16_cuda(x, wt, 1, 3, plan=plan._replace(
            tile_h=8, tile_w=8, stages=4))
    with pytest.raises(RuntimeError, match="cudaError"):
        # the split is 1, 2, 4 or 8 blocks of a cluster
        B.conv2d_bf16_cuda(x, wt, 1, 3, plan=plan._replace(split=3))
    with pytest.raises(ValueError, match="no tile"):
        B.conv2d_bf16_cuda(*_bf16_operands(dev, 0, 1, 16, 16, 8, 8, 9), 1, 4)
    with pytest.raises(TypeError):
        B.conv2d_bf16_cuda(x.to(torch.bfloat16), wt, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        B.conv2d_bf16_cuda(x.transpose(1, 2), wt, 1, 3)


def test_bf16_forward_launches_k6_per_float_conv(dev):
    """-bf16 on the card: one K6 launch per conv in fp32 mode, one per
    float conv (layer 0 and the heads) beside K1 in int8 mode; no cuDNN
    conv."""
    from yolo2_light_tpu_torch.cfg import ConvSpec
    from yolo2_light_tpu_torch.models import network as TN
    for mode in ("fp32", "int8"):
        spec, params, _ = build_params(os.path.join(DATA, "mini-yolo3.cfg"),
                                       None, quantized=mode == "int8",
                                       echo=False)
        x = np.random.RandomState(2).rand(2, spec.net.h, spec.net.w,
                                          3).astype(np.float32)
        pred = Predictor(spec, params, mode, device=dev,
                         compute_dtype=torch.bfloat16)
        K.reset_launch_counts()
        pred(x)
        torch.cuda.synchronize()
        convs = sum(isinstance(l, ConvSpec) for l in spec.layers)
        int8 = len(TN._int8_layer_set(spec, "cpu")) if mode == "int8" else 0
        assert K.LAUNCH_COUNTS["bf16_conv"] == convs - int8
        assert K.LAUNCH_COUNTS["int8_conv"] == int8


def test_bf16_forward_profile_shows_one_k6_per_conv_and_no_epilogue_ops(
        dev):
    """A -bf16 forward on the card under torch.profiler: one K6 kernel per
    conv and no bias or leaky op (no aten::where, aten::gt or aten::mul,
    and an aten::add only at each shortcut), nor an unfused BN's
    aten::sub or aten::div; the plain path on the card runs them, so the
    check sees them where they are."""
    from torch.profiler import ProfilerActivity, profile
    from yolo2_light_tpu_torch.cfg import ConvSpec, ShortcutSpec
    spec, params, _ = build_params(os.path.join(DATA, "mini-yolo3.cfg"), None,
                                   echo=False)
    convs = sum(isinstance(l, ConvSpec) for l in spec.layers)
    shortcuts = sum(isinstance(l, ShortcutSpec) for l in spec.layers)
    x = np.random.RandomState(4).rand(1, spec.net.h, spec.net.w,
                                      3).astype(np.float32)
    counts = {}
    for impl in ("xla", "plain"):
        pred = Predictor(spec, params, "fp32", device=dev, int8_impl=impl,
                         compute_dtype=torch.bfloat16)
        pred(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pred(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        counts[impl] = {
            "k6": sum("bf16_conv_kernel" in n for n in names),
            "epilogue": sum(n in ("aten::where", "aten::gt", "aten::mul",
                                  "aten::sub", "aten::div") for n in names),
            "add": names.count("aten::add")}
    assert counts["xla"] == {"k6": convs, "epilogue": 0,
                             "add": shortcuts}, counts
    assert counts["plain"]["k6"] == 0 and counts["plain"]["epilogue"] > 0
    assert counts["plain"]["add"] == convs + shortcuts, counts


def test_demo_on_card_runs_a_raw_video_without_cv2(dev, tmp_path):
    """``detector demo`` on the card (bf16 by default, so K6 in the
    captured graph) over a raw video, with OpenCV blocked: every frame."""
    import subprocess
    import sys
    from yolo2_light_tpu_torch.io.rawvideo import write_rawvideo
    from yolo2_light_tpu_torch.params import save_random_weights
    cfg = os.path.join(DATA, "mini-yolo3.cfg")
    weights = str(tmp_path / "w.weights")
    save_random_weights(cfg, weights, seed=3)
    rng = np.random.RandomState(0)
    vid = str(tmp_path / "v.cvs")
    write_rawvideo(vid, [(rng.rand(80, 96, 3) * 255).astype(np.uint8)
                         for _ in range(6)])
    names = tmp_path / "n.names"
    names.write_text("aaa\nbbb\nccc\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "from yolo2_light_tpu_torch.apps.cli import main\n"
        "from yolo2_light_tpu_torch.ops import int8_conv\n"
        f"rc = main(['detector', 'demo', {str(names)!r}, {cfg!r}, "
        f"{weights!r}, {vid!r}, '-dont_show'])\n"
        "assert int8_conv.LAUNCH_COUNTS['bf16_conv'] > 0\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(tmp_path), timeout=600,
                       env=dict(os.environ, PYTHONPATH=repo))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("Objects:") == 6


# ---------------------------------------------------------------------------
# the multi-device axes on one card: every position a stream of it
# ---------------------------------------------------------------------------


def _mini_int8():
    return build_params(os.path.join(DATA, "mini-yolo3.cfg"), None,
                        quantized=True, seed=3, echo=False)


@pytest.mark.parametrize("axes", [dict(data=2), dict(model=2), dict(space=2),
                                  dict(space=3),
                                  dict(data=2, space=2, model=2)])
def test_repeated_device_mesh_bit_identical(dev, axes):
    """A mesh whose positions repeat the card: one stream each, K1 once a
    position and int8 conv (the sharded ones at M/model), heads bit for bit
    the single-device forward's."""
    from yolo2_light_tpu_torch.models.network import _int8_layer_set
    from yolo2_light_tpu_torch.parallel import mesh as M
    spec, params, mode = _mini_int8()
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    want = [h.data for h in Predictor(spec, params, mode, device=dev)(x)]
    n = int(np.prod(list(axes.values())))
    mesh = M.make_mesh(n, **axes, devices=[dev] * n)
    assert len({p.stream.cuda_stream for p in mesh.positions}) == n
    fn, sh = M.make_sharded_predict(spec, params, mesh, mode)
    K.reset_launch_counts()
    got = fn(sh, x)
    torch.cuda.synchronize()
    assert K.LAUNCH_COUNTS["int8_conv"] == n * len(_int8_layer_set(spec,
                                                                   "cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_pp_wavefront_50_runs_bit_identical(dev):
    """Two stages on two streams of the card, microbatches of 1, run 50
    times with no synchronisation between runs and every run kept: each
    equals the single-device forward (the caching allocator hands no block
    one stream still reads to the other)."""
    from yolo2_light_tpu_torch.parallel.pp import PipelinedPredictor
    spec, params, mode = _mini_int8()
    x = torch.from_numpy(np.random.RandomState(1).rand(
        4, 64, 64, 3).astype(np.float32)).to(dev)
    pred = Predictor(spec, params, mode, device=dev)
    outs = [pred(x[i:i + 1]) for i in range(4)]
    want = [torch.cat([o[h].data for o in outs]) for h in range(2)]
    pp = PipelinedPredictor(spec, params, mode, n_stages=2, microbatch=1,
                            devices=[dev, dev])
    runs = [[h.data for h in pp(x)[0]] for _ in range(50)]
    torch.cuda.synchronize()
    for got in runs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("kw", ["mesh", "pp", "pp_tp"])
def test_pipeline_on_positions_equals_single(dev, kw):
    """DetectionPipeline (device NMS) under data2 x model2, pp2 and pp2 x
    tp2 on one card: the single-device pipeline's detections, frame by
    frame."""
    from yolo2_light_tpu_torch.parallel import mesh as M
    from yolo2_light_tpu_torch.pipeline import DetectionPipeline
    spec, params, mode = _mini_int8()
    frames = (np.random.RandomState(2).rand(2, 96, 128, 3) * 255).astype(
        np.uint8)
    args = dict(thresh=0.3, nms=0.4, k=2048, device_nms=True)
    single = DetectionPipeline(spec, params, mode, device=dev, **args)
    want = [single(frames[i:i + 1])[0] for i in range(2)]
    extra = {"mesh": dict(mesh=M.make_mesh(4, data=2, model=2,
                                           devices=[dev] * 4)),
             "pp": dict(pp_stages=2, pp_devices=[dev] * 2),
             "pp_tp": dict(pp_stages=2, pp_tp=2, pp_devices=[dev] * 4)}[kw]
    got = DetectionPipeline(spec, params, mode, device=dev, **args,
                            **extra)(frames)
    assert sum(d.n for d in got) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prob, b.prob)
        np.testing.assert_array_equal(a.bbox, b.bbox)


def test_comm_recorder_changes_no_head_and_no_launch(dev):
    """yolov3-416 int8 under model2, both positions streams of the card: the
    recorder on gives the heads and the kernel launches of the recorder
    off, bit for bit and count for count, and one gather a position for
    every sharded conv."""
    from yolo2_light_tpu_torch.ops import bf16_conv
    from yolo2_light_tpu_torch.parallel import commvol as CV
    from yolo2_light_tpu_torch.parallel import mesh as M
    spec, params, mode = build_params(os.path.join(DATA, "yolov3.cfg"), None,
                                      quantized=True, seed=7, echo=False)
    x = np.random.RandomState(3).rand(1, 416, 416, 3).astype(np.float32)
    mesh = M.make_mesh(2, model=2, devices=[dev] * 2)
    fn, sh = M.make_sharded_predict(spec, params, mesh, mode)
    fn(sh, x)
    runs = []
    for on in (False, True, False):
        K.reset_launch_counts()
        bf16_conv.reset_plan_launches()
        if on:
            with CV.recording() as log:
                heads = fn(sh, x)
        else:
            heads = fn(sh, x)
        torch.cuda.synchronize()
        # every hand kernel counts in K.LAUNCH_COUNTS (K1, K2, K6, ...)
        runs.append((heads, dict(K.LAUNCH_COUNTS), dict(K.FORM_LAUNCHES),
                     dict(K.PRE_LAUNCHES), dict(bf16_conv.PLAN_LAUNCHES)))
    assert runs[0][1]["int8_conv"] == 2 * 71
    for heads, *counts in runs[1:]:
        assert counts == list(runs[0][1:])
        for g, w in zip(heads, runs[0][0]):
            assert torch.equal(g, w)
    gathers = [e for e in log.entries if e.op == "all-gather"]
    assert len(gathers) == 2 * len(M.sharded_layers(spec, mesh))
