"""Tests of the port that need an NVIDIA GPU: the int8 conv kernel and the
fused residual-block kernel against their plain PyTorch versions on the
card, the wrappers' refusals, and the Predictor's kernel paths against its
plain path and the CPU.

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
from yolo2_light_tpu_torch.ops import fused_res as FR
from yolo2_light_tpu_torch.ops import int8_conv as K

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
