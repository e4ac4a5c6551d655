"""yolov4 on the card: K1's mish form against its plain twin, bit for bit,
at yolov4-416's mish shapes and at odd channel counts; the serving pipeline
(CUDA graph, device NMS) on the small yolov4 net against the benchmark's
plain reference; the traced graph's split of the network stage. Every test
skips where there is no card. Run with

    python -m pytest --noconftest -m cuda tests/test_torch_yolov4_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
lacks; this file imports none of it).
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import model, verify
from portbench import yolov4 as ref
from portbench.reference import post as ref_post
from yolo2_light_tpu_torch.cfg import parse_network_cfg
from yolo2_light_tpu_torch.models import network
from yolo2_light_tpu_torch.ops import int8_conv as K
from yolo2_light_tpu_torch.pipeline import SPLIT, STAGES, DetectionPipeline
from yolo2_light_tpu_torch.quant import quantize_params
from yolo2_light_tpu_torch.utils import profiling
from yolo2_light_tpu_torch.weights import fuse_conv_batchnorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(ROOT, "tests", "data", "mini-yolov4.cfg")
V4 = os.path.join(ROOT, "portbench", "configs", "yolov4-416.cfg")
SEED = 2**31 + 4004
IN_MULT = 40.0

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1's mish form runs only on the "
                    "card")
    return torch.device("cuda")


def _mish_shapes() -> list:
    """The distinct (H, W, C, M, ks, stride, pad) of yolov4-416's 71 mish
    int8 convs."""
    spec = parse_network_cfg(V4, batch=1, quantized=True)
    ints = network._int8_layer_set(spec, "cpu")
    return sorted(Counter((l.h, l.w, l.c, l.n, l.size, l.stride, l.pad)
                          for l in spec.conv_layers()
                          if l.index in ints and l.activation == "mish"))


def _operands(dev, seed, b, h, w, c, m, ks):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(b, h, w, c, generator=g) * 4).to(dev)
    wt = torch.randint(-127, 128, (m, ks, ks, c), generator=g).to(
        torch.int8).to(dev)
    bias = torch.randn(m, generator=g).to(dev)
    return x, wt, bias


def _check_mish(dev, seed, b, h, w, c, m, ks, s, pad, semantics="cpu"):
    x, wt, bias = _operands(dev, seed, b, h, w, c, m, ks)
    alpha = K.alpha_f32(IN_MULT, 16.0, 32 if semantics == "cpu" else 1)
    got = K.conv2d_int8_f32_cuda(x, wt, bias, IN_MULT, alpha, s, pad, "mish",
                                 semantics=semantics)
    lin = K.conv2d_int8_f32_plain(x, wt, bias, IN_MULT, alpha, s, pad,
                                  "linear", semantics=semantics)
    want = F.mish(lin)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (b, h, w, c, m, ks, s, pad, semantics)
    assert (got != lin).any()


def test_k1_mish_form_is_its_plain_twin_at_yolov4_shapes(dev):
    shapes = _mish_shapes()
    assert len(shapes) == 25
    for i, (h, w, c, m, ks, s, pad) in enumerate(shapes):
        _check_mish(dev, SEED + i, 1, h, w, c, m, ks, s, pad)
    # the gpu epilogue, and a batch, at a few of them
    for i, (h, w, c, m, ks, s, pad) in enumerate(shapes[::6]):
        _check_mish(dev, SEED + 100 + i, 1, h, w, c, m, ks, s, pad, "gpu")
        _check_mish(dev, SEED + 200 + i, 3, min(h, 52), min(w, 52), c, m,
                    ks, s, pad)


@pytest.mark.parametrize("c,m,ks,s", [(4, 1, 3, 1), (12, 7, 1, 1),
                                      (36, 65, 3, 2), (20, 130, 3, 1),
                                      (100, 33, 1, 1)])
def test_k1_mish_form_at_odd_channel_counts(dev, c, m, ks, s):
    _check_mish(dev, SEED + c + m, 2, 11, 13, c, m, ks, s, ks // 2)


def test_k1_mish_form_takes_only_its_float32_form(dev):
    x, wt, bias = _operands(dev, SEED, 1, 8, 8, 16, 16, 3)
    with pytest.raises(ValueError, match="mish form"):
        K.conv2d_int8_f32_cuda(x.to(torch.bfloat16), wt, bias, IN_MULT, 1.0,
                               1, 1, "mish", out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mish form"):
        K.conv2d_int8_f32_cuda(x, wt, bias, IN_MULT, 1.0, 1, 1, "mish",
                               out_dtype=torch.int8, out_mult=10.0)


def _mini(dev, k=4096):
    net = ref.parse(MINI)
    net.ref = ref
    raw = model.set_obj_bias(net, model.make_weights(net, SEED, dev), -1.5)
    spec = parse_network_cfg(MINI, batch=1, quantized=True, echo_table=False)
    params = quantize_params(spec, fuse_conv_batchnorm(
        spec, model.host_params(net, raw)))
    pipe = DetectionPipeline(spec, params, "int8", thresh=0.05, nms=0.45,
                             k=k, device_nms=True, device="cuda")
    return net, raw, spec, params, pipe


def _frames(n, seed=5):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 48, 64, 3)).astype(np.uint8)


def test_the_pipeline_on_the_small_yolov4_net_agrees_with_the_reference(dev):
    """The CUDA-graph pipeline (K1's mish and leaky forms, the scale_x_y
    decode, device NMS) against the plain reference run on the same card:
    every detection (candidate, class) on both sides; the network's heads
    within the CPU test's int8 tolerance; 8 mish launches of K1 a
    forward (the mish int8 convs) and no other form for them."""
    net, raw, spec, params, pipe = _mini(dev)
    frames = _frames(4)
    dets = pipe(frames)
    answers = [verify.Answer(i, d.bbox, d.prob) for i, d in enumerate(dets)]
    truths = verify.reference_truths(net, raw, frames, range(len(frames)),
                                     "int8", 0.05, 0.45, dev)
    numbers = verify.compare(answers, truths, 0.05)
    assert numbers["detections"] > 0 and numbers["unlike_pct"] == 0
    x = ref_post.ingest(torch.from_numpy(frames).to(dev), net.w, net.h)
    pred = network.Predictor(spec, params, "int8", device="cuda")
    K.reset_launch_counts()
    got = [h.data for h in pred(x)]
    mish = [l for l in spec.conv_layers() if l.activation == "mish"
            and l.index in network._int8_layer_set(spec, "cpu")]
    assert K.FORM_LAUNCHES["f32/cpu/f32/mish"] == len(mish) == 8
    want = ref.forward(net, ref.prepare(net, raw, "int8", dev), x, "int8")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def test_the_traced_graph_splits_the_network_stage(dev):
    """While a profiler runs, each replay of the small net's traced graph
    records stage.network.down and .up (split after layer 20, the last
    before the first upsample), which add up to stage.network; the stage
    times the untraced metrics read are all there."""
    from torch.profiler import ProfilerActivity, profile
    *_, pipe = _mini(dev)
    frames = _frames(2)
    pipe(frames)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            pipe(frames)
    rec = profiling.recorded()
    names = ["stage." + s for s in STAGES + SPLIT]
    stages = [d for d in rec.device if d.name.startswith("stage.")]
    assert len(stages) == 3 * len(names)
    for at in sorted({d.at for d in stages}):
        mine = {d.name: d.ms for d in stages if d.at == at}
        assert sorted(mine) == sorted(names)
        assert abs(mine["stage.network.down"] + mine["stage.network.up"]
                   - mine["stage.network"]) <= 1e-3 * mine["stage.network"]
        assert mine["stage.network.down"] > 0 and mine["stage.network.up"] > 0
