"""yolov4 on the port (CPU): the published cfg's structure, the parser's
mish and [yolo] options and its refusals, K1's mish epilogue (its plain
twin, and where it does not fuse), the network against the benchmark's
plain yolov4 reference (``portbench/yolov4``), ``scale_x_y`` in the device
decode, the host decode and the reference, and the traced graph's split
of the network stage."""

import dataclasses
import os
import types
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import model
from portbench import yolov4 as ref
from portbench.reference import post as ref_post
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch import pipeline
from yolo2_light_tpu_torch.models import layers as L
from yolo2_light_tpu_torch.models import network
from yolo2_light_tpu_torch.ops import int8_conv
from yolo2_light_tpu_torch.post import boxes
from yolo2_light_tpu_torch.post import device_decode
from yolo2_light_tpu_torch.quant import quantize_params
from yolo2_light_tpu_torch.utils import profiling
from yolo2_light_tpu_torch.weights import fuse_conv_batchnorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
MINI = os.path.join(DATA, "mini-yolov4.cfg")
V4 = os.path.join(ROOT, "portbench", "configs", "yolov4-416.cfg")
SEED = 2**31 + 404


def _spec(path, quantized=False):
    return TC.parse_network_cfg(path, batch=1, quantized=quantized)


def _kinds(spec) -> Counter:
    return Counter(type(l).__name__ for l in spec.layers)


# ---- the published cfg ------------------------------------------------------


def test_yolov4_cfg_is_the_published_network():
    """portbench/configs/yolov4-416.cfg is AlexeyAB/darknet's cfg/yolov4.cfg
    at 416: 162 layers, CSP stages of 1, 2, 8, 8 and 4 residual blocks, mish
    through layer 104 and leaky after it but for the three linear 1x1 head
    convs, SPP at 108-113, the PAN's routes and stride-2 convs, three heads
    with their masks, anchors and scale_x_y; 64,429,405 parameters (weights,
    biases, batch norm's three vectors) and 60.10 BFLOPs an image, the
    README's 60.1 for yolov4 at 416x416."""
    spec = _spec(V4)
    L_ = spec.layers
    assert (spec.net.w, spec.net.h, spec.net.c) == (416, 416, 3)
    assert len(L_) == 162 and _kinds(spec) == {
        "ConvSpec": 110, "ShortcutSpec": 23, "RouteSpec": 21,
        "MaxpoolSpec": 3, "UpsampleSpec": 2, "YoloSpec": 3}
    shortcuts = [l.index for l in L_ if isinstance(l, TC.ShortcutSpec)]
    assert all(L_[i].from_index == i - 3 and L_[i].activation == "linear"
               for i in shortcuts)
    rejoins = {9: (8, 2), 22: (21, 12), 53: (52, 25), 84: (83, 56),
               103: (102, 87)}
    assert all(L_[i].layers == srcs for i, srcs in rejoins.items())
    bounds = [0, *rejoins, 200]
    assert [sum(lo < i < hi for i in shortcuts)
            for lo, hi in zip(bounds, bounds[1:])] == [1, 2, 8, 8, 4, 0]
    heads = (138, 149, 160)
    for l in spec.conv_layers():
        if l.index in heads:
            assert (l.n, l.size, l.activation, l.batch_normalize) == (
                255, 1, "linear", False)
        else:
            assert l.batch_normalize
            assert l.activation == ("mish" if l.index <= 104 else "leaky")
    assert [(type(L_[i]).__name__, getattr(L_[i], "size", None))
            for i in range(108, 114)] == [
        ("MaxpoolSpec", 5), ("RouteSpec", None), ("MaxpoolSpec", 9),
        ("RouteSpec", None), ("MaxpoolSpec", 13), ("RouteSpec", None)]
    assert all(L_[i].stride == 1 and L_[i].out_h == 13
               for i in (108, 110, 112))
    assert L_[113].layers == (112, 110, 108, 107) and L_[113].out_c == 2048
    assert (L_[119].layers, L_[129].layers, L_[142].layers,
            L_[153].layers) == ((85,), (54,), (141, 126), (152, 116))
    assert (L_[85].out_h, L_[85].out_c, L_[54].out_h, L_[54].out_c) == (
        26, 512, 52, 256)
    assert [(L_[i].stride, L_[i].size) for i in (141, 152)] == [(2, 3)] * 2
    anchors = (12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72, 146, 142, 110,
               192, 243, 459, 401)
    for i, mask, s, grid in ((139, (0, 1, 2), 1.2, 52),
                             (150, (3, 4, 5), 1.1, 26),
                             (161, (6, 7, 8), 1.05, 13)):
        y = L_[i]
        assert isinstance(y, TC.YoloSpec) and y.mask == mask
        assert (y.classes, y.total, y.out_h, y.scale_x_y) == (80, 9, grid, s)
        assert y.anchors == tuple(float(a) for a in anchors)
    params = sum(l.n * l.size * l.size * l.c + l.n * (4 if l.batch_normalize
                                                      else 1)
                 for l in spec.conv_layers())
    assert params == 64429405
    assert round(sum(l.bflops for l in spec.conv_layers()), 2) == 60.10
    # the benchmark's reference parses the same network, and its
    # configuration loads through the harness unchanged
    config, net = model.load_config(os.path.join(
        ROOT, "portbench", "configs", "yolov4-416-int8.json"))
    assert net.ref is ref and config["reduced"] == []
    assert [(l.index, l.out_h, l.out_w, l.out_c) for l in net.layers] == [
        (l.index, l.out_h, l.out_w, l.out_c) for l in L_]
    assert [l.scale_x_y for l in net.heads] == [1.2, 1.1, 1.05]
    assert ref.count_params(net) == params


def test_under_int8_71_mish_and_35_leaky_convs_run_on_k1():
    spec = _spec(V4, quantized=True)
    ints = network._int8_layer_set(spec, "cpu")
    acts = Counter(spec.layers[i].activation for i in ints)
    assert acts == {"mish": 71, "leaky": 35}
    floats = [l for l in spec.conv_layers() if l.index not in ints]
    assert [(l.index, l.activation) for l in floats] == [
        (0, "mish"), (138, "linear"), (149, "linear"), (160, "linear")]
    # no residual block of yolov4 is K2's (leaky) block: the fused engine
    # keeps every mish block on K1
    assert network._fused_stage_runs(spec, ints) == {}


# ---- the parser -------------------------------------------------------------


def _variant(tmp_path, old: str, new: str) -> str:
    with open(MINI) as f:
        text = f.read()
    assert old in text
    path = tmp_path / "variant.cfg"
    path.write_text(text.replace(old, new))
    return str(path)


def test_the_parser_takes_mish_and_the_yolov4_head_keys(capsys):
    spec = _spec(MINI)
    assert "Unused field" not in capsys.readouterr().err
    assert spec.layers[0].activation == "mish"
    assert [l.scale_x_y for l in spec.layers
            if isinstance(l, TC.YoloSpec)] == [1.2, 1.1]
    # yolov3's heads have none: 1, the decode yolo2_light runs
    yolo3 = _spec(os.path.join(DATA, "mini-yolo3.cfg"))
    assert {l.scale_x_y for l in yolo3.layers
            if isinstance(l, TC.YoloSpec)} == {1.0}


@pytest.mark.parametrize("old,new,refusal", [
    ("nms_kind=greedynms", "nms_kind=diounms", "nms_kind=diounms"),
    ("nms_kind=greedynms", "nms_kind=cornersnms", "nms_kind=cornersnms"),
    ("max_delta=5", "max_delta=5\nnew_coords=1", "new_coords=1")])
def test_the_parser_refuses_what_the_port_does_not_decode(tmp_path, old,
                                                          new, refusal):
    with pytest.raises(ValueError, match=refusal):
        _spec(_variant(tmp_path, old, new))


def test_the_default_nms_kind_is_taken(tmp_path):
    spec = _spec(_variant(tmp_path, "nms_kind=greedynms\n", ""))
    assert len(spec.head_indices()) == 2


# ---- K1's mish epilogue ----------------------------------------------------


def _conv_operands(seed, b=2, h=9, w=7, c=12, m=10, ks=3):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g) * 3
    wt = torch.randint(-127, 128, (m, ks, ks, c), generator=g).to(torch.int8)
    bias = torch.randn(m, generator=g)
    return x, wt, bias


@pytest.mark.parametrize("semantics", ["cpu", "gpu"])
@pytest.mark.parametrize("ks,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_mish_epilogue_is_the_linear_epilogue_then_mish(semantics, ks,
                                                        stride, pad):
    """The mish form's plain twin: the linear epilogue's plain twin, then
    F.mish on its float32 output (what the kernel is held to, bit for bit,
    on the card)."""
    x, wt, bias = _conv_operands(7, ks=ks)
    alpha = int8_conv.alpha_f32(40.0, 64.0, 32 if semantics == "cpu" else 1)
    got = int8_conv.conv2d_int8_f32_plain(x, wt, bias, 40.0, alpha, stride,
                                          pad, "mish", semantics=semantics)
    lin = int8_conv.conv2d_int8_f32_plain(x, wt, bias, 40.0, alpha, stride,
                                          pad, "linear", semantics=semantics)
    assert got.dtype == torch.float32 and torch.equal(got, F.mish(lin))
    assert (got != lin).any() and (got < 0).any()


def test_mish_fuses_only_into_the_float32_form():
    fuses = int8_conv.fuses
    for act in ("leaky", "linear"):
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            assert fuses(act, dt, torch.int8)
    assert fuses("mish", torch.float32)
    assert fuses("mish", torch.float32, torch.float32, "gpu")
    assert not fuses("mish", torch.bfloat16, torch.bfloat16)   # -turbo
    assert not fuses("mish", torch.float32, torch.int8)        # -turbo_int8
    assert not fuses("mish", torch.int8)                       # int8 chain
    assert not fuses("mish", torch.float32, None, "old")
    assert not fuses("relu", torch.float32)
    with pytest.raises(ValueError, match="mish"):
        int8_conv.conv2d_int8_plain(
            torch.zeros(1, 4, 4, 4, dtype=torch.int8),
            torch.zeros(4, 1, 1, 4, dtype=torch.int8), torch.zeros(4), 1.0,
            1, 0, "mish", semantics="old")


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_mish_beside_another_store_runs_unfused_never_as_leaky(store):
    """Under -turbo (bf16 maps) and -turbo_int8 (an int8 store) mish runs
    on the kernel's float32 linear output and is stored after it, as the
    relu of any other activation is."""
    x, wt, bias = _conv_operands(11)
    alpha = int8_conv.alpha_f32(40.0, 64.0)
    xin = x.to(torch.bfloat16) if store == "bf16" else x
    kw = (dict(out_dtype=torch.bfloat16) if store == "bf16"
          else dict(out_dtype=torch.int8, out_mult=20.0))
    got = L.conv2d_int8(xin, wt, bias, 1, 1, "mish", 40.0, alpha, **kw)
    lin = int8_conv.conv2d_int8_f32_plain(xin, wt, bias, 40.0, alpha, 1, 1,
                                          "linear")
    want = int8_conv.store_plain(F.mish(lin), kw["out_dtype"],
                                 kw.get("out_mult"))
    leaky = int8_conv.store_plain(
        int8_conv.conv2d_int8_f32_plain(xin, wt, bias, 40.0, alpha, 1, 1,
                                        "leaky"), kw["out_dtype"],
        kw.get("out_mult"))
    assert got.dtype == kw["out_dtype"] and torch.equal(got, want)
    assert not torch.equal(got, leaky)


# ---- the network against the plain reference -------------------------------


def _weights(path=MINI):
    net = ref.parse(path)
    net.ref = ref
    raw = model.make_weights(net, SEED, "cpu")
    return net, model.set_obj_bias(net, raw, -1.5)


def _frames(n=2, seed=3):
    return torch.randint(0, 256, (n, 48, 64, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _port_heads(net, raw, x, arith, int8_impl="plain"):
    spec = _spec(MINI, quantized=arith == "int8")
    params = fuse_conv_batchnorm(spec, model.host_params(net, raw))
    mode = "fp32"
    if arith == "int8":
        params, mode = quantize_params(spec, params), "int8"
    pred = network.Predictor(spec, params, mode, device="cpu",
                             int8_impl=int8_impl)
    return [h.data for h in pred(x)]


# Tolerances of the heads (x, y, objectness and classes through the
# logistic; w, h raw). int8: the program and the reference take the same
# integer sums and the same float32 epilogue and mish on the CPU, so only a
# float32 rounding of a math function could part them; it would move a
# quantization bin of the next conv now and then, and so a head value by
# far less than 1e-4. f32: cuDNN-free float32 convs summed in orders that
# differ by a few ulps a layer (6e-8 seen). Rounding every mish's input to
# bfloat16 (8 bits of mantissa) moves the heads by over 1e-3 in int8, where
# it moves quantization bins, and by about 9e-5 in f32: five times the
# tolerance or more, in either arithmetic.
TOL = {"int8": 1e-4, "f32": 1e-5}


@pytest.mark.parametrize("arith", ["int8", "f32"])
def test_port_heads_match_the_yolov4_reference(arith):
    net, raw = _weights()
    x = ref_post.ingest(_frames(), net.w, net.h)
    want = ref.forward(net, ref.prepare(net, raw, arith, "cpu"), x, arith)
    got = _port_heads(net, raw, x, arith)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=TOL[arith])
    # the tolerance is tight enough to see mish computed in bfloat16
    low = ref.with_activations(
        {"mish": lambda y: ref.mish(y.to(torch.bfloat16).float())})
    coarse = low(net, ref.prepare(net, raw, arith, "cpu"), x, arith)
    assert max(float((c - w).abs().max())
               for c, w in zip(coarse, want)) > 5 * TOL[arith]


def test_the_fused_engine_runs_the_mish_blocks_on_k1(tmp_path):
    """int8_impl fused takes no mish block into K2 (its epilogue is leaky):
    the mini net's one residual block is K2's shape, fused where its convs
    are leaky and left to K1 where they are mish, and the forward equals
    the unfused engine's."""
    net, raw = _weights()
    spec = _spec(MINI, quantized=True)
    assert network._fused_stage_runs(
        spec, network._int8_layer_set(spec, "cpu")) == {}
    lspec = _spec(_variant(tmp_path, "activation=mish", "activation=leaky"),
                  quantized=True)
    assert network._fused_stage_runs(
        lspec, network._int8_layer_set(lspec, "cpu")) == {5: [(5, 6, 7)]}
    x = ref_post.ingest(_frames(1), net.w, net.h)
    fused = _port_heads(net, raw, x, "int8", int8_impl="fused_plain")
    plain = _port_heads(net, raw, x, "int8")
    assert all(torch.equal(a, b) for a, b in zip(fused, plain))


# ---- scale_x_y in the decodes ----------------------------------------------


def _heads(spec, seed, b=1):
    """Activated heads of ``spec``'s yolo layers: x, y, objectness and
    classes in (0, 1), w and h raw."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for l in spec.layers:
        if isinstance(l, TC.YoloSpec):
            h = torch.rand(b, l.out_h, l.out_w, l.n, 5 + l.classes,
                           generator=g)
            h[..., 2:4] = torch.randn(h[..., 2:4].shape, generator=g)
            out.append(h)
    return out


def test_scale_x_y_decodes_alike_on_device_host_and_reference():
    """The mini net's heads (scale_x_y 1.2 and 1.1): the device decode (on
    CPU tensors), the host decode and the reference give the same boxes,
    bit for bit, and they are not the boxes of the unscaled decode."""
    spec = _spec(MINI)
    net = ref.parse(MINI)
    heads = _heads(spec, 5)
    ys = [l for l in spec.layers if isinstance(l, TC.YoloSpec)]
    n = sum(l.out_h * l.out_w * l.n for l in ys)
    thresh = 0.3
    dev_boxes, dev_obj, dev_probs, _ = device_decode.decode_and_compact(
        heads, ys, net.w, net.h, thresh, k=n, decode_order=True)
    ref_boxes, _, ref_kept = ref.decode(net, heads, thresh)
    assert torch.equal(dev_boxes[0], ref_boxes[0])
    assert torch.equal(dev_probs[0], ref_kept[0])
    host = boxes.get_network_boxes([h[0].numpy() for h in heads], ys,
                                   net.w, net.h, net.w, net.h, thresh)
    live = (dev_obj[0] > thresh).numpy()
    # x and y bit for bit; w and h through NumPy's exp on the host, an ulp
    # from PyTorch's at most
    np.testing.assert_array_equal(host.bbox[:, :2],
                                  dev_boxes[0].numpy()[live, :2])
    np.testing.assert_allclose(host.bbox[:, 2:],
                               dev_boxes[0].numpy()[live, 2:], rtol=3e-7)
    unscaled = [dataclasses.replace(l, scale_x_y=1.0) for l in ys]
    plain_boxes = device_decode.decode_and_compact(
        heads, unscaled, net.w, net.h, thresh, k=n, decode_order=True)[0]
    assert not torch.equal(plain_boxes[0, :, :2], dev_boxes[0, :, :2])
    assert torch.equal(plain_boxes[0, :, 2:], dev_boxes[0, :, 2:])


def test_scale_x_y_one_leaves_the_yolov3_decode_bit_identical():
    """A head without scale_x_y (every yolov3 head) decodes as yolo2_light
    does, x = (col + sx) / W: no op is added to the device program, and
    both decodes equal that formula bit for bit."""
    spec = _spec(os.path.join(DATA, "mini-yolo3.cfg"))
    ys = [l for l in spec.layers if isinstance(l, TC.YoloSpec)]
    heads = _heads(spec, 9)
    consts = [device_decode._HeadConsts(l, h.shape, 64, 64, "cpu")
              for l, h in zip(ys, heads)]
    assert all(c.sxy is None for c in consts)
    dev = device_decode.decode_and_compact(
        heads, ys, 64, 64, 0.0, k=10**6, decode_order=True)[0][0]
    want = []
    for l, h in zip(ys, heads):
        cols = torch.arange(l.out_w, dtype=torch.float32)[None, :, None]
        rows = torch.arange(l.out_h, dtype=torch.float32)[:, None, None]
        bx = (cols + h[0, ..., 0]) / torch.tensor(float(l.out_w))
        by = (rows + h[0, ..., 1]) / torch.tensor(float(l.out_h))
        want.append(torch.stack([bx, by], -1).reshape(-1, 2))
    assert torch.equal(dev[:, :2], torch.cat(want))
    host = boxes.get_network_boxes([h[0].numpy() for h in heads], ys, 64, 64,
                                   64, 64, 0.0)
    np.testing.assert_array_equal(host.bbox[:, :2], torch.cat(want).numpy())


# ---- the traced graph's split of the network stage --------------------------


def test_the_split_follows_the_last_layer_before_the_first_upsample():
    assert pipeline._split_layer(_spec(V4)) == 117
    assert pipeline._split_layer(_spec(os.path.join(DATA,
                                                    "yolov3.cfg"))) == 84
    assert pipeline._split_layer(_spec(MINI)) == 20
    assert pipeline._split_layer(_spec(os.path.join(DATA,
                                                    "mini-yolo2.cfg"))) is None


class _Event:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_stage_times_hold_the_split_parts():
    rec = profiling.Recording()
    ev = [_Event(t) for t in (0.0, 1.0, 5.0, 6.0, 6.5)]
    split = _Event(3.5)
    inner = list(zip(pipeline.SPLIT, (ev[1], split), (split, ev[2])))
    rec.stages(ev, pipeline.STAGES, 7, 100, "trace.wait", inner)
    got = {d.name: d.ms for d in rec.device}
    assert got == {"stage.ingest": 1.0, "stage.network": 4.0,
                   "stage.decode": 1.0, "stage.nms": 0.5,
                   "stage.network.down": 2.5, "stage.network.up": 1.5}
    assert [s.name for s in rec.spans] == ["trace.wait"]


def test_the_traced_forward_records_the_split_event_once():
    """The traced capture's forward records its split event after the split
    layer and at no other layer; the untraced forward is the pipeline's own
    (no hook)."""
    net, raw = _weights()
    spec = _spec(MINI, quantized=True)
    params = quantize_params(spec, fuse_conv_batchnorm(
        spec, model.host_params(net, raw)))
    pipe = pipeline.DetectionPipeline(spec, params, "int8", device="cpu",
                                      int8_impl="plain")
    recorded = []
    mark = types.SimpleNamespace(record=lambda: recorded.append(1))
    stages = [types.SimpleNamespace(record=lambda: None)] * 5 + [mark]
    assert pipe._split_forward(stages[:5]) is pipe._fwd
    fwd = pipe._split_forward(stages)
    x = ref_post.ingest(_frames(1), net.w, net.h)
    plain_heads, _ = pipe._fwd(pipe.params, x)
    heads, _ = fwd(pipe.params, x)
    assert recorded == [1]
    assert all(torch.equal(a.data, b.data)
               for a, b in zip(heads, plain_heads))
