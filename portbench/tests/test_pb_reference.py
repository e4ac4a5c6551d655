"""The plain reference against the port's plain path on the small net:
heads in int8 (the integer arithmetic repeated exactly) and bf16, the
ingest resize, the decode and the NMS."""

import numpy as np
import pytest
import torch

from portbench import model
from portbench.reference import net as ref_net
from portbench.reference import post as ref_post
from portbench.tests.conftest import MINI_CFG, parsed

SEED = 2**31 + 17


def _port_heads(arith, host, x, device="cpu"):
    from yolo2_light_tpu_torch.cfg import parse_network_cfg
    from yolo2_light_tpu_torch.models.network import Predictor
    from yolo2_light_tpu_torch.quant import quantize_params
    from yolo2_light_tpu_torch.weights import fuse_conv_batchnorm
    spec = parse_network_cfg(MINI_CFG, batch=1, quantized=arith == "int8",
                             echo_table=False)
    params = fuse_conv_batchnorm(spec, host)
    kw = {}
    if arith == "int8":
        params = quantize_params(spec, params)
        mode = "int8"
    else:
        mode = "fp32"
        kw["compute_dtype"] = torch.bfloat16
    pred = Predictor(spec, params, mode, device=device, **kw)
    return [h.data.cpu() for h in pred(x)]


def _weights():
    net = parsed()
    raw = model.make_weights(net, SEED, "cpu")
    return net, model.set_obj_bias(net, raw, -1.5)


@pytest.mark.parametrize("arith", ["int8", "bf16"])
def test_reference_heads_equal_the_port_plain_path(arith):
    net, raw = _weights()
    frames = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    x = ref_post.ingest(frames, net.w, net.h)
    want = ref_net.forward(net, ref_net.prepare(net, raw, arith, "cpu"), x,
                           arith)
    got = _port_heads(arith, model.host_params(net, raw), x)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_reference_ingest_equals_the_port_resize():
    from yolo2_light_tpu_torch.ops.resize import Resizer
    frames = torch.randint(0, 256, (3, 37, 53, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    want = Resizer(37, 53, 64, 64, "cpu")(
        frames.float() / torch.tensor(255.0))
    assert torch.equal(ref_post.ingest(frames, 64, 64), want)


def test_reference_decode_and_nms_equal_the_port_host_path():
    from yolo2_light_tpu_torch.post import boxes as port_boxes
    from yolo2_light_tpu_torch.post.device_decode import \
        decode_and_compact
    from yolo2_light_tpu_torch.cfg import parse_network_cfg
    net, raw = _weights()
    frames = torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(9))
    x = ref_post.ingest(frames, net.w, net.h)
    heads = ref_net.forward(net, ref_net.prepare(net, raw, "f32", "cpu"), x,
                            "f32")
    boxes, _, kept = ref_post.decode(net, heads, 0.05)
    spec = parse_network_cfg(MINI_CFG, batch=1, echo_table=False)
    hs = [l for l in spec.layers if type(l).__name__ == "YoloSpec"]
    n = boxes.shape[1]
    pb, po, pp, count = decode_and_compact(heads, hs, 64, 64, 0.05, k=n,
                                           decode_order=True)
    assert torch.equal(pb[0], boxes[0]) and torch.equal(pp[0], kept[0])
    b = boxes[0].numpy()
    mine = ref_post.nms(b.astype(np.float64), kept[0].numpy(), 0.45)
    dets = port_boxes.Detections(b.copy(), po[0].numpy().copy(),
                                 kept[0].numpy().copy())
    port_boxes.do_nms_sort(dets, 3, 0.45)
    assert int(count[0]) > 3
    np.testing.assert_array_equal(mine, dets.prob)


def test_int8_multiplier_and_quantized_weights_equal_the_port_host_chain():
    from yolo2_light_tpu_torch.cfg import parse_network_cfg
    from yolo2_light_tpu_torch.quant import quantize_params
    from yolo2_light_tpu_torch.weights import fuse_conv_batchnorm
    net, raw = _weights()
    spec = parse_network_cfg(MINI_CFG, batch=1, quantized=True,
                             echo_table=False)
    port = quantize_params(spec, fuse_conv_batchnorm(
        spec, model.host_params(net, raw)))
    mine = ref_net.prepare(net, raw, "int8", "cpu")
    for l in net.convs:
        p, q = port[l.index], mine[l.index]
        np.testing.assert_array_equal(
            q["bias"].numpy(), p["biases"])
        if not q["int"]:
            continue
        wq = q["w"].permute(2, 3, 1, 0).numpy()
        np.testing.assert_array_equal(wq, p["weights_int8"].astype(float))
        assert q["in_mult"] == float(np.float32(p["input_quant_multipler"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arith", ["int8", "bf16"])
def test_reference_heads_against_the_port_kernels_on_the_card(arith):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    net, raw = _weights()
    frames = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    x = ref_post.ingest(frames.cuda(), net.w, net.h)
    want = ref_net.forward(net, ref_net.prepare(net, raw, arith, "cuda"), x,
                           arith)
    got = _port_heads(arith, model.host_params(net, raw), x, "cuda")
    for g, w in zip(got, want):
        if arith == "int8":
            assert torch.equal(g, w.cpu())
        else:
            torch.testing.assert_close(g, w.cpu(), rtol=0.1, atol=0.1)
