"""The region head's softmax tree (YOLO9000) and ``[softmax]`` layers in the
port against the JAX package, on the CPU: the layer ops, the forward,
``detector test`` and the serving pipeline on the mini tree net of
tests/test_tree.py.

Tolerances: the ops call exp, held to rtol=1e-5/atol=1e-6 as
tests/test_torch_layers.py holds them (XLA's and PyTorch's float32 exp
differ by a few ULP); the forwards to rtol=1e-4/atol=1e-5 as
tests/test_torch_network.py holds them (float32 convs summed in another
order). Streams and detections are compared exactly (detections: or F7
noise only, tests/test_torch_pipeline.py's rule).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_tree import CFG_TEMPLATE, TREE_TEXT
from tests.util_parity import assert_streams_match, parse_detection_lines
from yolo2_light_tpu import cfg as JC
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models.network import Predictor as JaxPredictor
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu.tree import read_tree, softmax_groups
from yolo2_light_tpu.weights import random_params, save_weights
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.models import layers as TL
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.pipeline import DetectionPipeline
from yolo2_light_tpu_torch.post import boxes as TB

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
IMAGE = os.path.join(DATA, "dog160.png")
NAMES = ["animal", "vehicle", "cat", "dog", "car", "truck", "bus"]


@pytest.fixture(scope="module")
def tree_net(tmp_path_factory):
    """The mini YOLO9000 net of tests/test_tree.py (7 classes in a 3-group
    tree), its random weights (seed 31) and names."""
    d = tmp_path_factory.mktemp("tree")
    tree = d / "mini.tree"
    tree.write_text(TREE_TEXT)
    cfg = str(d / "mini-tree.cfg")
    with open(cfg, "w") as f:
        f.write(CFG_TEMPLATE.format(tree_path=str(tree)))
    weights = str(d / "w.weights")
    save_weights(JC.parse_network_cfg(cfg, batch=1),
                 random_params(JC.parse_network_cfg(cfg, batch=1), seed=31),
                 weights)
    names = str(d / "t.names")
    with open(names, "w") as f:
        f.write("\n".join(NAMES) + "\n")
    return d, cfg, weights, names, str(tree)


def _groups(tree_path):
    return [g for _, g in softmax_groups(read_tree(tree_path))]


def _rand(seed, *shape, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("tree", [False, True], ids=["softmax", "tree"])
def test_region_head_with_and_without_tree_matches_jax(tree_net, tree):
    groups = _groups(tree_net[4]) if tree else None
    x = _rand(1, 2, 4, 5, 5 * (4 + 1 + 7))
    ref = np.asarray(JL.region_head(jnp.asarray(x), 5, 7, 4, True,
                                    softmax_tree_groups=groups))
    out = TL.region_head(torch.from_numpy(x), 5, 7, 4, True,
                         softmax_tree_groups=groups).numpy()
    assert out.shape == ref.shape == (2, 4, 5, 5, 12)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    if tree:
        # each group sums to 1 on its own
        cls = out[..., 5:]
        for lo, hi in ((0, 2), (2, 4), (4, 7)):
            np.testing.assert_allclose(cls[..., lo:hi].sum(-1), 1.0,
                                       rtol=1e-5)


@pytest.mark.parametrize("groups,temperature,tree", [
    (1, 1.0, False), (3, 1.0, False), (4, 0.7, False), (1, 1.0, True),
    (1, 2.5, True)], ids=["plain", "groups3", "groups4_t0.7", "tree",
                          "tree_t2.5"])
def test_softmax_layer_matches_jax(tree_net, groups, temperature, tree):
    tree_groups = _groups(tree_net[4]) if tree else None
    x = _rand(2, 2, 3, 1, 12 if not tree else 7)
    ref = np.asarray(JL.softmax_layer(jnp.asarray(x), groups, temperature,
                                      tree_groups=tree_groups))
    out = TL.softmax_layer(torch.from_numpy(x), groups, temperature,
                           tree_groups=tree_groups).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_tree_forward_matches_jax(tree_net):
    _, cfg, weights, _, _ = tree_net
    jspec, jparams, _ = jax_build_params(cfg, weights, echo=False)
    spec, params, _ = build_params(cfg, weights, echo=False)
    assert spec.layers[-1].softmax_tree is not None
    x = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    ref = JaxPredictor(jspec, jparams, "fp32")(x)
    out = Predictor(spec, params, "fp32", device="cpu")(x)
    assert len(out) == len(ref) == 1
    np.testing.assert_allclose(out[0].data.numpy(), np.asarray(ref[0].data),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quantized,thresh", [(False, "0.3"), (True, "0.2")],
                         ids=["fp32", "int8"])
def test_tree_detector_test_streams_match_jax_cli(tree_net, capsys, quantized,
                                                  thresh):
    d, cfg, weights, names, _ = tree_net
    args = ["detector", "test", names, cfg, weights, IMAGE, "-thresh", thresh,
            "-dont_show"] + (["-quantized"] if quantized else [])
    capsys.readouterr()
    rc_j = jax_main(args + ["-save", str(d / "jax")])
    out_j, err_j = capsys.readouterr()
    rc_t = torch_main(args + ["-save", str(d / "torch"), "-device", "cpu"])
    out_t, err_t = capsys.readouterr()
    assert rc_j == rc_t == 0, err_t[-2000:]
    assert parse_detection_lines(out_t)[0]
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")


@pytest.mark.parametrize("device_nms", [False, True],
                         ids=["host_nms", "device_nms"])
def test_tree_pipeline_matches_jax(tree_net, device_nms):
    """b=3 uint8 frames at their source size through both pipelines: the
    tree head's hierarchy decode on the device, the same printed
    detections."""
    from tests.fuzz_cfgs import _ulp_class_only
    _, cfg, weights, _, _ = tree_net
    jspec, jparams, jmode = jax_build_params(cfg, weights, echo=False)
    spec, params, mode = build_params(cfg, weights, echo=False)
    kw = dict(thresh=0.3, nms=0.4, k=256, device_nms=device_nms)
    jp = JaxPipeline(jspec, jparams, jmode, **kw)
    tp = DetectionPipeline(spec, params, mode, device="cpu", **kw)
    x = (np.random.RandomState(1).rand(3, 96, 128, 3) * 255).astype(np.uint8)
    ours, theirs = tp(x), jp(x)
    n = 0
    for a, b in zip(ours, theirs):
        la = TB.format_detections(a, NAMES, 0.3, 128, 96).splitlines()
        lb = TB.format_detections(b, NAMES, 0.3, 128, 96).splitlines()
        n += len(la)
        if la != lb:
            assert _ulp_class_only(lb, la), (lb, la)
    assert n > 0


SOFTMAX_CFG = """[net]
width=16
height=16
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters={filters}
size=1
stride=1
activation=linear

[softmax]
groups={groups}
{extra}
"""


@pytest.mark.parametrize("groups,extra,filters", [
    (1, "", 6), (2, "", 6), (1, "temperature=0.5", 6), (1, "tree={tree}", 7)],
    ids=["plain", "groups2", "temperature", "tree"])
def test_softmax_cfg_runs_through_forward_like_jax(tree_net, tmp_path, groups,
                                                   extra, filters):
    """A net ending in [softmax]: the forward's final output (the softmax
    over the flattened map, per group or over the tree's groups) against
    the JAX forward's."""
    from yolo2_light_tpu.models import network as JN
    from yolo2_light_tpu_torch.models import network as TN
    cfg = tmp_path / "sm.cfg"
    cfg.write_text(SOFTMAX_CFG.format(
        groups=groups, filters=filters,
        extra=extra.format(tree=tree_net[4])))
    jspec = JC.parse_network_cfg(str(cfg), batch=1)
    spec = TC.parse_network_cfg(str(cfg), batch=1)
    params = random_params(jspec, seed=4)
    from yolo2_light_tpu.weights import fuse_conv_batchnorm
    params = fuse_conv_batchnorm(jspec, params)
    x = np.random.RandomState(6).rand(2, 16, 16, 3).astype(np.float32)
    _, jaux = JN.build_forward(jspec, "fp32")(JN.params_to_device(params),
                                               jnp.asarray(x))
    _, aux = TN.build_forward(spec, "fp32")(
        TN.device_params(spec, params, "fp32", "cpu"), torch.from_numpy(x))
    ref = np.asarray(jaux["final"])
    out = aux["final"].numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
