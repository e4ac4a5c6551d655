"""``int8_impl="fused"`` in the port: the residual-block pattern match against
the JAX package's ``_fused_stage_runs``, and the fused Predictor against the
port's unfused int8 path (bit-exact) and the JAX fused Predictor (rtol=1e-4,
atol=1e-5, the bound of tests/test_torch_network.py, for the same reason:
the float32 convs of layer 0 and the heads sum in another order than XLA).

The JAX matcher also splits runs to fit a TPU VMEM budget; the port drops
that limit, so the two are compared where it does not bind, and the port's
runs are checked to be the JAX runs merged back where it does.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_fused_network import _residual_cfg
from tests.test_torch_network import _params, _specs, shrunk_yolov3
from yolo2_light_tpu.models import network as JN
from yolo2_light_tpu_torch.models import network as TN
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.ops import int8_conv as K

DATA = os.path.join(os.path.dirname(__file__), "data")
MINI_RES = os.path.join(DATA, "mini-res.cfg")
_RES_BLOCK = ("[convolutional]\nbatch_normalize=1\nfilters=16\nsize=1\n"
              "stride=1\npad=1\nactivation=leaky")


def _runs(cfg):
    spec, tspec = _specs(cfg)
    int8_set = TN._int8_layer_set(tspec, "cpu")
    return (TN._fused_stage_runs(tspec, int8_set),
            JN._fused_stage_runs(spec, int8_set))


def _cfg_from(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _route_on_interior(tmp_path):
    text = open(MINI_RES).read()
    # a route after the first block reads its interior 1x1 output (layer 2)
    i = text.index("[convolutional]\nbatch_normalize=1\nfilters=16\nsize=1",
                   text.index("from=-3"))
    return _cfg_from(tmp_path, "interior.cfg",
                     text[:i] + "[route]\nlayers=-3\n\n" + text[i:])


def _route_mid_stage(tmp_path):
    return _cfg_from(tmp_path, "routed.cfg", open(MINI_RES).read().replace(
        "[convolutional]\nbatch_normalize=1\nfilters=64\nsize=3\nstride=2",
        "[route]\nlayers=-4, -1\n\n[convolutional]\nbatch_normalize=1\n"
        "filters=64\nsize=3\nstride=2", 1))


def _xnor_block(tmp_path):
    return _cfg_from(tmp_path, "xnor.cfg", open(MINI_RES).read().replace(
        _RES_BLOCK, _RES_BLOCK.replace("batch_normalize=1\n",
                                       "batch_normalize=1\nxnor=1\n"), 1))


CFGS = {
    "mini-res": lambda tmp: MINI_RES,
    "mini-yolo3": lambda tmp: os.path.join(DATA, "mini-yolo3.cfg"),
    "mini-yolo2": lambda tmp: os.path.join(DATA, "mini-yolo2.cfg"),
    "shrunk-yolov3": shrunk_yolov3,
    "route-on-interior": _route_on_interior,
    "route-mid-stage": _route_mid_stage,
    "xnor-block": _xnor_block,
    "res512x8": lambda tmp: _residual_cfg(tmp, 512, 256, 8),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_run_sets_match_jax_where_the_budget_does_not_bind(tmp_path, name):
    ours, theirs = _runs(CFGS[name](tmp_path))
    assert ours == theirs


def test_run_sets_of_the_edge_cases():
    """What the cases above pin: mini-res fuses both stages, routes and
    xnor convs break blocks, nets without residual blocks fuse nothing."""
    assert _runs(MINI_RES)[0] == {2: [(2, 3, 4), (5, 6, 7)], 9: [(9, 10, 11)]}
    assert _runs(os.path.join(DATA, "mini-yolo3.cfg"))[0] == {}


def test_route_and_xnor_cases_break_blocks(tmp_path):
    # the route reads block 1's 1x1 output: block 1 breaks (and the 16
    # channels it hands on no longer match block 2's trunk width)
    assert _runs(_route_on_interior(tmp_path))[0] == {10: [(10, 11, 12)]}
    assert _runs(_route_mid_stage(tmp_path))[0] == {
        2: [(2, 3, 4)], 5: [(5, 6, 7)], 10: [(10, 11, 12)]}
    assert 2 not in _runs(_xnor_block(tmp_path))[0]


@pytest.mark.parametrize("c_trunk,c_mid,n", [(1024, 512, 4), (1024, 512, 2)])
def test_vmem_split_is_not_carried_over(tmp_path, c_trunk, c_mid, n):
    """Where the JAX budget splits a stage into single-block runs, the port
    keeps one run whose blocks are the JAX runs' blocks in order."""
    ours, theirs = _runs(_residual_cfg(tmp_path, c_trunk, c_mid, n))
    assert len(theirs) == n and list(ours) == [1]
    assert ours[1] == [blk for s in sorted(theirs) for blk in theirs[s]]


def test_yolov3_fuses_all_23_blocks():
    """On yolov3-416 every residual block fuses (46 convs); 25 int8 convs
    stay on the int8 conv kernel. The JAX package on the CPU leaves the
    208x208 block (and splits the 13x13 stage) under its VMEM budget."""
    spec, tspec = _specs(os.path.join(DATA, "yolov3.cfg"))
    int8_set = TN._int8_layer_set(tspec, "cpu")
    runs = TN._fused_stage_runs(tspec, int8_set)
    assert [len(r) for r in runs.values()] == [1, 2, 8, 8, 4]
    fused_convs = {i for r in runs.values() for i1, i2, _ in r
                   for i in (i1, i2)}
    assert len(fused_convs) == 46
    assert len(int8_set - fused_convs) == 25
    assert [(spec.layers[s].h, spec.layers[s].c, spec.layers[s].n)
            for s in runs] == [(208, 64, 32), (104, 128, 64), (52, 256, 128),
                               (26, 512, 256), (13, 1024, 512)]
    jax_runs = JN._fused_stage_runs(spec, int8_set)
    assert 2 not in jax_runs and sum(map(len, jax_runs.values())) == 22


def _inputs(cfg, batch=2, seed=7):
    spec, tspec = _specs(cfg)
    params = _params(spec, "int8")
    x = np.random.RandomState(seed).rand(batch, spec.net.h, spec.net.w,
                                         spec.net.c).astype(np.float32)
    return spec, tspec, params, x


@pytest.mark.parametrize("name", ["mini-res", "shrunk-yolov3"])
def test_fused_predictor_equals_unfused_path(tmp_path, name):
    _, tspec, params, x = _inputs(CFGS[name](tmp_path))
    K.reset_launch_counts()
    fused = Predictor(tspec, params, "int8", device="cpu",
                      int8_impl="fused")(x)
    unfused = Predictor(tspec, params, "int8", device="cpu")(x)
    assert sum(K.LAUNCH_COUNTS.values()) == 0
    assert len(fused) == len(unfused) >= 1
    for a, b in zip(fused, unfused):
        assert a.index == b.index and torch.equal(a.data, b.data)


@pytest.mark.parametrize("name", ["mini-res", "shrunk-yolov3"])
def test_fused_predictor_matches_jax_fused(tmp_path, name):
    spec, tspec, params, x = _inputs(CFGS[name](tmp_path))
    ref = JN.Predictor(spec, params, "int8", int8_impl="fused")(x)
    out = Predictor(tspec, params, "int8", device="cpu", int8_impl="fused")(x)
    assert len(out) == len(ref) >= 1
    for o, r in zip(out, ref):
        assert (o.index, o.kind) == (r.index, r.kind)
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   rtol=1e-4, atol=1e-5)


def test_gpu_policy_stays_unported_with_fused():
    """The fused kernel implements the cpu requant only: under the gpu
    policy ``-int8_impl fused`` fuses nothing (JAX network.py:319-321), and
    its forward is the xla engine's, which matches JAX's."""
    spec, tspec = _specs(MINI_RES)
    params = _params(spec, "int8")
    x = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    a = Predictor(tspec, params, "int8", device="cpu", int8_policy="gpu",
                  int8_impl="fused")(x)
    b = Predictor(tspec, params, "int8", device="cpu", int8_policy="gpu")(x)
    ref = JN.Predictor(spec, params, "int8", int8_policy="gpu",
                       int8_impl="fused")(x)
    for o, p, r in zip(a, b, ref):
        assert torch.equal(o.data, p.data)
        np.testing.assert_allclose(o.data.numpy(), np.asarray(r.data),
                                   rtol=1e-4, atol=1e-5)


def test_fused_in_fp32_mode_runs_the_fp32_path():
    spec, tspec = _specs(MINI_RES)
    params = _params(spec, "fp32")
    x = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    a = Predictor(tspec, params, "fp32", device="cpu", int8_impl="fused")(x)
    b = Predictor(tspec, params, "fp32", device="cpu")(x)
    assert torch.equal(a[0].data, b[0].data)
