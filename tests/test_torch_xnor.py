"""The port's XNOR (BIT1) path against the JAX package's, on the CPU.

On the CPU the port runs its bit kernels' plain PyTorch versions; the JAX
side runs eager ``L.conv2d_xnor`` (XLA, not Pallas) and the Pallas kernels
in interpret mode, as tests/test_pallas_xnor.py runs them. Tolerances:

* conv level, against eager ``L.conv2d_xnor``: bit-exact. Both sum the same
  +-1 products into the same integer and round ``dot * mean`` and ``+ bias``
  separately;
* conv level, against the interpret-mode Pallas kernels: rtol=atol=1e-5, the
  bound tests/test_pallas_xnor.py holds them to, since the jitted epilogue
  may contract an FMA (F7 in ROADMAP);
* network level, against the JAX Predictor: rtol=1e-4, atol=1e-5, as
  tests/test_torch_network.py: the float first conv and the head sum in
  another order than XLA. A sign flip at a zero crossing after that conv
  would show as an error far above the bound.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.util_parity import assert_streams_match, parse_detection_lines
from yolo2_light_tpu.apps.cli import main as jax_main
from yolo2_light_tpu.cfg import ConvSpec, parse_network_cfg
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models.network import Predictor as JaxPredictor
from yolo2_light_tpu.ops.pallas_xnor import (_pack_activations,
                                             conv2d_xnor_pallas, pack_weights)
from yolo2_light_tpu.weights import (fuse_conv_batchnorm, random_params,
                                     save_weights)
from yolo2_light_tpu.xnor import binarize_params as jax_binarize
from yolo2_light_tpu_torch import cfg as TC
from yolo2_light_tpu_torch.apps.cli import main as torch_main
from yolo2_light_tpu_torch.models import layers as L
from yolo2_light_tpu_torch.models import network as TN
from yolo2_light_tpu_torch.models.network import Predictor
from yolo2_light_tpu_torch.ops import xnor_gemm as XG
from yolo2_light_tpu_torch.xnor import (binarize_params, has_xnor,
                                        pack_sign_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
MINI = os.path.join(DATA, "mini-xnor.cfg")
TINY = os.path.join(DATA, "tiny-yolo-obj_xnor.cfg")
IMAGE = os.path.join(DATA, "dog160.png")
ENGINES = ("int8", "pallas", "pallas_mxu", "auto")
# (B, C, M, HW): tests/test_pallas_xnor.py's grid, and C=16 at b=2 with M
# not a multiple of 8 (half-padded words, ragged filter tiles)
GRID = [(2, 16, 8, 12), (2, 32, 32, 9), (2, 48, 24, 7), (2, 16, 40, 6)]


def _conv_inputs(seed, b, c, m, hw, ks=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hw, hw, c).astype(np.float32)
    w = (rng.randn(ks, ks, c, m) * 0.1).astype(np.float32)
    bias = rng.randn(m).astype(np.float32)
    mean = np.mean(np.abs(w), axis=(0, 1, 2)).astype(np.float32)
    sign = np.where(w > 0, 1, -1).astype(np.int8)
    return x, w, sign, mean, bias


def _port_conv(engine, x, sign, mean, bias, stride=1, pad=1,
               activation="leaky"):
    """The port's conv on one engine: "dense" (layers.conv2d_xnor),
    "popcount" or "mxu" (the bit kernels' plain versions)."""
    x, mean, bias = (torch.from_numpy(a) for a in (x, mean, bias))
    if engine == "dense":
        ws = torch.from_numpy(sign).permute(3, 2, 0, 1).float()
        return L.conv2d_xnor(x, ws, mean, bias, stride, pad,
                             activation).numpy()
    wp = torch.from_numpy(pack_sign_weights(sign))
    return XG.conv2d_xnor_bits(x, wp, mean, bias, c_real=sign.shape[2],
                               stride=stride, pad=pad, activation=activation,
                               engine=engine).numpy()


def _jax_conv(x, sign, mean, bias, stride=1, pad=1, activation="leaky"):
    return np.asarray(JL.conv2d_xnor(jnp.asarray(x), jnp.asarray(sign),
                                     jnp.asarray(mean), jnp.asarray(bias),
                                     stride, pad, activation))


# ---------------------------------------------------------------------------
# Binarization and bit packing
# ---------------------------------------------------------------------------


def _mini_params(seed=6):
    """mini-xnor parsed by each side (the port's layer dispatch checks its
    own spec classes) and the JAX package's params for it."""
    spec = parse_network_cfg(MINI, batch=1)
    return (spec, TC.parse_network_cfg(MINI, batch=1),
            fuse_conv_batchnorm(spec, random_params(spec, seed=seed)))


def test_binarize_params_matches_jax():
    spec, tspec, params = _mini_params()
    ours, ref = binarize_params(tspec, params), jax_binarize(spec, params)
    assert has_xnor(tspec)
    n_xnor = 0
    for l, p, r in zip(spec.layers, ours, ref):
        if not (isinstance(l, ConvSpec) and l.xnor):
            assert p is params[l.index]
            continue
        n_xnor += 1
        np.testing.assert_array_equal(p["mean_arr"], r["mean_arr"])
        assert p["mean_arr"].dtype == np.float32
        np.testing.assert_array_equal(p["sign_weights"], r["sign_weights"])
        assert p["sign_weights"].dtype == np.int8
        assert "packed_weights" not in p
        # the port's [M, kh, kw, C32] words hold the JAX [M, F] bits, whose
        # feature order is (c32, kh, kw)
        words = pack_sign_weights(p["sign_weights"])
        m, kh, kw, c32 = words.shape
        feat = words.transpose(0, 3, 1, 2).reshape(m, c32 * kh * kw)
        packed = r["packed_weights"]
        np.testing.assert_array_equal(packed[:m, :feat.shape[1]], feat)
        assert not packed[m:].any() and not packed[:, feat.shape[1]:].any()
    assert n_xnor == 2


def test_pack_sign_weights_bit_order_and_pad():
    rng = np.random.RandomState(1)
    sign = np.where(rng.randn(3, 3, 48, 5) > 0, 1, -1).astype(np.int8)
    words = pack_sign_weights(sign)
    assert words.shape == (5, 3, 3, 2) and words.dtype == np.int32
    u = words.view(np.uint32).astype(np.uint64)
    bits = (u[..., None] >> np.arange(32, dtype=np.uint64)) & 1
    bits = bits.reshape(5, 3, 3, 64)
    np.testing.assert_array_equal(bits[..., :48],
                                  np.transpose(sign > 0, (3, 0, 1, 2)))
    assert not bits[..., 48:].any()          # channel-pad bits are 0


@pytest.mark.parametrize("c", [16, 32, 48])
def test_pack_activations_matches_jax(c):
    x = np.random.RandomState(c).randn(2, 5, 4, c).astype(np.float32)
    x[0, 0, 0, :4] = 0.0                     # x > 0, not x >= 0
    ref, c32 = _pack_activations(jnp.asarray(x), c)
    out = XG.pack_activations(torch.from_numpy(x), c)
    assert out.dtype == torch.int32 and out.shape[-1] == c32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# Conv level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["dense", "popcount", "mxu"])
@pytest.mark.parametrize("activation", ["leaky", "linear"])
@pytest.mark.parametrize("b,c,m,hw", GRID)
def test_conv_bit_exact_to_eager_jax(engine, activation, b, c, m, hw):
    x, _, sign, mean, bias = _conv_inputs(c + m, b, c, m, hw)
    ref = _jax_conv(x, sign, mean, bias, activation=activation)
    out = _port_conv(engine, x, sign, mean, bias, activation=activation)
    assert out.shape == (b, hw, hw, m) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("engine", ["popcount", "mxu"])
@pytest.mark.parametrize("b,c,m,hw", GRID)
def test_conv_matches_interpret_pallas(engine, b, c, m, hw):
    x, w, sign, mean, bias = _conv_inputs(c * m, b, c, m, hw)
    packed, _, k_real = pack_weights(w)
    ref = np.asarray(conv2d_xnor_pallas(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(mean),
        jnp.asarray(bias), size=3, stride=1, pad=1, c_real=c, k_real=k_real,
        interpret=True, engine=engine))
    out = _port_conv(engine, x, sign, mean, bias)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_linear_matches_interpret_pallas():
    x, w, sign, mean, bias = _conv_inputs(3, 2, 48, 24, 7)
    packed, _, k_real = pack_weights(w)
    for engine in ("popcount", "mxu"):
        ref = np.asarray(conv2d_xnor_pallas(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(mean),
            jnp.asarray(bias), size=3, stride=1, pad=1, c_real=48,
            k_real=k_real, activation="linear", interpret=True,
            engine=engine))
        out = _port_conv(engine, x, sign, mean, bias, activation="linear")
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,pad", [(2, 1), (1, 0), (2, 0)])
def test_f5_other_geometries_pad_with_zero(stride, pad):
    """F5: off the bit path (stride 1, pad 1) the dense engine is the
    binarized float conv, whose padding is 0.0, bit-exact to JAX."""
    x, _, sign, mean, bias = _conv_inputs(11, 2, 32, 16, 9)
    ref = _jax_conv(x, sign, mean, bias, stride, pad)
    out = _port_conv("dense", x, sign, mean, bias, stride, pad)
    np.testing.assert_array_equal(out, ref)


def test_f5_bit_path_borders_are_minus_one():
    """F5: at stride 1, pad 1 the padding counts as -1: the border outputs
    differ from a zero-padded +-1 conv, the interior ones do not."""
    x, _, sign, mean, bias = _conv_inputs(12, 1, 32, 16, 6)
    out = _port_conv("dense", x, sign, mean, bias)
    xb = torch.where(torch.from_numpy(x) > 0, 1.0, -1.0).permute(0, 3, 1, 2)
    acc = torch.nn.functional.conv2d(
        xb, torch.from_numpy(sign).permute(3, 2, 0, 1).float(), padding=1)
    zero_pad = L.activate(acc.permute(0, 2, 3, 1) * torch.from_numpy(mean)
                          + torch.from_numpy(bias), "leaky").numpy()
    np.testing.assert_array_equal(out[:, 1:-1, 1:-1], zero_pad[:, 1:-1, 1:-1])
    assert (out[:, 0] != zero_pad[:, 0]).any()
    for engine in ("popcount", "mxu"):
        np.testing.assert_array_equal(
            _port_conv(engine, x, sign, mean, bias), out)


def test_f3_xnor_leaky_is_point_one_times_y():
    """F3: the XNOR path's leaky is 0.1*y (float32 multiply), not the int8
    path's y/10, in every engine and in JAX. A 1x1 conv with mean 0 puts
    y = bias on the output."""
    ys = np.float32(-np.arange(1, 2000)) / np.float32(7)
    diff = ys[np.float32(0.1) * ys != ys / np.float32(10)]
    assert diff.size
    y0 = diff[:3]
    x = np.ones((1, 2, 2, 8), np.float32)
    sign = np.ones((1, 1, 8, 3), np.int8)
    mean = np.zeros(3, np.float32)
    ref = _jax_conv(x, sign, mean, y0, 1, 0)
    np.testing.assert_array_equal(ref[0, 0, 0], np.float32(0.1) * y0)
    for engine in ("dense", "popcount", "mxu"):
        out = _port_conv(engine, x, sign, mean, y0, 1, 0)
        np.testing.assert_array_equal(out, ref)
        assert (out[0, 0, 0] != y0 / np.float32(10)).all()


def test_plain_versions_count_the_same_integer():
    """K3's 2*cnt - adjust and K4's dot - pad_bits are the same integer at
    an odd geometry (size 3, stride 2, C = 40), so the two engines agree
    bit for bit with each other off the network's bit path too."""
    x, _, sign, mean, bias = _conv_inputs(5, 3, 40, 19, 8)
    a = _port_conv("popcount", x, sign, mean, bias, 2, 1)
    b = _port_conv("mxu", x, sign, mean, bias, 2, 1)
    np.testing.assert_array_equal(a, b)


def _and_popc_dot(pt, wf):
    """The +-1 dot over every stored bit of patch rows ``pt`` [N, K] and
    filter rows ``wf`` [M, K] (int32 words) as K4 forms it from
    and-popcounts: ``4*popc(a & b) - 2*popc(a) - 2*popc(b) + K*32``,
    int64 ``[N, M]``."""
    a = pt.to(torch.int64) & 0xFFFFFFFF
    b = wf.to(torch.int64) & 0xFFFFFFFF
    both = XG._popcount32(a[:, None, :] & b[None, :, :]).sum(-1)
    return (4 * both - 2 * XG._popcount32(a).sum(-1)[:, None]
            - 2 * XG._popcount32(b).sum(-1)[None, :] + a.shape[1] * 32)


def _and_popc_conv(x, sign, mean, bias, activation="leaky"):
    """K4's arithmetic (and-popcounts, then dot - pad_bits and the
    epilogue) as a conv at stride 1, pad 1."""
    c, m = sign.shape[2], sign.shape[3]
    xp = XG.pack_activations(torch.from_numpy(x), c)
    wp = torch.from_numpy(pack_sign_weights(sign))
    dot = _and_popc_dot(XG.im2col_bits(xp, 3, 1, 1), wp.reshape(m, -1))
    _, pad_bits = XG._constants(3, xp.shape[-1], c)
    y = XG.epilogue_plain(dot - pad_bits, torch.from_numpy(mean),
                          torch.from_numpy(bias), activation)
    return y.reshape(*x.shape[:3], m).numpy()


@pytest.mark.parametrize("b,c,m,hw", GRID)
def test_and_popcount_identity_equals_pm1_dot(b, c, m, hw):
    """4*popc(a&b) - 2*popc(a) - 2*popc(b) + kwords*32 - pad_bits over the
    patch matrix is the integer +-1 dot of xnor_gemm_mxu_plain, exactly:
    border taps (0 words), half-padded words (C = 48) and kwords not a
    multiple of 8 (9 and 18) included."""
    x, _, sign, _, _ = _conv_inputs(7 * c + m, b, c, m, hw)
    xp = XG.pack_activations(torch.from_numpy(x), c)
    wp = torch.from_numpy(pack_sign_weights(sign))
    pt = XG.im2col_bits(xp, 3, 1, 1)
    wf = wp.reshape(m, -1)
    assert pt.shape[1] % 8                      # not whole 256-bit steps
    _, pad_bits = XG._constants(3, xp.shape[-1], c)
    dot = _and_popc_dot(pt, wf) - pad_bits
    pm1 = XG._unpack_pm1(pt) @ XG._unpack_pm1(wf).T - pad_bits
    assert dot.dtype == torch.int64
    assert torch.equal(dot, pm1.to(torch.int64))
    assert (pt == 0).any()                      # the border's 0 words


@pytest.mark.parametrize("activation", ["leaky", "linear"])
@pytest.mark.parametrize("b,c,m,hw", GRID)
def test_and_popcount_conv_bit_exact_to_eager_jax(activation, b, c, m, hw):
    x, _, sign, mean, bias = _conv_inputs(c + m, b, c, m, hw)
    ref = _jax_conv(x, sign, mean, bias, activation=activation)
    np.testing.assert_array_equal(
        _and_popc_conv(x, sign, mean, bias, activation), ref)


@pytest.mark.parametrize("b,c,m,hw", GRID)
def test_and_popcount_conv_matches_interpret_pallas(b, c, m, hw):
    x, w, sign, mean, bias = _conv_inputs(c * m, b, c, m, hw)
    packed, _, k_real = pack_weights(w)
    ref = np.asarray(conv2d_xnor_pallas(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(mean),
        jnp.asarray(bias), size=3, stride=1, pad=1, c_real=c, k_real=k_real,
        interpret=True, engine="mxu"))
    np.testing.assert_allclose(_and_popc_conv(x, sign, mean, bias), ref,
                               rtol=1e-5, atol=1e-5)


# (B, H, W, C, M): tiny-yolo-obj_xnor-416's seven XNOR convs, then ragged
# and batched shapes
PLAN_SHAPES = [(1, 208, 208, 16, 32), (1, 104, 104, 32, 64),
               (1, 52, 52, 64, 128), (1, 26, 26, 128, 256),
               (1, 13, 13, 256, 512), (1, 13, 13, 512, 1024),
               (1, 13, 13, 1024, 1024), (2, 11, 9, 48, 40), (2, 7, 5, 16, 3),
               (3, 1, 1, 33, 70), (4, 104, 104, 32, 64),
               (1, 13, 13, 1024, 1000)]


@pytest.mark.parametrize("engine", ["popcount", "mxu"])
@pytest.mark.parametrize("b,h,w,c,m", PLAN_SHAPES)
def test_plan_fits_the_card_and_covers_the_conv(engine, b, h, w, c, m):
    c32 = -(-c // 32)
    plan = XG.plan_launch(b, h, w, c32, m, 3, 1, 1, engine)
    kwords = 9 * c32
    assert (plan.tile_p, plan.tile_m) in XG.TILES + (XG.WARP_SPLIT_TILE,)
    assert plan.warp_split == ((plan.tile_p, plan.tile_m)
                               == XG.WARP_SPLIT_TILE)
    assert plan.warp_split or plan.tile_p * plan.tile_m == XG.TILE_AREA
    assert XG.THREADS <= 1024 and XG.THREADS % 32 == 0
    assert plan.smem == XG.smem_bytes(plan.tile_p, plan.tile_m, plan.kstep,
                                      plan.stages, plan.split) <= XG.MAX_SMEM
    assert plan.p_tiles * plan.tile_p >= b * h * w > (plan.p_tiles - 1) \
        * plan.tile_p
    assert plan.m_tiles * plan.tile_m >= m > (plan.m_tiles - 1) * plan.tile_m
    assert plan.kstep in XG.KSTEPS and plan.kstep % 8 == 0
    assert plan.steps * plan.kstep >= kwords > (plan.steps - 1) * plan.kstep
    assert 1 <= plan.split <= min(XG.MAX_SPLIT, plan.steps)
    assert 2 <= plan.stages <= XG.MAX_STAGES
    assert plan.blocks == plan.p_tiles * plan.m_tiles * plan.split
    assert plan.m_tiles <= 65535 and plan.blocks < 2 ** 31


@pytest.mark.parametrize("engine", ["popcount", "mxu"])
def test_plan_gives_each_conv_its_geometry(engine):
    """The kwords = 9 convs take large pixel tiles and no split; where the
    4096-output tiles leave SMs idle and the window has 16 words or more
    (52x52 down to 13x13) the warp split's 32x32 tile: K4 with 32-word
    steps, split across a cluster of 2 at the 288-word conv; K3 split
    across a cluster at the 13x13 convs of 144 and 288 words; a batch
    whose tiles fill the card neither."""
    plans = {(h, c): XG.plan_launch(b, h, w, -(-c // 32), m, 3, 1, 1, engine)
             for b, h, w, c, m in PLAN_SHAPES[:7]}
    for key in ((208, 16), (104, 32)):
        plan = plans[key]
        assert plan.split == 1 and plan.tile_p >= 64 and not plan.warp_split
    assert plans[208, 16].tile_p == 128      # M = 32: no padded filters
    for key in ((52, 64), (26, 128), (13, 256), (13, 512), (13, 1024)):
        plan = plans[key]
        assert plan.warp_split
        if engine == "mxu":
            assert plan.kstep == 32
            assert plan.split == (2 if key == (13, 1024) else 1)
        else:
            assert (plan.split > 1) == (key in ((13, 512), (13, 1024)))
    for b, h, c32, m in ((4, 104, 1, 64), (8, 26, 4, 256), (8, 13, 32, 1024)):
        plan = XG.plan_launch(b, h, h, c32, m, 3, 1, 1, engine)
        assert not plan.warp_split and plan.split == 1
        assert plan.p_tiles * plan.m_tiles >= XG.SM_COUNT
    with pytest.raises(ValueError, match="XNOR engine"):
        XG.plan_launch(1, 13, 13, 8, 512, 3, 1, 1, "int8")


@pytest.mark.parametrize("tiles,kwords,kstep,split", [
    (192, 288, 16, 2), (192, 288, 32, 3), (96, 72, 32, 1), (176, 36, 16, 3),
    (384, 144, 16, 5), (1, 9, 16, 1)])
def test_busiest_sm_words_charges_the_first_rank(tiles, kwords, kstep,
                                                 split):
    """K3's planner model: the busiest SM holds ceil(blocks / 132) blocks,
    each charged the real window words of a cluster's first rank, which
    has the most under the kernel's division of the steps (each rank
    steps // split, the first steps % split ranks one more), and
    K3_BLOCK_WORDS for its set-up and epilogue."""
    steps = -(-kwords // kstep)
    words, lo = [], 0
    for rank in range(split):
        n = steps // split + (rank < steps % split)
        words.append(min(kwords, (lo + n) * kstep) - lo * kstep)
        lo += n
    assert lo == steps and sum(words) == kwords and words[0] == max(words)
    assert XG._busiest_sm_words(tiles, kwords, kstep, split) == \
        -(-tiles * split // XG.SM_COUNT) * (words[0] + XG.K3_BLOCK_WORDS)


def test_bit_engines_refuse_other_activations():
    x, _, sign, mean, bias = _conv_inputs(2, 1, 16, 8, 4)
    with pytest.raises(ValueError, match="epilogue"):
        _port_conv("popcount", x, sign, mean, bias, activation="relu")
    with pytest.raises(ValueError, match="XNOR engine"):
        XG.conv2d_xnor_bits(torch.zeros(1, 2, 2, 16), None, None, None,
                            c_real=16, stride=1, pad=1, engine="triton")


# ---------------------------------------------------------------------------
# Network level
# ---------------------------------------------------------------------------


def shrunk_tiny_xnor(tmp_path, size=64, div=8):
    """tiny-yolo-obj_xnor.cfg at ``size`` x ``size`` with every conv but the
    125-filter head divided in width by ``div``."""
    import re
    with open(TINY) as f:
        text = f.read()
    text = text.replace("width=416", f"width={size}").replace(
        "height=416", f"height={size}")
    text = re.sub(r"filters=(\d+)", lambda m: m.group(0) if m.group(1) == "125"
                  else f"filters={int(m.group(1)) // div}", text)
    p = tmp_path / "tiny-xnor-shrunk.cfg"
    p.write_text(text)
    return str(p)


def _compare_network(cfg, seed=6):
    spec, tspec = parse_network_cfg(cfg, batch=1), TC.parse_network_cfg(
        cfg, batch=1)
    base = fuse_conv_batchnorm(spec, random_params(spec, seed=seed))
    ours, ref = binarize_params(tspec, base), jax_binarize(spec, base)
    x = np.random.RandomState(3).rand(2, spec.net.h, spec.net.w,
                                      spec.net.c).astype(np.float32)
    heads = {}
    for eng in ENGINES:
        r = JaxPredictor(spec, ref, xnor_impl=eng)(x)
        o = Predictor(tspec, ours, device="cpu", xnor_impl=eng)(x)
        assert len(o) == len(r) >= 1
        for a, b in zip(o, r):
            assert (a.index, a.kind) == (b.index, b.kind)
            np.testing.assert_allclose(a.data.numpy(), np.asarray(b.data),
                                       rtol=1e-4, atol=1e-5, err_msg=eng)
        heads[eng] = o
    for eng in ENGINES[1:]:       # the port's engines are bit-identical
        for a, b in zip(heads[eng], heads["int8"]):
            assert torch.equal(a.data, b.data), eng


def test_mini_xnor_network_matches_jax():
    _compare_network(MINI)


def test_shrunk_tiny_xnor_network_matches_jax(tmp_path):
    _compare_network(shrunk_tiny_xnor(tmp_path))


def test_predictor_accepts_jax_binarized_params():
    """A params list binarized by the JAX package carries its TPU-layout
    packed_weights; the port packs its own from sign_weights instead."""
    spec, tspec, params = _mini_params()
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    a = Predictor(tspec, binarize_params(tspec, params), device="cpu",
                  xnor_impl="pallas")(x)
    b = Predictor(tspec, jax_binarize(spec, params), device="cpu",
                  xnor_impl="pallas")(x)
    assert torch.equal(a[0].data, b[0].data)


@pytest.mark.parametrize("engine,kept", [
    ("int8", {"sign_weights"}),
    ("pallas", {"packed_weights"}),
    ("pallas_mxu", {"packed_weights"}),
    ("auto", {"sign_weights", "packed_weights"}),
])
def test_predictor_keeps_the_weights_of_its_engines(engine, kept):
    _, tspec, params = _mini_params()
    pred = Predictor(tspec, binarize_params(tspec, params), device="cpu",
                     xnor_impl=engine)
    names = dict(pred.named_buffers())
    assert "l0_weights" in names and "l0_sign_weights" not in names
    for i in (2, 4):          # mini-xnor's two XNOR convs
        have = {k.split("_", 1)[1] for k in names if k.startswith(f"l{i}_")}
        assert have == kept | {"mean_arr", "biases"}, have
    if "packed_weights" in kept:
        wp = names["l2_packed_weights"]
        assert wp.dtype == torch.int32 and wp.shape == (32, 3, 3, 1)
    if "sign_weights" in kept:
        assert names["l2_sign_weights"].shape == (32, 32, 3, 3)


def test_engine_dispatch_rule():
    """The bit engines run only on the bit path; auto takes K4 at GEMM
    M = batch*oh*ow up to the port's threshold and the dense conv above."""
    spec = TC.parse_network_cfg(TINY, batch=1)
    conv = spec.layers[13]                      # 13x13, 1024 -> 1024
    assert TN._xnor_engine(conv, "pallas", 1) == "pallas"
    assert TN._xnor_engine(conv, "pallas_mxu", 1) == "pallas_mxu"
    assert TN._xnor_engine(conv, "int8", 1) == "int8"
    assert TN._xnor_engine(conv, "auto", 1) == "pallas_mxu"
    limit = XG.AUTO_MXU_MAX_PIXELS
    assert XG.auto_prefers_mxu(limit) and not XG.auto_prefers_mxu(limit + 1)
    big = limit // (conv.out_h * conv.out_w) + 1
    assert TN._xnor_engine(conv, "auto", big) == "int8"
    for off_path in (dataclasses.replace(conv, stride=2),
                     dataclasses.replace(conv, pad=0)):
        for eng in ENGINES:
            assert TN._xnor_engine(off_path, eng, 1) == "int8"


def test_unknown_xnor_impl_is_a_value_error():
    spec = TC.parse_network_cfg(MINI, batch=1)
    with pytest.raises(ValueError, match=r"unknown xnor_impl 'popcount' "
                       r"\(expected int8, pallas, pallas_mxu, or auto\)"):
        TN.build_forward(spec, xnor_impl="popcount")


# ---------------------------------------------------------------------------
# The CLI and the cfg
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("xnor_cli")
    spec = parse_network_cfg(MINI, batch=1)
    weights = str(d / "mini-xnor.weights")
    save_weights(spec, random_params(spec, seed=1), weights)
    names = str(d / "mini.names")
    with open(names, "w") as f:
        f.write("a\nb\nc\n")
    return d, names, weights


def _run(main, capsys, args):
    capsys.readouterr()
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("engine", ENGINES + ("fast",))
def test_detector_test_streams_match_jax_cli(assets, capsys, engine):
    d, names, weights = assets
    args = ["detector", "test", names, MINI, weights, IMAGE, "-thresh", "0.1",
            "-dont_show", "-xnor_kernel", engine]
    rc_j, out_j, err_j = _run(jax_main, capsys,
                              args + ["-save", str(d / f"j_{engine}")])
    rc_t, out_t, err_t = _run(torch_main, capsys,
                              args + ["-save", str(d / f"t_{engine}"),
                                      "-device", "cpu"])
    assert rc_j == rc_t == (1 if engine == "fast" else 0)
    if engine == "fast":
        assert "Error: unknown xnor_impl 'fast'" in err_t
    else:
        assert len(parse_detection_lines(out_t)[0]) >= 10
    drop = ("Predicted in",)
    assert_streams_match(out_t, out_j, drop=drop, context="stdout")
    assert_streams_match(err_t, err_j, drop=drop, context="stderr")


def test_tiny_xnor_cfg_topology():
    """tests/data/tiny-yolo-obj_xnor.cfg has the shape tests/test_cfg.py
    expects of the reference's: 16 layers, 9 convs, the head at 15, the
    first conv dense; and the seven XNOR convs at 416 are the shapes the
    chip check runs."""
    spec = parse_network_cfg(TINY, batch=1)
    assert spec.n == 16 and len(spec.conv_layers()) == 9
    assert spec.head_indices() == [15]
    convs = spec.conv_layers()
    assert not convs[0].xnor and not convs[-1].xnor
    xnor = [(l.h, l.w, l.c, l.n) for l in convs if l.xnor]
    assert xnor == [(208, 208, 16, 32), (104, 104, 32, 64), (52, 52, 64, 128),
                    (26, 26, 128, 256), (13, 13, 256, 512),
                    (13, 13, 512, 1024), (13, 13, 1024, 1024)]
    assert all(l.bin_output and l.size == 3 and l.stride == 1 and l.pad == 1
               and l.activation == "leaky" for l in convs if l.xnor)
    head = spec.layers[15]
    assert (head.classes, head.n, head.coords) == (20, 5, 4)
    assert (convs[-1].n, convs[-1].size, convs[-1].activation) == (125, 1,
                                                                  "linear")


def test_tiny_xnor_cfg_is_generated_by_script(tmp_path):
    import importlib.util
    path = os.path.join(REPO, "scripts", "gen_tiny_xnor_cfg.py")
    spec = importlib.util.spec_from_file_location("gen_tiny_xnor_cfg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "t.cfg"
    assert mod.main([str(out)]) == 0
    with open(TINY, "rb") as f:
        assert out.read_bytes() == f.read()
