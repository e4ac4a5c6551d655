"""The port's fused residual block (ops/fused_res) against the JAX package's
fused residual stage (ops/pallas_fused.py).

On the CPU the port runs the kernel's plain PyTorch version. Against the
EAGER (un-jitted) ``res_stage_reference``, the XLA ops the unfused int8 path
runs, it must be bit-exact. Against the Pallas ``fused_res_stage`` and
``fused_res_stage_strips`` in interpret mode it is held to rtol=atol=1e-5:
those run under jit, where XLA rewrites the leaky's /10 into a multiply, so
they land up to 1 ULP off eager XLA (tests/test_pallas_fused.py). A
quantization-bin flip would show as an error far above that bound and is
classified as F7 (ROADMAP), never hidden by widening it.

The multipliers are np.float32, as ``quant.quantize_params`` makes them.
The eager bit-exact tests run at the weight multipliers of
tests/test_pallas_fused.py, [2, 6), and at [64, 256). The interpret-mode
Pallas comparisons run at [64, 256) only, where the int8 weights stand for
float weights within +-2: at [2, 6) they stand for +-50, the trunk reaches
the thousands, and where a block's output cancels such a trunk down to about
1, the trunk's 1-ULP jit difference alone exceeds 1e-5 (F7 in ROADMAP).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from yolo2_light_tpu.ops.pallas_fused import (fused_res_stage as jax_stage,
                                              fused_res_stage_strips as
                                              jax_strips, res_stage_reference)
from yolo2_light_tpu_torch.models import layers as L
from yolo2_light_tpu_torch.ops import fused_res as FR
from yolo2_light_tpu_torch.ops import int8_conv as K

STAGES = [(16, 32, 16, 1), (16, 32, 16, 2), (26, 64, 32, 4)]
STRIPS = [(16, 4), (24, 3), (16, 1)]
JAX_GRID_WM = (2, 6)       # tests/test_pallas_fused.py's weight multipliers
NARROW_WM = (64, 256)      # clear of F7 under jit
WM_RANGES = [JAX_GRID_WM, NARROW_WM]


def _mkblocks(rng, K_, C, C2, b1_shift=0.0, wm=NARROW_WM):
    return [dict(
        w1=rng.randint(-100, 100, (1, 1, C, C2)).astype(np.int8),
        b1=(rng.randn(C2) * 0.2 + b1_shift).astype(np.float32),
        m1=np.float32(rng.uniform(8, 24)),
        wm1=np.float32(rng.uniform(*wm)),
        w2=rng.randint(-100, 100, (3, 3, C2, C)).astype(np.int8),
        b2=(rng.randn(C) * 0.2).astype(np.float32),
        m2=np.float32(rng.uniform(8, 24)),
        wm2=np.float32(rng.uniform(*wm)),
    ) for _ in range(K_)]


def _eager_ref(x, blocks):
    return np.asarray(res_stage_reference(jnp.asarray(x), blocks))


def _stage_inputs(H, C, C2, K_, seed, wm=NARROW_WM):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, H, H, C).astype(np.float32)
    return x, _mkblocks(rng, K_, C, C2, wm=wm)


@pytest.mark.parametrize("wm", WM_RANGES)
@pytest.mark.parametrize("H,C,C2,K_", STAGES)
def test_stage_bit_exact_to_eager_reference(H, C, C2, K_, wm):
    x, blocks = _stage_inputs(H, C, C2, K_, H + K_, wm)
    out = FR.fused_res_stage(torch.from_numpy(x), blocks)
    assert out.dtype == torch.float32 and out.shape == x.shape
    np.testing.assert_array_equal(out.numpy(), _eager_ref(x, blocks))


@pytest.mark.parametrize("H,C,C2,K_", STAGES)
def test_stage_matches_interpret_pallas(H, C, C2, K_):
    """Block by block along the chain, at NARROW_WM: each Pallas block is
    fed the port's previous output, so each comparison sees one block's jit
    difference. End to end, the 1-ULP trunk difference of block k flips a
    quantization bin in block k+1 at (26, 64, 32, 4) (F7 in ROADMAP)."""
    x, blocks = _stage_inputs(H, C, C2, K_, H + K_)
    cur = x
    for blk in blocks:
        ref = np.asarray(jax.jit(
            lambda a: jax_stage(a, [blk], interpret=True))(jnp.asarray(cur)))
        cur = FR.fused_res_stage(torch.from_numpy(cur), [blk]).numpy()
        np.testing.assert_allclose(cur, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        cur, FR.fused_res_stage(torch.from_numpy(x), blocks).numpy())


@pytest.mark.parametrize("wm", WM_RANGES)
@pytest.mark.parametrize("H,n_strips", STRIPS)
def test_strips_bit_exact_to_eager_reference(H, n_strips, wm):
    x, blocks = _stage_inputs(H, 32, 16, 1, n_strips, wm)
    out = FR.fused_res_stage_strips(torch.from_numpy(x), blocks,
                                    n_strips=n_strips)
    np.testing.assert_array_equal(out.numpy(), _eager_ref(x, blocks))


@pytest.mark.parametrize("H,n_strips", STRIPS)
def test_strips_match_interpret_pallas(H, n_strips):
    """At NARROW_WM (F7 in ROADMAP)."""
    x, blocks = _stage_inputs(H, 32, 16, 1, n_strips)
    ref = np.asarray(jax.jit(
        lambda a: jax_strips(a, blocks, n_strips=n_strips,
                             interpret=True))(jnp.asarray(x)))
    out = FR.fused_res_stage_strips(torch.from_numpy(x), blocks,
                                    n_strips=n_strips)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_strips_take_exactly_one_block():
    x, blocks = _stage_inputs(8, 8, 4, 2, 0)
    with pytest.raises(AssertionError, match="exactly one"):
        FR.fused_res_stage_strips(torch.from_numpy(x), blocks)


def _padded_trunk_variant(x, blk):
    """The halo-mask fault: quantize the zero-padded trunk, so a border tap
    of the 3x3 sees q8(leaky10(b1)) where the reference sees 0."""
    a = FR._torch_block(blk, "cpu")
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(0, 2, 3, 1)
    t1 = K.conv2d_int8_plain(L.quantize_i8(xp, a["m1"]), a["w1"], a["b1"],
                             a["alpha1"], 1, 0, "leaky")
    y = K.conv2d_int8_plain(L.quantize_i8(t1, a["m2"]), a["w2"], a["b2"],
                            a["alpha2"], 1, 0, "leaky")
    return x + y


def test_halo_mask_with_large_positive_b1():
    """With b1 >> 0 the padded-trunk variant differs on the image border;
    the port's block is bit-exact to the reference there too."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 9, 7, 16).astype(np.float32)
    blocks = _mkblocks(rng, 1, 16, 8, b1_shift=3.0)
    out = FR.fused_res_stage(torch.from_numpy(x), blocks).numpy()
    ref = _eager_ref(x, blocks)
    np.testing.assert_array_equal(out, ref)
    wrong = _padded_trunk_variant(torch.from_numpy(x), blocks[0]).numpy()
    border = np.ones(x.shape[1:3], bool)
    border[1:-1, 1:-1] = False
    assert (wrong[:, border] != ref[:, border]).any()
    np.testing.assert_array_equal(wrong[:, ~border], ref[:, ~border])


def test_block_equals_unfused_int8_layers():
    """The plain block is the composition the unfused path runs:
    layers.conv2d_int8 (1x1), layers.conv2d_int8 (3x3), layers.shortcut."""
    x, blocks = _stage_inputs(10, 24, 12, 1, 3)
    a = FR._torch_block(blocks[0], "cpu")
    xt = torch.from_numpy(x)
    t1 = L.conv2d_int8(xt, a["w1"], a["b1"], 1, 0, "leaky", a["m1"],
                       a["alpha1"])
    t2 = L.conv2d_int8(t1, a["w2"], a["b2"], 1, 1, "leaky", a["m2"],
                       a["alpha2"])
    ref = L.shortcut(t2, xt, "linear")
    assert torch.equal(FR.fused_res_block(xt, **a), ref)
    assert torch.equal(FR.res_block_plain(xt, **a), ref)


def test_cpu_dispatch_runs_plain_and_launches_nothing():
    x, blocks = _stage_inputs(6, 8, 4, 2, 1)
    xt = torch.from_numpy(x)
    keep = xt.clone()
    K.reset_launch_counts()
    out = FR.run_blocks(xt, [FR._torch_block(b, "cpu") for b in blocks])
    assert K.LAUNCH_COUNTS["fused_res_block"] == 0
    assert torch.equal(xt, keep)          # the stage input is not written
    np.testing.assert_array_equal(out.numpy(), _eager_ref(x, blocks))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never takes a CPU detour: a CPU tensor is refused
    before anything is built or launched."""
    x, blocks = _stage_inputs(4, 8, 4, 1, 2)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        FR.fused_res_block_cuda(torch.from_numpy(x),
                                **FR._torch_block(blocks[0], "cpu"))
    assert K.LAUNCH_COUNTS["fused_res_block"] == 0


def test_jax_block_dicts_take_flat_1x1_weights():
    """``w1`` as [C, C2] (the Pallas kernel's own layout) or HWIO
    [1, 1, C, C2] gives the same block."""
    x, blocks = _stage_inputs(5, 8, 4, 1, 4)
    flat = dict(blocks[0], w1=blocks[0]["w1"].reshape(8, 4))
    a = FR.fused_res_stage(torch.from_numpy(x), blocks)
    b = FR.fused_res_stage(torch.from_numpy(x), [flat])
    assert torch.equal(a, b)
