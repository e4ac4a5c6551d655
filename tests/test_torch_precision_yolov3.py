"""The port's precision modes against the JAX package's on yolov3 shrunk to
64x64 with every non-head width divided by 8 (``shrunk_yolov3``): each mode
of tests/test_torch_precision.py's ``MODES``, at the tolerances stated there,
and -bf16's float convs one by one. A file of its own, so the test runner
spreads these slower cases over another worker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_network import _params, _specs, shrunk_yolov3
from tests.test_torch_precision import MODES, compare_in_mode
from yolo2_light_tpu.models import layers as JL
from yolo2_light_tpu.models import network as JN
from yolo2_light_tpu_torch.models import layers as TL


@pytest.mark.parametrize("mode_name", list(MODES))
def test_shrunk_yolov3_matches_jax_in_every_mode(tmp_path, mode_name):
    compare_in_mode(shrunk_yolov3(tmp_path), mode_name)


def test_bf16_convs_match_jax_conv_by_conv(tmp_path):
    """-bf16's float convs one by one, on the inputs the JAX forward gives
    each: within 1e-5 of the conv's largest value (the float32 sums of the
    exact bfloat16 products in another order)."""
    spec, _ = _specs(shrunk_yolov3(tmp_path))
    params = _params(spec, "fp32")
    fwd = JN.build_forward(spec, "fp32", compute_dtype=jnp.bfloat16,
                           capture_conv_inputs=True)
    x = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    with jax.disable_jit():
        _, aux = fwd(JN.params_to_device(params), jnp.asarray(x))
    convs = [l for l in spec.layers if type(l).__name__ == "ConvSpec"]
    assert len(convs) == len(aux["conv_inputs"]) == 75
    for l, xin in zip(convs, aux["conv_inputs"]):
        p = params[l.index]
        ref = np.asarray(JL.conv2d_fp32(
            xin, jnp.asarray(p["weights"]), jnp.asarray(p["biases"]),
            l.stride, l.pad, l.activation, compute_dtype=jnp.bfloat16))
        out = TL.conv2d_fp32(
            torch.from_numpy(np.array(xin)),
            torch.from_numpy(np.asarray(p["weights"])).permute(
                3, 2, 0, 1).to(torch.bfloat16),
            torch.from_numpy(np.asarray(p["biases"])), l.stride, l.pad,
            l.activation, compute_dtype=torch.bfloat16)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
