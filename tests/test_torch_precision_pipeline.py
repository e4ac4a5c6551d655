"""The port's serving pipeline in the precision modes against the JAX
package's, on the CPU: ``DetectionPipeline`` under ``-turbo`` and ``-bf16``,
in fp32 and int8 mode. Host NMS only: the device NMS does not depend on the
mode, and tests/test_torch_pipeline.py holds it to JAX's."""

import os

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_pipeline import _assert_same_detections, _frames
from yolo2_light_tpu.apps.detect import build_params as jax_build_params
from yolo2_light_tpu.pipeline import DetectionPipeline as JaxPipeline
from yolo2_light_tpu_torch.apps.detect import build_params
from yolo2_light_tpu_torch.pipeline import DetectionPipeline

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("precision", ["turbo", "bf16"])
def test_pipeline_matches_jax_in_precision_modes(precision, quantized):
    """``DetectionPipeline`` under -turbo and -bf16 on mini-yolo3, b=3 uint8
    frames at their source size: the JAX pipeline's detections (printed
    lines; F7 noise classified as in tests/test_torch_pipeline.py)."""
    cfg = os.path.join(DATA, "mini-yolo3.cfg")
    jspec, jparams, jmode = jax_build_params(cfg, None, quantized=quantized,
                                             seed=3, echo=False)
    spec, params, mode = build_params(cfg, None, quantized=quantized, seed=3,
                                      echo=False)
    args = dict(thresh=0.3, nms=0.4, k=256)
    if precision == "turbo":
        jkw = tkw = dict(turbo=True)
    else:
        jkw, tkw = (dict(compute_dtype=jnp.bfloat16),
                    dict(compute_dtype=torch.bfloat16))
    jp = JaxPipeline(jspec, jparams, jmode, **args, **jkw)
    tp = DetectionPipeline(spec, params, mode, device="cpu", **args, **tkw)
    x = _frames(1, 3)
    _assert_same_detections(tp(x), jp(x), 128, 96)
