"""Carry the JAX package's host-side params into the port's tensors.

The init chain stays the JAX package's pure-NumPy code (``cfg``, ``weights``
load + ``fuse_conv_batchnorm``, ``quant.quantize_params``); this module only
turns its per-layer list of NumPy dicts into tensors on one device, laid out
once for the ops that read them.
"""

from __future__ import annotations

import numpy as np
import torch

from yolo2_light_tpu.cfg import parse_network_cfg
from yolo2_light_tpu.quant import R_MULT
from yolo2_light_tpu.weights import random_params, save_weights

from .ops.int8_conv import alpha_f32, relayout_hwio


def save_random_weights(cfgfile: str, path: str, seed: int = 0) -> None:
    """Write a darknet ``.weights`` file of random params for ``cfgfile``,
    fixed by ``seed`` (the repo ships no trained weights)."""
    spec = parse_network_cfg(cfgfile, batch=1)
    save_weights(spec, random_params(spec, seed=seed), path)

_FLOAT_KEYS = ("biases", "scales", "rolling_mean", "rolling_variance")


def layer_to_torch(p: dict, device) -> dict:
    """One conv layer's params:

    * ``weights`` HWIO float32 -> ``[O, I, kh, kw]`` (PyTorch's conv layout);
    * ``biases`` and unfused BN vectors -> float32 tensors;
    * with INT8 fields: ``weights_int8`` HWIO -> ``[M, kh, kw, C]`` (the
      kernel's layout), ``input_quant_multipler`` and ``alpha`` =
      float32(R_MULT) / (float32(in_mult) * float32(w_mult)) as Python floats
      holding float32 values, rounded as the JAX path rounds them.
    """
    out = {}
    if "weights" in p:
        w = torch.as_tensor(np.asarray(p["weights"], np.float32))
        out["weights"] = w.permute(3, 2, 0, 1).contiguous().to(device)
    for k in _FLOAT_KEYS:
        if k in p:
            out[k] = torch.as_tensor(np.asarray(p[k], np.float32)).to(device)
    if "weights_int8" in p:
        out["weights_int8"] = relayout_hwio(p["weights_int8"]).to(device)
        out["input_quant_multipler"] = float(
            np.float32(p["input_quant_multipler"]))
        out["alpha"] = alpha_f32(p["input_quant_multipler"],
                                 p["weights_quant_multipler"], R_MULT)
    return out


def params_to_torch(params: list, device) -> list:
    """Per-layer list (``None`` for weightless layers) -> list of tensor dicts
    on ``device``."""
    device = torch.device(device)
    return [None if p is None else layer_to_torch(p, device) for p in params]
