"""Carry the host-side params into the port's tensors.

The init chain is pure NumPy (``cfg``, ``weights`` load +
``fuse_conv_batchnorm``, ``xnor.binarize_params``,
``quant.quantize_params``: the port's copies of the JAX package's modules,
apart from its own ``xnor``); this module only turns its per-layer list of
NumPy dicts into tensors on one device, laid out once for the ops that read
them.
"""

from __future__ import annotations

import numpy as np
import torch

from .cfg import parse_network_cfg
from .ops import bf16_conv
from .ops.int8_conv import alpha_f32, relayout_hwio
from .quant import R_MULT
from .weights import random_params, save_weights
from .xnor import pack_sign_weights


def save_random_weights(cfgfile: str, path: str, seed: int = 0) -> None:
    """Write a darknet ``.weights`` file of random params for ``cfgfile``,
    fixed by ``seed`` (the repo ships no trained weights)."""
    spec = parse_network_cfg(cfgfile, batch=1)
    save_weights(spec, random_params(spec, seed=seed), path)

_FLOAT_KEYS = ("biases", "scales", "rolling_mean", "rolling_variance",
               "mean_arr", "biases_quant")


def layer_to_torch(p: dict, device, drop=frozenset(),
                   weights_dtype=torch.float32) -> dict:
    """One conv layer's params, without the output fields named in ``drop``:

    * ``weights`` HWIO float32 -> ``[O, I, kh, kw]`` (PyTorch's conv layout)
      in ``weights_dtype`` (bfloat16 for ``-bf16``'s float convs, cast once
      here instead of at every forward, and then in channels-last memory,
      the ``[O, kh, kw, I]`` rows ``ops/bf16_conv`` reads);
    * ``biases``, unfused BN vectors, the XNOR ``mean_arr`` and the
      ``cpu_old`` epilogue's ``biases_quant`` -> float32 tensors;
    * with bfloat16 weights of a first conv (C = 3), ``weights_k32``: the
      ``[M, 32]`` rows of ``bf16_conv.pad_k32``, which the bf16 conv
      kernel's c3 form reads;
    * with INT8 fields: ``weights_int8`` HWIO -> ``[M, kh, kw, C]`` (the
      kernel's layout), ``input_quant_multipler``, ``alpha`` =
      float32(R_MULT) / (float32(in_mult) * float32(w_mult)) (the "cpu"
      epilogue's scale) and ``inv`` = float32(1) / (float32(in_mult) *
      float32(w_mult)) (the "gpu" epilogue's, JAX's float32
      ``1.0 / (input_mult * weights_mult)``) as Python floats holding
      float32 values, rounded as the JAX path rounds them, and, where the
      params carry it, ``output_multipler`` (the "old" epilogue's scale) as
      a Python float holding its float32 value;
    * with XNOR fields: ``sign_weights`` HWIO +-1 -> float32
      ``[O, I, kh, kw]`` (the dense engine's), and ``packed_weights``, the
      bit kernels' ``[M, kh, kw, C32]`` int32 packed from ``sign_weights``
      (a ``packed_weights`` of the JAX package, in the TPU's layout, is not
      read).
    """
    out = {}
    if "weights" in p and "weights" not in drop:
        w = torch.as_tensor(np.asarray(p["weights"], np.float32))
        if weights_dtype == torch.bfloat16:
            # channels-last memory: the bf16 conv kernel reads this
            # [O, I, kh, kw] tensor's permute(0, 2, 3, 1) without a copy
            w = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        else:
            w = w.permute(3, 2, 0, 1).contiguous()
        out["weights"] = w.to(device, weights_dtype)
    for k in _FLOAT_KEYS:
        if k in p and k not in drop:
            out[k] = torch.as_tensor(np.asarray(p[k], np.float32)).to(device)
    if "weights" in out and weights_dtype == torch.bfloat16:
        # the first conv's rows padded to one k32 step, for the kernel
        _, i, kh, _ = out["weights"].shape
        if bf16_conv.c3_form(i, kh):
            out["weights_k32"] = bf16_conv.pad_k32(
                bf16_conv.kernel_weights(out["weights"]))
    if "weights_int8" in p and "weights_int8" not in drop:
        out["weights_int8"] = relayout_hwio(p["weights_int8"]).to(device)
        out["input_quant_multipler"] = float(
            np.float32(p["input_quant_multipler"]))
        out["alpha"] = alpha_f32(p["input_quant_multipler"],
                                 p["weights_quant_multipler"], R_MULT)
        out["inv"] = alpha_f32(p["input_quant_multipler"],
                               p["weights_quant_multipler"], 1)
        if "output_multipler" in p:
            out["output_multipler"] = float(np.float32(p["output_multipler"]))
    if "sign_weights" in p:
        sign = np.asarray(p["sign_weights"], np.int8)
        if "sign_weights" not in drop:
            out["sign_weights"] = torch.as_tensor(sign).permute(
                3, 2, 0, 1).to(torch.float32).contiguous().to(device)
        if "packed_weights" not in drop:
            out["packed_weights"] = torch.as_tensor(
                pack_sign_weights(sign)).to(device)
    return out


def params_to_torch(params: list, device, drops=None,
                    weights_dtype=torch.float32) -> list:
    """Per-layer list (``None`` for weightless layers) -> list of tensor dicts
    on ``device``; ``drops[i]``, where given, names layer i's output fields
    to leave out; float conv weights in ``weights_dtype``."""
    device = torch.device(device)
    drops = drops or [frozenset()] * len(params)
    return [None if p is None else layer_to_torch(p, device, d, weights_dtype)
            for p, d in zip(params, drops)]
