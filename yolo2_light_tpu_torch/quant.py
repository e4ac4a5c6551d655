# Mirrors yolo2_light_tpu/quant.py up to entropy_calibration (its NumPy
# part): a copy, so that the port imports nothing of the JAX package. Its
# device half (activation_histogram, entropy_calibration_multipliers) is
# written anew in PyTorch below.
"""INT8 post-training quantization: multiplier heuristics + weight quantization +
TensorRT-style KL entropy calibration.

Reference: src/yolov2_forward_network_quantized.c —
``get_distribution``/``get_multiplier`` (:35-87), ``quantinization_and_get_multipliers``
(:1402-1494), ``entropy_calibration`` (:1292-1398). Constants (:9-14):
W_MAX_VAL = I_MAX_VAL = 127, R_MAX_VAL = 32767, R_MULT = 32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cfg import ConvSpec, ModelSpec

W_MAX_VAL = 127
I_MAX_VAL = 127
R_MAX_VAL = 256 * 256 // 2 - 1
R_MULT = 32


def get_distribution(arr: np.ndarray, number_of_ranges: int = 32,
                     start_range: float = 1.0 / 65536) -> np.ndarray:
    """Histogram over doubling ranges [r, 2r) (reference: get_distribution,
    src/yolov2_forward_network_quantized.c:35-56).

    Parity quirk: the reference compares the SIGNED value against the positive range
    bounds (``fabs(cur_range) <= w && w < fabs(cur_range*2)``), so negative values are
    never counted. Reproduced faithfully.
    """
    flat = arr.reshape(-1).astype(np.float32)
    counts = np.zeros(number_of_ranges, np.int64)
    edges = start_range * (2.0 ** np.arange(number_of_ranges + 1))
    idx = np.searchsorted(edges, flat, side="right") - 1
    valid = (flat >= edges[0]) & (flat < edges[-1])
    np.add.at(counts, idx[valid], 1)
    return counts


def get_multiplier(arr: np.ndarray, bits_length: int = 8) -> float:
    """Most-populated ``bits_length``-bin window multiplier (reference: get_multiplier,
    src/yolov2_forward_network_quantized.c:59-87)."""
    number_of_ranges = 32
    start_range = 1.0 / 65536
    count = get_distribution(arr, number_of_ranges, start_range)
    best, best_j = 0, 0
    for j in range(number_of_ranges):
        window = int(count[j: min(j + bits_length, number_of_ranges)].sum())
        if best < window:
            best, best_j = window, j
    return float(1.0 / (start_range * np.float32(2.0 ** best_j)))


def _max_abs_trunc(x: np.ndarray, max_val: int) -> np.ndarray:
    """C pattern ``max_abs((int)float_val, max_val)``: truncation toward zero then
    symmetric clamp (reference: max_abs, src/yolov2_forward_network_quantized.c:24-28)."""
    t = np.trunc(x)
    return np.clip(t, -max_val, max_val)


def quantize_params(spec: ModelSpec, params: list,
                    echo: bool = False) -> list:
    """Augment fused params with INT8 fields for every conv layer
    (reference: quantinization_and_get_multipliers,
    src/yolov2_forward_network_quantized.c:1402-1494).

    Adds per conv layer:
      * ``weights_quant_multipler`` = get_multiplier(weights, 8) / 4
      * ``weights_int8``            = clamp(trunc(w * mult), +-127)  (HWIO int8)
      * ``input_quant_multipler``   = cfg input_calibration[counter] or 40
      * ``output_multipler``        = next_input_mult / (w_mult * in_mult / R_MULT)
      * ``biases_quant``            = biases * (output_mult * w_mult * in_mult / R_MULT)

    ``echo``: print the reference's per-layer stdout lines verbatim
    (old_weight_mult, the short-calibration warning, "Multiplers: ...",
    "Skip layer: <LAYER_TYPE enum value>" — :1433,1449-1452,1480-1483).
    """
    calib = spec.net.input_calibration
    out: list = []
    counter = 0
    for i, l in enumerate(spec.layers):
        p = params[i]
        if p is None or not isinstance(l, ConvSpec):
            if echo:
                # reference prints the raw LAYER_TYPE enum value
                # (additionally.h:376-403)
                enum = {"MaxpoolSpec": 3, "SoftmaxSpec": 4, "RouteSpec": 8,
                        "ShortcutSpec": 13, "RegionSpec": 21, "YoloSpec": 22,
                        "UpsampleSpec": 23, "ReorgSpec": 24}
                print(f" Skip layer: {enum.get(type(l).__name__, 25)} ")
            out.append(p)
            continue
        q = dict(p)
        w = np.asarray(p["weights"], np.float32)
        wq_mult = get_multiplier(w, 8) / 4.0  # "good [2 - 8], best 4"
        if echo:
            print(f" old_weight_mult = {wq_mult:f}, "
                  f"weights_multiplier_single = {wq_mult:f} \n")
        q["weights_quant_multipler"] = np.float32(wq_mult)
        q["weights_int8"] = _max_abs_trunc(w * wq_mult, W_MAX_VAL).astype(np.int8)
        if echo and counter >= len(calib):
            print(f"\n Warning: input_calibration= in the cfg-file has less "
                  f"values {len(calib)} than convolutional layers {counter} ")
        in_mult = calib[counter] if counter < len(calib) else 40.0
        q["input_quant_multipler"] = np.float32(in_mult)
        counter += 1
        next_in_mult = calib[counter] if counter < len(calib) else 40.0
        out_mult = next_in_mult / (wq_mult * in_mult / R_MULT)
        q["output_multipler"] = np.float32(out_mult)
        q["biases_quant"] = (np.asarray(p["biases"], np.float32)
                             * np.float32(out_mult * wq_mult * in_mult / R_MULT))
        if echo:
            print(f" Multiplers: weights {float(np.float32(wq_mult)):g}, "
                  f"input {float(np.float32(in_mult)):g}, "
                  f"output {float(np.float32(out_mult)):g} ")
        out.append(q)
    return out


# ---------------------------------------------------------------------------
# Entropy (KL) calibration
# ---------------------------------------------------------------------------


def entropy_calibration(arr: np.ndarray, bin_width: float = 1.0 / 16,
                        max_bin: int = 4096, echo: bool = False) -> float:
    """TensorRT-style KL-divergence saturation-threshold search
    (reference: entropy_calibration, src/yolov2_forward_network_quantized.c:1292-1398).

    Builds a |x| histogram with ``max_bin`` bins of ``bin_width``; for each candidate
    threshold i in [128, max_bin) computes KL(P_i || Q_i) where P_i is the clipped
    histogram (outliers folded into the last bin) and Q_i is P_i quantized to 128 bins
    and re-expanded (preserving empty bins, averaging by non-empty count). Returns
    ``127 / ((argmin + 0.5) * bin_width)``.
    """
    flat = np.abs(np.asarray(arr, np.float32).reshape(-1))
    last = max_bin - 1
    # C: lround(fabs(x)/bin_width) — fabs promotes to double, half-away rounding
    # (NOT half-to-even), src/yolov2_forward_network_quantized.c:1311
    bins = np.floor(flat.astype(np.float64) / bin_width + 0.5).astype(np.int64)
    np.minimum(bins, last, out=bins)
    H = np.bincount(bins, minlength=max_bin).astype(np.float64)

    kl = np.full(max_bin, np.inf)
    cumsum = np.cumsum(H)
    total = cumsum[-1]
    for i in range(128, max_bin):
        P = H[:i].copy()
        outliers = total - cumsum[i - 1]
        qw = np.float32(i / 128.0)
        j = np.arange(i)
        # C: lround(j / quant_expand_width) — int/float -> float32 quotient,
        # lround half-away (ties DO occur when i divides 128*j)
        q = (j.astype(np.float32) / qw).astype(np.float64)
        qbin = np.minimum(np.floor(q + 0.5).astype(np.int64), 127)
        quant_Q = np.bincount(qbin, weights=P, minlength=128)
        quant_cnt = np.bincount(qbin, weights=(P != 0).astype(np.float64),
                                minlength=128)
        Q = np.zeros(i)
        nz = P != 0
        with np.errstate(divide="ignore", invalid="ignore"):
            expanded = quant_Q[qbin] / quant_cnt[qbin]
        Q[nz] = expanded[nz]
        P[i - 1] += outliers
        sum_P, sum_Q = P.sum(), Q.sum()
        if sum_P == 0 or sum_Q == 0:
            continue
        Pn, Qn = P / sum_P, Q / sum_Q
        flt_min = np.float32(1.1754944e-38)
        kl[i] = float(np.sum(Pn * np.log((Pn + flt_min) / (Qn + flt_min))))

    m_index = int(np.argmin(kl[128:]) + 128)
    threshold = (m_index + 0.5) * bin_width
    if echo:
        # reference printf inside entropy_calibration
        # (src/yolov2_forward_network_quantized.c:1387). min_m prints our f64
        # KL at f32 width; C's float-accumulated value can differ in the 6th
        # significant digit for nonzero minima (threshold choice unaffected).
        t32 = np.float32((np.float32(m_index) + np.float32(0.5))
                         * np.float32(bin_width))
        m32 = np.float32(127.0) / t32
        min_m = np.float32(np.min(kl[128:]))
        print(f" mult = {float(m32):g}, threshold = {float(t32):g}, "
              f"min_m = {float(min_m):g}, m_index = {float(m_index):g} ")
    return float(127.0 / threshold)


# ---------------------------------------------------------------------------
# On-device calibration (the JAX package's fast path, in PyTorch)
# ---------------------------------------------------------------------------
#
# The reference calibrates on the CPU per image per conv layer with an
# O(max_bin^2) threshold sweep (src/yolov2_forward_network_quantized.c:
# 1292-1398). The device method builds each conv input's |x| histogram on the
# device and sweeps the KL thresholds there too, so only one float per conv
# comes back to the host. Same math in float32: ties and rounding can pick a
# neighbouring threshold bin (the multiplier moves by about 0.03%); the host
# method (entropy_calibration above) stays the bit-exact one.


# Elements of one chunk's [L, chunk, max_bin] planes in the KL sweep: on a
# CUDA device, and on any other.
SWEEP_CHUNK_ELEMENTS_CUDA = 2 ** 25
SWEEP_CHUNK_ELEMENTS = 2 ** 22


def activation_histogram(x: torch.Tensor, bin_width: float = 1.0 / 16,
                         max_bin: int = 4096) -> torch.Tensor:
    """|x| histogram with ``max_bin`` bins of ``bin_width`` on ``x``'s
    device: bin = floor(float32(|x| / bin_width) + 0.5), saturated into the
    last bin (the reference's lround, src/yolov2_forward_network_quantized.c:
    1309-1317). Returns [max_bin] float32 counts. The counts are integers
    (``torch.bincount``), exact in any order; they equal the JAX package's
    float scatter-add bit for bit while no bin passes 2**24."""
    v = torch.abs(x.reshape(-1).to(torch.float32)) * float(1.0 / bin_width)
    bins = torch.clamp(torch.floor(v + 0.5), max=max_bin - 1).to(torch.int64)
    return torch.bincount(bins, minlength=max_bin).to(torch.float32)


def entropy_calibration_multipliers(hists: torch.Tensor,
                                    bin_width: float = 1.0 / 16
                                    ) -> torch.Tensor:
    """KL threshold sweep over a stack of histograms [L, max_bin] ->
    multipliers [L] float32, on the histograms' device: the JAX package's
    ``entropy_calibration_multipliers`` (the math of
    :func:`entropy_calibration` in float32), in PyTorch ops.

    The candidate thresholds i in [128, max_bin) run in chunks, all layers
    at once, each chunk's [L, chunk, max_bin] planes at most
    ``SWEEP_CHUNK_ELEMENTS_CUDA`` elements on a CUDA device and
    ``SWEEP_CHUNK_ELEMENTS`` elsewhere: the [3968, 4096] plane of every
    layer is never held at once.
    Each quantized bin qbin(i, j) = min(lround_f32(j / (i/128)), 127) is a
    contiguous run of j, so its per-j sums come from a reverse cummin over
    the run ends and a forward cummax over the run starts of the cumsums,
    frozen at the candidate (no gathers, no scatters), as in JAX."""
    hists = hists.to(torch.float32)
    n_layers, max_bin = hists.shape
    dev = hists.device
    max_elements = (SWEEP_CHUNK_ELEMENTS_CUDA if dev.type == "cuda"
                    else SWEEP_CHUNK_ELEMENTS)
    chunk = max(1, max_elements // (n_layers * max_bin))
    j = torch.arange(max_bin, device=dev)
    jf = j.to(torch.float32)
    flt_min = 1.1754944e-38
    big = 3.4e38
    csH = torch.cumsum(hists, dim=1)                       # [L, J]
    nzf = (hists != 0).to(torch.float32)
    csNZ = torch.cumsum(nzf, dim=1)
    total = csH[:, -1:, None]                              # [L, 1, 1]
    kls = []
    for c0 in range(128, max_bin, chunk):
        cands = torch.arange(c0, min(c0 + chunk, max_bin), device=dev)
        qw = cands.to(torch.float32)[:, None] / 128.0      # [C, 1]
        qbin = torch.clamp(torch.floor(jf[None, :] / qw + 0.5),
                           max=127).to(torch.int32)        # [C, J]
        ones = torch.ones((len(cands), 1), dtype=torch.bool, device=dev)
        is_start = torch.cat([ones, qbin[:, 1:] != qbin[:, :-1]], dim=1)
        is_end = torch.cat([is_start[:, 1:], ones], dim=1)
        in_range = j[None, :] < cands[:, None]             # [C, J]
        cs_at_i = csH[:, cands - 1][:, :, None]            # [L, C, 1]
        csn_at_i = csNZ[:, cands - 1][:, :, None]

        def seg_sum(cs, left_excl, frozen):
            hi = torch.flip(torch.cummin(torch.flip(torch.where(
                is_end, cs[:, None, :], big), [2]), dim=2).values, [2])
            lo = torch.cummax(torch.where(is_start, left_excl[:, None, :],
                                          -big), dim=2).values
            return torch.minimum(hi, frozen) - torch.minimum(lo, frozen)

        quant_q = seg_sum(csH, csH - hists, cs_at_i)
        quant_cnt = seg_sum(csNZ, csNZ - nzf, csn_at_i)
        P = torch.where(in_range, hists[:, None, :], 0.0)  # [L, C, J]
        Q = torch.where(P != 0, quant_q / torch.clamp(quant_cnt, min=1.0),
                        0.0)
        last = j[None, :] == cands[:, None] - 1
        P = torch.where(last, P + (total - cs_at_i), P)
        sum_p = P.sum(dim=2, keepdim=True)
        sum_q = Q.sum(dim=2, keepdim=True)
        Pn, Qn = P / sum_p, Q / sum_q
        kl = torch.where(in_range, Pn * torch.log((Pn + flt_min)
                                                 / (Qn + flt_min)),
                         0.0).sum(dim=2)                   # [L, C]
        kls.append(torch.where((sum_p[..., 0] == 0) | (sum_q[..., 0] == 0),
                               float("inf"), kl))
    m_index = torch.argmin(torch.cat(kls, dim=1), dim=1) + 128
    threshold = (m_index.to(torch.float32) + 0.5) * float(
        np.float32(bin_width))
    return 127.0 / threshold
