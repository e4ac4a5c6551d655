"""The port's communication volume and projected multi-GPU scaling of
yolov3-416, the counterpart of ``scripts/commvol_table.py``.

Records what the port's multi-device axes move (``parallel/commvol.py``'s
recorder on ``ShardedForward``, every position a stream of cuda:0 and
counted as if it had its own GPU) for yolov3-416 at full width
(``tests/data/yolov3.cfg``, random weights from seed 2), in the JAX script's
modes: tp (model) at 2, 4 and 8 positions and dp (data) at 2, 4 and 8 in
int8 (``-quantized``), sp (space) at 2, 4 and 8 in ``-bf16``, pp at 2 and 4
stages from the stage boundaries' live tensors (``pp_boundary_bytes``).
(JAX's tp program has bf16 float convs beside its int8 ones; in the port
every tensor that crosses is float32 either way.) Each row's wire bytes per
image are the pacing position's (the one with the most) over the images a
position runs. The projection divides one position's ms per image (the
compute anchor, int8 xla for tp/dp/pp, ``-bf16`` for sp) by the positions,
and puts the wire bytes over NVIDIA's published H100 SXM NVLink figure
(``commvol.NVLINK_BW_H100_SXM``; not a measurement).

Usage (on the card):

    python scripts/commvol_table_torch.py
    python scripts/commvol_table_torch.py --int8-ms A --bf16-ms B

The anchors are measured on the card at b=8 (``chip_smoke.anchor_ms``:
CUDA events behind a device sleep) unless given. Writes
``commvol_yolov3_416_torch.json`` (``--out``) and prints the markdown table.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from yolo2_light_tpu_torch.apps.detect import build_params  # noqa: E402
from yolo2_light_tpu_torch.parallel import commvol  # noqa: E402
from yolo2_light_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from yolo2_light_tpu_torch.parallel.pp import split_stages  # noqa: E402

CFG = os.path.join(ROOT, "tests", "data", "yolov3.cfg")
OUT = os.path.join(ROOT, "commvol_yolov3_416_torch.json")
SEED = 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int8-ms", type=float, default=None,
                    help="one position's int8 ms per image")
    ap.add_argument("--bf16-ms", type=float, default=None,
                    help="one position's -bf16 ms per image")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    card = cs.phase_device()        # exits 1 without a card
    bf16 = torch.bfloat16
    spec_q, params_q, mode_q = build_params(CFG, None, quantized=True,
                                            seed=SEED, echo=False)
    spec_f, params_f, mode_f = build_params(CFG, None, seed=SEED, echo=False)

    wire, details = {}, {}
    for n in (2, 4, 8):
        for label, axis, batch in (("tp", "model", 1), ("sp", "space", 1),
                                   ("dp", "data", n)):
            if label == "sp":
                spec, params, mode, cd = spec_f, params_f, mode_f, bf16
            else:
                spec, params, mode, cd = spec_q, params_q, mode_q, None
            mesh = make_mesh(n, **{axis: n},
                             devices=[torch.device("cuda", 0)] * n)
            vols, per_img = commvol.measure_mesh_comm(
                spec, params, mesh, mode=mode, batch=batch, compute_dtype=cd)
            wire[(label, n)] = per_img
            details[f"{label}{n}"] = {"wire_bytes_img": per_img,
                                      "batch": batch, "volumes": vols}
            print(f"recorded {label}={n}: {per_img / 1e6:.3f} MB/img wire, "
                  f"{ {k: v['count'] for k, v in vols.items()} }",
                  file=sys.stderr)
    pp_bytes = {n: commvol.pp_boundary_bytes(spec_q, split_stages(spec_q, n))
                for n in (2, 4)}

    anchors = {"int8": args.int8_ms, "bf16": args.bf16_ms}
    measured = []
    if anchors["int8"] is None:
        anchors["int8"] = cs.anchor_ms(spec_q, params_q, mode_q)
        measured.append("int8")
    if anchors["bf16"] is None:
        anchors["bf16"] = cs.anchor_ms(spec_f, params_f, mode_f,
                                       compute_dtype=bf16)
        measured.append("bf16")
    by_label = {"tp": anchors["int8"], "dp": anchors["int8"],
                "pp": anchors["int8"], "sp": anchors["bf16"]}
    link = commvol.NVLINK_BW_H100_SXM
    rows = commvol.scaling_rows(wire, pp_bytes, by_label, link)
    print(f"\nanchors (ms per image of one position, b={cs.COMM_ANCHOR_B}): "
          f"int8 {anchors['int8']:.4f}, bf16 {anchors['bf16']:.4f} "
          f"({'measured on ' + card if measured else 'given'}); link "
          f"{link:.3g} B/s, NVIDIA's published H100 SXM NVLink figure, not "
          "measured\n")
    print(commvol.table_markdown(rows))
    with open(args.out, "w") as f:
        json.dump({"cfg": os.path.relpath(CFG, ROOT), "seed": SEED,
                   "card": card, "anchors_ms_img": anchors,
                   "anchors_measured": measured,
                   "anchor_batch": cs.COMM_ANCHOR_B, "link_bw": link,
                   "link_bw_source": "NVIDIA's published H100 SXM NVLink "
                                     "bandwidth (900 GB/s both directions; "
                                     "450e9 B/s received), not measured",
                   "pp_boundary_bytes": pp_bytes, "rows": rows,
                   "details": details}, f, indent=1)
    print(f"\nwrote {os.path.relpath(args.out, ROOT)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
