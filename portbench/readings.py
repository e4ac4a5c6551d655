"""The readings the check's limits are set from.

    python3 portbench/readings.py --workload <name> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 3]

For each seed, one run of the cell with a short window at the cell's own
load (``bench.run_cell``: set-up, window, the check of a sample of its
answers) prints the program's numbers; for each control seed it also
prints the control's: the reference one precision below the
configuration's (``control`` in its file), put in the program's place on
the same sampled frames and judged by the same comparison. One JSON line a
seed; the largest of the program's readings is the lower
reading of each number, the smallest of the control's the upper.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_numbers(keep: dict, seed: int, device) -> dict:
    """The control's numbers on the frames the run's check compared."""
    from portbench import model, verify
    net, config = keep["net"], keep["config"]
    frames = [a.frame for a in keep["answers"]]
    raw = model.set_obj_bias(net, model.make_weights(net, seed, device),
                             keep["bias"])
    low = verify.reference_truths(net, raw, keep["pool"], frames,
                                  config["control"], keep["traffic"]["thresh"],
                                  keep["nms"], device)
    return verify.compare(verify.as_answers(low, frames), keep["truths"],
                          keep["traffic"]["thresh"])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args()
    from portbench import bench
    manifest = bench.load_manifest()
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(controls - set(seeds)):
        keep = {}
        t = time.perf_counter()
        result, _ = bench.run_cell(
            manifest, args.workload, seed, args.seconds, False, "cuda:0", t,
            say=lambda s: print(s, file=sys.stderr, flush=True), keep=keep)
        line = {"seed": seed, "program": keep["numbers"],
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()}}
        if seed in controls:
            line["control"] = control_numbers(keep, seed, "cuda:0")
        print(json.dumps(line), flush=True)
        keep.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
