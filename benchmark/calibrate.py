#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
card (benchmark runs never run this):

    python3 benchmark/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

For each seed, a run of the cell with a short window at its own load and
the usual check of a sample of its answers (sound runs: the lower
reading, the largest over the seeds); for each control seed, the same
with the control in the program's place (the upper reading, the smallest).
One JSON line a run, then one summary line.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", default=[])
    args = ap.parse_args()

    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    lower, upper, correct = {}, {}, True
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            r = harness.run_cell(cell.name, seed, args.seconds, False, dev,
                                 cell=cell, control=control)
            values = {k: c["value"] for k, c in r["checks"].items()}
            print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "checks": values}), flush=True)
            for k, v in values.items():
                if control:
                    upper[k] = min(upper.get(k, v), v)
                else:
                    lower[k] = max(lower.get(k, v), v)
            correct &= r["correct"] != control
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "sound_runs_correct_and_controls_refused": correct}), flush=True)
    return 0 if correct else 1


if __name__ == "__main__":
    sys.exit(main())
