"""Readings for the limits of `correct`: sound runs and the control.

    python3 proofbench/control.py --workload <name> --seeds 1,2,3 \\
        --seconds 10 [--control]

Runs the cell as `run.py` does (set-up, a short window, the reference's
judgement) once per seed and prints each run's compared numbers. With
`--control` the port runs the configuration's `control` options in
place of its own (a lower query count than the configuration states):
the control has to come out not correct. Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()

    import torch

    from proofbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    options = {k: v for k, v in cell.config["control"].items()
               if k != "why"} if args.control else {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.measure(cell, seed, args.seconds, False,
                            torch.device("cuda", 0), t0,
                            path_options=options)
        print(json.dumps(dict(
            workload=cell.name, seed=seed, control=args.control,
            correct=r["correct"], jobs=r["jobs"],
            readings={k: v["value"] for k, v in r["checks"].items()},
            metrics={k: v["value"] for k, v in r["metrics"].items()},
            reference_s=r["reference_s"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
