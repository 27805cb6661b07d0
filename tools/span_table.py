"""The port's own spans in one run of a benchmark cell, on the card.

    python3 tools/span_table.py --workload seg20-prove --seed 4200000001 \\
        --seconds 51 --mode traced [--chrome spans.json]

`--mode traced` is the benchmark's `--trace 1` run (`proofbench/run.py`):
its per-layer metrics, then the tracer's spans of the window
(`boundless_tpu_torch/utils/profiling.py`, turned on by the metric files
that read them) as a table by path from the root span (count, mean and
total seconds, mean self seconds: the span less its children, and the
spans' attributes, such as the AIR's `variant`, its data `cols` and the
data LDE's `lde_words`), and, with
`--chrome`, the spans as Chrome trace events. `--mode off` and `--mode
on` are the untraced run (the end-to-end metrics) with the tracer off or
on from the start: run them in turns in one call to read what the tracer
costs. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from proofbench import run as R  # noqa: E402  (the checkout's build paths)


def attrs_of(records) -> str:
    """The spans' attributes: `key=value` where every span gives the key
    one value, `key=<n values>` where they differ."""
    values = collections.defaultdict(set)
    for r in records:
        for k, v in r["attrs"].items():
            values[k].add(str(v))
    return " ".join(f"{k}={next(iter(vs))}" if len(vs) == 1
                    else f"{k}=<{len(vs)} values>"
                    for k, vs in sorted(values.items()))


def span_table(records) -> list:
    """[path, count, mean s, total s, mean self s, attributes] by path
    from the root, largest total first."""
    by_id = {r["id"]: r for r in records}
    child_ns = collections.Counter()
    for r in records:
        if r["parent"] in by_id:
            child_ns[r["parent"]] += r["t1_ns"] - r["t0_ns"]

    def path(r):
        names = [r["name"]]
        while r["parent"] in by_id:
            r = by_id[r["parent"]]
            names.append(r["name"])
        return "/".join(reversed(names))

    rows = collections.defaultdict(lambda: [0, 0, 0, []])
    for r in records:
        row = rows[path(r)]
        row[0] += 1
        row[1] += r["t1_ns"] - r["t0_ns"]
        row[2] += r["t1_ns"] - r["t0_ns"] - child_ns[r["id"]]
        row[3].append(r)
    return sorted(([p, n, t / n / 1e9, t / 1e9, s / n / 1e9, attrs_of(rs)]
                   for p, (n, t, s, rs) in rows.items()),
                  key=lambda row: -row[3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("traced", "off", "on"),
                    default="traced")
    ap.add_argument("--chrome")
    args = ap.parse_args(argv)

    import torch

    from boundless_tpu_torch.utils import profiling
    from proofbench import harness

    if not torch.cuda.is_available():
        print("span_table: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    if args.mode == "on":
        profiling.enable()
    result = harness.measure(cell, args.seed, args.seconds,
                             args.mode == "traced", torch.device("cuda", 0),
                             R.T_START)
    out = dict(workload=cell.name, seed=args.seed, mode=args.mode,
               correct=result["correct"], metrics=result["metrics"],
               jobs=result["jobs"]["completed"],
               card=torch.cuda.get_device_name(0))
    if args.mode == "traced":
        records = profiling.records()
        out["spans"] = span_table(records)
        if args.chrome:
            os.makedirs(os.path.dirname(args.chrome) or ".", exist_ok=True)
            profiling.export_chrome(args.chrome)
        for p, n, mean, total, self_s, attrs in out["spans"]:
            print(f"{p}  n={n}  mean={mean:.4f}  total={total:.3f}  "
                  f"self={self_s:.4f}  {attrs}".rstrip())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
