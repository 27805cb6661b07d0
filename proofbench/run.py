"""Run one cell of the port's benchmark on the card this process sees.

    python3 proofbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The system under test is `boundless_tpu_torch` (the PyTorch and CUDA
port); nothing here loads JAX or the JAX package. Without a CUDA card, or
with fewer cards than the cell asks for, it prints no result and exits 2.
The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device` and, traced, `breakdown`; the
compared numbers and their limits come last, under `checks`, and again as
the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc and g++ builds go to its `build/`)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from proofbench import harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"proofbench: cell {cell.name} needs {cell.chips} CUDA "
              f"card(s); this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.measure(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"proofbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
