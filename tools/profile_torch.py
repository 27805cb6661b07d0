"""Where the time goes in the port's main path on one CUDA card.

    python3 tools/profile_torch.py [--po2 17] [--reps 3]

The loop guest at `--po2` (as `chip_smoke.py` and the reference's
`bench.py`), rv32i, `DEFAULT_PS` (100 queries, rate 1/2), on `cuda:0`:

1. `prove_segment` wall seconds: one warm-up proof, then `--reps` more in
   the same process, each clock stopped after `torch.cuda.synchronize()`.
2. A stage table from one more proof in which each named function is
   wrapped with `torch.cuda.synchronize()` on both sides (inclusive
   seconds; nested rows overlap).
3. `torch.profiler` over one more proof with the wrappers taken off: device
   kernel seconds, the device busy share (kernel seconds / profiled wall),
   the launches of each hand-written kernel (sponge, NTT sub-transform,
   constraint chunks) and the top operators by device time.

Prints the card's `nvidia-smi` name, power limit, SM clock and power draw
first. Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boundless_tpu_torch.air import cons_eval, rv32im  # noqa: E402
from boundless_tpu_torch.core import bbmm, fri, merkle  # noqa: E402
from boundless_tpu_torch.core import field as F  # noqa: E402
from boundless_tpu_torch.core import ntt as NTT  # noqa: E402
from boundless_tpu_torch.kernels import cons as CK  # noqa: E402
from boundless_tpu_torch.kernels import ntt as NK  # noqa: E402
from boundless_tpu_torch.kernels import poseidon2 as P2K  # noqa: E402
from boundless_tpu_torch.prover import stark  # noqa: E402
from boundless_tpu_torch.zkvm import guests, prove  # noqa: E402
from boundless_tpu_torch.zkvm.executor import Executor  # noqa: E402

# (owner, attribute, label) of each timed stage.
STAGES = (
    (prove, "_gen_witness", "witness (host: C++ loop + numpy tail)"),
    (stark, "_lde_commit", "LDE + commit of ctrl/data/accum"),
    (merkle, "commit", "merkle.commit (all)"),
    (P2K, "_sponge", "sponge kernel calls"),
    (NTT, "ntt", "ntt (all transforms)"),
    (NK, "sub_ntt", "NTT sub-transform kernel calls"),
    (CK, "evaluate", "constraint kernels (4N grid)"),
    (stark, "_quotient_coeffs", "quotient (kernel + combine + interp.)"),
    (NTT, "eval_poly_ext", "DEEP taps (eval_poly_ext)"),
    (stark, "_deep_combo_evals", "DEEP combination"),
    (fri, "prove", "fri.prove"),
    (bbmm, "bb_weighted_sum", "bb_weighted_sum (all)"),
    (F, "ext_inv", "ext_inv (all)"),
    (stark, "combine_constraints", "alpha-combine (combine_constraints)"),
    (cons_eval, "combine_rows", "alpha-combine of kernel rows"),
    (rv32im.Rv32imAir, "constraints", "air.constraints (eager)"),
    (rv32im.Rv32imAir, "accum_trace", "accum_trace"),
)


def timed_proof(image, seg, dev):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    receipt = prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)
    torch.cuda.synchronize()
    return receipt, time.perf_counter() - t0


def stage_table(image, seg, dev):
    """Inclusive synchronised seconds and call counts per stage."""
    stats = collections.defaultdict(lambda: [0.0, 0])
    originals = []

    def wrap(owner, name, label):
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stats[label][0] += time.perf_counter() - t0
            stats[label][1] += 1
            return out

        setattr(owner, name, timed)

    for stage in STAGES:
        wrap(*stage)
    try:
        _, wall = timed_proof(image, seg, dev)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    return wall, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--po2", type=int, default=17)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    image = guests.loop_guest()
    seg = Executor(image, guests.words([((1 << args.po2) - 40) // 2]),
                   segment_po2=args.po2).run().segments[0]
    print(f"loop guest po2 {args.po2}: {seg.cycles} cycles, variant "
          f"{prove.air_variant_of(image, seg)}", flush=True)

    _, warm_up = timed_proof(image, seg, dev)
    walls = [timed_proof(image, seg, dev)[1] for _ in range(args.reps)]
    print(f"prove_segment wall s: warm-up {warm_up}, then {walls}",
          flush=True)

    wall, stats = stage_table(image, seg, dev)
    print(f"instrumented wall s: {wall}")
    for label, (secs, calls) in sorted(stats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:40s} {secs:9.4f} s  calls={calls}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels_ = (("sponge", P2K), ("ntt", NK), ("cons", CK))
    before = {name: mod.LAUNCHES for name, mod in kernels_}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed_proof(image, seg, dev)
    launches = {name: mod.LAUNCHES - before[name] for name, mod in kernels_}
    # Device time is summed over the kernel events alone: a CPU operator's
    # self device time repeats the time of the kernels it launched.
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_s = sum(e.device_time_total for e in kernels) / 1e6
    events = prof.key_averages()
    print(f"profiled wall s {wall}; device kernels {len(kernels)}, "
          f"{device_s} s; busy share {device_s / wall}; launches {launches}")
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:  # the hand-written kernels, by their CUDA names
        for key in ("sponge_kernel", "sub_ntt_kernel", "::cons_"):
            if key in e.name:
                by_name[key][0] += e.device_time_total / 1e6
                by_name[key][1] += 1
    for key, (secs, n) in sorted(by_name.items()):
        print(f"  device time of {key:16s} {secs:9.6f} s over {n} launches")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
