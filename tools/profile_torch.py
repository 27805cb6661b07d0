"""Where the time goes in the port's main path, or in a recursion lift, on
one CUDA card.

    python3 tools/profile_torch.py [--path main|recursion] [--po2 17]
                                   [--reps 3] [--root DIR]

`--path main` (the default): the loop guest at `--po2` (as
`chip_smoke.py` and the reference's `bench.py`), rv32i, `DEFAULT_PS` (100
queries, rate 1/2), `prove_segment` on `cuda:0`.

`--path recursion`: one rv32i lift at rec_po2 20 (50 queries, rate 1/2,
`chip_smoke.py`'s `[recursion]` sizing) of the first of the loop guest's
two po2-`--po2` `DEFAULT_PS` segment proofs: the session, both segment
proofs, the pre-chains and the `SuccinctSystem` are set-up and are not
timed. Its stage table splits the eager quotient (`_quotient_coeffs` ->
`eval_grid`) into `air.constraints` (RecursionAir's constraint evaluation)
and `combine_constraints` (the α-combine), and the α-combine into
`ext_powers`, the concatenations (`torch.cat` inside `_combine_pointwise`)
and the ext items (`F.ext_mul` and `F.ext_add` inside it: the terms, or
the weight rows α^k X^i), beside the DEEP combination, `bb_weighted_sum`,
the native evaluation and the rest of the prover.

`--root DIR` runs the port of another checkout (its
`boundless_tpu_torch/`, built into its own `build/`), so that a parent
and a change are profiled in one call; the stages it lacks are left out.

For either path:

1. Wall seconds: one warm-up proof, then `--reps` more in the same
   process, each clock stopped after `torch.cuda.synchronize()`.
2. A stage table from one more proof in which each named function is
   wrapped with `torch.cuda.synchronize()` on both sides (inclusive
   seconds; nested rows overlap).
3. `torch.profiler` over one more proof with the wrappers taken off: device
   kernel seconds, the device busy share (kernel seconds / profiled wall),
   the launches and device time of each hand-written kernel (sponge, NTT
   sub-transform, fused constraint kernel, weighted sum) and the top
   operators by device time.

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


def _root() -> str:
    """--root, read before the port is imported."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.abspath(pre.parse_known_args()[0].root)


sys.path.insert(0, _root())

from boundless_tpu_torch.air import cons_eval, rv32im  # noqa: E402
from boundless_tpu_torch.core import bbmm, fri, merkle  # noqa: E402
from boundless_tpu_torch.core import field as F  # noqa: E402
from boundless_tpu_torch.core import ntt as NTT  # noqa: E402
from boundless_tpu_torch.kernels import bbmm as BK  # noqa: E402
from boundless_tpu_torch.kernels import cons as CK  # noqa: E402
from boundless_tpu_torch.kernels import ntt as NK  # noqa: E402
from boundless_tpu_torch.kernels import poseidon2 as P2K  # noqa: E402
from boundless_tpu_torch.prover import stark  # noqa: E402
from boundless_tpu_torch.recursion import air as rair  # noqa: E402
from boundless_tpu_torch.recursion import succinct, vm  # noqa: E402
from boundless_tpu_torch.zkvm import guests, prove  # noqa: E402
from boundless_tpu_torch.zkvm.executor import Executor  # noqa: E402

# (owner, attribute, label) of each timed stage of either path.
COMMON_STAGES = (
    (stark, "_lde_commit", "LDE + commit of ctrl/data/accum"),
    (merkle, "commit", "merkle.commit (all)"),
    (P2K, "_sponge", "sponge kernel calls"),
    (NTT, "ntt", "ntt (all transforms)"),
    (NK, "sub_ntt", "NTT sub-transform kernel calls"),
    (stark, "_quotient_coeffs", "quotient (_quotient_coeffs)"),
    (NTT, "eval_poly_ext", "DEEP taps (eval_poly_ext)"),
    (stark, "_deep_combo_evals", "DEEP combination"),
    (fri, "prove", "fri.prove"),
    (bbmm, "bb_weighted_sum", "bb_weighted_sum (all, one matrix)"),
    (bbmm, "bb_weighted_sum_blocks", "bb_weighted_sum_blocks (all)"),
    (BK, "weighted_sum", "weighted-sum kernel calls (one matrix)"),
    (BK, "weighted_sum_blocks", "weighted-sum kernel calls (all)"),
    (F, "ext_inv", "ext_inv (all)"),
    (stark, "combine_constraints", "alpha-combine (combine_constraints)"),
    (stark, "_combine_pointwise", "alpha-combine pointwise"),
    # (owner, attribute, label, enclosing stage): timed only inside it
    (NTT, "ext_powers", "  ext_powers", "alpha-combine (combine_constraints)"),
    (torch, "cat", "  concatenation (torch.cat)", "alpha-combine pointwise"),
    (F, "ext_mul", "  ext items (ext_mul)", "alpha-combine pointwise"),
    (F, "ext_add", "  ext items (ext_add)", "alpha-combine pointwise"),
)
STAGES = {
    "main": COMMON_STAGES + (
        (prove, "_gen_witness", "witness (host: C++ loop + numpy tail)"),
        (CK, "evaluate_combined",
         "fused constraint kernel + alpha-combine (evaluate_combined)"),
        (cons_eval, "combine_rows", "eager alpha-combine of rows (CPU route)"),
        (rv32im.Rv32imAir, "constraints", "air.constraints (eager)"),
        (rv32im.Rv32imAir, "accum_trace", "accum_trace"),
    ),
    "recursion": COMMON_STAGES + (
        (succinct, "lift_witness", "lift witness (host)"),
        (rair, "data_trace", "native eval (rair.data_trace)"),
        (vm, "evaluate_native", "native eval, C++ alone (evaluate_native)"),
        (stark, "prove", "stark.prove"),
        (rair.RecursionAir, "constraints",
         "air.constraints (eager RecursionAir)"),
        (rair.RecursionAir, "accum_trace", "accum_trace"),
    ),
}
# The hand-written kernels: (label, launch counter, CUDA function names).
KERNELS = (("sponge", P2K, ("sponge_kernel", "tree_kernel")),
           ("ntt", NK, ("sub_ntt_kernel",)),
           ("cons", CK, ("cons_fused",)),
           ("bbmm", BK, ("ws_rows", "ws_mma", "ws_sum")))


def main_path(po2: int, dev):
    """() -> one po2 main-path proof (the loop guest, DEFAULT_PS)."""
    image = guests.loop_guest()
    seg = Executor(image, guests.words([((1 << po2) - 40) // 2]),
                   segment_po2=po2).run().segments[0]
    print(f"loop guest po2 {po2}: {seg.cycles} cycles, variant "
          f"{prove.air_variant_of(image, seg)}", flush=True)
    return lambda: prove.prove_segment(image, seg, prove.DEFAULT_PS,
                                       device=dev)


def recursion_path(po2: int, dev):
    """() -> one rv32i rec_po2-20 lift of the first of the loop guest's two
    po2 segments (chip_smoke.py's [recursion] sizing)."""
    image = guests.loop_guest()
    ex = Executor(image, guests.words([((1 << po2) - 40) // 2]),
                  segment_po2=po2)
    res = ex.run()
    seg = res.segments[0]
    receipt = prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)
    chains = succinct.segment_pre_chains(ex, res)
    t0 = time.perf_counter()
    system = succinct.SuccinctSystem(succinct.SuccinctParams(
        seg_po2=po2, seg_ps=prove.DEFAULT_PS, rec_po2=20,
        rec_ps=stark.ProofSystem(queries=50, fri_min_degree=256,
                                 commit_expand=2),
        variants=("rv32i",)), device=dev)
    print(f"loop guest po2 {po2}: {len(res.segments)} segments, variant "
          f"{receipt.variant}; rv32i rec_po2 20 q50 system in "
          f"{time.perf_counter() - t0} s (set-up)", flush=True)
    return lambda: system.lift(receipt, chains[seg.index], seg.pre_mem,
                               seg.index)


def timed(run):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stage_table(run, stages):
    """Inclusive synchronised seconds and call counts per stage; a stage
    with an enclosing stage counts only the calls made inside it (others
    pass straight through, unsynchronised)."""
    stats = collections.defaultdict(lambda: [0.0, 0])
    depth = collections.Counter()  # label -> calls of it in progress
    originals = []

    def wrap(owner, name, label, inside=None):
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        @functools.wraps(fn)
        def timed_call(*args, **kwargs):
            if inside is not None and not depth[inside]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[label] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[label] -= 1
            torch.cuda.synchronize()
            stats[label][0] += time.perf_counter() - t0
            stats[label][1] += 1
            return out

        setattr(owner, name, timed_call)

    for stage in stages:
        if hasattr(stage[0], stage[1]):
            wrap(*stage)
    try:
        _, wall = timed(run)
    finally:
        for owner, name, fn in reversed(originals):
            setattr(owner, name, fn)
    return wall, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(STAGES), default="main")
    ap.add_argument("--po2", type=int, default=17)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--root", help="checkout whose port to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(f"port: {os.path.dirname(stark.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    make = main_path if args.path == "main" else recursion_path
    run = make(args.po2, dev)

    _, warm_up = timed(run)
    walls = [timed(run)[1] for _ in range(args.reps)]
    print(f"{args.path} wall s: warm-up {warm_up}, then {walls}", flush=True)

    wall, stats = stage_table(run, STAGES[args.path])
    print(f"instrumented wall s: {wall}")
    for label, (secs, calls) in sorted(stats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {label:48s} {secs:9.4f} s  calls={calls}")
    quotient = stats["quotient (_quotient_coeffs)"][0]
    if quotient:
        cons = sum(v[0] for k, v in stats.items()
                   if k.startswith("air.constraints"))
        comb = stats["alpha-combine (combine_constraints)"][0]
        print(f"quotient split: constraint evaluation {cons} s "
              f"({cons / quotient}), alpha-combine {comb} s "
              f"({comb / quotient}), rest {quotient - cons - comb} s of "
              f"{quotient} s")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = {name: mod.LAUNCHES for name, mod, _ in KERNELS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(run)
    launches = {name: mod.LAUNCHES - before[name] for name, mod, _ in KERNELS}
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
        for label, _, keys in KERNELS:
            if any(key in e.name for key in keys):
                by_name[label][0] += e.device_time_total / 1e6
                by_name[label][1] += 1
    for label, (secs, n) in sorted(by_name.items()):
        print(f"  device time of {label:8s} {secs:9.6f} s over {n} launches")
    print(events.table(sort_by="self_device_time_total", row_limit=25,
                       max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
