"""The Poseidon2 sponge's device time on the port's paths, for one tree.

    python3 tools/sponge_profile.py [--root DIR] [--label NAME]

Imports `boundless_tpu_torch` from `--root` (default: this repository; a
checkout of another commit, e.g. the parent, to compare two trees in one
call) and `chip_smoke.py`'s helpers from this repository, and on `cuda:0`:

1. times the sponge as the tree's wrapper picks its layout, at the shapes
   the paths launch (`chip_smoke.SPONGE_TIME_SHAPES`, the recursion leaves
   2^21 x 64) and a whole `merkle.commit` of 2^18 x 392;
2. proves the main path (loop guest, po2 17, rv32i, `DEFAULT_PS`) and
   verifies it, a KeccakAir batch (42 random permutations, kec_po2 10,
   q50) and its lift_keccak at rec_po2 21 (a coproc lattice built for it),
   each under `chip_smoke.SpongeProfile`: the sponge's device time and
   launches by kind (leaves, tree levels, tree top, transcript permutes
   and absorbs, verifier) and by layout, beside the proof's wall seconds.

Prints `[profile] label=...` lines; the card's name and power limit first.
The kernels build at first use (the first call of each is a warm-up).
Run it on both trees in one call, in turns (parent, change, change,
parent), to compare them on one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))  # the tree's package
    import numpy as np
    import torch

    # this repository's chip_smoke.py, whichever tree the package comes from
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    from boundless_tpu_torch.core import merkle
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.prover import stark
    from boundless_tpu_torch.recursion import coproc_succinct as cs
    from boundless_tpu_torch.zkvm import coproc, guests, prove
    from boundless_tpu_torch.zkvm.executor import Executor

    label = args.label
    C.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(C.SEED)

    shapes = list(C.SPONGE_TIME_SHAPES) + [("recursion leaves",
                                            *C.REC_SPONGE_SHAPE)]
    for what, n, c in shapes:
        if c:
            x = C.rand_words(rng, (n, c), dev)
            ms = C.sponge_ms(lambda: P2K.hash_rows(x), n, c)
        else:
            x = C.rand_words(rng, (n, 24), dev)
            ms = C.sponge_ms(lambda: P2K.permute(x), n, c)
        C.say("profile", label=label, what=what.replace(" ", "_"),
              shape=f"{n}x{c}", kernel_ms=f"{ms:.4f}")
        del x
    leaf = C.rand_words(rng, C.LEAF_SHAPE, dev)
    P2K.LAUNCHES = 0
    merkle.commit(leaf)
    C.say("profile", label=label, what="merkle.commit",
          shape=f"{C.LEAF_SHAPE[0]}x{C.LEAF_SHAPE[1]}",
          launches=P2K.LAUNCHES,
          commit_ms=f"{C.cuda_ms(lambda: merkle.commit(leaf), 5):.4f}")
    del leaf

    def profiled(what, make, kind=None):
        with C.SpongeProfile(kind) as sponge:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = make()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        C.say("profile", label=label, proof=what, wall_s=f"{wall:.3f}",
              **C.sponge_fields(sponge.summary()))
        return out

    image = guests.loop_guest()
    iters = ((1 << C.MAIN_PO2) - 40) // 2
    seg = Executor(image, guests.words([iters]),
                   segment_po2=C.MAIN_PO2).run().segments[0]
    prove.prove_segment(image, seg, prove.DEFAULT_PS, device=dev)  # warm
    receipt = profiled("main po2-17", lambda: prove.prove_segment(
        image, seg, prove.DEFAULT_PS, device=dev))
    ok = profiled("main verify", lambda: prove.verify_segment(
        receipt, prove.DEFAULT_PS), "verifier")
    if not ok:
        raise AssertionError("verify_segment rejected the proof")

    q50 = stark.ProofSystem(**C.REC_PS_ARGS)
    states = [[int(v) for v in rng.integers(0, 1 << 64, size=25,
                                            dtype=np.uint64)]
              for _ in range(C.UNION_PERMS[0])]
    coproc.prove_keccak(states, C.KEC_PO2, q50, device=dev)  # warm
    kec = profiled("KeccakAir kec_po2-10", lambda: coproc.prove_keccak(
        states, C.KEC_PO2, q50, device=dev))
    csys = cs.CoprocSystem(cs.CoprocParams(
        kec_po2=C.KEC_PO2, kec_ps=q50, rec_po2=C.COPROC_REC_PO2,
        rec_ps=q50), device=dev)
    csys.lift(kec)  # warm
    lift = profiled("lift_keccak rec_po2-21", lambda: csys.lift(kec))
    if not csys.verify(lift):
        raise AssertionError("the lift_keccak receipt did not verify")


if __name__ == "__main__":
    main()
