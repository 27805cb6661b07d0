"""Regenerate `torch_control_golden.npz`: the JAX control IDs of the
production recursion programs, which the port's `SuccinctSystem` and
`CoprocSystem` compute on the card (`chip_smoke.py` `[recursion]` and
`[coproc]` compare them with this file).

Stores, from the JAX package on the CPU, for each program its ROM sha256
(canonical little-endian u32, as `torch_rec_golden.npz` and
`torch_keccak_golden.npz` hold it) and its control ID, the canonical
8-word root `stark.control_root_of(recursion.air.AIR, rec_po2, rom, q50)`
(the ROM's LDE committed on the 2^(rec_po2 + 1)-row commit domain):
  * `rec20/<kind>/...`: the rv32i lattice at rec_po2 20: lift_i
    (`build_lift(17, DEFAULT_PS, "rv32i")`), join and resolve;
  * `rec21/<kind>/...`: the rv32im and coproc lattices at rec_po2 21:
    lift (`build_lift(17, DEFAULT_PS, "rv32im")`), join, resolve,
    lift_keccak (kec_po2 10), union and resolve_coproc built with the
    placeholder constants of `make_torch_keccak_golden.py`;
with the q50 system `ProofSystem(queries=50, fri_min_degree=256,
commit_expand=2)`. The ROMs are built as `make_torch_keccak_golden.py`
builds them.

Usage (JAX on a CPU host; each 2^21-row ROM is a 2^22-row Poseidon2
commit, so give it tens of minutes and about 10 GB of memory):

    JAX_PLATFORMS=cpu python tests/data/make_torch_control_golden.py

`--rec20 P --rec21 Q` builds the same programs at other sizes (a quick
rehearsal; the output then goes to `--out`).
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_control_golden.npz")
PROD_SEG_PO2 = 17
PROD_KEC_PO2 = 10


def lattices(rec20: int, rec21: int):
    """{prefix: (rec_po2, {kind: builder})} of the production programs."""
    sys.path.insert(0, HERE)
    from make_torch_keccak_golden import builders, q50_ps

    from boundless_tpu.recursion import succinct
    from boundless_tpu.zkvm import prove

    q50 = q50_ps()
    rv32i = {
        "lift_i": lambda: succinct.build_lift(PROD_SEG_PO2, prove.DEFAULT_PS,
                                              "rv32i"),
        "join": lambda: succinct.build_join(rec20, q50),
        "resolve": lambda: succinct.build_resolve(rec20, q50)}
    rv32im = builders(PROD_SEG_PO2, PROD_KEC_PO2, rec21, prove.DEFAULT_PS,
                      q50, q50, True)
    return {"rec20": (rec20, rv32i), "rec21": (rec21, rv32im)}


def control_ids(arrays: dict, rec20: int, rec21: int):
    from make_torch_keccak_golden import q50_ps, words_sha256

    from boundless_tpu.core import field as F
    from boundless_tpu.prover import stark
    from boundless_tpu.recursion import air as rair

    q50 = q50_ps()
    for prefix, (rec_po2, makers) in lattices(rec20, rec21).items():
        for kind, build in makers.items():
            t0 = time.perf_counter()
            prog = build()
            arrays[f"{prefix}/{kind}/rows"] = np.array(len(prog.rows))
            rom = prog.finalize(1 << rec_po2).ctrl_trace_np()
            arrays[f"{prefix}/{kind}/rom_sha256"] = np.array(
                words_sha256(rom))
            t1 = time.perf_counter()
            del prog
            root = stark.control_root_of(rair.AIR, rec_po2, F.fp(rom), q50)
            arrays[f"{prefix}/{kind}/control_id"] = np.asarray(
                F.from_mont(root), dtype=np.int64)
            print(prefix, kind, "rows", int(arrays[f"{prefix}/{kind}/rows"]),
                  "build_s", f"{t1 - t0:.1f}", "control_root_s",
                  f"{time.perf_counter() - t1:.1f}", "id",
                  arrays[f"{prefix}/{kind}/control_id"].tolist(), flush=True)
            del rom, root
            gc.collect()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec20", type=int, default=20)
    ap.add_argument("--rec21", type=int, default=21)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundless_tpu.core import field as F

    F.enable_u64()  # bit-identical field math, faster CPU compile
    arrays = {"rec_po2": np.array([args.rec20, args.rec21])}
    control_ids(arrays, args.rec20, args.rec21)
    np.savez_compressed(args.out, **arrays)
    print(args.out, os.path.getsize(args.out), "bytes")


if __name__ == "__main__":
    main()
