"""Regenerate `torch_keccak_golden.npz`: JAX reference data for the port's
keccak coprocessor (`boundless_tpu_torch/air/keccak.py`,
`zkvm/coproc.py`, `recursion/coproc_succinct.py` and the coproc parts of
`recursion/succinct.py`).

Stores, from the JAX package on the CPU (`BT_ZK_SEED` fixed):
  * `kec/...`: a KeccakAir batch proof at kec_po2 7 of `KEC_PERMS`
    permutations of random states (`STATE_SEED`), under the CI system
    `ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)`: the
    input lanes, the public state table, the circuit id, the proof's
    words (keys of the port's `convert.proof_to_numpy`) and the sha256 of
    the lift_keccak data trace over it (canonical little-endian u32, ROM
    at 2^19 rows; claim publics with a zero allowed root);
  * `ci/<kind>/rom_diff`: the CI-scale ROMs, finalized at 2^19 rows, of
    lift_keccak (kec_po2 7, the CI system), union (rec_po2 19, the CI
    system) and resolve_coproc (rec_po2 19 main and coproc lattice, the
    CI system, the placeholder constants below), stored transposed as
    row differences (int32; `numpy.cumsum` along the last axis restores
    the canonical words), with `ci/<kind>/rows` (before padding);
  * `prod/<kind>/rom_sha256` and `prod/<kind>/rows`: the ROM sha256
    (finalized at 2^21 rows) and row count of the production programs:
    lift (`build_lift(17, DEFAULT_PS, "rv32im")`), join and resolve
    (rec_po2 21, q50), lift_keccak (kec_po2 10, q50), union (rec_po2 21,
    q50) and resolve_coproc (rec_po2 21, q50, coproc lattice rec_po2 21
    q50, placeholder constants); the q50 system is
    `ProofSystem(queries=50, fri_min_degree=256, commit_expand=2)`;
  * `prod/circuit_id`: the keccak circuit id at kec_po2 10 under q50;
  * `placeholder/coproc_root`, `placeholder/kec_circuit_id`: the two
    constants the placeholder resolve_coproc ROMs embed.

Usage (a few minutes on a CPU host: the JAX prover's compile and the
production program builds):

    JAX_PLATFORMS=cpu python tests/data/make_torch_keccak_golden.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_keccak_golden.npz")
ZK_SEED = "20260"
KEC_PO2 = 7
KEC_PERMS = 2
STATE_SEED = 7
CI_ROWS = 1 << 19
CI_REC_PO2 = 19
PROD_SEG_PO2 = 17
PROD_REC_PO2 = 21
PROD_KEC_PO2 = 10
PLACEHOLDER_ROOT = tuple(range(1, 9))
PLACEHOLDER_CID = tuple(range(11, 19))


def words_sha256(a) -> str:
    """sha256 of canonical field words as little-endian u32."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a, dtype=np.int64).astype("<u4")).tobytes()).hexdigest()


def rom_diff(rom) -> np.ndarray:
    """(rows, cols) canonical ROM -> (cols, rows) int32 row differences."""
    d = np.diff(np.asarray(rom, dtype=np.int64), axis=0, prepend=0)
    return np.ascontiguousarray(d.T.astype(np.int32))


def rom_of_diff(diff) -> np.ndarray:
    """Inverse of `rom_diff`: (rows, cols) canonical int64 ROM."""
    return np.cumsum(np.asarray(diff, dtype=np.int64), axis=1).T


def states(n: int):
    rng = np.random.default_rng(STATE_SEED)
    return [[int(x) for x in rng.integers(0, 1 << 64, size=25,
                                          dtype=np.uint64)]
            for _ in range(n)]


def ci_ps():
    from boundless_tpu.prover import stark

    return stark.ProofSystem(queries=2, fri_min_degree=16, commit_expand=2)


def q50_ps():
    from boundless_tpu.prover import stark

    return stark.ProofSystem(queries=50, fri_min_degree=256,
                             commit_expand=2)


def keccak_proof(arrays: dict):
    sys.path.insert(0, HERE)
    from make_torch_rec_golden import flatten

    from boundless_tpu.recursion import coproc_succinct as cs
    from boundless_tpu.recursion import vm
    from boundless_tpu.zkvm import coproc

    ps = ci_ps()
    st = states(KEC_PERMS)
    r = coproc.prove_keccak(st, po2=KEC_PO2, ps=ps)
    assert coproc.verify_keccak(r, ps)
    cid = coproc.circuit_id(KEC_PO2, ps)
    arrays["kec/states"] = np.asarray(st, dtype=np.uint64)
    arrays["kec/states_pub"] = np.asarray(r.states_pub, dtype=np.int64)
    arrays["kec/circuit_id"] = np.asarray(cid, dtype=np.int64)
    flat = {}
    flatten(r.proof, "", flat)
    arrays.update({f"kec/proof.{k}": v for k, v in flat.items()})

    prog = cs.build_lift_keccak(KEC_PO2, ps).finalize(CI_ROWS)
    system = object.__new__(cs.CoprocSystem)  # witness helpers only
    system.params = cs.CoprocParams(kec_po2=KEC_PO2, kec_ps=ps,
                                    rec_po2=CI_REC_PO2, rec_ps=ps)
    wit = cs.CoprocSystem.lift_witness(system, r)
    claim = cs.CoprocClaim.of_batch(cid, r.states_pub, r.count)
    data = vm.evaluate_native(prog, wit, tuple(list(claim.digest())
                                               + [0] * 16))
    arrays["kec/lift_data_sha256"] = np.array(words_sha256(data))
    print("keccak proof", len(flat), "arrays;", len(wit), "inputs",
          flush=True)


def builders(seg_po2, kec_po2, rec_po2, seg_ps, kec_ps, rec_ps,
             with_main: bool):
    from boundless_tpu.recursion import coproc_succinct as cs
    from boundless_tpu.recursion import succinct

    out = {}
    if with_main:
        out["lift"] = lambda: succinct.build_lift(seg_po2, seg_ps, "rv32im")
        out["join"] = lambda: succinct.build_join(rec_po2, rec_ps)
        out["resolve"] = lambda: succinct.build_resolve(rec_po2, rec_ps)
    out["lift_keccak"] = lambda: cs.build_lift_keccak(kec_po2, kec_ps)
    out["union"] = lambda: cs.build_union(rec_po2, rec_ps)
    out["resolve_coproc"] = lambda: succinct.build_resolve_coproc(
        rec_po2, rec_ps, PLACEHOLDER_ROOT, rec_po2, rec_ps, PLACEHOLDER_CID)
    return out


def ci_roms(arrays: dict):
    ps = ci_ps()
    for kind, build in builders(None, KEC_PO2, CI_REC_PO2, None, ps, ps,
                                False).items():
        prog = build()
        arrays[f"ci/{kind}/rows"] = np.array(len(prog.rows))
        arrays[f"ci/{kind}/rom_diff"] = rom_diff(
            prog.finalize(CI_ROWS).ctrl_trace_np())
        print("ci", kind, int(arrays[f"ci/{kind}/rows"]), flush=True)


def production(arrays: dict):
    from boundless_tpu.zkvm import coproc, prove

    q50 = q50_ps()
    cid = coproc.circuit_id(PROD_KEC_PO2, q50)
    arrays["prod/circuit_id"] = np.asarray(cid, dtype=np.int64)
    print("prod circuit id", cid, flush=True)
    for kind, build in builders(PROD_SEG_PO2, PROD_KEC_PO2, PROD_REC_PO2,
                                prove.DEFAULT_PS, q50, q50, True).items():
        prog = build()
        arrays[f"prod/{kind}/rows"] = np.array(len(prog.rows))
        rom = prog.finalize(1 << PROD_REC_PO2).ctrl_trace_np()
        arrays[f"prod/{kind}/rom_sha256"] = np.array(words_sha256(rom))
        print("prod", kind, int(arrays[f"prod/{kind}/rows"]), flush=True)
        del prog, rom


def main():
    os.environ["BT_ZK_SEED"] = ZK_SEED
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundless_tpu.core import field as F

    F.enable_u64()  # bit-identical field math, faster CPU compile
    arrays = {"placeholder/coproc_root": np.asarray(PLACEHOLDER_ROOT),
              "placeholder/kec_circuit_id": np.asarray(PLACEHOLDER_CID)}
    ci_roms(arrays)
    production(arrays)
    keccak_proof(arrays)
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
