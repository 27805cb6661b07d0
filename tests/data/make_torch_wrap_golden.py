"""Regenerate `torch_wrap_golden.npz`: JAX reference data for the port's
Groth16 wrap circuit (`boundless_tpu_torch/groth16/circuit.py`).

Stores, from the JAX package on the CPU:
  * `toy/...`: the words of the p254-suite toy proof of
    `tests/test_suite254.py` (ProdAir, n = 32, 4 queries, rate 1/2) given
    the 24 publics `TOY_PUB` that `circuit.build_verifier` requires (its
    p254 digests as raw u32 words; the toy has no blinded rows);
  * `r1cs/...`: `build_verifier` over that proof (concrete mode): row and
    variable counts, and the sha256 of its rows and of its witness
    (`rows_sha256`, `witness_sha256`);
  * `groth16/...`: `qap.setup_trapdoor` and `qap.prove_with_trapdoor` on
    that system with the random source `fixed_rng(TRAPDOOR_SEED)`: the
    proof's A and C (affine x, y) and B (x0, x1, y0, y1), and the
    verifying key's alpha and IC points, each coordinate as 8
    little-endian u32 words.

Usage (about 2 minutes on a CPU host, most of it XLA compile, the circuit
and the trapdoor prover):

    JAX_PLATFORMS=cpu python tests/data/make_torch_wrap_golden.py
"""

from __future__ import annotations

import hashlib
import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_wrap_golden.npz")
TOY_PO2 = 5
TOY_PUB = [3] + list(range(101, 124))  # pub[0] is the AIR's first value
TRAPDOOR_SEED = 20263


def fixed_rng(seed: int):
    """A deterministic `rng(n) -> [0, n)` for the Groth16 set-up/prover."""
    r = random.Random(seed)
    return lambda n: r.randrange(n)


def rows_sha256(rows) -> str:
    """sha256 over an R1CS's rows: each (A, B, C) linear combination as
    its (variable, coefficient) pairs in insertion order."""
    h = hashlib.sha256()
    for row in rows:
        for lc in row:
            h.update(b"|")
            for k, c in lc.items():
                h.update(b"%d:%d," % (k, c))
        h.update(b";")
    return h.hexdigest()


def witness_sha256(values) -> str:
    """sha256 of a witness as 32-byte little-endian felts."""
    return hashlib.sha256(b"".join(int(v).to_bytes(32, "little")
                                   for v in values)).hexdigest()


def int_words(x: int) -> np.ndarray:
    """A felt as 8 little-endian u32 words."""
    return np.array([(int(x) >> (32 * i)) & 0xFFFFFFFF for i in range(8)],
                    dtype=np.uint32)


def g1_words(p) -> np.ndarray:
    aff = p.to_affine()
    return (np.zeros(16, dtype=np.uint32) if aff is None else
            np.concatenate([int_words(aff[0]), int_words(aff[1])]))


def g2_words(p) -> np.ndarray:
    (x0, x1), (y0, y1) = p
    return np.concatenate([int_words(v) for v in (x0, x1, y0, y1)])


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundless_tpu.core import field as F

    F.enable_u64()  # bit-identical field math, faster CPU compile
    from boundless_tpu.groth16 import circuit, qap, r1cs
    from boundless_tpu.prover import stark
    from test_suite254 import _toy_air

    air = _toy_air()
    n = 1 << TOY_PO2
    vals = [TOY_PUB[0]]
    for _ in range(n - 1):
        vals.append(vals[-1] * vals[-1] % F.P)
    data = F.fp(np.asarray(vals, dtype=np.int64)[:, None])
    pub = F.fp(np.asarray(TOY_PUB, dtype=np.int64))
    ps = stark.ProofSystem(queries=4, fri_min_degree=8, commit_expand=2,
                           hash="poseidon254")
    proof = stark.prove(air, data, pub, TOY_PO2, ps, None)
    root = stark.control_root_of(air, TOY_PO2, ps=ps)
    assert bool(stark.verify(air, proof, pub, TOY_PO2, root, ps))
    out = {}
    flatten(proof, "toy/", out)
    out["toy/control_root"] = np.asarray(root, dtype=np.uint32)

    bld = r1cs.Builder(concrete=True)
    circuit.build_verifier(bld, air, TOY_PO2, ps,
                           [int(x) for x in np.asarray(root)], proof=proof,
                           pub_vals=TOY_PUB)
    sys_ = bld.to_sparse()
    wit = bld.witness()
    assert sys_.is_satisfied(wit)
    out["r1cs/n_rows"] = np.int64(len(sys_.rows))
    out["r1cs/n_vars"] = np.int64(sys_.n_vars)
    out["r1cs/n_pub"] = np.int64(sys_.n_pub)
    out["r1cs/rows_sha256"] = np.array(rows_sha256(sys_.rows))
    out["r1cs/witness_sha256"] = np.array(witness_sha256(wit))

    rng = fixed_rng(TRAPDOOR_SEED)
    td, vk = qap.setup_trapdoor(sys_, rng=rng)
    g = qap.prove_with_trapdoor(sys_, td, wit, rng=rng)
    out["groth16/a"] = g1_words(g.a)
    out["groth16/b"] = g2_words(g.b)
    out["groth16/c"] = g1_words(g.c)
    out["groth16/vk_alpha"] = g1_words(vk.alpha_g1)
    out["groth16/vk_ic"] = np.stack([g1_words(p) for p in vk.ic])
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(sys_.rows)} rows, {sys_.n_vars} variables")


def flatten(v, prefix: str, out: dict):
    """Proof pytree -> {field path: uint32} (the keys of the port's
    `convert.proof_to_numpy`)."""
    if v is None:
        return
    if hasattr(v, "_fields"):
        for name in v._fields:
            flatten(getattr(v, name), f"{prefix}{name}.", out)
    elif isinstance(v, tuple):
        for i, x in enumerate(v):
            flatten(x, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(v).astype(np.uint32)


if __name__ == "__main__":
    main()
