"""Regenerate `torch_golden_po2_8.npz`: JAX reference proofs for the port.

Runs the JAX package's jitted `stark.prove` on the `__graft_entry__._example`
inputs (echo guest, po2 8, TEST_PS, blinding seed fixed) for both AIR
variants, and stores the inputs (canonical data/ctrl, Montgomery publics)
and the SegmentProof words. `tests/test_torch_prove.py` holds the port's
CPU proof against this file bit for bit; `chip_smoke.py` does the same on
the GPU. Usage (minutes of XLA compile on a CPU host):

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ZK_SEED = "20260"
PO2 = 8
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "torch_golden_po2_8.npz")
PUB_FIELDS = ("pre_pc", "post_pc", "pre_regs", "post_regs", "halted",
              "pre_seqs", "post_seqs", "io", "cpio", "mem")


def flatten(v, prefix: str, out: dict):
    """Proof pytree -> {field path: uint32}; the same keys as the port's
    `convert.proof_to_numpy` (named tuples by field, tuples by index)."""
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


def jax_proof(variant: str):
    """(data, pub, ctrl, SegmentProof) from the JAX package's jitted prover
    on the `_example` inputs (BT_ZK_SEED must be set)."""
    import jax

    from __graft_entry__ import _example
    from boundless_tpu.prover import stark
    from boundless_tpu.zkvm import prove

    ps = prove.TEST_PS
    data, pub, ctrl = _example(PO2, ps, variant)
    air = prove._AIRS[variant]
    proof = jax.jit(lambda d, p, c: stark.prove(air, d, p, PO2, ps, c))(
        data, pub, ctrl)
    return data, pub, ctrl, proof


def golden(variant: str) -> dict:
    """{key: array} for one variant: inputs under `in.`, proof under
    `proof.`; data/ctrl are canonical (they compress), the rest Montgomery."""
    from boundless_tpu.core import field as F

    data, pub, ctrl, proof = jax_proof(variant)
    out = {"in.data": np.asarray(F.from_mont(data)).astype(np.uint32),
           "in.ctrl": np.asarray(F.from_mont(ctrl)).astype(np.uint32)}
    for k in PUB_FIELDS:
        out[f"in.pub.{k}"] = np.asarray(getattr(pub, k)).astype(np.uint32)
    flat = {}
    flatten(proof, "", flat)
    out.update({f"proof.{k}": v for k, v in flat.items()})
    return out


def main():
    os.environ["BT_ZK_SEED"] = ZK_SEED
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundless_tpu.core import field as F

    F.enable_u64()  # bit-identical field math, faster CPU compile
    arrays = {"zk_seed": np.array(int(ZK_SEED))}
    for variant in ("rv32im", "rv32i"):
        arrays.update({f"{variant}/{k}": v
                       for k, v in golden(variant).items()})
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
