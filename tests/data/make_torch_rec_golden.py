"""Regenerate `torch_rec_golden.npz`: JAX reference data for the port's
succinct recursion (`boundless_tpu_torch/recursion/`).

Stores, from the JAX package on the CPU:
  * `demo/...`: the demo program of `tests/test_recursion_air.py`
    (`_demo_pub`: every op family) at po2 8 — its input, publics,
    canonical ROM and data trace, and the words of its RecursionAir STARK
    proof under `TEST_PS` (jitted `stark.prove`, minutes of XLA compile);
  * `lift/<variant>/data_sha256`: the sha256 of the lift program's data
    trace (canonical little-endian u32 words) over the golden po2-8
    segment proof of `torch_golden_po2_8.npz`, ROM at 2^18 rows;
  * `prod/<kind>/rom_sha256` and `prod/<kind>/rows`: the sha256 of the ROM
    words (canonical little-endian u32, finalized at 2^20 rows) and the
    row count before padding of the production programs: lift_i
    (`build_lift(17, DEFAULT_PS, "rv32i")`), join and resolve
    (`build_join` / `build_resolve(20, ProofSystem(queries=50,
    fri_min_degree=256, commit_expand=2))`). Host program construction
    only: the control IDs at rec_po2 20 are not derived here.

Usage (a few minutes on a CPU host):

    JAX_PLATFORMS=cpu python tests/data/make_torch_rec_golden.py
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_rec_golden.npz")
DEMO_PO2 = 8
LIFT_PO2 = 8
LIFT_ROWS = 1 << 18
PROD_SEG_PO2 = 17
PROD_REC_PO2 = 20


def words_sha256(a) -> str:
    """sha256 of canonical field words as little-endian u32."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a, dtype=np.int64).astype("<u4")).tobytes()).hexdigest()


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


def jax_segment_proof(flat: dict):
    """The JAX package's SegmentProof from a flat {field path: words}."""
    import jax.numpy as jnp

    from boundless_tpu.core import fri
    from boundless_tpu.prover import stark

    fields = {}
    for name in stark.SegmentProof._fields:
        if name.startswith("open_"):
            fields[name] = (stark.GroupOpening(
                jnp.asarray(flat[f"{name}.rows"]),
                jnp.asarray(flat[f"{name}.paths"]))
                if f"{name}.rows" in flat else None)
        elif name == "fri_proof":
            lists = []
            for lst in ("round_roots", "round_rows", "round_paths"):
                keys = sorted((k for k in flat
                               if k.startswith(f"fri_proof.{lst}.")),
                              key=lambda k: int(k.rsplit(".", 1)[1]))
                lists.append(tuple(jnp.asarray(flat[k]) for k in keys))
            fields[name] = fri.FriProof(
                *lists, jnp.asarray(flat["fri_proof.final_coeffs"]))
        else:
            fields[name] = jnp.asarray(flat[name]) if name in flat else None
    return stark.SegmentProof(**fields)


def golden_segment(variant: str):
    """(canonical pub dict, JAX SegmentProof, segment pre_mem) of the po2-8
    golden segment proof of one variant."""
    from boundless_tpu.core import field as F
    from boundless_tpu.zkvm import guests
    from boundless_tpu.zkvm.executor import Executor

    g = np.load(os.path.join(HERE, "torch_golden_po2_8.npz"))
    pre = variant + "/"
    flat = {k[len(pre + "proof."):]: g[k] for k in g.files
            if k.startswith(pre + "proof.")}
    pub = {}
    for k in g.files:
        if k.startswith(pre + "in.pub."):
            v = np.asarray(F.from_mont(g[k])).astype(np.int64)
            pub[k[len(pre + "in.pub."):]] = int(v) if v.ndim == 0 else v
    seg = Executor(guests.echo(), guests.words([2, 11, 22]),
                   segment_po2=LIFT_PO2).run().segments[0]
    return pub, jax_segment_proof(flat), seg.pre_mem


def lift_claim_pub_vals(pub, proof, pre_mem):
    """The lift's 24 publics: claim digest, a zero allowed root, zeros."""
    from boundless_tpu.core import field as F
    from boundless_tpu.recursion import claims, succinct

    pre_root, post_root, _ = succinct.paging_walk(pub, pre_mem)
    image_id = np.asarray(F.from_mont(proof.ctrl_root)).astype(np.int64)
    claim = claims.Claim.of_segment(image_id, pub, None, pre_root, post_root)
    return list(claim.digest()) + [0] * 16


def demo(arrays: dict):
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_recursion_air import _demo_pub

    from boundless_tpu.core import field as F
    from boundless_tpu.prover import stark
    from boundless_tpu.recursion import air as rair
    from boundless_tpu.zkvm import prove

    prog, inputs, pub_vals = _demo_pub()
    n = 1 << DEMO_PO2
    ctrl = rair.rom_trace(prog, n)
    data = rair.data_trace(prog, inputs, pub_vals)
    pub = rair.pub_array(pub_vals)
    proof = jax.jit(lambda d, p, c: stark.prove(
        rair.AIR, d, p, DEMO_PO2, prove.TEST_PS, c))(data, pub, ctrl)
    arrays["demo/inputs"] = np.asarray(inputs, dtype=np.int64)
    arrays["demo/pub_vals"] = np.asarray(pub_vals, dtype=np.int64)
    arrays["demo/ctrl"] = np.asarray(F.from_mont(ctrl)).astype(np.uint32)
    arrays["demo/data"] = np.asarray(F.from_mont(data)).astype(np.uint32)
    flat = {}
    flatten(proof, "", flat)
    arrays.update({f"demo/proof.{k}": v for k, v in flat.items()})


def lift_digests(arrays: dict):
    from boundless_tpu.recursion import succinct, vm
    from boundless_tpu.zkvm import prove

    for variant in ("rv32im", "rv32i"):
        pub, proof, pre_mem = golden_segment(variant)
        prog = succinct.build_lift(LIFT_PO2, prove.TEST_PS, variant)
        prog.finalize(LIFT_ROWS)
        wit = succinct.lift_witness(pub, proof, LIFT_PO2, prove.TEST_PS,
                                    None, pre_mem, variant, 0)
        data = vm.evaluate_native(prog, wit, lift_claim_pub_vals(
            pub, proof, pre_mem))
        arrays[f"lift/{variant}/data_sha256"] = np.array(words_sha256(data))
        print("lift", variant, len(wit), "inputs", flush=True)


def production_roms(arrays: dict):
    from boundless_tpu.prover import stark
    from boundless_tpu.recursion import succinct
    from boundless_tpu.zkvm import prove

    rec_ps = stark.ProofSystem(queries=50, fri_min_degree=256,
                               commit_expand=2)
    makers = {
        "lift_i": lambda: succinct.build_lift(PROD_SEG_PO2, prove.DEFAULT_PS,
                                              "rv32i"),
        "join": lambda: succinct.build_join(PROD_REC_PO2, rec_ps),
        "resolve": lambda: succinct.build_resolve(PROD_REC_PO2, rec_ps)}
    for kind, build in makers.items():
        prog = build()
        arrays[f"prod/{kind}/rows"] = np.array(len(prog.rows))
        rom = prog.finalize(1 << PROD_REC_PO2).ctrl_trace_np()
        arrays[f"prod/{kind}/rom_sha256"] = np.array(words_sha256(rom))
        print("prod", kind, int(arrays[f"prod/{kind}/rows"]), flush=True)
        del prog, rom


def main():
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundless_tpu.core import field as F

    F.enable_u64()  # bit-identical field math, faster CPU compile
    arrays = {}
    lift_digests(arrays)
    production_roms(arrays)
    demo(arrays)
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
