"""numpy <-> port converters for every array the prover carries across.

A proof, its public values, the Poseidon2 tables, the recursion
receipts, the p254 final-shrink receipt and the Groth16 objects (proofs,
keys, seals, receipts) are this system's "weights": tests move them
between the JAX package and the port as numpy arrays and Python ints. The flat proof dictionary is keyed
by field path (`open_data.rows`, `fri_proof.round_roots.0`, ...) so that
a proof of either package flattens to the same keys. This module imports no JAX: it
reads leaves through `numpy.asarray`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .air.rv32im import PublicValues
from .core import field as F
from .core import fri
from .core import poseidon2 as P2
from .groth16 import bn254, protocol, wrap
from .kernels import poseidon254 as P254K
from .prover import stark
from .recursion import claims, coproc_succinct, identity, succinct
from .zkvm import coproc

_OPENINGS = ("open_ctrl", "open_data", "open_accum", "open_check")
_FRI_LISTS = ("round_roots", "round_rows", "round_paths")


def to_numpy(x) -> np.ndarray:
    """Torch tensor, JAX array or numpy array -> numpy (no copy if numpy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor(x, device="cpu") -> torch.Tensor:
    """Montgomery words (any integer array < P) -> int32 tensor on `device`."""
    arr = to_numpy(x).astype(np.int64)
    if arr.size and (arr.min() < 0 or arr.max() >= F.P):
        raise ValueError("not an array of reduced field words")
    return torch.from_numpy(arr.astype(np.int32)).to(device)


def proof_to_numpy(proof, prefix: str = "", out=None) -> dict:
    """SegmentProof (either package) -> {field path: uint32 array}.

    Named tuples recurse by field name, tuples by index; None is absent."""
    out = {} if out is None else out
    if proof is None:
        return out
    if hasattr(proof, "_fields"):
        for name in proof._fields:
            proof_to_numpy(getattr(proof, name), f"{prefix}{name}.", out)
    elif isinstance(proof, tuple):
        for i, v in enumerate(proof):
            proof_to_numpy(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = to_numpy(proof).astype(np.uint32)
    return out


def _is_digest(key: str) -> bool:
    """Merkle roots and paths: the digest fields of a flat proof."""
    return (key.endswith("_root") or key.endswith(".paths")
            or key.startswith("fri_proof.round_roots.")
            or key.startswith("fri_proof.round_paths."))


def proof_from_numpy(flat: dict, device="cpu",
                     p254: bool = False) -> stark.SegmentProof:
    """Inverse of `proof_to_numpy`, building the port's SegmentProof.
    `p254`: a poseidon254-suite proof, whose digests are raw u32 words
    (held as int32 bit patterns) and not field words."""
    def t(k):
        if p254 and _is_digest(k):
            return P254K.words_tensor(flat[k], device)
        return tensor(flat[k], device)
    fields = {}
    for name in stark.SegmentProof._fields:
        if name in _OPENINGS:
            fields[name] = (stark.GroupOpening(t(f"{name}.rows"),
                                               t(f"{name}.paths"))
                            if f"{name}.rows" in flat else None)
        elif name == "fri_proof":
            lists = {}
            for lst in _FRI_LISTS:
                keys = sorted((k for k in flat
                               if k.startswith(f"fri_proof.{lst}.")),
                              key=lambda k: int(k.rsplit(".", 1)[1]))
                lists[lst] = tuple(t(k) for k in keys)
            fields[name] = fri.FriProof(
                lists["round_roots"], lists["round_rows"],
                lists["round_paths"], t("fri_proof.final_coeffs"))
        else:
            fields[name] = t(name) if name in flat else None
    return stark.SegmentProof(**fields)


_PUB_FIELDS = [f.name for f in dataclasses.fields(PublicValues)]


def pub_to_numpy(pub) -> dict:
    """PublicValues (either package) -> {field: uint32 Montgomery array}."""
    return {k: to_numpy(getattr(pub, k)).astype(np.uint32)
            for k in _PUB_FIELDS}


def pub_from_numpy(flat: dict, device="cpu") -> PublicValues:
    return PublicValues(**{k: tensor(flat[k], device) for k in _PUB_FIELDS})


def poseidon2_constants() -> tuple:
    """The port's (external rc (8, 24), internal rc (21,), mu (24,)) tables
    as uint32 Montgomery numpy, laid out like the JAX `P2._constants()`."""
    ext_rc, int_rc, mu = P2.constants()
    return (ext_rc.astype(np.uint32), int_rc.astype(np.uint32),
            mu.astype(np.uint32))


def _dataclass_from_numpy(cls, flat: dict):
    """A frozen claim dataclass from {field: array}: ints stay ints,
    words become tuples."""
    return cls(**{f.name: (int(flat[f.name]) if flat[f.name].ndim == 0
                           else tuple(int(x) for x in flat[f.name]))
                  for f in dataclasses.fields(cls)})


def claim_to_numpy(claim) -> dict:
    """Claim or CoprocClaim (either package) -> {field: int64 array}
    (canonical words)."""
    return {f.name: np.asarray(getattr(claim, f.name), dtype=np.int64)
            for f in dataclasses.fields(claim)}


def claim_from_numpy(flat: dict) -> claims.Claim:
    """Inverse of `claim_to_numpy` for a main-lattice Claim."""
    return _dataclass_from_numpy(claims.Claim, flat)


def coproc_claim_from_numpy(flat: dict) -> coproc_succinct.CoprocClaim:
    """Inverse of `claim_to_numpy` for a coproc-lattice CoprocClaim."""
    return _dataclass_from_numpy(coproc_succinct.CoprocClaim, flat)


def rec_receipt_to_numpy(r) -> dict:
    """RecReceipt or CoprocRecReceipt (either package) -> {key: array}:
    kind, po2, pub_vals, `claim.<field>` and `proof.<field path>`
    (Montgomery words)."""
    out = {"kind": np.array(r.kind), "po2": np.array(int(r.po2)),
           "pub_vals": np.asarray(r.pub_vals, dtype=np.int64)}
    out.update({f"claim.{k}": v for k, v in claim_to_numpy(r.claim).items()})
    out.update({f"proof.{k}": v
                for k, v in proof_to_numpy(r.proof).items()})
    return out


def _sub(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _rec_receipt_from_numpy(flat: dict, device, cls, claim_from):
    proof = _sub(flat, "proof.")
    return cls(kind=str(flat["kind"]),
               proof=proof_from_numpy(proof, device) if proof else None,
               claim=claim_from(_sub(flat, "claim.")),
               pub_vals=tuple(int(x) for x in flat["pub_vals"]),
               po2=int(flat["po2"]))


def rec_receipt_from_numpy(flat: dict, device="cpu") -> succinct.RecReceipt:
    """Inverse of `rec_receipt_to_numpy`, building the port's RecReceipt
    with its proof on `device`."""
    return _rec_receipt_from_numpy(flat, device, succinct.RecReceipt,
                                   claim_from_numpy)


def coproc_rec_receipt_from_numpy(flat: dict, device="cpu"
                                  ) -> coproc_succinct.CoprocRecReceipt:
    """Inverse of `rec_receipt_to_numpy` for a coproc-lattice receipt
    (lift_keccak / union), with its proof on `device`."""
    return _rec_receipt_from_numpy(flat, device,
                                   coproc_succinct.CoprocRecReceipt,
                                   coproc_claim_from_numpy)


def keccak_receipt_to_numpy(r) -> dict:
    """KeccakReceipt (either package) -> {key: array}: po2, count,
    states_pub (canonical int64) and `proof.<field path>`."""
    out = {"po2": np.array(int(r.po2)), "count": np.array(int(r.count)),
           "states_pub": np.asarray(r.states_pub, dtype=np.int64)}
    out.update({f"proof.{k}": v
                for k, v in proof_to_numpy(r.proof).items()})
    return out


def keccak_receipt_from_numpy(flat: dict, device="cpu"
                              ) -> coproc.KeccakReceipt:
    """Inverse of `keccak_receipt_to_numpy`, building the port's
    KeccakReceipt with its proof on `device`."""
    proof = _sub(flat, "proof.")
    return coproc.KeccakReceipt(
        proof=proof_from_numpy(proof, device) if proof else None,
        states_pub=np.asarray(flat["states_pub"], dtype=np.int64),
        po2=int(flat["po2"]), count=int(flat["count"]))


def p254_receipt_to_numpy(r) -> dict:
    """P254Receipt (either package) -> {key: array}: po2, pub_vals,
    `claim.<field>` and `proof.<field path>` (digests as raw u32 words)."""
    out = {"po2": np.array(int(r.po2)),
           "pub_vals": np.asarray(r.pub_vals, dtype=np.int64)}
    out.update({f"claim.{k}": v for k, v in claim_to_numpy(r.claim).items()})
    out.update({f"proof.{k}": v
                for k, v in proof_to_numpy(r.proof).items()})
    return out


def p254_receipt_from_numpy(flat: dict, device="cpu"
                            ) -> identity.P254Receipt:
    """Inverse of `p254_receipt_to_numpy`, with the proof on `device`."""
    return identity.P254Receipt(
        proof=proof_from_numpy(_sub(flat, "proof."), device, p254=True),
        claim=claim_from_numpy(_sub(flat, "claim.")),
        pub_vals=tuple(int(x) for x in flat["pub_vals"]),
        po2=int(flat["po2"]))


# ---------------------------------------------------------------------------
# Groth16 objects <-> Python ints
# ---------------------------------------------------------------------------

# dataclass fields that hold G1 points (one or a list); G2 points are
# already Python-int tuples ((x0, x1), (y0, y1)) or None in both packages
_G1_FIELDS = {"a", "c", "alpha_g1", "beta_g1", "delta_g1", "ic", "a_g1",
              "b_g1", "l_g1", "h_g1"}


def _g1_ints(p):
    return p.to_affine()  # (x, y) ints, None at infinity


def groth16_to_ints(obj) -> dict:
    """A Groth16 `Proof`, `VerifyingKey` or `ProvingKey` of either package
    -> {field: value}: G1 points as affine (x, y) ints (None at infinity),
    lists of them as lists, G2 points as they are."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in _G1_FIELDS:
            v = ([_g1_ints(p) for p in v] if isinstance(v, list)
                 else _g1_ints(v))
        out[f.name] = v
    return out


def groth16_from_ints(cls, d: dict, g1=bn254.G1):
    """Inverse of `groth16_to_ints` into `cls` (the port's
    `protocol.Proof` / `VerifyingKey` / `ProvingKey`, or the reference's,
    with its `G1` class as `g1`)."""
    fields = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name in _G1_FIELDS:
            v = ([g1.from_affine(p) for p in v] if isinstance(v, list)
                 else g1.from_affine(v))
        fields[f.name] = v
    return cls(**fields)


def seal_to_ints(seal) -> dict:
    """Groth16Seal (either package) -> {field: ints / numpy}."""
    return {"proof": groth16_to_ints(seal.proof),
            "vk": groth16_to_ints(seal.vk),
            "publics": tuple(int(x) for x in seal.publics),
            "claim": claim_to_numpy(seal.claim),
            "entry_pc": int(seal.entry_pc),
            "image_mem_root": (None if seal.image_mem_root is None else
                               tuple(int(x) for x in seal.image_mem_root)),
            "allowed_root": tuple(int(x) for x in seal.allowed_root)}


def seal_from_ints(d: dict) -> wrap.Groth16Seal:
    """Inverse of `seal_to_ints`, building the port's Groth16Seal."""
    return wrap.Groth16Seal(
        proof=groth16_from_ints(protocol.Proof, d["proof"]),
        vk=groth16_from_ints(protocol.VerifyingKey, d["vk"]),
        publics=tuple(d["publics"]), claim=claim_from_numpy(d["claim"]),
        entry_pc=d["entry_pc"], image_mem_root=d["image_mem_root"],
        allowed_root=tuple(d["allowed_root"]))


def groth16_receipt_to_ints(r) -> dict:
    """A real (not dev-mode) Groth16Receipt of either package -> dict."""
    if r.dev_mode:
        raise ValueError("a dev-mode receipt carries a session receipt, "
                         "not a seal")
    return {"kind": r.kind, "selector": r.selector,
            "claim_digest": bytes(r.claim_digest),
            "journal": bytes(r.journal),
            "image_id": tuple(int(x) for x in r.image_id),
            "inner": seal_to_ints(r.inner)}


def groth16_receipt_from_ints(d: dict) -> wrap.Groth16Receipt:
    """Inverse of `groth16_receipt_to_ints`, building the port's."""
    return wrap.Groth16Receipt(
        kind=d["kind"], selector=d["selector"],
        claim_digest=d["claim_digest"], journal=d["journal"],
        image_id=tuple(d["image_id"]), dev_mode=False,
        inner=seal_from_ints(d["inner"]))
