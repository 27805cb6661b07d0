"""Keccak coprocessor proving: batch receipts + union tree (host layer).

Counterpart of `boundless_tpu/zkvm/coproc.py`. A batch of keccak-f[1600]
permutations is proven by one KeccakAir STARK (`air/keccak.py`) on the
device the caller names (the card unless the caller asks for the CPU);
per-permutation claim digests are derived from the proof's PUBLIC state
table and must match the executor's ecall digests
(`zkvm/executor.keccak_perm_digest`). Union receipts merge batches
pairwise (aggregation semantics: children carried, digests concatenated);
the succinct lattice over the same batches is
`recursion/coproc_succinct.py`.

The compute side of the reference's coproc stream
(`prover/crates/workflow/src/tasks/keccak.rs:71-84` prove_keccak,
`tasks/union.rs:44-50` union).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np

from ..air import keccak as K
from ..core import field as F
from ..core import poseidon2_np as P2NP
from ..prover import stark
from .prove import _device

# CI-friendly default batch size: 2^8 rows = 10 permutations / segment.
DEFAULT_PO2 = 8


@dataclasses.dataclass
class KeccakReceipt:
    """One proven batch: proof + public state table + claim digests of
    the first `count` (real) permutations."""

    proof: Optional[stark.SegmentProof]  # None in dev mode
    states_pub: np.ndarray  # (KMAX, 1 + 200) canonical int64
    po2: int
    count: int

    def digests(self) -> List[bytes]:
        out = []
        for k in range(self.count):
            limbs = [int(x) for x in self.states_pub[k, 1:]]
            d = P2NP.hash_elems_np(limbs)
            out.append(b"".join(int(w).to_bytes(4, "little") for w in d))
        return out


@dataclasses.dataclass
class UnionReceipt:
    """Aggregation union of keccak batches (reference union.rs:44)."""

    children: list  # KeccakReceipt | UnionReceipt

    def digests(self) -> List[bytes]:
        out = []
        for ch in self.children:
            out.extend(ch.digests())
        return out


@functools.lru_cache(maxsize=None)
def _circuit_id(po2: int, ps: stark.ProofSystem, device: str) -> tuple:
    root = stark.control_root_of(K.AIR, po2, ps=ps, device=device)
    return tuple(int(x) for x in F.from_mont(root).cpu().numpy())


def circuit_id(po2: int, ps: stark.ProofSystem, device="cuda") -> tuple:
    """The keccak circuit's control root (static ctrl group), computed on
    `device` (the card unless the caller asks for the CPU)."""
    return _circuit_id(po2, ps, str(_device(device)))


def prove_keccak(states: List[list], po2: int = DEFAULT_PO2,
                 ps: stark.ProofSystem = None, dev_mode: bool = False,
                 device="cuda") -> KeccakReceipt:
    """Prove a batch of permutations (input lane lists) on `device`."""
    ps = ps or stark.ProofSystem()
    data, pub, _outs = K.witness(states, po2)
    if dev_mode:
        return KeccakReceipt(proof=None, states_pub=pub["states"],
                             po2=po2, count=len(states))
    dev = _device(device)
    proof = stark.prove(K.AIR, F.fp(data, dev),
                        K.PublicValues(states=F.fp(pub["states"], dev)),
                        po2, ps)
    return KeccakReceipt(proof=proof, states_pub=pub["states"], po2=po2,
                         count=len(states))


def verify_keccak(r: KeccakReceipt, ps: stark.ProofSystem = None) -> bool:
    """Verify a batch receipt: the STARK against the static circuit id,
    with the receipt's public state table, on the proof's device."""
    if r.proof is None:
        return False  # dev receipts don't verify (fixture semantics)
    ps = ps or stark.ProofSystem()
    dev = r.proof.data_root.device
    root = F.fp(np.asarray(circuit_id(r.po2, ps, dev), dtype=np.int64), dev)
    ok = stark.verify(K.AIR, r.proof,
                      K.PublicValues(states=F.fp(r.states_pub, dev)),
                      r.po2, root, ps)
    return bool(ok)


def union(left, right) -> UnionReceipt:
    return UnionReceipt(children=[left, right])


def verify_union(r, ps: stark.ProofSystem = None,
                 dev_mode: bool = False) -> bool:
    """Recursively verify an aggregation union."""
    if isinstance(r, KeccakReceipt):
        return dev_mode if r.proof is None else verify_keccak(r, ps)
    return all(verify_union(ch, ps, dev_mode) for ch in r.children)
