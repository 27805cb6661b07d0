"""Succinct coprocessor lattice: lift_keccak + union recursion programs.

Counterpart of `boundless_tpu/recursion/coproc_succinct.py`: the same two
programs, built over the port's AIRs with the reference's ROMs word for
word, and proved as RecursionAir STARKs on the device the system was made
for (the card unless the caller asks for the CPU), the data trace coming
from the C++ evaluator.

The reference merges keccak coprocessor receipts with
`ProverServer::union` into a binary tree of SuccinctReceipts
(`prover/crates/workflow/src/tasks/union.rs:44-50`); the leaves become
succinct by verifying the keccak circuit proof inside the recursion
circuit. Two programs on the same RecursionAir:

  * **lift_keccak** — verifies one KeccakAir batch STARK wire-for-wire
    (the generic `programs.StarkVerifier` over `air/keccak.py`; its
    wire-algebra public LogUp sum, `keccak._public_sum_prog`, binds the
    public state table), derives each real permutation's claim digest
    in-circuit (`H(limb_0..199)` over the PUBLIC in/out state — the same
    digest `zkvm/coproc.KeccakReceipt.digests` computes host-side), and
    folds them into a digest CHAIN: `h' = H(h || d)`. The pre-chain is
    free witness — coproc claims are spans ("IF pre THEN post"), exactly
    like segment io chains, so independently proven batches unite
    pairwise without re-proving.
  * **union** — verifies two child coproc recursion proofs, checks
    circuit-id equality and chain/count continuity (L.post == R.pre) and
    emits the spanning claim — `build_join`'s shape over CoprocClaim.

The in-circuit keccak verifier's size is dominated by leaf hashing of the
4048-column trace (253 sponge permutations per query per tree), so the
coproc lattice runs at its OWN uniform rec_po2 with its own allowed-set
root; `succinct.build_resolve_coproc` discharges a main-lattice claim's
keccak chain against one of its receipts.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..air import keccak as K
from ..core import field as F
from ..core import poseidon2_np as P2NP
from ..prover import stark
from ..zkvm import coproc as zco
from ..zkvm.prove import _device
from . import air as rair
from . import claims, programs, vm
from .succinct import _const4, _pack4, _select2, _sync

P = F.P

CP_CLAIM_WIRES = 7
CP_CLAIM_ELEMS = 4 * CP_CLAIM_WIRES  # 28 slots
ROW_ELEMS = 1 + 2 * K.ENTRIES  # mask + 100 (lo, hi) limb pairs


def chain_step(h: Sequence[int], d: Sequence[int]) -> Tuple[int, ...]:
    """h' = H(h(8) || d(8)) — one 16-element fold."""
    return P2NP.hash_elems_np([int(x) % P for x in list(h) + list(d)])


def perm_digest_words(state_row: Sequence[int]) -> Tuple[int, ...]:
    """Claim digest of one permutation from its public (in||out) limbs —
    identical to `zkvm/coproc.KeccakReceipt.digests` (which emits the
    byte form of the same 8 words)."""
    return P2NP.hash_elems_np([int(x) % P for x in state_row])


@dataclasses.dataclass(frozen=True)
class CoprocClaim:
    """A span of the coprocessor digest chain (1..k keccak batches)."""

    circuit_id: tuple  # 8 words = keccak circuit control root
    pre_chain: tuple   # 8
    post_chain: tuple  # 8
    pre_count: int
    post_count: int

    def to_elems(self) -> List[int]:
        out = [int(x) for x in self.circuit_id]
        out += [int(x) for x in self.pre_chain]
        out += [int(x) for x in self.post_chain]
        out += [int(self.pre_count), int(self.post_count), 0, 0]
        assert len(out) == CP_CLAIM_ELEMS
        return out

    def digest(self) -> Tuple[int, ...]:
        return P2NP.hash_elems_np([x % P for x in self.to_elems()])

    @staticmethod
    def of_batch(circuit_id, states_pub: np.ndarray, count: int,
                 pre_chain: Sequence[int] = claims.ZERO_CHAIN,
                 pre_count: int = 0) -> "CoprocClaim":
        h = tuple(int(x) for x in pre_chain)
        for k in range(count):
            h = chain_step(h, perm_digest_words(states_pub[k, 1:]))
        return CoprocClaim(circuit_id=tuple(int(x) for x in circuit_id),
                           pre_chain=tuple(int(x) for x in pre_chain),
                           post_chain=h, pre_count=pre_count,
                           post_count=pre_count + count)

    def union(self, right: "CoprocClaim") -> "CoprocClaim":
        if self.circuit_id != right.circuit_id:
            raise ValueError("union: circuit id mismatch")
        if self.post_chain != right.pre_chain or \
                self.post_count != right.pre_count:
            raise ValueError("union: chain discontinuity")
        return CoprocClaim(circuit_id=self.circuit_id,
                           pre_chain=self.pre_chain,
                           post_chain=right.post_chain,
                           pre_count=self.pre_count,
                           post_count=right.post_count)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


class _WireKecPub:
    """keccak PublicValues over wires: states[k] = [mask, limb 0..199]."""

    def __init__(self, sp: programs.ScalarPub, kmax: int):
        self.states = [[sp[k * ROW_ELEMS + j] for j in range(ROW_ELEMS)]
                       for k in range(kmax)]


class KeccakVerifier(programs.StarkVerifier):
    def unpack_pub(self, pub_wires):
        sp = programs.ScalarPub(self.p, pub_wires, self.pub_len)
        self.wire_pub = _WireKecPub(sp, self.pub_len // ROW_ELEMS)
        return self.wire_pub


def build_lift_keccak(kec_po2: int, kec_ps: stark.ProofSystem) -> vm.Prog:
    """In-circuit KeccakAir verify + coproc claim derivation.

    Witness order: serialized keccak proof (programs.serialize_proof),
    then pre_chain (2 packed wires), [pre_count, 0, 0, 0], and kmax
    fold-flag bits (1 for each REAL permutation, prefix-structured).

    The batch's PUBLIC mask column is 1 for every slot (the static
    circuit runs zero-state permutations in padding slots and the LogUp
    balance binds them all), so which perms enter the claim chain is a
    prefix-constrained WITNESS choice: every folded digest still comes
    from a proven permutation, and any fold selection that differs from
    the guest's actual ecall chain fails the resolve_coproc span
    equality — the prover can neither omit a requested permutation nor
    smuggle a padding digest in.
    """
    kmax = K.max_perms(kec_po2)
    p = vm.Prog(f"lift_keccak-p{kec_po2}q{kec_ps.queries}"
                f"e{kec_ps.commit_expand}")
    v = KeccakVerifier(K.AIR, kec_po2, kec_ps, pub_len=kmax * ROW_ELEMS,
                       prog=p, bind_pub_groups=False)
    res = v.build()
    pub = v.wire_pub

    pre_chain = (p.input(), p.input())
    pre_count = p.input()
    chain = pre_chain
    count = pre_count
    neg1 = (P - 1, 0, 0, 0)
    prev_mask = None
    for k in range(kmax):
        row = pub.states[k]
        mask = p.input_bit()  # fold flag (witness; boolean-constrained)
        if prev_mask is not None:  # padding only at the tail
            p.assert_zero(p.mul(mask, p.addc(prev_mask, neg1)))
        prev_mask = mask
        packed = [_pack4(p, row[1 + 4 * i: 1 + 4 * i + 4])
                  for i in range(2 * K.ENTRIES // 4)]
        d = p.hash_packed(packed, 2 * K.ENTRIES)
        f = p.hash_packed([chain[0], chain[1], d[0], d[1]], 16)
        chain = _select2(p, mask, f, chain)
        count = p.add(count, mask)

    cw = [res.ctrl_root[0], res.ctrl_root[1],
          pre_chain[0], pre_chain[1], chain[0], chain[1],
          p.add(pre_count, p._mul_basis(count, 1, 1))]
    assert len(cw) == CP_CLAIM_WIRES
    d0, d1 = p.hash_packed(cw, CP_CLAIM_ELEMS)
    p.assert_eq(d0, p.pub(0))
    p.assert_eq(d1, p.pub(1))
    p.assert_zero(p.pub(4))
    p.assert_zero(p.pub(5))
    return p


def verify_child_coproc(p: vm.Prog, rec_po2: int,
                        rec_ps: stark.ProofSystem, allowed_root=None):
    """`succinct._verify_child` over a CoprocClaim child (7 claim wires).

    The child's allowed root is the program's own (pub groups 2-3: union)
    or, when `allowed_root` is given, that constant (resolve_coproc, a
    main-lattice program verifying a coproc-lattice child)."""
    v = programs.StarkVerifier(rair.AIR, rec_po2, rec_ps,
                               pub_len=vm.PUB_VALS, prog=p,
                               bind_pub_groups=False)
    res = v.build()
    pub_w = res.pub_wires
    fixed = None if allowed_root is None else [
        _const4(p, allowed_root[0:4]), _const4(p, allowed_root[4:8])]

    def root(half):  # a pub wire is emitted afresh at each use
        return p.pub(2 + half) if fixed is None else fixed[half]

    p.assert_eq(pub_w[2], root(0))
    p.assert_eq(pub_w[3], root(1))
    p.assert_zero(pub_w[4])
    p.assert_zero(pub_w[5])
    cur = res.ctrl_root
    for _ in range(claims.ALLOWED_DEPTH):
        sib = (p.input(), p.input())
        b = p.input_bit()
        left = _select2(p, b, sib, cur)
        right = _select2(p, b, cur, sib)
        cur = programs.hash_pair(p, left, right)
    p.assert_eq(cur[0], root(0))
    p.assert_eq(cur[1], root(1))
    cwires = [p.input() for _ in range(CP_CLAIM_WIRES)]
    d0, d1 = p.hash_packed(cwires, CP_CLAIM_ELEMS)
    p.assert_eq(d0, pub_w[0])
    p.assert_eq(d1, pub_w[1])
    return cwires


def build_union(rec_po2: int, rec_ps: stark.ProofSystem) -> vm.Prog:
    """The union program: two coproc children + chain continuity.

    Witness order: child L (proof + allowed path + claim wires), child R.
    """
    p = vm.Prog(f"union-p{rec_po2}q{rec_ps.queries}e{rec_ps.commit_expand}")
    L = verify_child_coproc(p, rec_po2, rec_ps)
    R = verify_child_coproc(p, rec_po2, rec_ps)

    p.assert_eq(L[0], R[0])  # circuit id
    p.assert_eq(L[1], R[1])
    p.assert_eq(L[4], R[2])  # L.post_chain == R.pre_chain
    p.assert_eq(L[5], R[3])
    # counts: L.post_count == R.pre_count (comp 1 of wire 6 vs comp 0)
    p.assert_eq(p.pick(L[6], 1), p.pick(R[6], 0))

    U = [L[0], L[1], L[2], L[3], R[4], R[5],
         p.add(p.pick(L[6], 0), p._mul_basis(p.pick(R[6], 1), 1, 1))]
    d0, d1 = p.hash_packed(U, CP_CLAIM_ELEMS)
    p.assert_eq(d0, p.pub(0))
    p.assert_eq(d1, p.pub(1))
    p.assert_zero(p.pub(4))
    p.assert_zero(p.pub(5))
    return p


# ---------------------------------------------------------------------------
# The system
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoprocParams:
    kec_po2: int
    kec_ps: stark.ProofSystem
    rec_po2: int  # uniform coproc-lattice proof size (must fit lift_keccak)
    rec_ps: stark.ProofSystem


@dataclasses.dataclass
class CoprocRecReceipt:
    kind: str  # lift_keccak / union
    proof: Optional[stark.SegmentProof]  # None in dev mode
    claim: CoprocClaim
    pub_vals: tuple
    po2: int

    def claim_digest(self) -> tuple:
        return self.claim.digest()


COPROC_KINDS = ("lift_keccak", "union")


def lift_witness(kec_receipt, kec_po2: int, kec_ps: stark.ProofSystem,
                 pre_chain: Sequence[int] = claims.ZERO_CHAIN,
                 pre_count: int = 0) -> List[tuple]:
    """Witness stream for the lift_keccak program."""
    flat = [int(x) for x in
            np.asarray(kec_receipt.states_pub, dtype=np.int64).reshape(-1)]
    out = programs.serialize_proof(K.AIR, kec_receipt.proof, flat, kec_po2,
                                   kec_ps)
    out += programs._pack4([int(x) for x in pre_chain])
    out.append((int(pre_count), 0, 0, 0))
    for k in range(K.max_perms(kec_po2)):  # fold flags: real perms only
        out.append((1 if k < int(kec_receipt.count) else 0, 0, 0, 0))
    return out


class CoprocSystem:
    """Program set + prover for the coproc lattice (own allowed root), on
    `device` (the card unless the caller asks for the CPU): the ROMs, the
    control IDs and every proof live there.

    `seconds` holds the host clock of the set-up stages (`program_build`,
    `control_ids`) and of the stages of the latest proof (`witness`,
    `native_eval`, `prove`), as `SuccinctSystem` keeps them."""

    def __init__(self, params: CoprocParams, device="cuda"):
        self.params = params
        self.device = _device(device)
        self.seconds: Dict[str, float] = {}
        n = 1 << params.rec_po2
        t0 = time.perf_counter()
        self.progs: Dict[str, vm.Prog] = {
            "lift_keccak": build_lift_keccak(params.kec_po2, params.kec_ps),
            "union": build_union(params.rec_po2, params.rec_ps),
        }
        for name, prog in self.progs.items():
            if len(prog.rows) >= n:
                raise ValueError(f"{name} has {len(prog.rows)} rows; "
                                 f"rec_po2={params.rec_po2} too small")
            prog.finalize(n)
        self.roms = {k: rair.rom_trace(pr, n, self.device)
                     for k, pr in self.progs.items()}
        self.seconds["program_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.control_ids = {
            k: tuple(int(x) for x in F.from_mont(stark.control_root_of(
                rair.AIR, params.rec_po2, self.roms[k], params.rec_ps)))
            for k in COPROC_KINDS}
        self.seconds["control_ids"] = time.perf_counter() - t0
        self.allowed_ids = [self.control_ids[k] for k in COPROC_KINDS]
        self.allowed_root = claims.allowed_set_root(self.allowed_ids)

    def _pub_vals(self, claim: CoprocClaim) -> tuple:
        return tuple(list(claim.digest()) + list(self.allowed_root)
                     + [0] * 8)

    def _prove(self, kind: str, inputs, claim: CoprocClaim
               ) -> CoprocRecReceipt:
        pub_vals = self._pub_vals(claim)
        t0 = time.perf_counter()
        data = rair.data_trace(self.progs[kind], inputs, pub_vals,
                               self.device)
        _sync(self.device)
        t1 = time.perf_counter()
        proof = stark.prove(rair.AIR, data, rair.pub_array(
            pub_vals, self.device), self.params.rec_po2, self.params.rec_ps,
            self.roms[kind])
        _sync(self.device)
        self.seconds["native_eval"] = t1 - t0
        self.seconds["prove"] = time.perf_counter() - t1
        return CoprocRecReceipt(kind=kind, proof=proof, claim=claim,
                                pub_vals=pub_vals, po2=self.params.rec_po2)

    def lift(self, kec_receipt,
             pre_chain: Sequence[int] = claims.ZERO_CHAIN,
             pre_count: int = 0) -> CoprocRecReceipt:
        """Keccak batch receipt -> succinct coproc receipt."""
        t0 = time.perf_counter()
        cid = zco.circuit_id(self.params.kec_po2, self.params.kec_ps,
                             self.device)
        claim = CoprocClaim.of_batch(cid, kec_receipt.states_pub,
                                     kec_receipt.count, pre_chain,
                                     pre_count)
        wit = lift_witness(kec_receipt, self.params.kec_po2,
                           self.params.kec_ps, pre_chain, pre_count)
        witness_s = time.perf_counter() - t0
        r = self._prove("lift_keccak", wit, claim)
        self.seconds["witness"] = witness_s
        return r

    def child_witness(self, child: CoprocRecReceipt) -> List[tuple]:
        """Witness stream for one `verify_child_coproc` call (also the
        coproc child of `succinct.build_resolve_coproc`)."""
        out = programs.serialize_proof(rair.AIR, child.proof,
                                       list(child.pub_vals), child.po2,
                                       self.params.rec_ps)
        idx = COPROC_KINDS.index(child.kind)
        path = claims.allowed_set_path(self.allowed_ids, idx)
        for lvl in range(claims.ALLOWED_DEPTH):
            out += programs._pack4([int(x) for x in path[lvl]])
            out.append(((idx >> lvl) & 1, 0, 0, 0))
        out += programs._pack4(child.claim.to_elems())
        return out

    def union(self, left: CoprocRecReceipt, right: CoprocRecReceipt
              ) -> CoprocRecReceipt:
        t0 = time.perf_counter()
        claim = left.claim.union(right.claim)
        wit = self.child_witness(left) + self.child_witness(right)
        witness_s = time.perf_counter() - t0
        r = self._prove("union", wit, claim)
        self.seconds["witness"] = witness_s
        return r

    def verify(self, r: CoprocRecReceipt) -> bool:
        """One STARK + public-value binding, on the proof's device."""
        if r.kind not in self.control_ids or r.proof is None:
            return False
        if tuple(r.pub_vals) != self._pub_vals(r.claim):
            return False
        dev = r.proof.data_root.device
        root = F.fp(np.asarray(self.control_ids[r.kind], dtype=np.int64),
                    dev)
        return bool(stark.verify(rair.AIR, r.proof,
                                 rair.pub_array(r.pub_vals, dev), r.po2,
                                 root, self.params.rec_ps))


@functools.lru_cache(maxsize=2)
def get_system(params: CoprocParams, device="cuda") -> CoprocSystem:
    return CoprocSystem(params, device)


class DevModeCoprocSystem:
    """Proof-less receipts with identical claim semantics (reference
    RISC0_DEV_MODE)."""

    allowed_root = (0,) * 8

    def lift(self, kec_receipt,
             pre_chain: Sequence[int] = claims.ZERO_CHAIN,
             pre_count: int = 0) -> CoprocRecReceipt:
        claim = CoprocClaim.of_batch((0,) * 8, kec_receipt.states_pub,
                                     kec_receipt.count, pre_chain,
                                     pre_count)
        pub = tuple(list(claim.digest()) + [0] * 16)
        return CoprocRecReceipt(kind="lift_keccak", proof=None,
                                claim=claim, pub_vals=pub, po2=0)

    def union(self, left: CoprocRecReceipt, right: CoprocRecReceipt
              ) -> CoprocRecReceipt:
        claim = left.claim.union(right.claim)
        pub = tuple(list(claim.digest()) + [0] * 16)
        return CoprocRecReceipt(kind="union", proof=None, claim=claim,
                                pub_vals=pub, po2=0)

    def verify(self, r: CoprocRecReceipt) -> bool:
        return r.proof is None  # dev receipts only "verify" in dev mode
