"""Succinct recursion programs: lift / join / resolve as in-circuit claims.

Counterpart of `boundless_tpu/recursion/succinct.py`, with the keccak
coprocessor lattice (`build_resolve_coproc`, `SuccinctSystem(coproc=)`,
`resolve_coproc`; the coproc programs themselves are in
`coproc_succinct.py`). The programs are built over the port's AIRs and
have the reference's ROMs word for word; every recursion proof runs the
port's STARK prover on the device the system was made for (the card
unless the caller asks for the CPU), the data trace coming from the C++
evaluator. `segment_pre_chains` is the port's copy of the cluster's
per-segment chain derivation.

The analogue of risc0's recursion programs (invoked via
`ProverServer::{lift, join, resolve}` at `prover/crates/workflow/src/
tasks/{prove,join,resolve}.rs`; SURVEY.md §2.4 `risc0-circuit-recursion-
sys`): each program is a recursion-VM `Prog` (one RecursionAir circuit)
that *verifies proofs in-circuit* and derives a claim v2 digest
(recursion/claims.py):

  * **lift** — verifies one rv32im segment STARK wire-for-wire
    (programs.StarkVerifier over the rv32im AIR), then derives the
    segment's span claim: image_id = the verified control root, pc /
    regs / seqs / halted read from the segment's public values, and the
    three per-tag io chains folded in-circuit from the public io table
    (with per-tag seq-contiguity enforcement, so chain order is bound).
    Pre-chains are free witness (claims are "IF pre THEN post", like pc).
  * **join** — verifies two child *recursion* proofs (RecursionAir at the
    uniform rec_po2), checks both children's control roots are members of
    the allowed-set Merkle root (own pub groups 2-3), checks the childrens'
    claims (witnessed, hash-checked against their pub digests) chain
    (post == pre for pc/regs/seqs/chains/mem), and emits the joined claim.
  * **resolve** — verifies a conditional child + an assumption child,
    checks the assumption's claim is itself fully resolved, pops the top
    assumption from the conditional's assumptions chain (re-deriving the
    8 digest-word folds from a witnessed 8-back chain value) and checks
    the popped digest equals the assumption child's claim digest.
  * **resolve_coproc** — verifies a conditional child + one receipt of
    the keccak coproc lattice (membership under that lattice's allowed
    root, a constant of the program, which also pins the keccak circuit
    id) and discharges the claim's keccak ecall chain against its span.

Every recursion proof carries PUB_VALS = 24 public scalars:
groups 0-1 claim digest, 2-3 allowed-set root, 4-5 zero. All programs pad
to the same 2^rec_po2 rows so receipts nest uniformly (risc0 fixes its
recursion circuit size the same way). `SuccinctSystem` builds the program
set, derives control IDs + the allowed root, and exposes lift/join/
resolve/verify over `RecReceipt`s.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import time

import numpy as np

from ..air import rv32im
from ..core import field as F
from ..prover import stark
from ..utils import profiling
from ..zkvm import coproc as zco
from ..zkvm import paging
from ..zkvm.prove import _device
from . import air as rair
from . import claims, programs, vm

P = F.P

RV_AIR = rv32im.Rv32imAir()
RV_AIR_I = rv32im.Rv32imAir(False)
RV_AIRS = {"rv32im": RV_AIR, "rv32i": RV_AIR_I}
IO = rv32im.IO_MAX
CP_IO = rv32im.CP_IO
CP_PERMS = rv32im.CP_PERMS
MEM_PAGES = rv32im.MEM_PAGES
PAGE_WORDS = rv32im.PAGE_WORDS
MEM_PAGE_ELEMS = rv32im.MEM_PAGE_ELEMS
PG_DEPTH = paging.DEPTH
# Flat public-element count of an rv32im proof (rv32im.PublicValues fields
# in declaration order: pre_pc, post_pc, pre_regs, post_regs, halted,
# pre_seqs, post_seqs, io, cpio, mem).
RV_PUB_LEN = (2 + 64 + 64 + 1 + 4 + 4 + 5 * IO + 4 * CP_IO
              + MEM_PAGES * MEM_PAGE_ELEMS)
_PRE_REGS0, _POST_REGS0 = 2, 66
_HALTED, _PRE_SEQS0, _POST_SEQS0, _IO0 = 130, 131, 135, 139
_CPIO0 = _IO0 + 5 * IO
_MEM0 = _CPIO0 + 4 * CP_IO

# claim wire indices (claims.py layout)
W_IMG = (0, 1)
W_PC = 2          # [pre_pc, post_pc, halted, 0]
W_PRE_REGS = slice(3, 19)
W_POST_REGS = slice(19, 35)
W_PRE_SEQS = 35
W_POST_SEQS = 36
W_CHAINS = {4: (37, 39), 5: (41, 43), 6: (45, 47),
            8: (53, 55)}  # tag -> (pre0, post0); 8 = coproc chain
W_PRE_MEM, W_POST_MEM = (49, 50), (51, 52)
W_SEGS = 57       # [pre_segments, post_segments, 0, 0]


def rv_pub_flat(pub: dict) -> List[int]:
    """Canonical flat public elements of a segment (tree-leaf order)."""
    out = [int(pub["pre_pc"]), int(pub["post_pc"])]
    out += [int(x) for x in pub["pre_regs"]]
    out += [int(x) for x in pub["post_regs"]]
    out.append(int(pub["halted"]))
    out += [int(x) for x in pub["pre_seqs"]]
    out += [int(x) for x in pub["post_seqs"]]
    out += [int(x) for x in np.asarray(pub["io"], dtype=np.int64).reshape(-1)]
    out += [int(x) for x in
            np.asarray(pub["cpio"], dtype=np.int64).reshape(-1)]
    out += [int(x) for x in np.asarray(pub["mem"], dtype=np.int64).reshape(-1)]
    assert len(out) == RV_PUB_LEN
    return out


# ---------------------------------------------------------------------------
# Wire helpers
# ---------------------------------------------------------------------------


def _pack4(p: vm.Prog, scalars: Sequence[int]) -> int:
    """Pack up to 4 scalar wires into one wire (components 0..3)."""
    assert 1 <= len(scalars) <= 4
    acc = scalars[0]
    for c in range(1, len(scalars)):
        acc = p.add(acc, p._mul_basis(scalars[c], c, 1))
    return acc


def _const4(p: vm.Prog, vals4: Sequence[int]) -> int:
    """A wire holding 4 constant words (a root half pinned by a program)."""
    return p.addc(p.const(0), tuple(int(x) % P for x in vals4))


class _WireRv32Pub:
    """rv32im PublicValues over wires (what the AIR's constraints and the
    lift claim derivation read). Elements are lazily picked from the
    packed pub wires."""

    def __init__(self, p: vm.Prog, sp: programs.ScalarPub):
        self.sp = sp
        self.pre_pc = sp[0]
        self.post_pc = sp[1]
        self.pre_regs = [sp[_PRE_REGS0 + i] for i in range(64)]
        self.post_regs = [sp[_POST_REGS0 + i] for i in range(64)]
        self.halted = sp[_HALTED]
        self.pre_seqs = [sp[_PRE_SEQS0 + i] for i in range(4)]
        self.post_seqs = [sp[_POST_SEQS0 + i] for i in range(4)]
        self.io = [[sp[_IO0 + 5 * r + j] for j in range(5)]
                   for r in range(IO)]
        self.cpio = [[sp[_CPIO0 + 4 * r + j] for j in range(4)]
                     for r in range(CP_IO)]
        self.mem = []
        for e in range(MEM_PAGES):
            base = _MEM0 + e * MEM_PAGE_ELEMS
            self.mem.append(dict(
                page_idx=sp[base], pmask=sp[base + 1],
                words=[tuple(sp[base + 2 + 5 * w + j] for j in range(5))
                       for w in range(PAGE_WORDS)]))


class Rv32imVerifier(programs.StarkVerifier):
    """StarkVerifier over the rv32im AIR with structured public values."""

    def unpack_pub(self, pub_wires):
        self.wire_pub = _WireRv32Pub(self.p, programs.ScalarPub(
            self.p, pub_wires, self.pub_len))
        return self.wire_pub


def _fold_step(p: vm.Prog, chain2, lohi: int) -> Tuple[int, int]:
    """In-circuit claims.chain_step: H(chain(8) || lo, hi)."""
    return p.hash_packed([chain2[0], chain2[1], lohi], 10)


def _select2(p: vm.Prog, b: int, x2, y2):
    return (p.select(b, x2[0], y2[0]), p.select(b, x2[1], y2[1]))


# ---------------------------------------------------------------------------
# lift
# ---------------------------------------------------------------------------


def build_lift(seg_po2: int, seg_ps: stark.ProofSystem,
               variant: str = "rv32im") -> vm.Prog:
    """The lift program: in-circuit rv32im verify + claim v2 derivation.

    Witness order (must mirror lift_witness): the serialized segment
    proof (programs.serialize_proof), then 6 pre-chain wires (tags
    4, 5, 6; 2 packed wires each), then the pre-memory PageTree root
    (2 packed wires) and, per public page entry, PG_DEPTH sibling
    digests (2 packed wires each) for the incremental page walk.

    Public values: groups 0-1 = claim digest; 2-3 = allowed-set root
    (unread here — rides through for uniformity); 4-5 pinned zero.
    """
    tag = "lift" if variant == "rv32im" else "lift_i"
    p = vm.Prog(
        f"{tag}-p{seg_po2}q{seg_ps.queries}e{seg_ps.commit_expand}")
    v = Rv32imVerifier(RV_AIRS[variant], seg_po2, seg_ps,
                       pub_len=RV_PUB_LEN, prog=p, bind_pub_groups=False)
    res = v.build()
    pub = v.wire_pub
    zero = p.const(0)

    # --- per-tag chains: fold the public io table in-circuit ---
    pre_chain = {t: (p.input(), p.input()) for t in claims.CHAIN_TAGS}
    chain = {t: pre_chain[t] for t in claims.CHAIN_TAGS}
    exp_seq = {t: pub.pre_seqs[i]
               for i, t in enumerate(claims.CHAIN_TAGS)}
    for r in range(IO):
        tag, seq, lo, hi, mask = pub.io[r]
        # mask is boolean
        p.assert_zero(p.mul(mask, p.addc(mask, (P - 1, 0, 0, 0))))
        # tag flags: b_t * (tag - t) == 0 and Σ b_t == mask forces the
        # correct one-hot on masked rows (masked tag must be in the set)
        dts, bts = {}, {}
        for t in claims.CHAIN_TAGS:
            dts[t] = p.addc(tag, (P - t, 0, 0, 0))
            bts[t] = p.flag_eqz(dts[t])
            p.assert_zero(p.mul(bts[t], dts[t]))
        prod = p.mul(p.mul(dts[4], dts[5]), dts[6])
        p.assert_zero(p.mul(mask, prod))
        bsum = p.add(p.add(bts[4], bts[5]), bts[6])
        p.assert_eq(bsum, mask)
        # per-tag seq contiguity (binds chain order to seq order)
        for t in claims.CHAIN_TAGS:
            p.assert_zero(p.mul(bts[t], p.sub(seq, exp_seq[t])))
            exp_seq[t] = p.add(exp_seq[t], bts[t])
        # one fold per row: select the active tag's chain, fold, write back
        sel0 = sel1 = zero
        for t in claims.CHAIN_TAGS:
            sel0 = p.add(sel0, p.mul(bts[t], chain[t][0]))
            sel1 = p.add(sel1, p.mul(bts[t], chain[t][1]))
        lohi = p.add(lo, p._mul_basis(hi, 1, 1))
        f = _fold_step(p, (sel0, sel1), lohi)
        for t in claims.CHAIN_TAGS:
            chain[t] = _select2(p, bts[t], f, chain[t])
    for i, t in enumerate(claims.CHAIN_TAGS):
        p.assert_eq(exp_seq[t], pub.post_seqs[i])

    # --- coproc chain: fold the public keccak cpio table in-circuit ---
    # (rv32im variant only — the rv32i AIR has no cpio ports, so a
    # nonzero cpio mask is unprovable there and the chain passes through)
    pre_cp = (p.input(), p.input())
    neg1_ = (P - 1, 0, 0, 0)
    if variant == "rv32im":
        cp_chain = pre_cp
        exp_cp = pub.pre_seqs[3]
        prev_pm = None
        for perm in range(CP_PERMS):
            rows = pub.cpio[100 * perm : 100 * perm + 100]
            m0 = rows[0][3]
            p.assert_zero(p.mul(m0, p.addc(m0, neg1_)))  # boolean
            if prev_pm is not None:  # whole-perm prefix structure
                p.assert_zero(p.mul(m0, p.addc(prev_pm, neg1_)))
            prev_pm = m0
            ins: List[int] = []
            outs: List[int] = []
            for e in range(100):
                seq, lo, hi, mask = rows[e]
                p.assert_eq(mask, m0)  # perms are atomic (burst rows)
                p.assert_zero(p.mul(m0, p.sub(seq, exp_cp)))
                exp_cp = p.add(exp_cp, m0)
                (ins if e % 2 == 0 else outs).extend([lo, hi])
            limbs = ins + outs  # keccak-circuit digest preimage order
            packed = [_pack4(p, limbs[i : i + 4])
                      for i in range(0, 200, 4)]
            dd = p.hash_packed(packed, 200)
            f = p.hash_packed([cp_chain[0], cp_chain[1], dd[0], dd[1]], 16)
            cp_chain = _select2(p, m0, f, cp_chain)
        p.assert_eq(exp_cp, pub.post_seqs[3])
        seqs_pre_w = _pack4(p, pub.pre_seqs)
        seqs_post_w = _pack4(p, pub.post_seqs)
    else:
        # claim cp-seq counter is witness, constant across the segment
        cp_seq_w = p.input()
        cp_chain = pre_cp
        seqs_pre_w = _pack4(p, pub.pre_seqs[:3] + [cp_seq_w])
        seqs_post_w = _pack4(p, pub.post_seqs[:3] + [cp_seq_w])
    # PoVW work counter: post_segments = pre_segments + 1
    pre_segs = p.input()
    segs_w = _pack4(p, [pre_segs, p.addc(pre_segs, (1, 0, 0, 0))])

    # --- RAM continuity: derive post_mem_root in-circuit -------------
    # The segment AIR binds every touched word's first-access (pre) and
    # final (post) value into the public page table (init/final LogUp
    # ports, air/rv32im.py). Here we hash each touched page and walk the
    # sparse memory Merkle tree (zkvm/paging.py shape): verify the pre
    # page against the running root, substitute the post page, chain.
    # pre_mem_root enters as witness ("IF pre THEN post" claim
    # semantics, anchored at genesis); post_mem_root is DERIVED — a
    # forged post root is unsatisfiable, closing the round-2 gap
    # (reference: risc0 claims carry verified MemoryImage roots,
    # prover/crates/workflow/src/tasks/prove.rs:68-95).
    pre_root = (p.input(), p.input())
    cur = pre_root
    neg1 = (P - 1, 0, 0, 0)
    for page in pub.mem:
        pidx, pmask = page["page_idx"], page["pmask"]
        p.assert_zero(p.mul(pmask, p.addc(pmask, neg1)))
        pre_elems: List[int] = []
        post_elems: List[int] = []
        for (wmask, pre_lo, pre_hi, post_lo, post_hi) in page["words"]:
            p.assert_zero(p.mul(wmask, p.addc(wmask, neg1)))
            # a touched word implies a walked page
            p.assert_zero(p.mul(wmask, p.addc(pmask, neg1)))
            # untouched words carry through unchanged
            wm1 = p.addc(wmask, neg1)
            p.assert_zero(p.mul(wm1, p.sub(post_lo, pre_lo)))
            p.assert_zero(p.mul(wm1, p.sub(post_hi, pre_hi)))
            pre_elems += [pre_lo, pre_hi]
            post_elems += [post_lo, post_hi]
        pre_leaf = p.hash_packed(
            [_pack4(p, pre_elems[i : i + 4])
             for i in range(0, len(pre_elems), 4)], 2 * PAGE_WORDS)
        post_leaf = p.hash_packed(
            [_pack4(p, post_elems[i : i + 4])
             for i in range(0, len(post_elems), 4)], 2 * PAGE_WORDS)
        bits = p.decompose(pidx, 0, nbits=PG_DEPTH)
        a, b = pre_leaf, post_leaf
        for lvl in range(PG_DEPTH):
            sib = (p.input(), p.input())
            bl = bits[lvl]
            a = programs.hash_pair(p, _select2(p, bl, sib, a),
                                   _select2(p, bl, a, sib))
            b = programs.hash_pair(p, _select2(p, bl, sib, b),
                                   _select2(p, bl, b, sib))
        p.assert_zero(p.mul(pmask, p.sub(a[0], cur[0])))
        p.assert_zero(p.mul(pmask, p.sub(a[1], cur[1])))
        cur = _select2(p, pmask, b, cur)
    post_root = cur

    # --- assemble the claim wire vector ---
    # image id = the VERIFIED control root (the program's static code
    # table — every segment is proven against the same table now)
    cw: List[int] = [res.ctrl_root[0], res.ctrl_root[1]]
    cw.append(_pack4(p, [pub.pre_pc, pub.post_pc, pub.halted]))
    for i in range(16):
        cw.append(_pack4(p, pub.pre_regs[4 * i : 4 * i + 4]))
    for i in range(16):
        cw.append(_pack4(p, pub.post_regs[4 * i : 4 * i + 4]))
    cw.append(seqs_pre_w)
    cw.append(seqs_post_w)
    for t in claims.CHAIN_TAGS:
        cw += [pre_chain[t][0], pre_chain[t][1], chain[t][0], chain[t][1]]
    # mem roots: pre witnessed (anchored at genesis), post DERIVED
    cw += [pre_root[0], pre_root[1], post_root[0], post_root[1]]
    # coproc chain (pre witnessed, post derived from pub.cpio) + segments
    cw += [pre_cp[0], pre_cp[1], cp_chain[0], cp_chain[1]]
    cw.append(segs_w)
    assert len(cw) == claims.CLAIM_WIRES

    d0, d1 = p.hash_packed(cw, claims.CLAIM_ELEMS)
    p.assert_eq(d0, p.pub(0))
    p.assert_eq(d1, p.pub(1))
    p.assert_zero(p.pub(4))
    p.assert_zero(p.pub(5))
    return p


def paging_walk(seg_pub: dict, pre_mem: dict):
    """Host-side mirror of the lift page walk.

    pre_mem: byte-addr -> u32 word store at segment entry (Segment.pre_mem).
    Returns (pre_root, post_root, sib_paths): the claim's memory roots
    and, per public page entry, the PG_DEPTH sibling digests extracted
    incrementally (page e's path reflects updates of pages < e), exactly
    the order the circuit consumes.
    """
    tree = paging.PageTree.from_words(
        {a >> 2: int(v) for a, v in pre_mem.items()})
    pre_root = tree.root()
    mem_pub = np.asarray(seg_pub["mem"], dtype=np.int64)
    sib_paths = []
    for e in range(MEM_PAGES):
        pidx, pmask = int(mem_pub[e, 0]), int(mem_pub[e, 1])
        if pmask:
            path = tree.path(pidx)
            words = []
            for w in range(PAGE_WORDS):
                base = 2 + 5 * w
                words.append(int(mem_pub[e, base + 3])
                             | (int(mem_pub[e, base + 4]) << 16))
            tree.set_page(pidx, words)
        else:
            path = [(0,) * 8] * PG_DEPTH
        sib_paths.append(path)
    return pre_root, tree.root(), sib_paths


def lift_witness(seg_pub: dict, proof, seg_po2: int,
                 seg_ps: stark.ProofSystem,
                 pre_chains: Optional[dict] = None,
                 pre_mem: Optional[dict] = None,
                 variant: str = "rv32im",
                 seg_index: int = 0) -> List[tuple]:
    """Witness stream for the lift program."""
    if pre_chains is None:
        pre_chains = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
    out = programs.serialize_proof(RV_AIRS[variant], proof,
                                   rv_pub_flat(seg_pub), seg_po2, seg_ps)
    for t in claims.CHAIN_TAGS:
        out += programs._pack4([int(x) for x in pre_chains[t]])
    pre_cp = pre_chains.get(claims.COPROC_TAG, claims.ZERO_CHAIN)
    out += programs._pack4([int(x) for x in pre_cp])
    if variant != "rv32im":
        # claim cp-seq counter (constant across an rv32i segment)
        out.append((int(seg_pub["pre_seqs"][3])
                    if len(seg_pub["pre_seqs"]) > 3 else 0, 0, 0, 0))
    out.append((int(seg_index), 0, 0, 0))
    pre_root, _post_root, sib_paths = paging_walk(seg_pub, pre_mem or {})
    out += programs._pack4([int(x) for x in pre_root])
    for path in sib_paths:
        for lvl in range(PG_DEPTH):
            out += programs._pack4([int(x) for x in path[lvl]])
    return out


# ---------------------------------------------------------------------------
# join / resolve (children are RecursionAir proofs at the uniform po2)
# ---------------------------------------------------------------------------


def _verify_child(p: vm.Prog, rec_po2: int, rec_ps: stark.ProofSystem):
    """In-circuit verification of one recursion proof; returns
    (pub_wires (6 packed), ctrl_root (2), claim wires (53))."""
    v = programs.StarkVerifier(rair.AIR, rec_po2, rec_ps,
                               pub_len=vm.PUB_VALS, prog=p,
                               bind_pub_groups=False)
    res = v.build()
    pub_w = res.pub_wires  # 6 packed wires == the 6 pub groups
    # the child's allowed-set root must equal ours; spare groups zero
    p.assert_eq(pub_w[2], p.pub(2))
    p.assert_eq(pub_w[3], p.pub(3))
    p.assert_zero(pub_w[4])
    p.assert_zero(pub_w[5])
    # control-root membership in the allowed set
    cur = res.ctrl_root
    for _ in range(claims.ALLOWED_DEPTH):
        sib = (p.input(), p.input())
        b = p.input_bit()
        left = _select2(p, b, sib, cur)
        right = _select2(p, b, cur, sib)
        cur = programs.hash_pair(p, left, right)
    p.assert_eq(cur[0], p.pub(2))
    p.assert_eq(cur[1], p.pub(3))
    # the child's claim, witnessed and bound to its digest
    cwires = [p.input() for _ in range(claims.CLAIM_WIRES)]
    d0, d1 = p.hash_packed(cwires, claims.CLAIM_ELEMS)
    p.assert_eq(d0, pub_w[0])
    p.assert_eq(d1, pub_w[1])
    return pub_w, res.ctrl_root, cwires


def _child_witness(child: "RecReceipt", leaf_index: int,
                   allowed_ids: List[tuple],
                   rec_ps: stark.ProofSystem) -> List[tuple]:
    """Witness stream for one _verify_child call."""
    out = programs.serialize_proof(rair.AIR, child.proof,
                                   list(child.pub_vals), child.po2, rec_ps)
    path = claims.allowed_set_path(allowed_ids, leaf_index)
    idx = leaf_index
    for lvl in range(claims.ALLOWED_DEPTH):
        out += programs._pack4([int(x) for x in path[lvl]])
        out.append(((idx >> lvl) & 1, 0, 0, 0))
    elems = child.claim.to_elems()
    out += programs._pack4(elems)
    return out


def _own_pub_pins(p: vm.Prog, claim_wires: List[int]):
    """Pin own pub groups 0-1 to the claim digest and 4-5 to zero."""
    d0, d1 = p.hash_packed(claim_wires, claims.CLAIM_ELEMS)
    p.assert_eq(d0, p.pub(0))
    p.assert_eq(d1, p.pub(1))
    p.assert_zero(p.pub(4))
    p.assert_zero(p.pub(5))


def build_join(rec_po2: int, rec_ps: stark.ProofSystem) -> vm.Prog:
    """The join program: two child recursion proofs + claim chaining.

    Witness order: child L (_child_witness), child R, nothing else.
    """
    p = vm.Prog(f"join-p{rec_po2}q{rec_ps.queries}e{rec_ps.commit_expand}")
    _, _, L = _verify_child(p, rec_po2, rec_ps)
    _, _, R = _verify_child(p, rec_po2, rec_ps)

    # continuity
    p.assert_eq(L[W_IMG[0]], R[W_IMG[0]])
    p.assert_eq(L[W_IMG[1]], R[W_IMG[1]])
    p.assert_zero(p.pick(L[W_PC], 2))  # left not halted
    p.assert_eq(p.pick(L[W_PC], 1), p.pick(R[W_PC], 0))  # post_pc == pre_pc
    for i in range(16):
        p.assert_eq(L[W_POST_REGS][i], R[W_PRE_REGS][i])
    p.assert_eq(L[W_POST_SEQS], R[W_PRE_SEQS])
    for t in W_CHAINS:
        pre0, post0 = W_CHAINS[t]
        p.assert_eq(L[post0], R[pre0])
        p.assert_eq(L[post0 + 1], R[pre0 + 1])
    p.assert_eq(L[W_POST_MEM[0]], R[W_PRE_MEM[0]])
    p.assert_eq(L[W_POST_MEM[1]], R[W_PRE_MEM[1]])
    # segments counter: L.post == R.pre
    p.assert_eq(p.pick(L[W_SEGS], 1), p.pick(R[W_SEGS], 0))

    # joined claim
    J = list(L)
    J[W_PC] = _pack4(p, [p.pick(L[W_PC], 0), p.pick(R[W_PC], 1),
                         p.pick(R[W_PC], 2)])
    J[W_POST_REGS] = R[W_POST_REGS]
    J[W_POST_SEQS] = R[W_POST_SEQS]
    for t in W_CHAINS:
        _, post0 = W_CHAINS[t]
        J[post0], J[post0 + 1] = R[post0], R[post0 + 1]
    J[W_POST_MEM[0]], J[W_POST_MEM[1]] = R[W_POST_MEM[0]], R[W_POST_MEM[1]]
    J[W_SEGS] = _pack4(p, [p.pick(L[W_SEGS], 0), p.pick(R[W_SEGS], 1)])
    _own_pub_pins(p, J)
    return p


def build_resolve(rec_po2: int, rec_ps: stark.ProofSystem) -> vm.Prog:
    """The resolve program: pop one assumption from a conditional claim.

    Witness order: conditional child (_child_witness), assumption child,
    then 2 packed wires = the 8-back assumptions-chain value.
    """
    p = vm.Prog(f"resolve-p{rec_po2}q{rec_ps.queries}e{rec_ps.commit_expand}")
    _, _, C = _verify_child(p, rec_po2, rec_ps)
    apub, _, A = _verify_child(p, rec_po2, rec_ps)

    # the assumption receipt must itself be fully resolved
    pre0, post0 = W_CHAINS[6]
    p.assert_eq(A[post0], A[pre0])
    p.assert_eq(A[post0 + 1], A[pre0 + 1])

    # pop: re-derive the top 8 folds (the assumption's claim digest words)
    prev = (p.input(), p.input())
    # digest words = components of the assumption child's pub groups 0-1;
    # split each into 16-bit limbs (decompose gives canonical 31 bits)
    h = prev
    for w in range(8):
        src = apub[0] if w < 4 else apub[1]
        bits = p.decompose(src, w % 4, nbits=31)
        lo = None
        hi = None
        for i, b in enumerate(bits):
            t = p.gen(b, ca=pow(2, i if i < 16 else i - 16, P))
            if i < 16:
                lo = t if lo is None else p.add(lo, t)
            else:
                hi = t if hi is None else p.add(hi, t)
        lohi = p.add(lo, p._mul_basis(hi, 1, 1))
        h = _fold_step(p, h, lohi)
    cpre0, cpost0 = W_CHAINS[6]
    p.assert_eq(h[0], C[cpost0])
    p.assert_eq(h[1], C[cpost0 + 1])

    # resolved claim: conditional with the popped chain
    Rv = list(C)
    Rv[cpost0], Rv[cpost0 + 1] = prev[0], prev[1]
    _own_pub_pins(p, Rv)
    return p


def build_resolve_coproc(rec_po2: int, rec_ps: stark.ProofSystem,
                         coproc_root, coproc_rec_po2: int,
                         coproc_rec_ps: stark.ProofSystem,
                         kec_circuit_id) -> vm.Prog:
    """Discharge a claim's keccak ecall chain against a proven coproc
    span — the in-circuit form of the reference's resolve-side union
    check (`prover/crates/workflow/src/tasks/resolve.rs:85-100`).

    Verifies the conditional child (own lattice) plus one coproc-lattice
    receipt (lift_keccak/union at the coproc po2/ps, membership under
    the coproc allowed root — a CONSTANT of this program, which also
    pins the keccak circuit id), then enforces:
      union.pre_chain  == claim.pre_coproc
      union.post_chain == claim.post_coproc
      100 * (union.post_count - union.pre_count) == cpio entry span
    and emits the claim with post_coproc reset to pre_coproc (the
    obligation is proven; finalize requires post == ZERO at genesis).

    Witness order: conditional child (_child_witness), then the coproc
    child (serialized proof + coproc allowed path + CoprocClaim wires).
    """
    from . import coproc_succinct as _cs

    p = vm.Prog(f"resolve_coproc-p{rec_po2}q{rec_ps.queries}"
                f"e{rec_ps.commit_expand}")
    _, _, C = _verify_child(p, rec_po2, rec_ps)
    U = _cs.verify_child_coproc(p, coproc_rec_po2, coproc_rec_ps,
                                coproc_root)

    cid = [_const4(p, kec_circuit_id[0:4]), _const4(p, kec_circuit_id[4:8])]
    p.assert_eq(U[0], cid[0])
    p.assert_eq(U[1], cid[1])
    pre0, post0 = W_CHAINS[8]
    p.assert_eq(U[2], C[pre0])
    p.assert_eq(U[3], C[pre0 + 1])
    p.assert_eq(U[4], C[post0])
    p.assert_eq(U[5], C[post0 + 1])
    perms = p.sub(p.pick(U[6], 1), p.pick(U[6], 0))
    span = p.sub(p.pick(C[W_POST_SEQS], 3), p.pick(C[W_PRE_SEQS], 3))
    p.assert_eq(p.mul(perms, p.const(100)), span)

    Rv = list(C)
    Rv[post0], Rv[post0 + 1] = C[pre0], C[pre0 + 1]
    _own_pub_pins(p, Rv)
    return p


# ---------------------------------------------------------------------------
# The system: programs, control IDs, receipts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuccinctParams:
    seg_po2: int
    seg_ps: stark.ProofSystem
    rec_po2: int  # uniform recursion proof size (must fit every program)
    rec_ps: stark.ProofSystem
    # lift variants in the allowed set. A deployment pins the program
    # set it serves; rv32i-only lattices exist because the full-layout
    # lift at 100 queries/rate-1/2 is ~1.18M wire rows (past 2^20) —
    # the rv32im lift at that soundness needs rec_po2 21 or the rate-1/4
    # sizing (docs/ROUND5.md).
    variants: tuple = ("rv32im", "rv32i")


@dataclasses.dataclass
class RecReceipt:
    """A constant-size recursion receipt: one RecursionAir STARK whose
    public values bind (claim digest, allowed root, 0)."""

    kind: str  # lift/lift_i/join/resolve/resolve_coproc
    proof: stark.SegmentProof
    claim: claims.Claim
    pub_vals: tuple  # 24 canonical scalars
    po2: int

    def claim_digest(self) -> tuple:
        return self.claim.digest()


class SuccinctError(Exception):
    pass


PROGRAM_KINDS = ("lift", "lift_i", "join", "resolve")


class SuccinctSystem:
    """Builds and runs the recursion program set for one parameterization,
    on `device` (the card unless the caller asks for the CPU): the ROMs,
    the control IDs and every proof live there.

    One RecursionAir prover serves every program: only the ROM (the ctrl
    trace, a prover argument) differs. `seconds` holds the host clock of
    the set-up stages (`program_build`, `control_ids`). Each proof runs
    under the tracer's span `rec.<kind>` (`utils/profiling.py`) with
    children `rec.witness`, `rec.native_eval` and `rec.prove`.

    `coproc`: optional `coproc_succinct.CoprocParams` — when given, the
    keccak coproc lattice is built (`coproc_sys`, on the same device) and
    a fifth program (resolve_coproc) joins the allowed set, discharging
    claim coproc chains against proven union spans IN-CIRCUIT.
    """

    def __init__(self, params: SuccinctParams, coproc=None, device="cuda"):
        self.params = params
        self.device = _device(device)
        self.seconds: Dict[str, float] = {}
        self.coproc_sys = None
        if coproc is not None:
            from .coproc_succinct import get_system as cs_get

            self.coproc_sys = cs_get(coproc, self.device)
        n = 1 << params.rec_po2
        t0 = time.perf_counter()
        self.progs: Dict[str, vm.Prog] = {}
        if "rv32im" in params.variants:
            self.progs["lift"] = build_lift(params.seg_po2, params.seg_ps,
                                            "rv32im")
        if "rv32i" in params.variants:
            self.progs["lift_i"] = build_lift(params.seg_po2,
                                              params.seg_ps, "rv32i")
        self.progs["join"] = build_join(params.rec_po2, params.rec_ps)
        self.progs["resolve"] = build_resolve(params.rec_po2,
                                              params.rec_ps)
        self.kinds = [k for k in PROGRAM_KINDS if k in self.progs]
        if coproc is not None:
            self.progs["resolve_coproc"] = build_resolve_coproc(
                params.rec_po2, params.rec_ps, self.coproc_sys.allowed_root,
                coproc.rec_po2, coproc.rec_ps,
                zco.circuit_id(coproc.kec_po2, coproc.kec_ps, self.device))
            self.kinds.append("resolve_coproc")
        for name, prog in self.progs.items():
            if len(prog.rows) >= n:
                raise SuccinctError(
                    f"{name} program has {len(prog.rows)} rows; "
                    f"rec_po2={params.rec_po2} too small")
            prog.finalize(n)
        self.roms = {k: rair.rom_trace(pr, n, self.device)
                     for k, pr in self.progs.items()}
        self.seconds["program_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.control_ids = {
            k: tuple(int(x) for x in F.from_mont(stark.control_root_of(
                rair.AIR, params.rec_po2, self.roms[k], params.rec_ps)))
            for k in self.kinds}
        self.seconds["control_ids"] = time.perf_counter() - t0
        self.allowed_ids = [self.control_ids[k] for k in self.kinds]
        self.allowed_root = claims.allowed_set_root(self.allowed_ids)

    # -- proving ------------------------------------------------------------

    def _pub_vals(self, claim: claims.Claim) -> tuple:
        return tuple(list(claim.digest()) + list(self.allowed_root)
                     + [0] * 8)

    def _span(self, name: str):
        return profiling.span(name, sync=True, device=self.device)

    def _prove(self, kind: str, inputs, claim: claims.Claim) -> RecReceipt:
        pub_vals = self._pub_vals(claim)
        with self._span("rec.native_eval"):
            data = rair.data_trace(self.progs[kind], inputs, pub_vals,
                                   self.device)
        with self._span("rec.prove"):
            proof = stark.prove(rair.AIR, data, rair.pub_array(
                pub_vals, self.device), self.params.rec_po2,
                self.params.rec_ps, self.roms[kind])
        return RecReceipt(kind=kind, proof=proof, claim=claim,
                          pub_vals=pub_vals, po2=self.params.rec_po2)

    def lift(self, seg_receipt, pre_chains: Optional[dict] = None,
             pre_mem: Optional[dict] = None,
             seg_index: int = 0) -> RecReceipt:
        """Segment receipt -> recursion receipt (reference prove.rs:95).

        RAM continuity: `pre_mem` is the segment's entry word store
        (Segment.pre_mem; byte-addr keyed). The claim's pre_mem_root is
        its PageTree root (witnessed in-circuit, anchored at genesis);
        post_mem_root is DERIVED in-circuit from the proof-bound public
        page words — the lift is unsatisfiable for any other root.
        `seg_index`: segments proven before this one (PoVW counter).
        """
        if pre_chains is None:
            pre_chains = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
        with self._span("rec.lift"):
            with profiling.span("rec.witness"):
                pre_root, post_root, _ = paging_walk(seg_receipt.pub,
                                                     pre_mem or {})
                claim = claims.Claim.of_segment(
                    seg_receipt.image_id, seg_receipt.pub, pre_chains,
                    pre_mem_root=pre_root, post_mem_root=post_root,
                    seg_index=seg_index)
                variant = seg_receipt.variant
                wit = lift_witness(seg_receipt.pub, seg_receipt.proof,
                                   self.params.seg_po2, self.params.seg_ps,
                                   pre_chains, pre_mem or {}, variant,
                                   seg_index)
            return self._prove("lift" if variant == "rv32im" else "lift_i",
                               wit, claim)

    def _kind_index(self, kind: str) -> int:
        return self.kinds.index(kind)

    def join(self, left: RecReceipt, right: RecReceipt) -> RecReceipt:
        """Pairwise join (reference join.rs:53)."""
        with self._span("rec.join"):
            with profiling.span("rec.witness"):
                claim = left.claim.join(right.claim)
                wit = (_child_witness(left, self._kind_index(left.kind),
                                      self.allowed_ids, self.params.rec_ps)
                       + _child_witness(right, self._kind_index(right.kind),
                                        self.allowed_ids,
                                        self.params.rec_ps))
            return self._prove("join", wit, claim)

    def resolve(self, conditional: RecReceipt, assumption: RecReceipt,
                prev_chain: Sequence[int]) -> RecReceipt:
        """Pop the top assumption (reference resolve.rs:85). `prev_chain`
        is the conditional claim's assumptions chain *before* the
        discharged digest was folded (host-tracked; see
        claims.assumption_chain_prefixes)."""
        with self._span("rec.resolve"):
            with profiling.span("rec.witness"):
                claim = conditional.claim.resolve(assumption.claim.digest(),
                                                  prev_chain)
                wit = (_child_witness(conditional,
                                      self._kind_index(conditional.kind),
                                      self.allowed_ids, self.params.rec_ps)
                       + _child_witness(assumption,
                                        self._kind_index(assumption.kind),
                                        self.allowed_ids,
                                        self.params.rec_ps))
                wit += programs._pack4([int(x) for x in prev_chain])
            return self._prove("resolve", wit, claim)

    def resolve_coproc(self, conditional: RecReceipt,
                       union_receipt) -> RecReceipt:
        """Discharge the claim's keccak ecall chain against a proven
        coproc-lattice span (reference resolve.rs union handling).
        `union_receipt` is a `coproc_succinct.CoprocRecReceipt` (a
        lift_keccak or union receipt)."""
        if self.coproc_sys is None:
            raise SuccinctError("system built without coproc params")
        with self._span("rec.resolve_coproc"):
            with profiling.span("rec.witness"):
                claim = conditional.claim.discharge_coproc(
                    union_receipt.claim)
                wit = _child_witness(conditional,
                                     self._kind_index(conditional.kind),
                                     self.allowed_ids, self.params.rec_ps)
                wit += self.coproc_sys.child_witness(union_receipt)
            return self._prove("resolve_coproc", wit, claim)

    # -- verification ---------------------------------------------------

    def verify(self, r: RecReceipt) -> bool:
        """Constant-work verification: one STARK + public-value binding,
        on the device the proof lives on."""
        if r.kind not in self.control_ids:
            return False
        expected = self._pub_vals(r.claim)
        if tuple(r.pub_vals) != expected:
            return False
        dev = r.proof.data_root.device
        root = F.fp(np.asarray(self.control_ids[r.kind], dtype=np.int64),
                    dev)
        ok = stark.verify(rair.AIR, r.proof, rair.pub_array(r.pub_vals, dev),
                          r.po2, root, self.params.rec_ps)
        return bool(ok)


@functools.lru_cache(maxsize=4)
def get_system(params: SuccinctParams, coproc=None,
               device="cuda") -> SuccinctSystem:
    return SuccinctSystem(params, coproc, device)


class DevModeSystem:
    """Fake-receipt recursion system (reference `RISC0_DEV_MODE=true`,
    SURVEY.md §4): claims are derived and chained exactly as the real
    SuccinctSystem — same digests, same pop/fold semantics — but receipts
    carry no proof and `verify` checks only the claim/public binding.
    Instant and NOT sound; exists so the pipeline around the prover can
    run without proving."""

    DEV_ROOT = tuple(range(101, 109))  # sentinel allowed root

    def __init__(self):
        self.allowed_root = self.DEV_ROOT

    def _pub_vals(self, claim: claims.Claim) -> tuple:
        return tuple(list(claim.digest()) + list(self.allowed_root)
                     + [0] * 8)

    def _receipt(self, kind: str, claim: claims.Claim) -> RecReceipt:
        return RecReceipt(kind=kind, proof=None, claim=claim,
                          pub_vals=self._pub_vals(claim), po2=0)

    def lift(self, seg_receipt, pre_chains: Optional[dict] = None,
             pre_mem: Optional[dict] = None,
             seg_index: int = 0) -> RecReceipt:
        if pre_chains is None:
            pre_chains = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
        pre_root, post_root, _ = paging_walk(seg_receipt.pub, pre_mem or {})
        claim = claims.Claim.of_segment(
            seg_receipt.image_id, seg_receipt.pub, pre_chains,
            pre_mem_root=pre_root, post_mem_root=post_root,
            seg_index=seg_index)
        return self._receipt("lift", claim)

    def join(self, left: RecReceipt, right: RecReceipt) -> RecReceipt:
        return self._receipt("join", left.claim.join(right.claim))

    def resolve(self, conditional: RecReceipt, assumption: RecReceipt,
                prev_chain: Sequence[int]) -> RecReceipt:
        a = assumption.claim
        if a.post_assumptions != a.pre_assumptions:
            raise SuccinctError("assumption receipt itself unresolved")
        return self._receipt("resolve", conditional.claim.resolve(
            assumption.claim.digest(), prev_chain))

    def resolve_coproc(self, conditional: RecReceipt,
                       union_receipt) -> RecReceipt:
        return self._receipt("resolve_coproc",
                             conditional.claim.discharge_coproc(
                                 union_receipt.claim))

    def verify(self, r: RecReceipt) -> bool:
        return (r.proof is None
                and tuple(r.pub_vals) == self._pub_vals(r.claim))


def segment_pre_chains(ex, result) -> Dict[int, Dict[int, tuple]]:
    """Per-segment pre-chains {segment index: {tag: 8-tuple}}: prefix
    folds of the session's journal / input / verify word streams at each
    segment's pre_seqs counters, plus the keccak coproc chain (tag 8:
    per-permutation digest folds at the segment's cpio counter).

    The port's copy of `boundless_tpu/cluster/agent.py`
    `_segment_pre_chains` (the cluster is not ported); it returns the
    decoded form (int tags, tuples) in place of the JSON-safe task
    encoding. `ex` is the executor after `run()`, `result` its result."""
    streams = {4: [int(w) for w in ex.journal_words],
               5: [int(w) for w in ex.input_words],
               6: [int(w) for w in ex.verify_words]}
    seq_key = {4: "commit", 5: "read", 6: "verify"}
    perm_digests = [claims.digest_from_bytes(d) for d in ex.keccak_claims]
    out = {}
    chain = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
    cp_chain = claims.ZERO_CHAIN
    pos = {t: 0 for t in claims.CHAIN_TAGS}
    cp_pos = 0
    for seg in result.segments:
        for t in claims.CHAIN_TAGS:
            upto = int(seg.pre_seqs[seq_key[t]])
            if upto > pos[t]:
                chain[t] = claims.fold_words(
                    chain[t], streams[t][pos[t]: upto])
                pos[t] = upto
        upto_p = int(seg.pre_seqs.get("cpio", 0)) // 100
        while cp_pos < upto_p:
            cp_chain = claims.coproc_fold_step(cp_chain,
                                               perm_digests[cp_pos])
            cp_pos += 1
        out[seg.index] = {**{t: tuple(chain[t]) for t in claims.CHAIN_TAGS},
                          claims.COPROC_TAG: tuple(cp_chain)}
    return out


# ---------------------------------------------------------------------------
# Session receipt (constant-size finalize; reference finalize.rs:56)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SuccinctSessionReceipt:
    """Constant-size session receipt: one recursion STARK + the journal.

    The journal bytes are bound to the root claim by refolding their
    words into the journal chain (claims.fold_words) and comparing with
    `claim.post_journal`; genesis/halt conditions pin the span to a full
    session. Mirrors the reference's `Receipt::new(InnerReceipt::
    Succinct(root), journal)` + `verify(image_id)` at
    `prover/crates/workflow/src/tasks/finalize.rs:56-69`.
    """

    root: RecReceipt
    journal: bytes
    image_id: tuple
    entry_pc: int
    # PageTree root of the program's initial memory (genesis anchor for
    # the RAM-continuity chain; paging.image_root)
    image_mem_root: tuple = None

    def journal_words(self) -> List[int]:
        assert len(self.journal) % 4 == 0
        return [int.from_bytes(self.journal[i : i + 4], "little")
                for i in range(0, len(self.journal), 4)]


def finalize_session(root: RecReceipt, journal_words: Sequence[int],
                     entry_pc: int,
                     image_mem_root=None) -> SuccinctSessionReceipt:
    """Root recursion receipt -> session receipt.

    `journal_words`: the guest's committed 32-bit words (the executor's
    journal output); checked against the claim's journal chain here and
    again at verify time. `image_mem_root`: the program image's initial
    PageTree root (paging.image_root) — when supplied, genesis requires
    claim.pre_mem_root to equal it, anchoring RAM continuity.
    """
    c = root.claim
    if not c.halted:
        raise SuccinctError("finalize: session did not halt")
    if not c.is_genesis(entry_pc, image_mem_root):
        raise SuccinctError("finalize: span does not start at genesis")
    if c.post_assumptions != claims.ZERO_CHAIN:
        raise SuccinctError("finalize: unresolved assumptions")
    if tuple(c.post_coproc) != claims.ZERO_CHAIN:
        raise SuccinctError("finalize: undischarged keccak coproc chain "
                            "(resolve_coproc must run first)")
    words = [int(w) for w in journal_words]
    if claims.fold_words(claims.ZERO_CHAIN, words) != c.post_journal:
        raise SuccinctError("finalize: journal does not match claim chain")
    journal = b"".join(w.to_bytes(4, "little") for w in words)
    return SuccinctSessionReceipt(
        root=root, journal=journal, image_id=c.image_id, entry_pc=entry_pc,
        image_mem_root=(tuple(int(x) for x in image_mem_root)
                        if image_mem_root is not None else None))


def verify_session(s: SuccinctSessionReceipt, system: SuccinctSystem,
                   expected_image_id=None, expected_mem_root=None) -> bool:
    """Constant-work session verification: one recursion STARK + claim
    genesis/halt/journal binding.

    `expected_mem_root`: the program image's initial PageTree root; when
    supplied, the genesis anchor pre_mem_root must equal it (callers
    derive it from the image via paging.image_root)."""
    c = s.root.claim
    if expected_image_id is not None and tuple(
            int(x) for x in expected_image_id) != c.image_id:
        return False
    if c.image_id != tuple(int(x) for x in s.image_id):
        return False
    anchor = (expected_mem_root if expected_mem_root is not None
              else s.image_mem_root)
    if not c.halted or not c.is_genesis(s.entry_pc, anchor):
        return False
    if c.post_assumptions != claims.ZERO_CHAIN:
        return False
    if tuple(c.post_coproc) != claims.ZERO_CHAIN:
        return False
    if len(s.journal) % 4:
        return False
    if claims.fold_words(claims.ZERO_CHAIN, s.journal_words()) \
            != c.post_journal:
        return False
    return system.verify(s.root)
