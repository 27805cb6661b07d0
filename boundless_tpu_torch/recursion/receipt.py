"""Recursion layer: lift / join / union / resolve over segment receipts.

Counterpart of `boundless_tpu/recursion/receipt.py`, copied over the
port's `zkvm.prove`: the v1 aggregation receipts, which the Groth16 wrap
takes on its dev-mode branch (`groth16/wrap.py`). Segment proofs verify
on the device they live on.

Mirrors the reference's recursion pipeline shape (`prover/crates/workflow/
src/tasks/{prove,join,union,resolve,finalize}.rs`, SURVEY.md §3.1): segment
STARKs are lifted, pairwise joined along the planner's MMR tree, coprocessor
claims unioned, and assumptions resolved to produce one session receipt.

v1 semantics (honest scope note): lift/join produce **aggregation
receipts** — claim chaining (state/seq/image continuity) is checked
eagerly at join time, and the joined receipt carries its children, so the
root receipt verifies by checking every embedded segment STARK plus the
claim chain. This is sound but not succinct: the constant-size recursion
circuit (an in-AIR STARK verifier, risc0's lift/join programs) is the
planned round-2 milestone; the task/cluster topology is already identical,
so it slots in behind this API without changes. Cross-segment RAM
continuity: claims carry pre/post PageTree roots (zkvm/paging.py);
verify replays the public page words across the span, and the session
layer replays the whole chain from the program image when given it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Optional

import numpy as np

from ..air.rv32im import TAG, IO_MAX
from ..prover import stark
from ..zkvm.prove import SegmentReceipt, verify_segment


class RecursionError(Exception):
    pass


@dataclasses.dataclass
class SpanClaim:
    """Claim for a contiguous span of execution (1..k segments)."""

    image_id: tuple  # 8 canonical u32 words (the PROGRAM identity)
    pre_pc: int
    post_pc: int
    pre_regs: tuple  # 64 limbs
    post_regs: tuple
    pre_seqs: tuple  # (commit, read, verify)
    post_seqs: tuple
    halted: int
    io: tuple  # ((tag, seq, lo, hi), ...) across the span
    # RAM continuity: sparse PageTree roots (zkvm/paging.py) of the
    # span's first/last memory; genesis anchors pre to the image's root
    pre_mem_root: tuple = ()
    post_mem_root: tuple = ()

    @staticmethod
    def of_segment(r: SegmentReceipt, pre_mem_root=(),
                   post_mem_root=()) -> "SpanClaim":
        """pre/post_mem_root: the segment's PageTree roots (derived from
        pre_mem + the proof-bound public page words; succinct.paging_walk).
        """
        p = r.pub
        io = tuple(tuple(int(x) for x in row[:4])
                   for row in p["io"] if int(row[4]))
        return SpanClaim(
            image_id=tuple(int(x) for x in r.image_id),
            pre_pc=int(p["pre_pc"]), post_pc=int(p["post_pc"]),
            pre_regs=tuple(int(x) for x in p["pre_regs"]),
            post_regs=tuple(int(x) for x in p["post_regs"]),
            pre_seqs=tuple(int(x) for x in p["pre_seqs"]),
            post_seqs=tuple(int(x) for x in p["post_seqs"]),
            halted=int(p["halted"]), io=io,
            pre_mem_root=tuple(int(x) for x in pre_mem_root),
            post_mem_root=tuple(int(x) for x in post_mem_root))

    def digest(self) -> bytes:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(b"boundless-tpu.claim.v1:" + blob.encode()).digest()

    def validate_io(self):
        """Range-check public io rows: limbs must be 16-bit (the in-circuit
        register-file range invariant leans on reads being well-formed)."""
        for tag, seq, lo, hi in self.io:
            if not (0 <= lo < (1 << 16) and 0 <= hi < (1 << 16)):
                raise RecursionError("io word limb out of range")
            if seq < 0:
                raise RecursionError("negative io sequence")

    def journal_words(self) -> List[int]:
        self.validate_io()
        rows = sorted((r for r in self.io if r[0] == TAG["commit"]),
                      key=lambda r: r[1])
        for i, r in enumerate(rows):
            if r[1] != i:
                raise RecursionError("non-contiguous journal sequence")
        return [r[2] | (r[3] << 16) for r in rows]

    def assumption_digests(self) -> List[bytes]:
        rows = sorted((r for r in self.io if r[0] == TAG["verify"]),
                      key=lambda r: r[1])
        words = [r[2] | (r[3] << 16) for r in rows]
        if len(words) % 8:
            raise RecursionError("assumption words not a multiple of 8")
        return [b"".join(w.to_bytes(4, "little") for w in words[i : i + 8])
                for i in range(0, len(words), 8)]


@dataclasses.dataclass
class SuccinctReceipt:
    """Receipt for a span claim (kind: lift/join/resolve/union)."""

    kind: str
    claim: SpanClaim
    segments: List[SegmentReceipt]  # v1: carried; round-2: folded away
    assumptions_resolved: bool = False
    resolved_with: Optional[list] = None  # nested SuccinctReceipts

    def claim_digest(self) -> bytes:
        return self.claim.digest()


def lift(seg_receipt: SegmentReceipt, ps: stark.ProofSystem = None,
         pre_mem: dict = None) -> SuccinctReceipt:
    """Segment STARK -> recursion-layer receipt (reference prove.rs:95).

    `pre_mem`: the segment's entry word store (Segment.pre_mem); the
    claim's memory roots are its PageTree root and the root after the
    segment's public page updates (succinct.paging_walk)."""
    from .succinct import paging_walk

    kwargs = {} if ps is None else {"ps": ps}
    if not verify_segment(seg_receipt, **kwargs):
        raise RecursionError("segment receipt failed verification at lift")
    pre_root, post_root, _ = paging_walk(seg_receipt.pub, pre_mem or {})
    return SuccinctReceipt(
        kind="lift",
        claim=SpanClaim.of_segment(seg_receipt, pre_root, post_root),
        segments=[seg_receipt])


def join(left: SuccinctReceipt, right: SuccinctReceipt) -> SuccinctReceipt:
    """Pairwise join with claim-chaining checks (reference join.rs:53)."""
    a, b = left.claim, right.claim
    if a.image_id != b.image_id:
        raise RecursionError("join: image id mismatch")
    if a.halted:
        raise RecursionError("join: left span already halted")
    if (a.post_pc, a.post_regs, a.post_seqs) != (b.pre_pc, b.pre_regs,
                                                 b.pre_seqs):
        raise RecursionError("join: state discontinuity")
    if a.post_mem_root != b.pre_mem_root:
        raise RecursionError("join: memory root discontinuity")
    claim = SpanClaim(
        image_id=a.image_id, pre_pc=a.pre_pc, post_pc=b.post_pc,
        pre_regs=a.pre_regs, post_regs=b.post_regs,
        pre_seqs=a.pre_seqs, post_seqs=b.post_seqs,
        halted=b.halted, io=a.io + b.io,
        pre_mem_root=a.pre_mem_root, post_mem_root=b.post_mem_root)
    return SuccinctReceipt(kind="join", claim=claim,
                           segments=left.segments + right.segments)


def union(left: SuccinctReceipt, right: SuccinctReceipt) -> SuccinctReceipt:
    """Union of coprocessor receipts (reference union.rs:44)."""
    claim = SpanClaim(
        image_id=left.claim.image_id, pre_pc=0, post_pc=0,
        pre_regs=(0,) * 64, post_regs=(0,) * 64,
        pre_seqs=(0, 0, 0), post_seqs=(0, 0, 0), halted=1,
        io=left.claim.io + right.claim.io)
    return SuccinctReceipt(kind="union", claim=claim,
                           segments=left.segments + right.segments)


def resolve(conditional: SuccinctReceipt,
            assumption_receipts: List[SuccinctReceipt]) -> SuccinctReceipt:
    """Discharge assumptions (reference resolve.rs:85): every VERIFY'd claim
    digest must be proven by one of the supplied receipts."""
    available = {}
    for r in assumption_receipts:
        if not r.assumptions_resolved and r.claim.assumption_digests():
            raise RecursionError("assumption receipt itself unresolved")
        available[r.claim_digest()] = r
    used = []
    for digest in conditional.claim.assumption_digests():
        match = available.get(digest)
        if match is None:
            raise RecursionError(
                f"unresolved assumption {digest.hex()[:16]}...")
        used.append(match)
    out = SuccinctReceipt(kind="resolve", claim=conditional.claim,
                          segments=conditional.segments,
                          assumptions_resolved=True, resolved_with=used)
    return out


def verify_succinct(receipt: SuccinctReceipt, ps: stark.ProofSystem = None,
                    expected_image_id=None) -> bool:
    """Full verification of a recursion-layer receipt.

    v1: verifies every embedded segment STARK and replays the claim chain
    (continuity is re-checked by re-folding the segment claims).
    """
    kwargs = {} if ps is None else {"ps": ps}
    segs = receipt.segments
    if not segs:
        return False
    try:
        receipt.claim.validate_io()
    except RecursionError:
        return False
    if expected_image_id is not None and tuple(
            int(x) for x in expected_image_id) != receipt.claim.image_id:
        return False
    for s in segs:
        if not verify_segment(s, **kwargs):
            return False
    if receipt.kind != "union":
        # the claim's image id must be the (proof-bound) id every segment
        # verified against — one static program table for all segments
        prog_id = tuple(int(x) for x in receipt.claim.image_id)
        for s_ in segs:
            if tuple(int(x) for x in s_.image_id) != prog_id:
                return False
        # RAM continuity replay at the publics level: every word value a
        # segment's public page table exposes must agree with what the
        # span established earlier (first exposure wins; posts update).
        # The claim's PageTree ROOTS are fully validated by the session
        # layer against the program image (SessionReceipt.verify(image=));
        # the succinct circuit path derives them in-circuit.
        established = {}
        for s_ in segs:
            mem = np.asarray(s_.pub["mem"], dtype=np.int64)
            for e in range(mem.shape[0]):
                if not mem[e, 1]:
                    continue
                pg = int(mem[e, 0])
                for w in range(64):
                    base = 2 + 5 * w
                    addr = pg * 64 + w
                    pre = int(mem[e, base + 1]) | (int(mem[e, base + 2]) << 16)
                    post = int(mem[e, base + 3]) | (int(mem[e, base + 4]) << 16)
                    if addr in established and established[addr] != pre:
                        return False
                    established[addr] = post

        def span_of(k):
            return SpanClaim.of_segment(segs[k])

        cur = span_of(0)
        for k in range(1, len(segs)):
            nxt = span_of(k)
            if cur.halted or cur.image_id != nxt.image_id:
                return False
            if (cur.post_pc, cur.post_regs, cur.post_seqs) != (
                    nxt.pre_pc, nxt.pre_regs, nxt.pre_seqs):
                return False
            cur = SpanClaim(image_id=cur.image_id, pre_pc=cur.pre_pc,
                            post_pc=nxt.post_pc, pre_regs=cur.pre_regs,
                            post_regs=nxt.post_regs, pre_seqs=cur.pre_seqs,
                            post_seqs=nxt.post_seqs, halted=nxt.halted,
                            io=cur.io + nxt.io)
        got = dataclasses.asdict(cur)
        want = dataclasses.asdict(receipt.claim)
        for key in ("pre_mem_root", "post_mem_root"):
            got.pop(key), want.pop(key)
        if got != want:
            return False
    if receipt.resolved_with is not None:
        digests = set()
        for r in receipt.resolved_with:
            if not verify_succinct(r, ps):
                return False
            digests.add(r.claim_digest())
        for d in receipt.claim.assumption_digests():
            if d not in digests:
                return False
    elif receipt.claim.assumption_digests():
        return False  # unresolved conditional receipt
    return True


@dataclasses.dataclass
class SessionReceipt:
    """Final session receipt (reference finalize.rs:56): root span +
    extracted journal, verified halted from genesis state."""

    root: SuccinctReceipt
    journal: bytes
    image_id: tuple
    entry_pc: int

    @staticmethod
    def finalize(root: SuccinctReceipt, entry_pc: int,
                 image_mem_root=None) -> "SessionReceipt":
        c = root.claim
        if not c.halted:
            raise RecursionError("finalize: session did not halt")
        if c.pre_pc != entry_pc or any(c.pre_regs) or any(c.pre_seqs):
            raise RecursionError("finalize: span does not start at genesis")
        if image_mem_root is not None and tuple(c.pre_mem_root) != tuple(
                int(x) for x in image_mem_root):
            raise RecursionError(
                "finalize: genesis memory root is not the program image's")
        journal = b"".join(w.to_bytes(4, "little")
                           for w in c.journal_words())
        return SessionReceipt(root=root, journal=journal,
                              image_id=c.image_id, entry_pc=entry_pc)

    def verify(self, ps: stark.ProofSystem = None,
               expected_image_id=None, image=None) -> bool:
        """`image`: when the caller supplies the program MemoryImage, the
        verifier replays the whole RAM-continuity chain from genesis —
        every segment's public pre words checked against the evolving
        word store and the claim's memory roots recomputed exactly
        (PageTree; zkvm/paging.py)."""
        c = self.root.claim
        if not c.halted or c.pre_pc != self.entry_pc or any(c.pre_regs):
            return False
        if image is not None and not _replay_mem_chain(
                image, self.root.segments, c):
            return False
        return verify_succinct(self.root, ps, expected_image_id)


def _replay_mem_chain(image, segments, claim: SpanClaim) -> bool:
    """Genesis-anchored RAM replay: evolve the image's word store through
    every segment's public page words; check pre values and recompute the
    claim's pre/post PageTree roots."""
    from ..zkvm import paging

    words = {a >> 2: int(v) for a, v in image.words.items()}
    tree = paging.PageTree.from_words(words)
    if tuple(claim.pre_mem_root) != tuple(tree.root()):
        return False
    now = dict(words)
    for s_ in segments:
        mem = np.asarray(s_.pub["mem"], dtype=np.int64)
        for e in range(mem.shape[0]):
            if not mem[e, 1]:
                continue
            pg = int(mem[e, 0])
            for w in range(64):
                base = 2 + 5 * w
                addr = pg * 64 + w
                pre = int(mem[e, base + 1]) | (int(mem[e, base + 2]) << 16)
                post = int(mem[e, base + 3]) | (int(mem[e, base + 4]) << 16)
                if now.get(addr, 0) != pre:
                    return False
                if post != pre:
                    now[addr] = post
                    tree.set_word(addr, post)
    return tuple(claim.post_mem_root) == tuple(tree.root())
