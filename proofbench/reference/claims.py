"""Span claims for succinct recursion: layout, chain folding, digests.

Frozen copy of `boundless_tpu_torch/recursion/claims.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/recursion/claims.py` (host numpy over the
port's `core/poseidon2_np.py`; the same digests word for word).

The recursion layer's claims mirror the reference's `ReceiptClaim`
(risc0-zkvm; joined at `prover/crates/workflow/src/tasks/join.rs:53`)
reshaped for this zkVM's public-value design: instead of a memory-image
SystemState digest pair, a claim pins the register file, pc, per-tag io
sequence counters, three **per-tag io hash chains** (journal / input /
assumptions), and pre/post **memory roots** (the paging.py page tree; the
chains keep claims fixed-size so joins stay O(1) — the reference reaches
the same end with journal digests + SystemState digests in the claim).

Claim v3 element vector (canonical Baby Bear scalars packed 4 per wire;
order is normative — the lift/join programs hash exactly this; see
docs/PROTOCOL.md "Recursion layer"):

  wires  0- 1  image_id (8 words = rv32im control root)
  wire   2     [pre_pc, post_pc, halted, 0]
  wires  3-18  pre_regs (64 limbs)
  wires 19-34  post_regs (64 limbs)
  wire  35     [pre_seqs(4)]   (commit, read, verify, cpio entries)
  wire  36     [post_seqs(4)]
  wires 37-38  pre_journal_chain (8)
  wires 39-40  post_journal_chain (8)
  wires 41-42  pre_input_chain (8)
  wires 43-44  post_input_chain (8)
  wires 45-46  pre_assumptions_chain (8)
  wires 47-48  post_assumptions_chain (8)
  wires 49-50  pre_mem_root (8)
  wires 51-52  post_mem_root (8)
  wires 53-54  pre_coproc_chain (8)   (keccak ecall chain)
  wires 55-56  post_coproc_chain (8)
  wire  57     [pre_segments, post_segments, 0, 0]  (PoVW work counter)

(58 packed wires = 232 slots; digest = P2.hash_elems over the 232-slot
vector.)

Chain folding: h' = H(h(8) || lo, hi) per masked io word of the tag, in
per-tag seq order (the lift program enforces seq-contiguity of the public
io table, so table order == seq order per tag). Genesis chains are
all-zeros. The assumptions chain doubles as a cons list: resolve pops the
top 8 folds (one claim digest = 8 words) by re-deriving them from a
witnessed 8-back chain value.

The coproc chain folds one per-permutation digest per keccak ecall:
h' = H(h(8) || d(8)) with d = H(the 200 public cpio limbs of the
permutation) — derived in-circuit by the lift from pub.cpio and matched
in-circuit against the coproc lattice's union span by resolve_coproc
(the reference's resolve-side union check,
prover/crates/workflow/src/tasks/resolve.rs:85-100). The segments
counter backs PoVW work receipts: lift sets post = pre + 1, join chains,
so a session receipt proves `post_segments << seg_po2` padded cycles.

Memory roots: sparse PageTree roots (zkvm/paging.py) chained across
joins. The lift program derives post_mem_root IN-CIRCUIT from the
segment's public page words (init/final LogUp ports) by hashing each
touched page and walking the tree from the witnessed pre root; genesis
anchors pre_mem_root to the program image's initial PageTree root
(is_genesis with image_mem_root).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from . import field as F
from . import poseidon2_np as P2NP

CLAIM_WIRES = 58
CLAIM_ELEMS = 4 * CLAIM_WIRES  # padded slot count (232)

ZERO_CHAIN = (0,) * 8

# io tags with chains (air/rv32im.py TAG values)
CHAIN_TAGS = (4, 5, 6)  # commit -> journal, read -> input, verify -> assum.
COPROC_TAG = 8  # keccak cpio entries (chain folds per-PERM digests)


def _hash_elems_canonical(elems: Sequence[int]) -> Tuple[int, ...]:
    """Canonical-int host hash (pure numpy; bit-identical to
    core.poseidon2.hash_rows after from_mont)."""
    return P2NP.hash_elems_np([int(x) % F.P for x in elems])


def chain_step(h: Sequence[int], lo: int, hi: int) -> Tuple[int, ...]:
    """h' = H(h || lo, hi)  (10 elements, one sponge block)."""
    return _hash_elems_canonical(list(h) + [lo, hi])


def fold_words(pre: Sequence[int], words32) -> Tuple[int, ...]:
    """Fold 32-bit words (as ints) into a chain."""
    h = tuple(int(x) for x in pre)
    for w in words32:
        w = int(w)
        h = chain_step(h, w & 0xFFFF, w >> 16)
    return h


def fold_io(pre_chains, io_rows):
    """Fold masked io rows (tag, seq, lo, hi, mask) into per-tag chains.

    pre_chains: {tag: 8-tuple}. Rows must be in per-tag seq order (the
    segment's public io table order). Returns the post {tag: 8-tuple}.
    """
    chains = {t: tuple(int(x) for x in pre_chains[t]) for t in CHAIN_TAGS}
    for row in io_rows:
        tag, seq, lo, hi, mask = (int(x) for x in row)
        if mask:
            if tag not in chains:
                raise ValueError(f"io row with unknown tag {tag}")
            chains[tag] = chain_step(chains[tag], lo, hi)
    return chains


def coproc_fold_step(h, d):
    """h' = H(h(8) || d(8)) — one per-permutation coproc chain fold
    (identical to recursion/coproc_succinct.chain_step)."""
    return _hash_elems_canonical(list(h) + list(d))


def fold_coproc(pre_chain, cpio_rows):
    """Fold the segment's public cpio table into the coproc chain.

    cpio_rows: (CP_IO, 4) [seq, lo, hi, mask] — 100 word entries per
    permutation in table order (in words at even offsets, out words at
    odd — air/rv32im.py burst emission). Mirrors the lift program's
    in-circuit derivation: d = H(in limbs(100) || out limbs(100)),
    h' = H(h || d)."""
    rows = [tuple(int(x) for x in r) for r in cpio_rows]
    h = tuple(int(x) for x in pre_chain)
    for p in range(0, len(rows), 100):
        perm = rows[p : p + 100]
        if len(perm) < 100 or not perm[0][3]:
            break
        assert all(r[3] for r in perm), "partial keccak permutation"
        limbs = []
        for j in range(50):  # in words
            limbs += [perm[2 * j][1], perm[2 * j][2]]
        for j in range(50):  # out words
            limbs += [perm[2 * j + 1][1], perm[2 * j + 1][2]]
        d = _hash_elems_canonical(limbs)
        h = coproc_fold_step(h, d)
    return h


@dataclasses.dataclass(frozen=True)
class Claim:
    """A span claim (contiguous rv32im execution, 1..k segments)."""

    image_id: tuple      # 8 words
    pre_pc: int
    post_pc: int
    halted: int
    pre_regs: tuple      # 64 limbs
    post_regs: tuple
    pre_seqs: tuple      # (commit, read, verify, cpio entries)
    post_seqs: tuple
    pre_journal: tuple   # 8
    post_journal: tuple
    pre_input: tuple
    post_input: tuple
    pre_assumptions: tuple
    post_assumptions: tuple
    pre_mem_root: tuple = ZERO_CHAIN
    post_mem_root: tuple = ZERO_CHAIN
    pre_coproc: tuple = ZERO_CHAIN   # keccak ecall chain (per-perm folds)
    post_coproc: tuple = ZERO_CHAIN
    pre_segments: int = 0            # PoVW work counter (segments proven)
    post_segments: int = 0

    def to_elems(self) -> List[int]:
        """The normative padded 232-slot vector (see module docstring)."""
        out = list(self.image_id)
        out += [self.pre_pc, self.post_pc, self.halted, 0]
        out += list(self.pre_regs)
        out += list(self.post_regs)
        out += list(self.pre_seqs) + [0] * (4 - len(self.pre_seqs))
        out += list(self.post_seqs) + [0] * (4 - len(self.post_seqs))
        for pair in ((self.pre_journal, self.post_journal),
                     (self.pre_input, self.post_input),
                     (self.pre_assumptions, self.post_assumptions),
                     (self.pre_mem_root, self.post_mem_root),
                     (self.pre_coproc, self.post_coproc)):
            out += list(pair[0]) + list(pair[1])
        out += [self.pre_segments, self.post_segments, 0, 0]
        assert len(out) == CLAIM_ELEMS
        return out

    def digest(self) -> Tuple[int, ...]:
        return _hash_elems_canonical(self.to_elems())

    def digest_words(self) -> List[int]:
        """Digest as 8 32-bit io words (lo | hi<<16 limbs) — the form a
        guest VERIFY-ecalls an assumption digest in."""
        return [int(x) for x in self.digest()]

    @staticmethod
    def of_segment(image_id, pub, pre_chains=None,
                   pre_mem_root=ZERO_CHAIN, post_mem_root=ZERO_CHAIN,
                   seg_index: int = 0) -> "Claim":
        """Claim of one segment from its (canonical) public values.

        pub: dict-like with pre_pc/post_pc/halted/pre_regs/post_regs/
        pre_seqs/post_seqs/io/cpio (the SegmentReceipt.pub layout,
        zkvm/witness.py). `pre_chains`: {tag: 8-tuple}
        (genesis = all-zero; tag 8 = the coproc chain). `seg_index`:
        segments proven before this one (the PoVW work counter).
        """
        if pre_chains is None:
            pre_chains = {t: ZERO_CHAIN for t in CHAIN_TAGS}
        post = fold_io(pre_chains, pub["io"])
        pre_cp = tuple(int(x) for x in pre_chains.get(COPROC_TAG,
                                                      ZERO_CHAIN))
        post_cp = fold_coproc(pre_cp, pub.get("cpio", []))
        pre_seqs = tuple(int(x) for x in pub["pre_seqs"])
        post_seqs = tuple(int(x) for x in pub["post_seqs"])
        if len(pre_seqs) == 3:  # legacy 3-seq publics
            pre_seqs += (0,)
            post_seqs += (0,)
        return Claim(
            image_id=tuple(int(x) for x in image_id),
            pre_pc=int(pub["pre_pc"]), post_pc=int(pub["post_pc"]),
            halted=int(pub["halted"]),
            pre_regs=tuple(int(x) for x in pub["pre_regs"]),
            post_regs=tuple(int(x) for x in pub["post_regs"]),
            pre_seqs=pre_seqs, post_seqs=post_seqs,
            pre_journal=tuple(pre_chains[4]), post_journal=post[4],
            pre_input=tuple(pre_chains[5]), post_input=post[5],
            pre_assumptions=tuple(pre_chains[6]), post_assumptions=post[6],
            pre_mem_root=tuple(int(x) for x in pre_mem_root),
            post_mem_root=tuple(int(x) for x in post_mem_root),
            pre_coproc=pre_cp, post_coproc=post_cp,
            pre_segments=int(seg_index),
            post_segments=int(seg_index) + 1)

    def join(self, right: "Claim") -> "Claim":
        """The joined claim (must satisfy the chaining equalities the
        join program enforces in-circuit)."""
        assert self.image_id == right.image_id
        assert not self.halted
        assert self.post_pc == right.pre_pc
        assert self.post_regs == right.pre_regs
        assert self.post_seqs == right.pre_seqs
        assert self.post_journal == right.pre_journal
        assert self.post_input == right.pre_input
        assert self.post_assumptions == right.pre_assumptions
        assert self.post_mem_root == right.pre_mem_root
        assert self.post_coproc == right.pre_coproc
        assert self.post_segments == right.pre_segments
        return Claim(
            image_id=self.image_id, pre_pc=self.pre_pc,
            post_pc=right.post_pc, halted=right.halted,
            pre_regs=self.pre_regs, post_regs=right.post_regs,
            pre_seqs=self.pre_seqs, post_seqs=right.post_seqs,
            pre_journal=self.pre_journal, post_journal=right.post_journal,
            pre_input=self.pre_input, post_input=right.post_input,
            pre_assumptions=self.pre_assumptions,
            post_assumptions=right.post_assumptions,
            pre_mem_root=self.pre_mem_root,
            post_mem_root=right.post_mem_root,
            pre_coproc=self.pre_coproc, post_coproc=right.post_coproc,
            pre_segments=self.pre_segments,
            post_segments=right.post_segments)

    def discharge_coproc(self, union_claim) -> "Claim":
        """Discharge the keccak ecall chain against a proven coproc
        span (host mirror of the resolve_coproc program): the union's
        span must cover the claim's coproc chain exactly, and its
        permutation count must match the cpio entry counters."""
        if tuple(union_claim.pre_chain) != tuple(self.pre_coproc):
            raise ValueError("coproc span pre-chain mismatch")
        if tuple(union_claim.post_chain) != tuple(self.post_coproc):
            raise ValueError("coproc span post-chain mismatch")
        perms = int(union_claim.post_count) - int(union_claim.pre_count)
        if 100 * perms != int(self.post_seqs[3]) - int(self.pre_seqs[3]):
            raise ValueError("coproc perm count mismatch")
        return dataclasses.replace(self, post_coproc=self.pre_coproc)

    def resolve(self, assumption_digest: Sequence[int],
                prev_chain: Sequence[int]) -> "Claim":
        """Pop the top assumption (cons-list semantics): re-derives the
        last 8 folds from `prev_chain` and checks they land on
        post_assumptions; the resolved claim's post chain is prev_chain.
        Mirrors what the resolve program enforces in-circuit."""
        h = fold_words(prev_chain, [int(x) for x in assumption_digest])
        assert h == self.post_assumptions, "assumption digest mismatch"
        return dataclasses.replace(
            self, post_assumptions=tuple(int(x) for x in prev_chain))

    def is_genesis(self, entry_pc: int, image_mem_root=None) -> bool:
        """Genesis state: entry pc, zero regs/seqs/chains, and (when the
        caller supplies it) pre_mem_root == the program image's initial
        PageTree root — anchoring the whole RAM-continuity chain to the
        program's initial memory (risc0's MemoryImage root = image id
        model; reference prove.rs:68-95). image_id itself is the static
        code table's control root, checked separately by the verifier."""
        if image_mem_root is not None and tuple(
                int(x) for x in image_mem_root) != tuple(self.pre_mem_root):
            return False
        return (self.pre_pc == int(entry_pc) and not any(self.pre_regs)
                and not any(self.pre_seqs) and not any(self.pre_journal)
                and not any(self.pre_input)
                and not any(self.pre_assumptions)
                and not any(self.pre_coproc)
                and self.pre_segments == 0)


def digest_bytes(digest8: Sequence[int]) -> bytes:
    """Canonical 32-byte encoding of an 8-word claim digest (LE u32 per
    word — the form a guest VERIFY-ecalls and hot-store receipt keys use)."""
    return b"".join(int(w).to_bytes(4, "little") for w in digest8)


def digest_from_bytes(blob: bytes) -> Tuple[int, ...]:
    assert len(blob) == 32
    return tuple(int.from_bytes(blob[i : i + 4], "little")
                 for i in range(0, 32, 4))


def assumption_chain_prefixes(pre: Sequence[int], digests) -> List[tuple]:
    """Chain value before each digest fold (resolve pops in reverse order).

    digests: list of 8-word claim digests in VERIFY order. Returns
    [chain before digest 0, chain before digest 1, ...]."""
    out = []
    h = tuple(int(x) for x in pre)
    for d in digests:
        out.append(h)
        h = fold_words(h, [int(x) for x in d])
    return out


# ---------------------------------------------------------------------------
# Allowed-set (control-root lattice)
# ---------------------------------------------------------------------------


ALLOWED_DEPTH = 3  # lift, lift_i, join, resolve, resolve_coproc + spares


def allowed_set_root(ids: Sequence[Sequence[int]], depth: int = ALLOWED_DEPTH
                     ) -> Tuple[int, ...]:
    """Merkle root over program control IDs (8-word digests).

    The root is a *public input* of every recursion proof; programs check
    their children's control roots are members (risc0's control-root
    lattice, `risc0_zkvm` control ids). Slots pad with zero digests.
    """
    leaves = [tuple(int(x) for x in d) for d in ids]
    slots = 1 << depth
    assert len(leaves) <= slots
    leaves = leaves + [(0,) * 8] * (slots - len(leaves))
    level = leaves
    while len(level) > 1:
        level = [P2NP.hash_pair_np(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]


def allowed_set_path(ids: Sequence[Sequence[int]], index: int,
                     depth: int = ALLOWED_DEPTH) -> List[Tuple[int, ...]]:
    """Sibling path for leaf `index` (leaf level first)."""
    leaves = [tuple(int(x) for x in d) for d in ids]
    slots = 1 << depth
    leaves = leaves + [(0,) * 8] * (slots - len(leaves))
    path = []
    level = leaves
    idx = index
    while len(level) > 1:
        path.append(level[idx ^ 1])
        level = [P2NP.hash_pair_np(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
        idx >>= 1
    return path
