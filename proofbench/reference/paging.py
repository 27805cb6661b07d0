"""Sparse page-Merkle commitment of guest memory (cross-segment RAM

Frozen copy of `boundless_tpu_torch/zkvm/paging.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

continuity).

Counterpart of `boundless_tpu/zkvm/paging.py`, on the port's numpy
Poseidon2. Segments expose touched-page pre/post words as public values
tied to the memory log by LogUp ports; the recursion lift program hashes
those pages and walks this tree to chain `pre_mem_root -> post_mem_root`
in the span claim.

Tree shape (normative for the lift circuit):
  * word-addressed space 2^24 words (2^26 bytes), pages of 64 words
    -> 2^18 pages, binary tree of depth 18;
  * page hash = Poseidon2 hash_elems over 128 elements
    (lo0, hi0, lo1, hi1, ...) — 16-bit limb pairs per word;
  * node = Poseidon2 hash_pair(left, right); empty subtrees use the
    precomputed zero-page lineage (a zero page hashes like any other).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

from . import poseidon2_np as NP

PAGE_WORDS = 64
PAGE_ELEMS = 2 * PAGE_WORDS
SPACE_WORDS_LOG2 = 24
DEPTH = SPACE_WORDS_LOG2 - PAGE_WORDS.bit_length() + 1  # 18
NPAGES = 1 << DEPTH

Digest = Tuple[int, ...]


def _hash_elems(elems: Sequence[int]) -> Digest:
    return NP.hash_elems_np(elems)


def _hash_pair(a: Digest, b: Digest) -> Digest:
    return NP.hash_pair_np(a, b)


def page_limbs(words: Sequence[int]) -> List[int]:
    assert len(words) == PAGE_WORDS
    out = []
    for w in words:
        w = int(w)
        out += [w & 0xFFFF, w >> 16]
    return out


def page_hash(words: Sequence[int]) -> Digest:
    return _hash_elems(page_limbs(words))


class _ZeroLineage:
    """zero[d] = root of an all-zero-memory subtree of height d. The
    cluster's worker threads fill it under a lock: two threads extending
    it at once would append one level twice."""

    def __init__(self):
        self._cache = [page_hash([0] * PAGE_WORDS)]
        self._lock = threading.Lock()

    def __getitem__(self, d: int) -> Digest:
        with self._lock:
            while len(self._cache) <= d:
                h = self._cache[-1]
                self._cache.append(_hash_pair(h, h))
            return self._cache[d]


ZERO = _ZeroLineage()


class PageTree:
    """Sparse Merkle tree over page hashes (host-exact, incremental).

    `pages`: page_index -> 64-word list. Unlisted pages are all-zero.
    """

    def __init__(self, pages: Dict[int, Sequence[int]] = None):
        self._leaf: Dict[int, Digest] = {}
        self._words: Dict[int, List[int]] = {}
        if pages:
            for idx, words in pages.items():
                self.set_page(idx, words)

    @staticmethod
    def from_words(words: Dict[int, int]) -> "PageTree":
        """word_addr -> u32 value (sparse) — e.g. a MemoryImage."""
        t = PageTree()
        by_page: Dict[int, List[int]] = {}
        for wa, val in words.items():
            pg, off = divmod(int(wa), PAGE_WORDS)
            by_page.setdefault(pg, [0] * PAGE_WORDS)[off] = int(val)
        for pg, ws in by_page.items():
            t.set_page(pg, ws)
        return t

    def page_words(self, idx: int) -> List[int]:
        return list(self._words.get(idx, [0] * PAGE_WORDS))

    def set_page(self, idx: int, words: Sequence[int]):
        assert 0 <= idx < NPAGES
        ws = [int(w) for w in words]
        assert len(ws) == PAGE_WORDS
        self._words[idx] = ws
        self._leaf[idx] = page_hash(ws)

    def set_word(self, word_addr: int, val: int):
        pg, off = divmod(int(word_addr), PAGE_WORDS)
        ws = self.page_words(pg)
        ws[off] = int(val)
        self.set_page(pg, ws)

    def get_word(self, word_addr: int) -> int:
        pg, off = divmod(int(word_addr), PAGE_WORDS)
        return self.page_words(pg)[off]

    # -- hashing --------------------------------------------------------------

    def _node(self, d: int, idx: int) -> Digest:
        """Root of the subtree of height d covering pages
        [idx*2^d, (idx+1)*2^d)."""
        if d == 0:
            return self._leaf.get(idx, ZERO[0])
        lo, hi = idx << d, (idx + 1) << d
        if not any(lo <= k < hi for k in self._leaf):
            return ZERO[d]
        return _hash_pair(self._node(d - 1, 2 * idx),
                          self._node(d - 1, 2 * idx + 1))

    def root(self) -> Digest:
        return self._node(DEPTH, 0)

    def path(self, page_idx: int) -> List[Digest]:
        """Sibling digests leaf->root (DEPTH entries)."""
        out = []
        idx = int(page_idx)
        for d in range(DEPTH):
            out.append(self._node(d, idx ^ 1))
            idx >>= 1
        return out


def verify_path(page_idx: int, leaf: Digest, path: Sequence[Digest],
                root: Digest) -> bool:
    cur = tuple(leaf)
    idx = int(page_idx)
    for sib in path:
        cur = _hash_pair(sib, cur) if idx & 1 else _hash_pair(cur, sib)
        idx >>= 1
    return cur == tuple(root)


def image_root(image) -> Digest:
    """PageTree root of a program image's initial memory (byte-addr
    keyed word store) — the genesis anchor for RAM continuity."""
    return PageTree.from_words(
        {a >> 2: int(v) for a, v in image.words.items()}).root()


def apply_updates(root_pages: "PageTree", updates: Dict[int, List[int]]
                  ) -> Digest:
    """The root after replacing whole pages (the pages are replaced in
    `root_pages`)."""
    for idx, ws in updates.items():
        root_pages.set_page(idx, ws)
    return root_pages.root()
