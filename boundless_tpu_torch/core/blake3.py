"""BLAKE3 hash (pure Python, hash mode only).

The reference's Groth16 wrap flavor commits journals under BLAKE3
(`blake3_groth16/src/receipt.rs`, the `blake3` crate); this replaces the
round-3 sha256 stand-in so `blake3_groth16` receipts carry true BLAKE3
journal digests. Implements the BLAKE3 spec: 1024-byte chunks of
64-byte blocks, 7-round compression with the fixed schedule
permutation, binary chaining tree, 32-byte root output (extended output
not needed here). Counterpart of `boundless_tpu/core/blake3.py`,
copied. Vectors: tests/test_blake3.py.
"""

from __future__ import annotations

import struct

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
PARENT = 1 << 2
ROOT = 1 << 3

_MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
_M32 = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _M32


def _g(st, a, b, c, d, mx, my):
    st[a] = (st[a] + st[b] + mx) & _M32
    st[d] = _rotr(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b] + my) & _M32
    st[d] = _rotr(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr(st[b] ^ st[c], 7)


def _compress(cv, block_words, counter: int, block_len: int,
              flags: int):
    st = [cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
          IV[0], IV[1], IV[2], IV[3],
          counter & _M32, (counter >> 32) & _M32, block_len, flags]
    m = list(block_words)
    for r in range(7):
        _g(st, 0, 4, 8, 12, m[0], m[1])
        _g(st, 1, 5, 9, 13, m[2], m[3])
        _g(st, 2, 6, 10, 14, m[4], m[5])
        _g(st, 3, 7, 11, 15, m[6], m[7])
        _g(st, 0, 5, 10, 15, m[8], m[9])
        _g(st, 1, 6, 11, 12, m[10], m[11])
        _g(st, 2, 7, 8, 13, m[12], m[13])
        _g(st, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[_MSG_PERM[i]] for i in range(16)]
    return [st[i] ^ st[i + 8] for i in range(8)]


def _words(block: bytes):
    return struct.unpack("<16I", block.ljust(64, b"\0"))


def _chunk_cv(chunk: bytes, counter: int) -> list:
    cv = list(IV)
    blocks = [chunk[i : i + 64] for i in range(0, max(len(chunk), 1), 64)]
    for i, blk in enumerate(blocks):
        flags = (CHUNK_START if i == 0 else 0) | (
            CHUNK_END if i == len(blocks) - 1 else 0)
        cv = _compress(cv, _words(blk), counter, len(blk), flags)
    return cv


def _root_bytes(cv, block_words, counter, block_len, flags) -> bytes:
    out = _compress(cv, block_words, counter, block_len, flags | ROOT)
    return struct.pack("<8I", *out)


def digest(data: bytes) -> bytes:
    """BLAKE3 hash of `data` (32 bytes)."""
    if len(data) <= 1024:
        # single chunk: root flag on its final block
        cv = list(IV)
        blocks = [data[i : i + 64]
                  for i in range(0, max(len(data), 1), 64)]
        for i, blk in enumerate(blocks[:-1]):
            flags = CHUNK_START if i == 0 else 0
            cv = _compress(cv, _words(blk), 0, len(blk), flags)
        last = blocks[-1]
        flags = (CHUNK_START if len(blocks) == 1 else 0) | CHUNK_END
        return _root_bytes(cv, _words(last), 0, len(last), flags)

    # chunk leaves
    cvs = []
    for idx, off in enumerate(range(0, len(data), 1024)):
        cvs.append(_chunk_cv(data[off : off + 1024], idx))

    # binary chaining tree: each parent's left subtree covers the
    # largest power-of-two number of chunks strictly less than its span
    # (BLAKE3 spec tree shape)
    def tree_cv(lo, hi):
        if hi - lo == 1:
            return cvs[lo]
        mid = lo + (1 << ((hi - lo - 1).bit_length() - 1))
        left = tree_cv(lo, mid)
        right = tree_cv(mid, hi)
        return _compress(list(IV), left + right, 0, 64, PARENT)

    n = len(cvs)
    mid = 1 << ((n - 1).bit_length() - 1)
    left = tree_cv(0, mid)
    right = tree_cv(mid, n)
    return _root_bytes(list(IV), left + right, 0, 64, PARENT)
