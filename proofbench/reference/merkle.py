"""Merkle commitments over Poseidon2 leaf hashes, plain torch.

Frozen copy of the commit and path check of
`boundless_tpu_torch/core/merkle.py`, with the sponge's plain version
(`poseidon2.py`) in place of the port's kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import poseidon2 as P2


class MerkleTree(NamedTuple):
    """levels[0] = leaf digests (N, 8) ... levels[-1] = root (1, 8)."""

    levels: tuple

    @property
    def root(self):
        return self.levels[-1][0]


def commit(matrix) -> MerkleTree:
    """Commit to an (N, C) matrix, N a power of two."""
    n = matrix.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    cur = P2.hash_rows(matrix.contiguous())
    levels = [cur]
    while cur.shape[0] > 1:
        # rows 2i and 2i+1 are adjacent: the (n/2, 16) view is [left|right]
        cur = P2.hash_rows(cur.reshape(-1, 16))
        levels.append(cur)
    return MerkleTree(levels=tuple(levels))


def verify_rows(root, indices, rows, paths):
    """Recompute the root from opened rows; returns a bool tensor (Q,)."""
    cur = P2.hash_rows(rows.contiguous())
    idx = indices
    for d in range(paths.shape[1]):
        sib = paths[:, d]
        is_right = (idx & 1).bool()[:, None]
        left = torch.where(is_right, sib, cur)
        right = torch.where(is_right, cur, sib)
        cur = P2.hash_rows(torch.cat([left, right], dim=1))
        idx = idx >> 1
    return torch.all(cur == root[None, :], dim=-1)
