"""Merkle commitments over Poseidon2 digests.

Counterpart of `boundless_tpu/core/merkle.py`: leaf i is the sponge hash
of row i of an (N, C) matrix, then a binary tree of 2-to-1 compressions.
Every hash goes through `kernels/poseidon2.py` (the CUDA sponge on a GPU
tensor), at every size: no small-level fallback as on the TPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import poseidon2 as P2K


class MerkleTree(NamedTuple):
    """levels[0] = leaf digests (N, 8) ... levels[-1] = root (1, 8)."""

    levels: tuple
    matrix: torch.Tensor  # committed rows (N, C), Montgomery int32

    @property
    def root(self):
        return self.levels[-1][0]


def commit(matrix) -> MerkleTree:
    """Commit to a (N, C) matrix, N a power of two."""
    n = matrix.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    matrix = matrix.contiguous()
    cur = P2K.hash_rows(matrix)
    levels = [cur]
    while cur.shape[0] > 1:
        # rows 2i and 2i+1 are adjacent: the (n/2, 16) view is [left|right]
        cur = P2K.hash_rows(cur.view(-1, 16))
        levels.append(cur)
    return MerkleTree(levels=tuple(levels), matrix=matrix)


def open_rows(tree: MerkleTree, indices):
    """Open query rows. indices: (Q,) int64 tensor.

    Returns (rows (Q, C), paths (Q, depth, 8)); paths[q][d] is the sibling
    digest at depth d (leaf level first).
    """
    rows = tree.matrix[indices]
    sibs = []
    idx = indices
    for level in tree.levels[:-1]:
        sibs.append(level[idx ^ 1])
        idx = idx >> 1
    if not sibs:
        return rows, torch.zeros((indices.shape[0], 0, 8), dtype=torch.int32,
                                 device=rows.device)
    return rows, torch.stack(sibs, dim=1)


def verify_rows(root, indices, rows, paths):
    """Recompute the root from opened rows; returns a bool tensor (Q,)."""
    cur = P2K.hash_rows(rows.contiguous())
    idx = indices
    for d in range(paths.shape[1]):
        sib = paths[:, d]
        is_right = (idx & 1).bool()[:, None]
        left = torch.where(is_right, sib, cur)
        right = torch.where(is_right, cur, sib)
        cur = P2K.hash_pairs(left, right)
        idx = idx >> 1
    return torch.all(cur == root[None, :], dim=-1)
