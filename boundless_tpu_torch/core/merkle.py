"""Merkle commitments over Poseidon2 digests.

Counterpart of `boundless_tpu/core/merkle.py`: leaf i is the sponge hash
of row i of an (N, C) matrix, then a binary tree of 2-to-1 compressions.
Every hash goes through `kernels/poseidon2.py` (the CUDA sponge on a GPU
tensor), at every size: no small-level fallback as on the TPU. On the card
the levels above one of at most `TREE_TOP` nodes are one launch
(`hash_tree`); on the CPU every level runs the plain loop.

A matrix may also come as its column blocks, each on its own device (a
column-sharded proof, `core/sharded.py`): block k's sponge starts from
block k-1's (N, 24) state, so the leaves equal those of the whole rows,
and the levels above run on the first block's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import poseidon2 as P2
from . import sharded
from ..kernels import poseidon2 as P2K


class MerkleTree(NamedTuple):
    """levels[0] = leaf digests (N, 8) ... levels[-1] = root (1, 8)."""

    levels: tuple
    # the committed rows (N, C), Montgomery int32, as contiguous column
    # blocks in column order: one block unless the commit was sharded
    blocks: tuple

    @property
    def root(self):
        return self.levels[-1][0]

    @property
    def num_leaves(self):
        return self.levels[0].shape[0]


def commit(matrix) -> MerkleTree:
    """Commit to an (N, C) matrix, N a power of two: one tensor, or a
    tuple of its column blocks in column order, every block but the last
    a multiple of the sponge's rate wide, each on its own device."""
    blocks = ((matrix,) if isinstance(matrix, torch.Tensor)
              else tuple(matrix))
    n = blocks[0].shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    blocks = tuple(b.contiguous() for b in blocks)
    if any(b.shape[1] % P2.RATE for b in blocks[:-1]):
        raise ValueError(f"a chained leaf hash needs blocks of multiples of "
                         f"{P2.RATE} columns: {[b.shape[1] for b in blocks]}")
    state = None
    for b in blocks[:-1]:
        state = P2K.hash_rows(b, None if state is None else
                              sharded.move(state, b.device), P2.WIDTH)
    cur = P2K.hash_rows(blocks[-1], None if state is None else
                        sharded.move(state, blocks[-1].device))
    if len(blocks) > 1:
        cur = sharded.move(cur, blocks[0].device)
    levels = [cur]
    while cur.shape[0] > P2K.TREE_TOP:
        # rows 2i and 2i+1 are adjacent: the (n/2, 16) view is [left|right]
        cur = P2K.hash_rows(cur.view(-1, 16))
        levels.append(cur)
    if cur.shape[0] > 1:
        levels.extend(P2K.hash_tree(cur))  # the rest: one launch on the card
    return MerkleTree(levels=tuple(levels), blocks=blocks)


def open_rows(tree: MerkleTree, indices):
    """Open query rows. indices: (Q,) int64 tensor on the tree's leader
    (its first block's device).

    Returns (rows (Q, C), paths (Q, depth, 8)); paths[q][d] is the sibling
    digest at depth d (leaf level first). A sharded tree's rows are
    gathered from its blocks and joined in column order on the leader.
    """
    leader = tree.blocks[0].device
    rows = [tree.blocks[0][indices]] + [
        sharded.move(b[sharded.move(indices, b.device)], leader)
        for b in tree.blocks[1:]]
    rows = rows[0] if len(rows) == 1 else torch.cat(rows, 1)
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
