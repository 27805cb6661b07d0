"""Exact Baby Bear weighted column sums (the prover's field "matmuls").

Counterpart of `boundless_tpu/core/bbmm.py`, which splits operands into
int8 limbs for the TPU's matrix unit (`_bb_ws_chunk`). CUDA has no integer
`torch.matmul`, so here the same function is a chunked exact sum: each
product of two reduced words (< 2^62) is reduced mod P before it is
accumulated in int64, and the single Montgomery R^-1 is applied once at
the end. Results equal the reference's bit for bit:

  bb_weighted_sum(V, W) == Σ_k mont_mul(V[:, k], W[k, :])

Plain torch for now; a CUDA kernel is queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from . import field as F

# int64 elements per chunk temporary (bounds device memory, ~256 MB)
CHUNK_ELEMS = 1 << 25


def bb_weighted_sum(values, weights):
    """values (M, K) int32, weights (K, W) int32 -> (M, W) Montgomery sum."""
    m, k = values.shape
    k2, w = weights.shape
    assert k == k2
    acc = torch.zeros((m, w), dtype=torch.int64, device=values.device)
    wts = weights.to(torch.int64)
    step = max(1, CHUNK_ELEMS // max(1, m * w))
    for k0 in range(0, k, step):
        v = values[:, k0:k0 + step].to(torch.int64)
        acc += ((v[:, :, None] * wts[None, k0:k0 + step]) % F.P).sum(1)
        acc %= F.P
    return F._reduce(acc)


def bb_weighted_sum_t(values_t, weights):
    """bb_weighted_sum for transposed values: (K, M) @ weights (K, W)."""
    return bb_weighted_sum(values_t.t(), weights)
