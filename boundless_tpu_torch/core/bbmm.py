"""Exact Baby Bear weighted column sums (the prover's field "matmuls").

Counterpart of `boundless_tpu/core/bbmm.py`, which splits operands into
int8 limbs for the TPU's matrix unit (`_bb_ws_chunk`). Results equal the
reference's bit for bit:

  bb_weighted_sum(V, W) == Σ_k mont_mul(V[:, k], W[k, :])

On a CUDA tensor each call launches the hand-written kernel
(`kernels/bbmm.py` -> `csrc/bbmm.cu`: 64-bit sums of the raw products, one
reduction and one Montgomery R^-1 per output) or raises; on a CPU tensor
it runs the plain version, `bb_weighted_sum_plain`: a chunked exact sum in
which each product of two reduced words (< 2^62) is reduced mod P before
it is accumulated in int64, and the R^-1 is applied once at the end.
There is no fallback from the card to the plain version; `PLAIN_ON_CUDA`
counts the plain versions' calls on CUDA tensors (made only to check the
kernel).
"""

from __future__ import annotations

import threading

import torch

from ..kernels import bbmm as BK
from . import field as F

# int64 elements per chunk temporary of the plain version (~256 MB)
CHUNK_ELEMS = 1 << 25
PLAIN_ON_CUDA = 0
_COUNT_LOCK = threading.Lock()


def bb_weighted_sum(values, weights):
    """values (M, K) int32, weights (K, W) int32 -> (M, W) Montgomery sum:
    the kernel on a CUDA tensor (row-major with any row stride, see
    `kernels/bbmm.row_stride`), the plain version on a CPU tensor."""
    if values.device.type == "cpu":
        return bb_weighted_sum_plain(values, weights)
    return BK.weighted_sum(values, weights)


def bb_weighted_sum_t(values_t, weights):
    """bb_weighted_sum for transposed values: (K, M) @ weights (K, W).
    The kernel reads row-major values only, so on a CUDA tensor this
    raises unless the (M, K) view is row-major too (as when K is 1). No path
    on the card calls it: its one caller, the eager α-combine
    (`cons_eval.combine_rows`), runs on the CPU, and the card's constraint
    kernel combines its own rows."""
    if values_t.device.type == "cpu":
        return bb_weighted_sum_t_plain(values_t, weights)
    return BK.weighted_sum(values_t.t(), weights)


def bb_weighted_sum_plain(values, weights):
    """Plain torch version of the kernel (arguments as bb_weighted_sum)."""
    global PLAIN_ON_CUDA
    if values.is_cuda:
        with _COUNT_LOCK:
            PLAIN_ON_CUDA += 1
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


def bb_weighted_sum_t_plain(values_t, weights):
    """Plain version of bb_weighted_sum_t."""
    return bb_weighted_sum_plain(values_t.t(), weights)
