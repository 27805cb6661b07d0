"""Multi-scalar multiplication for BN254 G1.

The reference wraps its final STARK into a Groth16 proof whose cost is
MSM-dominated (`risc0-groth16-sys` CUDA / rapidsnark, SURVEY.md §2.4).
Counterpart of `boundless_tpu/groth16/msm.py`, copied: `msm_naive` and
the host-exact windowed bucket MSM `msm_pippenger`, the exact references
of the card's Pippenger (`groth16/msm_device.py`, `csrc/msm.cu`).
"""

from __future__ import annotations

from typing import List, Sequence

from .bn254 import G1, R


def msm_naive(points: Sequence[G1], scalars: Sequence[int]) -> G1:
    acc = G1.infinity()
    for p, s in zip(points, scalars):
        acc = acc.add(p.mul(s))
    return acc


def msm_pippenger(points: Sequence[G1], scalars: Sequence[int],
                  window_bits: int = 8) -> G1:
    """Windowed bucket method: O(n * 254/w + 2^w) group ops."""
    scalars = [s % R for s in scalars]
    num_windows = (254 + window_bits - 1) // window_bits
    mask = (1 << window_bits) - 1
    window_sums: List[G1] = []
    for w in range(num_windows):
        shift = w * window_bits
        buckets = [G1.infinity()] * (mask + 1)
        for p, s in zip(points, scalars):
            digit = (s >> shift) & mask
            if digit:
                buckets[digit] = buckets[digit].add(p)
        # running-sum trick: sum_j j * bucket[j]
        running = G1.infinity()
        total = G1.infinity()
        for j in range(mask, 0, -1):
            running = running.add(buckets[j])
            total = total.add(running)
        window_sums.append(total)
    acc = G1.infinity()
    for ws in reversed(window_sums):
        for _ in range(window_bits):
            acc = acc.double()
        acc = acc.add(ws)
    return acc
