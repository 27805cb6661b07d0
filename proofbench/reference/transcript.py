"""Fiat-Shamir transcript: a Poseidon2 duplex sponge.

Frozen copy of `boundless_tpu_torch/core/transcript.py` for the
benchmark's reference (plain torch and numpy; no kernel of the port).

Counterpart of `boundless_tpu/core/transcript.py`, with the same absorb
and squeeze schedule, so both packages draw the same challenges. The
state is a (24,) Montgomery tensor on the prover's device; every
permutation and every absorbed hash runs through `kernels/poseidon2.py`
(on the CPU an absorbed hash runs through the numpy twin).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import field as F
from . import poseidon2 as P2
from . import poseidon2_np as P2NP


class Transcript:
    def __init__(self, device="cpu"):
        self.state = torch.zeros((P2.WIDTH,), dtype=F.I32, device=device)
        self._pool = P2.RATE  # force a permute before the first squeeze

    def _permute(self):
        self.state = P2.permute(self.state[None])[0]

    def mix_digest(self, digest):
        """Absorb an 8-word digest (Montgomery int32)."""
        self.state = torch.cat([
            F.add(self.state[: P2.DIGEST_WORDS], digest),
            self.state[P2.DIGEST_WORDS:]])
        self._permute()
        self._pool = 0

    def mix_elems(self, elems):
        """Absorb a flat vector of field elements via its sponge hash, on
        the host's numpy twin of the sponge (one long row is thousands of
        sequential permutations)."""
        digest = F.fp(np.asarray(P2NP.hash_elems_np(
            F.from_mont(elems.reshape(-1)).cpu().numpy())), elems.device)
        self.mix_digest(digest)

    def mix_pub(self, pub):
        """Absorb public values, a dataclass of tensors or one tensor: the
        hash of the fields flattened in declaration order (the JAX pytree
        leaf order)."""
        leaves = ([pub] if isinstance(pub, torch.Tensor) else
                  [getattr(pub, f.name) for f in dataclasses.fields(pub)])
        flat = torch.cat([x.reshape(-1) for x in leaves])
        self.mix_elems(flat)

    def sample_elem(self):
        if self._pool >= P2.RATE:
            self._permute()
            self._pool = 0
        out = self.state[self._pool]
        self._pool += 1
        return out

    def sample_ext(self):
        return torch.stack([self.sample_elem() for _ in range(4)])

    def sample_u32(self):
        """A 32-bit word from two squeezed elements (int64 tensor)."""
        a = F.from_mont(self.sample_elem()).to(torch.int64)
        b = F.from_mont(self.sample_elem()).to(torch.int64)
        return (a & 0xFFFF) | ((b & 0xFFFF) << 16)

    def sample_indices(self, count: int, bits: int):
        """count indices in [0, 2^bits), int64 tensor (count,)."""
        mask = (1 << bits) - 1
        return torch.stack([self.sample_u32() & mask for _ in range(count)])
