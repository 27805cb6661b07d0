"""Hash-suite abstraction for the STARK prover/verifier.

Counterpart of `boundless_tpu/core/suites.py`. Two suites:

  * **poseidon2** — Baby Bear Poseidon2, the default everywhere
    (`core/merkle.py`, `core/transcript.py`).
  * **poseidon254** — BN254-scalar-field Poseidon (core/poseidon_bn254),
    used only by the final-shrink proof that the Groth16 wrap verifies
    (`recursion/identity.py`). Its Merkle hashing runs where the matrix
    lies, through `kernels/poseidon254.py`: the CUDA sponge on the card,
    the Python-int hash on the CPU (the reference hashes on the host
    through `jax.pure_callback`). Its transcript (`Transcript254`, a few
    permutations a proof) keeps its state as Python ints on the host.

A suite provides `commit`/`verify_rows` (Merkle) and `transcript()`
(Fiat-Shamir). Digests are (…, 8) int32 tensors in both suites, so tree
and proof shapes are suite-independent; a p254 digest is a 254-bit felt
as 8 little-endian u32 words held as their int32 bit patterns
(`kernels/poseidon254.py`).
"""

from __future__ import annotations

import dataclasses

import torch

from . import field as F
from . import merkle as M
from . import poseidon_bn254 as P254
from .transcript import Transcript
from ..kernels import poseidon254 as P254K


class Poseidon2Suite:
    name = "poseidon2"

    def commit(self, matrix) -> M.MerkleTree:
        return M.commit(matrix)

    def verify_rows(self, root, indices, rows, paths):
        return M.verify_rows(root, indices, rows, paths)

    def transcript(self, device="cpu"):
        return Transcript(device)


class Poseidon254Suite:
    name = "poseidon254"

    def commit(self, matrix) -> M.MerkleTree:
        n = matrix.shape[0]
        assert n & (n - 1) == 0, "leaf count must be a power of two"
        matrix = matrix.contiguous()
        cur = P254K.hash_rows(matrix)
        levels = [cur]
        while cur.shape[0] > P254K.TREE_TOP:
            # rows 2i and 2i+1 are adjacent: the (n/2, 16) view is [l | r]
            cur = P254K.hash_level(cur.view(-1, 16), trusted=True)
            levels.append(cur)
        if cur.shape[0] > 1:  # the rest in one launch on the card
            levels.extend(P254K.hash_tree(cur))
        return M.MerkleTree(levels=tuple(levels), matrix=matrix)

    def verify_rows(self, root, indices, rows, paths):
        leaves = P254K.hash_rows(rows.contiguous())
        roots = P254K.hash_paths(leaves, indices, paths)
        return torch.all(roots == root[None, :], dim=-1)

    def transcript(self, device="cpu"):
        return Transcript254(device)


class Transcript254:
    """Fiat-Shamir over the p254 sponge, state on the host.

    State: 3 felts (Python ints). Challenge squeezes yield Baby Bear
    elements via 62-bit chunks mod P (poseidon_bn254.squeeze_bb); the wrap
    circuit re-derives the identical sequence natively. Samples come back
    as tensors on the prover's device, as `Transcript`'s do.
    """

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.state = [0, 0, 0]
        self._queue = []  # squeezed canonical BB elements not yet consumed

    def _absorb(self, felt: int):
        s = list(self.state)
        s[0] = (s[0] + felt) % P254.FR
        self.state = P254.permute(s)
        self._queue = []

    def mix_digest(self, digest):
        """Absorb an 8-word p254 digest (int32 bit patterns or ints)."""
        words = [int(w) & 0xFFFFFFFF for w in
                 (digest.tolist() if isinstance(digest, torch.Tensor)
                  else digest)]
        self._absorb(P254.felt_of_words(words))

    def mix_elems(self, elems):
        """Absorb a flat vector of BB field elements (Montgomery)."""
        flat = F.from_mont(elems.reshape(-1)).tolist()
        self._absorb(P254.hash_bb(flat))

    def mix_pub(self, pub):
        """Absorb public values: one tensor or a dataclass of tensors (its
        fields flattened in declaration order, the JAX pytree leaf
        order); None absorbs the zero digest."""
        if pub is None:
            self.mix_digest([0] * P254.DIGEST_WORDS)
            return
        leaves = ([pub] if isinstance(pub, torch.Tensor) else
                  [getattr(pub, f.name) for f in dataclasses.fields(pub)])
        self.mix_elems(torch.cat([x.reshape(-1) for x in leaves]))

    def _next(self) -> int:
        if not self._queue:
            self._queue = P254.squeeze_bb(self.state[0])
            self.state = P254.permute(self.state)
        return self._queue.pop(0)

    def sample_elem(self):
        return F.const(self._next(), self.device)

    def sample_ext(self):
        return F.fp([self._next() for _ in range(4)], self.device)

    def _u32(self) -> int:
        a, b = self._next(), self._next()
        return (a & 0xFFFF) | ((b & 0xFFFF) << 16)

    def sample_u32(self):
        """A 32-bit word from two squeezed elements (int64 tensor)."""
        return torch.tensor(self._u32(), dtype=torch.int64,
                            device=self.device)

    def sample_indices(self, count: int, bits: int):
        """count indices in [0, 2^bits), int64 tensor (count,)."""
        mask = (1 << bits) - 1
        return torch.tensor([self._u32() & mask for _ in range(count)],
                            dtype=torch.int64, device=self.device)


SUITES = {
    "poseidon2": Poseidon2Suite(),
    "poseidon254": Poseidon254Suite(),
}


def get(name: str):
    return SUITES[name]
