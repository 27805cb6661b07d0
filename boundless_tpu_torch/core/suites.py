"""Hash-suite abstraction for the STARK prover/verifier.

Counterpart of `boundless_tpu/core/suites.py`. Only the Baby Bear
Poseidon2 suite is ported; the BN254 `poseidon254` suite (the Groth16-
facing final-shrink proof) is still to port (ROADMAP.md).
"""

from __future__ import annotations

from . import merkle as M
from .transcript import Transcript


class Poseidon2Suite:
    name = "poseidon2"

    def commit(self, matrix) -> M.MerkleTree:
        return M.commit(matrix)

    def verify_rows(self, root, indices, rows, paths):
        return M.verify_rows(root, indices, rows, paths)

    def transcript(self, device="cpu"):
        return Transcript(device)


SUITES = {"poseidon2": Poseidon2Suite()}


def get(name: str):
    return SUITES[name]
