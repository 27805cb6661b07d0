"""identity_p254: the Groth16-facing final-shrink proof.

Counterpart of `boundless_tpu/recursion/identity.py`, on the port's
prover. Reference: risc0's `identity_p254` recursion program — the last
hop before the Groth16 wrap re-proves the root claim with a BN254-native
hash so the wrap circuit can verify it with native-field Poseidon
(`blake3_groth16/src/prove.rs:33-62`).

A recursion-VM program that verifies ONE root recursion receipt
in-circuit (Baby Bear hashing — cheap hash gates) and re-pins its claim
digest / allowed root to its own public values. The OUTER STARK of this
program is proven under the `poseidon254` hash suite (core/suites.py):
its Merkle trees and Fiat-Shamir transcript are BN254-native Poseidon, so
the Groth16 verifier circuit (groth16/circuit.py) re-derives every hash
at ~240 constraints per permutation instead of emulating Baby Bear
Poseidon2. On the card every Merkle hash of the proof runs through the
p254 sponge kernel (`kernels/poseidon254.py`); RecursionAir takes the
eager quotient as in every recursion proof. `seconds` holds the host
clock of the set-up stages (`program_build`, `control_id`) and of the
latest `verify`; a shrink runs under the tracer's span `rec.shrink`
(`utils/profiling.py`) with children `rec.witness`, `rec.native_eval`
and `rec.prove`.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict

from ..kernels import poseidon254 as P254K
from ..prover import stark
from ..utils import profiling
from . import air as rair
from . import claims, succinct, vm


def build_identity(rec_po2: int, rec_ps: stark.ProofSystem) -> vm.Prog:
    """Verify one recursion receipt; own publics mirror the child's.

    Witness order: one succinct._child_witness stream.
    """
    p = vm.Prog(f"identity-p{rec_po2}q{rec_ps.queries}"
                f"e{rec_ps.commit_expand}")
    pub_w, _ctrl, _cw = succinct._verify_child(p, rec_po2, rec_ps)
    # own claim == child claim (groups 2-5 already pinned to own pubs by
    # _verify_child: allowed-root pass-through + zero spares)
    p.assert_eq(pub_w[0], p.pub(0))
    p.assert_eq(pub_w[1], p.pub(1))
    return p


@dataclasses.dataclass
class P254Receipt:
    """The final-shrink receipt: one RecursionAir STARK under the
    poseidon254 suite, binding (claim digest, allowed root)."""

    proof: stark.SegmentProof
    claim: claims.Claim
    pub_vals: tuple  # 24 canonical scalars (same layout as RecReceipt)
    po2: int


class P254System:
    """Builds/runs identity_p254 for one SuccinctSystem parameterization,
    on the system's device (the card unless it was made for the CPU).

    The outer proof system is the recursion proof system with the hash
    suite swapped to poseidon254; `control_id` is the p254-suite control
    root of the identity program (8 u32 words) — the value the Groth16
    verifying key pins (risc0's identity_p254 control id).
    """

    def __init__(self, system: succinct.SuccinctSystem):
        self.system = system
        self.device = system.device
        self.seconds: Dict[str, float] = {}
        params = system.params
        self.ps254 = dataclasses.replace(params.rec_ps, hash="poseidon254")
        t0 = time.perf_counter()
        self.prog = build_identity(params.rec_po2, params.rec_ps)
        # identity is consumed only by the Groth16 wrap (nothing verifies
        # it inside the recursion lattice), so it gets its own po2: the
        # smallest that fits — a smaller outer proof means a smaller wrap
        # circuit (Merkle depth scales with it).
        self.po2 = max(8, (len(self.prog.rows) + 1).bit_length())
        n = 1 << self.po2
        self.prog.finalize(n)
        self.rom = rair.rom_trace(self.prog, n, self.device)
        self.seconds["program_build"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        root = stark.control_root_of(rair.AIR, self.po2, self.rom,
                                     self.ps254)
        self.control_id = tuple(int(x) for x in P254K.words_np(root))
        self.seconds["control_id"] = time.perf_counter() - t0

    def shrink(self, root: succinct.RecReceipt) -> P254Receipt:
        """Root recursion receipt -> p254 final-shrink receipt."""
        sys_ = self.system  # its spans wait for this system's device
        with sys_._span("rec.shrink"):
            with profiling.span("rec.witness"):
                wit = succinct._child_witness(
                    root, sys_._kind_index(root.kind), sys_.allowed_ids,
                    sys_.params.rec_ps)
                pub_vals = tuple(root.pub_vals)
            with sys_._span("rec.native_eval"):
                data = rair.data_trace(self.prog, wit, pub_vals, self.device)
            with sys_._span("rec.prove"):
                proof = stark.prove(rair.AIR, data,
                                    rair.pub_array(pub_vals, self.device),
                                    self.po2, self.ps254, self.rom)
        return P254Receipt(proof=proof, claim=root.claim,
                           pub_vals=pub_vals, po2=self.po2)

    def verify(self, r: P254Receipt) -> bool:
        """One p254-suite STARK + claim/pub binding (constant work; no
        inner-receipt re-verification — the identity program did that
        in-circuit), on the device the proof lives on."""
        expected = tuple(list(r.claim.digest())
                         + list(self.system.allowed_root) + [0] * 8)
        if tuple(r.pub_vals) != expected:
            return False
        t0 = time.perf_counter()
        dev = r.proof.data_root.device
        # p254 digests are raw 254-bit words, NOT Baby Bear Montgomery
        root = P254K.words_tensor(self.control_id, dev)
        ok = bool(stark.verify(rair.AIR, r.proof,
                               rair.pub_array(r.pub_vals, dev), r.po2, root,
                               self.ps254))
        self.seconds["verify"] = time.perf_counter() - t0
        return ok


@functools.lru_cache(maxsize=4)
def get_p254(system: succinct.SuccinctSystem) -> P254System:
    """The identity system of a recursion system (built once per system:
    the reference keys it by the system's params, `identity.py:117`)."""
    return P254System(system)
