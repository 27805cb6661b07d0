"""STARK -> SNARK wrap (Groth16 / blake3-journal Groth16).

Counterpart of `boundless_tpu/groth16/wrap.py`, over the port's
`succinct.SuccinctSystem`: the identity_p254 shrink runs on the system's
device (the card unless the system was made for the CPU), every p254
Merkle hash through the CUDA sponge, and the CRS prover's MSMs through
the CUDA Pippenger (`qap.prove_sparse(device=)`). A `WrapKey`'s `seconds`
holds the host clock of its stages: `r1cs_layout` and `setup` when it was
built, `concrete_build` and `prove` of the latest compress over it (the
identity shrink's are the tracer's `rec.shrink` span and its children,
`utils/profiling.py`). The prover mode
(`_prover_mode`) reads one setting, BT_GROTH16_CRS (a ceremony CRS file),
and otherwise the 200,000-variable line.

Reference shape: `tasks/snark.rs:44-71` — `compress(ProverOpts::groth16())`
or `blake3_groth16::compress_blake3_groth16` (identity_p254 -> witness ->
BN254 Groth16 via CUDA/rapidsnark).

The REAL path (succinct sessions): root recursion receipt ->
identity_p254 final shrink (recursion/identity.py; outer proof under the
BN254-native poseidon254 suite) -> the R1CS verifier circuit
(groth16/circuit.py) -> Groth16 proof over the dev CRS (groth16/qap.py).
The produced receipt has `dev_mode=False`: verification is the PAIRING
CHECK plus claim-structure bindings — no STARK re-verification anywhere.
The CRS is a locally-generated dev setup (trapdoor kept for the O(nnz)
prover; production substitutes a ceremony zkey + the MSM prover, same
proof format).

The legacy dev-mode attestation path remains for v1 aggregation
receipts and DevModeSystem sessions (`dev_mode=True`, full inner receipt
carried and re-verified).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

from ..recursion.receipt import SessionReceipt

# Seal selectors (reference `crates/boundless-market/src/selector.rs:64-92`).
SELECTOR_GROTH16 = "0x73c457ba"  # Groth16V3_0
SELECTOR_BLAKE3_GROTH16 = "0x62f049f6"  # Blake3Groth16V0_1
SELECTOR_DEV_MODE = "0xdeadbeef"


@dataclasses.dataclass
class Groth16Seal:
    """The real wrap seal: one Groth16 proof + its public felts, plus
    the claim it binds (the claim digest IS public input 0, so every
    claim field is proof-bound)."""

    proof: object  # qap.Proof (A, B, C points)
    vk: object  # protocol.VerifyingKey (dev CRS; production pins this)
    publics: tuple  # 3 felts: pack(claim digest), pack(allowed root), 0
    claim: object  # recursion.claims.Claim
    entry_pc: int
    image_mem_root: Optional[tuple]
    allowed_root: tuple


@dataclasses.dataclass
class Groth16Receipt:
    kind: str  # "groth16" | "blake3_groth16"
    selector: str
    claim_digest: bytes
    journal: bytes
    image_id: tuple
    dev_mode: bool
    inner: object  # real: Groth16Seal; dev: the carried session receipt

    def seal_bytes(self) -> bytes:
        jd = (journal_digest_blake3_style(self.journal)
              if self.kind == "blake3_groth16"
              else hashlib.sha256(self.journal).digest())
        return (bytes.fromhex(self.selector[2:]) + self.claim_digest + jd)


def journal_digest_blake3_style(journal: bytes) -> bytes:
    """Journal digest for the blake3_groth16 flavor: REAL BLAKE3
    (core/blake3.py; matches the reference's `blake3` crate —
    `blake3_groth16/src/receipt.rs`)."""
    from ..core import blake3

    return blake3.digest(journal)


def _verify_session(session, system=None) -> bool:
    """Verify either session-receipt flavor: v1 `SessionReceipt` (self-
    verifying) or `succinct.SuccinctSessionReceipt` (needs the recursion
    system that issued it)."""
    if isinstance(session, SessionReceipt):
        return session.verify()
    from ..recursion import succinct as _succ

    if system is None:
        raise ValueError("succinct session receipt needs `system` to verify")
    return _succ.verify_session(session, system)


def _claim_digest_bytes(session) -> bytes:
    cd = session.root.claim_digest()
    if isinstance(cd, bytes):
        return cd
    from ..recursion import claims as _claims

    return _claims.digest_bytes(cd)


# ---------------------------------------------------------------------------
# Real wrap machinery (per-recursion-system, cached)
# ---------------------------------------------------------------------------

_WRAP_KEYS = {}


@dataclasses.dataclass
class WrapKey:
    td: object  # qap.Trapdoor (dev CRS); None in MSM/ceremony mode
    vk: object  # protocol.VerifyingKey
    n_rows: int
    n_vars: int
    pk: object = None  # protocol.ProvingKey (MSM prover path)
    mode: str = "trapdoor"  # the prover mode taken (_prover_mode)
    seconds: dict = dataclasses.field(default_factory=dict)


def _prover_mode(n_vars: Optional[int] = None) -> str:
    """crs (BT_GROTH16_CRS=<path>) | msm | trapdoor.

    A ceremony CRS named by BT_GROTH16_CRS takes the CRS + Pippenger-MSM
    prover. Without it, a layout of at most MSM_SETUP_MAX_VARS variables
    takes the same prover over a locally generated CRS (cached on disk
    under the temporary directory, per layout). Local generation is
    O(n_vars) host scalar-muls, so above that line the TRAPDOOR prover is
    used instead and a warning names the CRS path: the wrap circuit is
    ~4.3M variables at CI scale, and the reference faces the same wall —
    its production prover INGESTS a fetched ceremony zkey
    (`xtask/src/setup_blake3_groth16.rs`); it never generates a CRS
    locally either. BT_GROTH16_CRS is the only setting read; the
    reference's BT_GROTH16_PROVER and BT_GROTH16_CACHE are not carried."""
    import os

    if os.environ.get("BT_GROTH16_CRS"):
        return "crs"
    if n_vars is not None and n_vars > MSM_SETUP_MAX_VARS:
        import logging

        logging.getLogger(__name__).warning(
            "groth16: wrap circuit has %d variables — local CRS "
            "generation is infeasible at this scale; falling back to "
            "the trapdoor prover. Provide a ceremony CRS via "
            "BT_GROTH16_CRS for the production MSM path.", n_vars)
        return "trapdoor"
    return "msm"


# Largest layout for which a local (dev) CRS is generated by default:
# setup_sparse costs O(n_vars) host scalar multiplications.
MSM_SETUP_MAX_VARS = 200_000


def wrap_key_for(p254) -> WrapKey:
    """Build (once per identity system) the wrap circuit layout + CRS.
    Layout mode emits the identical constraint sequence the concrete
    prover walks, so the keys match every proof."""
    key = (p254.system.params, tuple(p254.control_id))
    if key in _WRAP_KEYS:
        return _WRAP_KEYS[key]
    from ..recursion import air as rair
    from . import circuit as C
    from . import qap, r1cs

    t0 = time.perf_counter()
    bld = r1cs.Builder(concrete=False)
    C.build_verifier(bld, rair.AIR, p254.po2, p254.ps254,
                     p254.control_id, proof=None, pub_vals=None)
    sys_ = bld.to_sparse()
    layout_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mode = _prover_mode(sys_.n_vars)
    if mode == "crs":
        import os

        from . import crs as crs_mod

        pk, vk, meta = crs_mod.load_crs(os.environ["BT_GROTH16_CRS"])
        assert (meta.n_rows, meta.n_vars) == (len(sys_.rows),
                                              sys_.n_vars), \
            "CRS file does not match the wrap circuit layout"
        wk = WrapKey(td=None, vk=vk, n_rows=meta.n_rows,
                     n_vars=meta.n_vars, pk=pk, mode=mode)
    elif mode == "msm":
        # local CRS, cached on disk per circuit layout (the ceremony-CRS
        # deployment shape without the ceremony): setup once, reuse
        import hashlib as _hl
        import os
        import tempfile

        from . import crs as crs_mod

        cache_dir = os.path.join(tempfile.gettempdir(), "bt_groth16_crs")
        os.makedirs(cache_dir, exist_ok=True)
        tag = _hl.sha256(
            f"{len(sys_.rows)}:{sys_.n_vars}:{sys_.n_pub}:"
            f"{tuple(p254.control_id)}".encode()).hexdigest()[:16]
        path = os.path.join(cache_dir, f"wrap-{tag}.btzk")
        if os.path.exists(path):
            pk, vk, meta = crs_mod.load_crs(path)
            assert (meta.n_rows, meta.n_vars) == (len(sys_.rows),
                                                  sys_.n_vars)
        else:
            pk, vk = qap.setup_sparse(sys_)
            crs_mod.save_crs(path, pk, vk,
                             crs_mod.CrsMeta(n_rows=len(sys_.rows),
                                             n_vars=sys_.n_vars,
                                             n_pub=sys_.n_pub))
        wk = WrapKey(td=None, vk=vk, n_rows=len(sys_.rows),
                     n_vars=sys_.n_vars, pk=pk, mode=mode)
    else:
        td, vk = qap.setup_trapdoor(sys_)
        wk = WrapKey(td=td, vk=vk, n_rows=len(sys_.rows),
                     n_vars=sys_.n_vars, mode=mode)
    wk.seconds.update(r1cs_layout=layout_s, setup=time.perf_counter() - t0)
    _WRAP_KEYS[key] = wk
    return wk


def _real_compress(session, kind: str, system) -> Groth16Receipt:
    from ..core import poseidon_bn254 as P254
    from ..recursion import air as rair
    from ..recursion import identity
    from . import circuit as C
    from . import qap, r1cs

    p254 = identity.get_p254(system)
    shr = p254.shrink(session.root)
    if not p254.verify(shr):
        raise ValueError("identity_p254 shrink failed verification")
    wk = wrap_key_for(p254)
    t0 = time.perf_counter()
    bld = r1cs.Builder(concrete=True)
    C.build_verifier(bld, rair.AIR, p254.po2, p254.ps254,
                     p254.control_id, proof=shr.proof,
                     pub_vals=shr.pub_vals)
    sys_ = bld.to_sparse()
    assert len(sys_.rows) == wk.n_rows and sys_.n_vars == wk.n_vars, \
        "wrap circuit layout drifted from the CRS"
    t1 = time.perf_counter()
    if wk.pk is not None:
        # production-shaped prover: coset-NTT QAP division + Pippenger
        # MSMs over the CRS (no trapdoor anywhere in the process)
        proof = qap.prove_sparse(sys_, wk.pk, bld.witness(),
                                 device=system.device)
    else:
        proof = qap.prove_with_trapdoor(sys_, wk.td, bld.witness())
    wk.seconds.update(concrete_build=t1 - t0, prove=time.perf_counter() - t1)
    pv = [int(x) for x in shr.pub_vals]
    publics = tuple(P254.pack_bb(pv[8 * i : 8 * i + 8]) for i in range(3))
    seal = Groth16Seal(proof=proof, vk=wk.vk, publics=publics,
                       claim=shr.claim, entry_pc=session.entry_pc,
                       image_mem_root=getattr(session, "image_mem_root",
                                              None),
                       allowed_root=tuple(system.allowed_root))
    return Groth16Receipt(
        kind=kind,
        selector=(SELECTOR_GROTH16 if kind == "groth16"
                  else SELECTOR_BLAKE3_GROTH16),
        claim_digest=_claim_digest_bytes(session),
        journal=session.journal,
        image_id=session.image_id,
        dev_mode=False,
        inner=seal)


def compress(session, kind: str = "groth16", system=None) -> Groth16Receipt:
    assert kind in ("groth16", "blake3_groth16")
    if not _verify_session(session, system):
        raise ValueError("cannot wrap: stark receipt fails verification")
    from ..recursion import succinct as _succ

    if (system is not None and isinstance(system, _succ.SuccinctSystem)
            and isinstance(session, _succ.SuccinctSessionReceipt)):
        return _real_compress(session, kind, system)
    # legacy/dev attestation (v1 aggregation receipts, DevModeSystem)
    return Groth16Receipt(
        kind=kind,
        selector=(SELECTOR_GROTH16 if kind == "groth16"
                  else SELECTOR_BLAKE3_GROTH16),
        claim_digest=_claim_digest_bytes(session),
        journal=session.journal,
        image_id=session.image_id,
        dev_mode=True,
        inner=session)


def verify(receipt: Groth16Receipt, expected_image_id=None,
           system=None) -> bool:
    if expected_image_id is not None and tuple(
            int(x) for x in expected_image_id) != tuple(receipt.image_id):
        return False
    if receipt.dev_mode:
        inner = receipt.inner
        return (inner.journal == receipt.journal
                and _claim_digest_bytes(inner) == receipt.claim_digest
                and _verify_session(inner, system))
    return _verify_real(receipt, system)


def _verify_real(receipt: Groth16Receipt, system=None) -> bool:
    """Pairing-only verification of the real seal (reference
    `blake3_groth16/src/verify.rs:63-124`): one Groth16 pairing check +
    claim-structure bindings. NO STARK is re-verified — the wrap circuit
    proved the identity_p254 STARK, which proved the root recursion
    receipt, which proved the whole session."""
    from ..core import poseidon_bn254 as P254
    from ..recursion import claims as _claims
    from . import protocol

    seal: Groth16Seal = receipt.inner
    c = seal.claim
    # claim digest binds every claim field; it must match the receipt's
    # digest bytes AND public input 0
    digest = c.digest()
    if _claims.digest_bytes(digest) != receipt.claim_digest:
        return False
    if seal.publics[0] != P254.pack_bb(list(digest)):
        return False
    # allowed root: the recursion lattice this proof closed over
    want_root = (tuple(system.allowed_root) if system is not None
                 else tuple(seal.allowed_root))
    if seal.publics[1] != P254.pack_bb(list(want_root)):
        return False
    if seal.publics[2] != 0:
        return False
    # session-level claim checks (mirror succinct.verify_session)
    if c.image_id != tuple(int(x) for x in receipt.image_id):
        return False
    if not c.halted or not c.is_genesis(seal.entry_pc,
                                        seal.image_mem_root):
        return False
    if c.post_assumptions != _claims.ZERO_CHAIN:
        return False
    if len(receipt.journal) % 4:
        return False
    words = [int.from_bytes(receipt.journal[i : i + 4], "little")
             for i in range(0, len(receipt.journal), 4)]
    if _claims.fold_words(_claims.ZERO_CHAIN, words) != c.post_journal:
        return False
    # THE pairing check
    return protocol.verify(seal.vk, seal.proof, [s % protocol.R
                                                 for s in seal.publics])
