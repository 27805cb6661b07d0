"""Fulfillment aggregation: batches, Merkle set-builder, assessor.

The port's copy of `boundless_tpu/market/batcher.py`.

Re-design of the reference aggregation stack (SURVEY §3.3):
`Risc0BatchProcessor` (`crates/risc0-backend/src/batch.rs:94-140`) builds a
batch of per-order claims, proves the **assessor** over the signed
requests, folds everything into a **set-builder Merkle root**, and the
Submitter lands one `submitRootAndFulfill` tx
(`contracts/src/BoundlessMarket.sol:737-786`). Here:

  * `Batch`/`BatchProcessor` implement the Backend trait's
    estimate/update/close lifecycle (`crates/boundless-backend/src/
    types.rs:377-441`), with opaque resumable state.
  * The set is a sha256 binary Merkle tree over per-fill leaves
    (request-id digest + claim digest + journal digest).
  * The assessor checks each fill against its signed request
    (signature, predicate, image id) and attests to the root —
    dev-mode host attestation now; the in-guest assessor (run on our own
    zkVM) is staged with the recursion circuit work.
  * `MarketChain.submit_root_and_fulfill` verifies inclusion proofs
    against the attested root — one seal verification per batch instead
    of per fill.
"""

from __future__ import annotations

import dataclasses
import hashlib

from typing import List, Optional, Tuple

from .chain import MarketChain, MarketError
from .types import Fulfillment, ProofRequest


def _h(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def fill_leaf(request_id: str, claim_digest: bytes, journal: bytes) -> bytes:
    return _h(b"leaf:" + request_id.encode() + claim_digest
              + _h(journal))


def merkle_root(leaves: List[bytes]) -> bytes:
    if not leaves:
        return _h(b"empty")
    level = list(leaves)
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [_h(b"node:" + level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
    return level[0]


def merkle_path(leaves: List[bytes], index: int) -> List[bytes]:
    path = []
    level = list(leaves)
    idx = index
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        sib = idx ^ 1
        path.append(level[sib])
        level = [_h(b"node:" + level[i] + level[i + 1])
                 for i in range(0, len(level), 2)]
        idx //= 2
    return path


def merkle_verify(root: bytes, leaf: bytes, index: int,
                  path: List[bytes]) -> bool:
    cur = leaf
    idx = index
    for sib in path:
        pair = (sib + cur) if idx & 1 else (cur + sib)
        cur = _h(b"node:" + pair)
        idx //= 2
    return cur == root


@dataclasses.dataclass
class AssessorReceipt:
    """The assessor GUEST's attestation that every fill in the set
    satisfies its signed request (reference AssessorJournal/
    AssessorReceipt). `journal` is the guest's committed AssessorJournal
    analogue — it binds each fill's app claim digest, predicate kind,
    EIP-712 request digest and recovered signer address. `dev_mode=True`
    means the guest was EXECUTED but not proven (reference
    RISC0_DEV_MODE); the production path attaches the proven session
    receipt (`session`), whose journal must equal `journal`."""

    root: bytes
    prover: str
    dev_mode: bool
    journal: bytes = b""
    session: object = None  # SuccinctSessionReceipt when proven


def assessor_guest_input(fills: List[Tuple[ProofRequest, bytes,
                                           "Fulfillment"]]) -> bytes:
    """Build the assessor GUEST's input stream (zkvm/guests.assessor).

    Per fill: 8 LE words of the app claim digest (each VERIFY'd by the
    guest, binding the app proof as an assumption), the predicate kind,
    and for prefix predicates the interleaved journal/expected words.
    CLAIM_MATCH maps to kind 0 (the VERIFY binding is the whole check);
    PREFIX_MATCH to kind 1; DIGEST_MATCH (sha256) has no in-guest form
    yet and must stay on the host path.
    """
    from ..zkvm.guests import words
    from .types import PredicateType

    def _w(b: bytes) -> List[int]:
        b = b + b"\0" * (-len(b) % 4)
        return [int.from_bytes(b[i : i + 4], "little")
                for i in range(0, len(b), 4)]

    out = [len(fills)]
    for req, _sig, fill in fills:
        pred = req.requirements.predicate
        digest_words = _w(fill.claim_digest)
        assert len(digest_words) == 8
        out += digest_words
        if pred.kind == PredicateType.PREFIX_MATCH:
            jw, ew = _w(fill.journal), _w(pred.data)
            # word-aligned prefix compare (sub-word tails take the whole
            # word: the builder only emits byte-aligned predicates)
            out += [1, len(jw), len(ew)]
            for i, w in enumerate(jw):
                out.append(w)
                if i < len(ew):
                    out.append(ew[i])
        elif pred.kind == PredicateType.CLAIM_MATCH:
            out.append(0)
        else:
            raise MarketError(
                "assessor guest: DIGEST_MATCH requires the host path")
    return words(out)


def assessor_guest_input_v2(fills: List[Tuple[ProofRequest, bytes,
                                              "Fulfillment"]]) -> bytes:
    """Input stream for the PRODUCTION assessor guest
    (zkvm/secp256k1_guest.assessor_ecdsa): per fill, the app claim
    digest, the predicate (claim / prefix / keccak-digest), and the
    request's ECDSA signature material — digest z, (r, s, v), and the
    client address the recovery must land on. The guest verifies the
    signature with in-guest secp256k1 (reference
    assessor-guest/src/main.rs:58-66)."""
    from ..zkvm import secp256k1_guest as sg
    from ..zkvm.guests import words
    from .types import PredicateType

    def _w(b: bytes) -> List[int]:
        b = b + b"\0" * (-len(b) % 4)
        return [int.from_bytes(b[i : i + 4], "little")
                for i in range(0, len(b), 4)]

    out = [len(fills)]
    for req, sig, fill in fills:
        pred = req.requirements.predicate
        digest_words = _w(fill.claim_digest)
        assert len(digest_words) == 8
        out += digest_words
        if pred.kind == PredicateType.PREFIX_MATCH:
            jw, ew = _w(fill.journal), _w(pred.data)
            out += [1, len(jw), len(ew)]
            for i, w in enumerate(jw):
                out.append(w)
                if i < len(ew):
                    out.append(ew[i])
        elif pred.kind == PredicateType.CLAIM_MATCH:
            out.append(0)
        else:  # DIGEST_MATCH: keccak-256(journal) == data, in-guest
            if len(fill.journal) % 4:
                # zkVM journals are word streams by construction; the
                # guest hashes whole words
                raise MarketError(
                    "assessor guest: DIGEST_MATCH journal must be "
                    "word-aligned")
            jw = _w(fill.journal)
            if len(jw) > sg.JBUF_WORDS:
                raise MarketError("assessor guest: journal too long")
            out += [2, len(jw)] + jw + _w(pred.data)
        if len(sig) != 65:
            raise MarketError("assessor guest: malformed signature")
        z = int.from_bytes(req.signing_digest(), "big")
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        addr = bytes.fromhex(req.id.client[2:])
        out += sg.int_words(z) + sg.int_words(r) + sg.int_words(s)
        out += [sig[64]]
        out += _w(addr)
    return words(out)


def expected_assessor_journal(fills) -> bytes:
    """The journal the assessor guest commits for these fills (host
    mirror; receipt verification recomputes and compares)."""
    from ..zkvm import secp256k1_guest as sg
    from ..zkvm.guests import words
    from .types import PredicateType

    kind_of = {PredicateType.CLAIM_MATCH: 0, PredicateType.PREFIX_MATCH: 1,
               PredicateType.DIGEST_MATCH: 2}

    def _w(b: bytes) -> List[int]:
        b = b + b"\0" * (-len(b) % 4)
        return [int.from_bytes(b[i : i + 4], "little")
                for i in range(0, len(b), 4)]

    out = [len(fills)]
    for req, _sig, fill in fills:
        out += _w(fill.claim_digest)
        out.append(kind_of[req.requirements.predicate.kind])
        out += sg.int_words(int.from_bytes(req.signing_digest(), "big"))
        out += _w(bytes.fromhex(req.id.client[2:]))
    return words(out)


class Assessor:
    """Runs the assessor GUEST over the fills and attests to the set root
    (reference `crates/assessor` + assessor-guest/src/main.rs:24-115).

    Every check lives in the guest (zkvm/secp256k1_guest.assessor_ecdsa):
    in-guest secp256k1 recovery of the request's EIP-712 signature
    against its client address, predicate enforcement (claim / prefix /
    keccak digest), and VERIFY-binding of each fill's app claim digest.
    A wrongly-signed fill makes the guest FAULT — no execution, no
    journal, no proof exists (the reference guest's panic semantics).

    `prover_fn(image, input_bytes) -> SuccinctSessionReceipt` is the
    optional proving hook (cluster-backed); without it receipts are
    dev-mode (executed natively, unproven). `session_verifier(session,
    image_id)` verifies a proven session receipt at consumption time.
    """

    def __init__(self, prover_fn=None, session_verifier=None):
        self.prover_fn = prover_fn
        self.session_verifier = session_verifier

    def guest_session(self, fills: List[Tuple[ProofRequest, bytes,
                                              "Fulfillment"]]):
        """(image, input) of the production assessor guest session."""
        from ..zkvm import secp256k1_guest as sg

        return sg.assessor_ecdsa(), assessor_guest_input_v2(fills)

    def assess(self, fills: List[Tuple[ProofRequest, bytes, Fulfillment]],
               prover: str) -> AssessorReceipt:
        from ..zkvm.executor import GuestFault, fast_execute

        image, input_bytes = self.guest_session(fills)
        try:
            _cycles, code, journal = fast_execute(image, input_bytes)
        except GuestFault as e:
            raise MarketError(f"assessor guest faulted: {e}") from e
        if code != 0:
            raise MarketError(f"assessor guest exit code {code}")
        if journal != expected_assessor_journal(fills):
            raise MarketError("assessor journal mismatch")
        leaves = [fill_leaf(req.id.encoded(), fill.claim_digest,
                            fill.journal) for req, _sig, fill in fills]
        root = merkle_root(leaves)
        session = None
        if self.prover_fn is not None:
            session = self.prover_fn(image, input_bytes)
            if bytes(session.journal) != journal:
                raise MarketError("assessor session journal mismatch")
        return AssessorReceipt(root=root, prover=prover,
                               dev_mode=session is None, journal=journal,
                               session=session)

    def verify(self, receipt: AssessorReceipt, fills) -> bool:
        """Receipt consumption check: the journal must re-derive from the
        fills (binding requests, predicates, signers and app claims), and
        a proven receipt's session must verify against the assessor
        image."""
        if receipt.journal != expected_assessor_journal(fills):
            return False
        leaves = [fill_leaf(req.id.encoded(), fill.claim_digest,
                            fill.journal) for req, _sig, fill in fills]
        if receipt.root != merkle_root(leaves):
            return False
        if receipt.dev_mode:
            return True
        if receipt.session is None or self.session_verifier is None:
            return False
        if bytes(receipt.session.journal) != receipt.journal:
            return False
        from ..zkvm import secp256k1_guest as sg

        return bool(self.session_verifier(receipt.session,
                                          sg.assessor_ecdsa()))


@dataclasses.dataclass
class Batch:
    """One aggregation batch with resumable opaque state
    (reference BackendBatchState)."""

    fills: List[Tuple[ProofRequest, bytes, Fulfillment]] = \
        dataclasses.field(default_factory=list)
    closed: bool = False
    root: Optional[bytes] = None
    assessor_receipt: Optional[AssessorReceipt] = None

    def state(self) -> dict:
        return dict(n=len(self.fills), closed=self.closed,
                    root=self.root.hex() if self.root else None)


class BatchProcessor:
    """estimate_batch_size / update_batch / close_batch lifecycle."""

    def __init__(self, assessor: Assessor, prover_addr: str,
                 max_batch: int = 8):
        self.assessor = assessor
        self.prover_addr = prover_addr
        self.max_batch = max_batch

    def estimate_batch_size(self, pending: int) -> int:
        return min(pending, self.max_batch)

    def update_batch(self, batch: Batch,
                     fill: Tuple[ProofRequest, bytes, Fulfillment]) -> Batch:
        assert not batch.closed
        batch.fills.append(fill)
        if len(batch.fills) >= self.max_batch:
            return self.close_batch(batch)
        return batch

    def close_batch(self, batch: Batch) -> Batch:
        batch.assessor_receipt = self.assessor.assess(batch.fills,
                                                      self.prover_addr)
        batch.root = batch.assessor_receipt.root
        batch.closed = True
        return batch

    def submission(self, batch: Batch):
        """(root, assessor_receipt, [(req, sig, fill, index, path)]) for
        the chain (requests ride along so the consumer can re-derive the
        assessor journal)."""
        assert batch.closed
        leaves = [fill_leaf(req.id.encoded(), f.claim_digest, f.journal)
                  for req, _, f in batch.fills]
        return (batch.root, batch.assessor_receipt,
                [(req, sig, f, i, merkle_path(leaves, i))
                 for i, (req, sig, f) in enumerate(batch.fills)])


def submit_root_and_fulfill(chain: MarketChain, assessor: Assessor,
                            root: bytes, assessor_receipt: AssessorReceipt,
                            entries) -> None:
    """Batch fulfillment: one assessor verification + per-fill Merkle
    inclusion (reference BoundlessMarket.submitRootAndFulfill :742-786)."""
    fill_tuples = [(req, sig, fill) for req, sig, fill, _i, _p in entries]
    if assessor_receipt.root != root or \
            not assessor.verify(assessor_receipt, fill_tuples):
        raise MarketError("bad assessor receipt")
    fills = []
    for _req, _sig, fill, index, path in entries:
        leaf = fill_leaf(fill.request_id.encoded(), fill.claim_digest,
                         fill.journal)
        if not merkle_verify(root, leaf, index, path):
            raise MarketError("merkle inclusion failed")
        fills.append(fill)
    # inclusion + assessor replace per-fill seal verification, for these
    # fills alone (the reference swaps chain.verifier for the call, which a
    # concurrent per-fill fulfill on the same chain would meet)
    chain.fulfill(fills, verifier=lambda f, r: True)
