"""Market data types: proof requests, offers, requirements, fulfillments.

The port's copy of `boundless_tpu/market/types.py`.

Python re-design of the reference's market types (`crates/boundless-market/
src/contracts/` + `contracts/src/types/*.sol`): `ProofRequest`, reverse-
Dutch-auction `Offer` (types/Offer.sol), `Requirements`/`Predicate`
(types/Predicate.sol), flagged `RequestId` (types/RequestId.sol),
`Fulfillment`, and the EIP-712-style structured signing digest.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
from typing import Optional

DOMAIN = "boundless-tpu.market.v1"


class PredicateType(enum.Enum):
    DIGEST_MATCH = "digest_match"  # journal digest equals
    PREFIX_MATCH = "prefix_match"  # journal starts with
    CLAIM_MATCH = "claim_match"  # claim digest equals


@dataclasses.dataclass(frozen=True)
class Predicate:
    kind: PredicateType
    data: bytes

    def eval(self, journal: bytes, claim_digest: bytes) -> bool:
        if self.kind == PredicateType.DIGEST_MATCH:
            # keccak-256: the canonical journal digest of this market
            # spec — chosen so the assessor GUEST can enforce it through
            # the proven keccak coprocessor (zkvm/secp256k1_guest.kec256)
            # instead of an in-guest sha256 (the reference's choice on
            # risc0, where sha256 is the accelerated primitive).
            from . import crypto as C

            return C.keccak256(journal) == self.data
        if self.kind == PredicateType.PREFIX_MATCH:
            return journal.startswith(self.data)
        return claim_digest == self.data

    @staticmethod
    def digest_match(journal: bytes) -> "Predicate":
        from . import crypto as C

        return Predicate(PredicateType.DIGEST_MATCH, C.keccak256(journal))

    @staticmethod
    def prefix_match(prefix: bytes) -> "Predicate":
        return Predicate(PredicateType.PREFIX_MATCH, prefix)


@dataclasses.dataclass(frozen=True)
class Requirements:
    image_id: str  # hex image id the proof must attest to
    predicate: Predicate
    callback: Optional[str] = None  # contract address to invoke on fulfill
    selector: Optional[str] = None  # required seal selector (proof kind)


@dataclasses.dataclass(frozen=True)
class Offer:
    """Reverse Dutch auction (reference types/Offer.sol)."""

    min_price: int  # wei at auction start
    max_price: int  # wei at ramp end
    bidding_start: float  # unix seconds
    ramp_up_period: float  # seconds from start to max price
    lock_timeout: float  # seconds a lock is valid for
    timeout: float  # request expiry (seconds after bidding_start)
    lock_collateral: int  # prover collateral to lock

    def price_at(self, t: float) -> int:
        if t < self.bidding_start:
            return self.min_price
        dt = t - self.bidding_start
        if dt >= self.ramp_up_period:
            return self.max_price
        frac = dt / self.ramp_up_period if self.ramp_up_period else 1.0
        return int(self.min_price + (self.max_price - self.min_price) * frac)

    def expires_at(self) -> float:
        return self.bidding_start + self.timeout

    def lock_deadline(self) -> float:
        return self.bidding_start + self.lock_timeout


@dataclasses.dataclass(frozen=True)
class RequestId:
    """Address + index + flags (reference types/RequestId.sol)."""

    client: str
    index: int
    smart_contract_signed: bool = False

    def encoded(self) -> str:
        flag = 1 if self.smart_contract_signed else 0
        return f"{self.client}:{self.index}:{flag}"


@dataclasses.dataclass(frozen=True)
class ProofRequest:
    id: RequestId
    requirements: Requirements
    image_url: str  # storage URL of the guest image
    input_data: bytes
    offer: Offer

    def signing_digest(self) -> bytes:
        """EIP-712 typed-data digest (keccak-256 throughout).

        Struct layout mirrors the reference's on-chain typed data
        (`contracts/src/types/*.sol` + SDK EIP-712 bindings): nested
        Predicate / Requirements / Offer struct hashes, dynamic members
        pre-hashed per the EIP-712 spec.
        """
        from . import crypto as C

        pred = C.hash_struct(
            "Predicate(uint8 predicateType,bytes data)",
            [PREDICATE_TYPE_IDS[self.requirements.predicate.kind],
             C.keccak256(self.requirements.predicate.data)])
        reqs = C.hash_struct(
            "Requirements(bytes32 imageId,bytes32 predicate,"
            "bytes32 callback,bytes32 selector)",
            [C.keccak256(self.requirements.image_id.encode()), pred,
             C.keccak256((self.requirements.callback or "").encode()),
             C.keccak256((self.requirements.selector or "").encode())])
        offer = C.hash_struct(
            "Offer(uint256 minPrice,uint256 maxPrice,uint64 biddingStart,"
            "uint32 rampUpPeriod,uint32 lockTimeout,uint32 timeout,"
            "uint256 lockCollateral)",
            [self.offer.min_price, self.offer.max_price,
             int(self.offer.bidding_start), int(self.offer.ramp_up_period),
             int(self.offer.lock_timeout), int(self.offer.timeout),
             self.offer.lock_collateral])
        root = C.hash_struct(
            "ProofRequest(bytes32 id,bytes32 requirements,bytes32 imageUrl,"
            "bytes32 input,bytes32 offer)",
            [C.keccak256(self.id.encoded().encode()), reqs,
             C.keccak256(self.image_url.encode()),
             C.keccak256(self.input_data), offer])
        return C.typed_data_digest(_domain_separator(), root)


PREDICATE_TYPE_IDS = {PredicateType.DIGEST_MATCH: 0,
                      PredicateType.PREFIX_MATCH: 1,
                      PredicateType.CLAIM_MATCH: 2}

_MARKET_CONTRACT = "0x" + hashlib.sha256(DOMAIN.encode()).hexdigest()[:40]


def _domain_separator() -> bytes:
    from . import crypto as C

    return C.domain_separator("boundless-tpu-market", "1", 1,
                              _MARKET_CONTRACT)


def sign_request(request: ProofRequest, wallet) -> bytes:
    """ECDSA (secp256k1) over the EIP-712 digest. `wallet` is a
    crypto.Wallet (or anything with .sign(digest))."""
    return wallet.sign(request.signing_digest())


def verify_signature(request: ProofRequest, sig: bytes) -> bool:
    """True iff the signature recovers to the request's client address —
    pure recovery, no key registry (reference assessor-guest semantics)."""
    from . import crypto as C

    addr = C.recover_address(request.signing_digest(), sig)
    return addr is not None and addr == request.id.client.lower()


@dataclasses.dataclass
class Fulfillment:
    """A delivered proof for one request (reference types/Fulfillment)."""

    request_id: RequestId
    journal: bytes
    claim_digest: bytes
    seal: object  # SessionReceipt (stark) or wrapped snark
    prover: str


@dataclasses.dataclass
class RequestLock:
    prover: str
    locked_at: float
    deadline: float
    collateral: int
    price: int
