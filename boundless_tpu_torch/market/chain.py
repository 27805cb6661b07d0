"""In-process market chain: Python semantics of BoundlessMarket.sol.

The port's copy of `boundless_tpu/market/chain.py`.

Functional re-design of the reference market contract
(`contracts/src/BoundlessMarket.sol`: submitRequest :162, lockRequest :170,
priceRequest :254, fulfill :317, slash :795, deposit :845 / withdraw :871,
depositCollateral :881) plus the verifier-router dispatch
(`contracts/src/router/BoundlessRouter.sol`). Serves as the L7 layer for
the SDK/broker/e2e tests and as the executable spec for a future Solidity
port; an event log drives the broker's chain monitor.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from .types import Fulfillment, ProofRequest, RequestLock, verify_signature


class MarketError(Exception):
    pass


@dataclasses.dataclass
class Event:
    kind: str  # RequestSubmitted / RequestLocked / RequestFulfilled / ...
    block: int
    data: dict


class MarketChain:
    """Single-chain market state machine with balances + event log."""

    def __init__(self, verifier: Callable[[Fulfillment, ProofRequest], bool],
                 clock: Callable[[], float] = time.time):
        self._lock = threading.Lock()
        self.verifier = verifier
        self.clock = clock
        self.block = 0
        self.events: List[Event] = []
        self.balances: Dict[str, int] = {}
        self.collateral: Dict[str, int] = {}
        self.requests: Dict[str, ProofRequest] = {}
        self.request_sigs: Dict[str, bytes] = {}
        self.locks: Dict[str, RequestLock] = {}
        self.fulfilled: Dict[str, Fulfillment] = {}
        self.slashed: set = set()

    # -- accounts -------------------------------------------------------
    # No key registry: request auth is ECDSA recovery against the
    # client address in the request id (reference EIP-712 model).
    def create_account(self, address: str, funds: int = 0):
        with self._lock:
            self.balances[address] = self.balances.get(address, 0) + funds

    def deposit(self, address: str, amount: int):
        with self._lock:
            self.balances[address] = self.balances.get(address, 0) + amount

    def withdraw(self, address: str, amount: int):
        with self._lock:
            if self.balances.get(address, 0) < amount:
                raise MarketError("insufficient balance")
            self.balances[address] -= amount

    def deposit_collateral(self, address: str, amount: int):
        with self._lock:
            if self.balances.get(address, 0) < amount:
                raise MarketError("insufficient balance for collateral")
            self.balances[address] -= amount
            self.collateral[address] = self.collateral.get(address, 0) + amount

    # -- requests -------------------------------------------------------
    def _emit(self, kind, **data):
        self.block += 1
        self.events.append(Event(kind, self.block, data))

    def submit_request(self, request: ProofRequest, signature: bytes):
        with self._lock:
            rid = request.id.encoded()
            if rid in self.requests:
                raise MarketError("duplicate request id")
            if not verify_signature(request, signature):
                raise MarketError("bad request signature")
            self.requests[rid] = request
            self.request_sigs[rid] = signature
            self._emit("RequestSubmitted", request_id=rid)

    def lock_request(self, request_id: str, prover: str):
        """Prover locks a request, staking collateral (reference :170)."""
        with self._lock:
            req = self.requests.get(request_id)
            if req is None:
                raise MarketError("unknown request")
            now = self.clock()
            if now > req.offer.lock_deadline():
                raise MarketError("lock window expired")
            if request_id in self.locks:
                raise MarketError("already locked")
            if request_id in self.fulfilled:
                raise MarketError("already fulfilled")
            stake = req.offer.lock_collateral
            if self.collateral.get(prover, 0) < stake:
                raise MarketError("insufficient collateral")
            self.collateral[prover] -= stake
            price = req.offer.price_at(now)
            self.locks[request_id] = RequestLock(
                prover=prover, locked_at=now,
                deadline=req.offer.expires_at(), collateral=stake,
                price=price)
            self._emit("RequestLocked", request_id=request_id, prover=prover,
                       price=price)

    def price_request(self, request_id: str) -> int:
        with self._lock:
            req = self.requests.get(request_id)
            if req is None:
                raise MarketError("unknown request")
            lock = self.locks.get(request_id)
            if lock:
                return lock.price
            return req.offer.price_at(self.clock())

    # -- fulfillment ----------------------------------------------------
    def fulfill(self, fills: List[Fulfillment], *,
                verifier: Optional[Callable] = None):
        """Batch fulfill (reference :317): verify each seal + requirements,
        pay the prover, return collateral. `verifier` checks the fills in
        place of the chain's own, for this call alone (the set-root path,
        whose assessor and Merkle inclusion replace the per-fill seal
        check); the chain's verifier is never swapped, so a concurrent
        per-fill call still meets it."""
        with self._lock:
            check = self.verifier if verifier is None else verifier
            now = self.clock()
            for fill in fills:
                rid = fill.request_id.encoded()
                req = self.requests.get(rid)
                if req is None:
                    raise MarketError(f"unknown request {rid}")
                if rid in self.fulfilled:
                    raise MarketError("already fulfilled")
                if now > req.offer.expires_at():
                    raise MarketError("request expired")
                if not req.requirements.predicate.eval(fill.journal,
                                                       fill.claim_digest):
                    raise MarketError("requirements predicate failed")
                if not check(fill, req):
                    raise MarketError("seal verification failed")
                lock = self.locks.get(rid)
                price = lock.price if lock else req.offer.price_at(now)
                if lock and lock.prover != fill.prover:
                    # another prover fulfilling a locked request gets no pay
                    price = 0
                client = req.id.client
                if self.balances.get(client, 0) < price:
                    raise MarketError("client balance too low")
                self.balances[client] -= price
                self.balances[fill.prover] = \
                    self.balances.get(fill.prover, 0) + price
                if lock and lock.prover == fill.prover:
                    self.collateral[fill.prover] = \
                        self.collateral.get(fill.prover, 0) + lock.collateral
                self.fulfilled[rid] = fill
                self._emit("RequestFulfilled", request_id=rid,
                           prover=fill.prover, price=price)

    # -- slashing -------------------------------------------------------
    def slash(self, request_id: str, caller: str):
        """Slash an expired locked-but-unfulfilled request (reference :795)."""
        with self._lock:
            req = self.requests.get(request_id)
            lock = self.locks.get(request_id)
            if req is None or lock is None:
                raise MarketError("not slashable")
            if request_id in self.fulfilled or request_id in self.slashed:
                raise MarketError("not slashable")
            if self.clock() <= lock.deadline:
                raise MarketError("not yet expired")
            # burn half, reward the caller half (simplified split)
            reward = lock.collateral // 2
            self.balances[caller] = self.balances.get(caller, 0) + reward
            self.slashed.add(request_id)
            self._emit("RequestSlashed", request_id=request_id, caller=caller)

    # -- queries --------------------------------------------------------
    def events_since(self, block: int) -> List[Event]:
        with self._lock:
            return [e for e in self.events if e.block > block]

    def request_status(self, request_id: str) -> str:
        with self._lock:
            if request_id in self.fulfilled:
                return "fulfilled"
            if request_id in self.slashed:
                return "slashed"
            lock = self.locks.get(request_id)
            req = self.requests.get(request_id)
            if req is None:
                return "unknown"
            if self.clock() > req.offer.expires_at():
                return "expired"
            return "locked" if lock else "open"

    def get_fulfillment(self, request_id: str) -> Optional[Fulfillment]:
        with self._lock:
            return self.fulfilled.get(request_id)
