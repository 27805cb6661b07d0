"""Satellite market services: slasher, order generator, distributor,
indexer, requestor lists.

The port's copy of `boundless_tpu/market/services.py`, over the port's
`market/chain.py` and `market/client.py`.

Re-designs of the reference crates (SURVEY.md §2.2): `crates/slasher`
(`src/lib.rs:83-147`), `crates/order-generator`, `crates/distributor`
(`src/main.rs:307`), `crates/indexer` (market-wide aggregates), and
`crates/requestor-lists` — as in-process services over the Python market
chain.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional

from .chain import MarketChain, MarketError
from .client import Client


class Slasher:
    """Watches expired locked requests and submits slash txs."""

    def __init__(self, chain: MarketChain, address: str, poll: float = 0.1):
        self.chain = chain
        self.address = address
        self.poll = poll
        self.slashed: List[str] = []
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.is_set():
            now = self.chain.clock()
            for rid, lock in list(self.chain.locks.items()):
                if (rid not in self.chain.fulfilled
                        and rid not in self.chain.slashed
                        and now > lock.deadline):
                    try:
                        self.chain.slash(rid, self.address)
                        self.slashed.append(rid)
                    except MarketError:
                        pass
            time.sleep(self.poll)


class OrderGenerator:
    """Synthetic load: submits proof requests on an interval."""

    def __init__(self, client: Client, make_request: Callable,
                 interval: float = 1.0, count: Optional[int] = None):
        self.client = client
        self.make_request = make_request
        self.interval = interval
        self.count = count
        self.submitted: List[str] = []
        self._stop = threading.Event()

    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def stop(self):
        self._stop.set()

    def _run(self):
        n = 0
        while not self._stop.is_set():
            if self.count is not None and n >= self.count:
                return
            req = self.make_request()
            self.submitted.append(self.client.submit_onchain(req))
            n += 1
            time.sleep(self.interval)


class Distributor:
    """Funds top-up bot across operator accounts."""

    def __init__(self, chain: MarketChain, treasury: str,
                 operators: List[str], min_balance: int, top_up: int):
        self.chain = chain
        self.treasury = treasury
        self.operators = operators
        self.min_balance = min_balance
        self.top_up = top_up

    def run_once(self) -> dict:
        moved = {}
        for op in self.operators:
            bal = self.chain.balances.get(op, 0)
            if bal < self.min_balance:
                amount = min(self.top_up,
                             self.chain.balances.get(self.treasury, 0))
                if amount > 0:
                    self.chain.withdraw(self.treasury, amount)
                    self.chain.deposit(op, amount)
                    moved[op] = amount
        return moved


@dataclasses.dataclass
class MarketAggregates:
    total_requests: int
    total_fulfilled: int
    total_slashed: int
    total_volume: int
    per_prover_fulfilled: dict
    per_requestor_requests: dict


class Indexer:
    """Event-log indexer computing market-wide aggregates (reference
    `crates/indexer` role, minus the external DB)."""

    def __init__(self, chain: MarketChain):
        self.chain = chain
        self._block = 0
        self.requests = 0
        self.fulfilled = 0
        self.slashed = 0
        self.volume = 0
        self.per_prover: dict = {}
        self.per_requestor: dict = {}

    def sync(self) -> MarketAggregates:
        for ev in self.chain.events_since(self._block):
            self._block = max(self._block, ev.block)
            if ev.kind == "RequestSubmitted":
                self.requests += 1
                client = ev.data["request_id"].split(":")[0]
                self.per_requestor[client] = \
                    self.per_requestor.get(client, 0) + 1
            elif ev.kind == "RequestFulfilled":
                self.fulfilled += 1
                self.volume += ev.data.get("price", 0)
                p = ev.data["prover"]
                self.per_prover[p] = self.per_prover.get(p, 0) + 1
            elif ev.kind == "RequestSlashed":
                self.slashed += 1
        return MarketAggregates(
            total_requests=self.requests, total_fulfilled=self.fulfilled,
            total_slashed=self.slashed, total_volume=self.volume,
            per_prover_fulfilled=dict(self.per_prover),
            per_requestor_requests=dict(self.per_requestor))


@dataclasses.dataclass
class RequestorList:
    """Published priority/allow list (reference `crates/requestor-lists`)."""

    name: str
    addresses: List[str]

    def validate(self) -> bool:
        return all(isinstance(a, str) and a for a in self.addresses)

    def is_member(self, address: str) -> bool:
        return address in self.addresses
