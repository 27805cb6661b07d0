"""Off-chain order stream: pub/sub order feed with signature auth.

The port's copy of `boundless_tpu/market/order_stream.py`.

Re-design of `crates/order-stream` (REST + WebSocket broadcast,
`src/lib.rs:523-539`; signature-authenticated connections): an in-process
broker-facing feed with subscriber callbacks; the HTTP layer wraps it
(order_stream_http.py) the same way cluster/api.py wraps ClusterApi.

Durability: pass `db_path` to persist the order log in sqlite (the role
of the reference's Postgres order DB, `crates/order-stream/src/
order_db.rs`) — orders are written inside the submit critical section
and reloaded in index order on restart, so a broker resuming from its
cursor (`orders_since`) sees the same feed across stream restarts.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Callable, List, Optional

from .types import ProofRequest, verify_signature


class OrderStream:
    def __init__(self, db_path: Optional[str] = None):
        self._subs: List[Callable] = []
        self._orders: list = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.heartbeats: dict = {}  # address -> last heartbeat ts
        self._db = None
        if db_path is not None:
            self._db = sqlite3.connect(db_path, check_same_thread=False)
            self._db.execute(
                "CREATE TABLE IF NOT EXISTS orders ("
                "idx INTEGER PRIMARY KEY, request TEXT, signature BLOB)")
            self._db.commit()
            # reload the persisted feed in index order (resume point for
            # broker cursors)
            from .order_stream_http import request_from_json

            for _, req_json, sig in self._db.execute(
                    "SELECT idx, request, signature FROM orders "
                    "ORDER BY idx"):
                self._orders.append(
                    (request_from_json(json.loads(req_json)), bytes(sig)))

    def submit(self, request: ProofRequest, signature: bytes):
        # ECDSA recovery against the request's client address — same
        # auth model as the reference order-stream's signature checks
        # (`crates/order-stream/src/lib.rs` ECDSA-authenticated submit).
        if not verify_signature(request, signature):
            raise PermissionError("bad order signature")
        with self._cond:
            if self._db is not None:
                from .order_stream_http import request_to_json

                self._db.execute(
                    "INSERT INTO orders (idx, request, signature) "
                    "VALUES (?, ?, ?)",
                    (len(self._orders), json.dumps(request_to_json(request)),
                     signature))
                self._db.commit()  # durable before subscribers see it
            self._orders.append((request, signature))
            subs = list(self._subs)
            self._cond.notify_all()
        for cb in subs:
            cb(request, signature)

    def wait_orders(self, index: int, timeout: float = 10.0):
        """Orders after `index`, blocking up to `timeout` for new ones
        (the WS push loop's wake-up; reference broadcast channel)."""
        with self._cond:
            if len(self._orders) <= index:
                self._cond.wait(timeout)
            return self._orders[index:]

    def subscribe(self, callback: Callable):
        with self._lock:
            self._subs.append(callback)

    def orders_since(self, index: int):
        with self._lock:
            return self._orders[index:]

    def heartbeat(self, address: str):
        self.heartbeats[address] = time.time()
