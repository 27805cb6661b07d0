"""Broker order database: durable order state across restarts.

The port's copy of `boundless_tpu/market/broker/db.py`.

Re-design of the broker sqlite DB (`crates/broker/src/db/`, 2,579 LoC,
statuses `order_types.rs:38-57`): orders persist with status/price/error
so a restarted broker resumes committed work (SURVEY §5.4).
"""

from __future__ import annotations

import pickle
import sqlite3
import threading
from typing import Dict, List

from .pipeline import Order, OrderStatus


class OrderDb:
    SCHEMA = """
    CREATE TABLE IF NOT EXISTS orders (
        request_id TEXT PRIMARY KEY,
        status TEXT,
        cycles INTEGER,
        price INTEGER,
        error TEXT,
        request BLOB
    );
    """

    def __init__(self, path: str = ":memory:"):
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(self.SCHEMA)
        self._lock = threading.Lock()

    def upsert(self, rid: str, order: Order):
        with self._lock, self._db:
            self._db.execute(
                "INSERT INTO orders VALUES (?,?,?,?,?,?) "
                "ON CONFLICT(request_id) DO UPDATE SET status=excluded.status,"
                "cycles=excluded.cycles, price=excluded.price,"
                "error=excluded.error",
                (rid, order.status, order.cycles or 0, order.price,
                 order.error, pickle.dumps(order.request)))

    def load_all(self) -> Dict[str, Order]:
        with self._lock:
            out = {}
            for rid, status, cycles, price, error, blob in self._db.execute(
                    "SELECT * FROM orders").fetchall():
                out[rid] = Order(request=pickle.loads(blob), status=status,
                                 cycles=cycles or None, price=price,
                                 error=error)
            return out

    def in_flight(self) -> List[str]:
        """Orders to resume after restart (committed/locked/proving)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT request_id FROM orders WHERE status IN (?,?,?)",
                (OrderStatus.COMMITTED, OrderStatus.LOCKED,
                 OrderStatus.PROVING)).fetchall()
            return [r[0] for r in rows]
