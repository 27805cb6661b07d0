"""Broker telemetry: periodic state snapshots + heartbeats.

The port's copy of `boundless_tpu/market/broker/telemetry.py`.

Re-design of `crates/broker/src/telemetry/` (snapshots + heartbeats to
order-stream, riding the critical cancel token, reference
broker.rs:400-413) and `crates/order-stream/src/heartbeat.rs`.
"""

from __future__ import annotations

import threading
import time
from typing import List


class Telemetry:
    def __init__(self, broker, order_stream=None, interval: float = 0.5):
        self.broker = broker
        self.order_stream = order_stream
        self.interval = interval
        self.snapshots: List[dict] = []
        self._stop = threading.Event()

    def snapshot(self) -> dict:
        by_status: dict = {}
        for order in self.broker.orders.values():
            by_status[order.status] = by_status.get(order.status, 0) + 1
        return dict(ts=time.time(), address=self.broker.address,
                    orders=by_status, total=len(self.broker.orders))

    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.is_set():
            snap = self.snapshot()
            self.snapshots.append(snap)
            if len(self.snapshots) > 1000:
                del self.snapshots[:500]
            if self.order_stream is not None:
                self.order_stream.heartbeat(self.broker.address)
            time.sleep(self.interval)
