"""Market-level load benchmark: lock/fulfill/e2e latency per request.

The port's copy of `boundless_tpu/market/bench.py`.

Re-design of `crates/bench` (`src/bench.rs:27-75,96+`): submit N requests
of loop-guest cycles, record per-request lock latency, fulfill latency and
effective kHz, emit CSV/JSON rows.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional


@dataclasses.dataclass
class BenchRow:
    request_id: str
    cycles: int
    submitted_at: float
    locked_at: Optional[float] = None
    fulfilled_at: Optional[float] = None

    @property
    def lock_latency(self):
        return (self.locked_at - self.submitted_at
                if self.locked_at else None)

    @property
    def fulfill_latency(self):
        return (self.fulfilled_at - self.submitted_at
                if self.fulfilled_at else None)

    @property
    def effective_khz(self):
        if self.fulfilled_at and self.locked_at:
            dt = self.fulfilled_at - self.locked_at
            return self.cycles / dt / 1000.0 if dt > 0 else None
        return None


class MarketBench:
    def __init__(self, client, chain, image, make_input, count: int = 4):
        self.client = client
        self.chain = chain
        self.image = image
        self.make_input = make_input
        self.count = count
        self.rows: List[BenchRow] = []

    def run(self, timeout: float = 120.0) -> List[BenchRow]:
        for i in range(self.count):
            req = self.client.build_request(self.image, self.make_input(i))
            rid = self.client.submit_onchain(req)
            self.rows.append(BenchRow(
                request_id=rid,
                cycles=0,
                submitted_at=time.time()))
        deadline = time.time() + timeout
        pending = {r.request_id: r for r in self.rows}
        while pending and time.time() < deadline:
            for ev in self.chain.events_since(0):
                rid = ev.data.get("request_id")
                row = next((r for r in self.rows if r.request_id == rid), None)
                if row is None:
                    continue
                if ev.kind == "RequestLocked" and row.locked_at is None:
                    row.locked_at = time.time()
                if ev.kind == "RequestFulfilled" and row.fulfilled_at is None:
                    row.fulfilled_at = time.time()
                    pending.pop(rid, None)
            time.sleep(0.05)
        return self.rows

    def to_csv(self) -> str:
        lines = ["request_id,lock_latency,fulfill_latency,effective_khz"]
        for r in self.rows:
            lines.append(f"{r.request_id},{r.lock_latency},"
                         f"{r.fulfill_latency},{r.effective_khz}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps([
            dict(request_id=r.request_id, lock_latency=r.lock_latency,
                 fulfill_latency=r.fulfill_latency)
            for r in self.rows])
