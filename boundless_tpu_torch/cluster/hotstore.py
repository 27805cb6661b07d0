"""Hot store: TTL'd key-value plane for in-flight segments/receipts.

The port's copy of `boundless_tpu/cluster/hotstore.py` (plain Python).

Stand-in for the reference's Redis/Valkey hot store (`prover/crates/
workflow/src/tasks/mod.rs:22-34` key scheme; TTL default 8h,
`workflow/src/lib.rs:86-90`). In-process dict with the same semantics:
workers write `job:<id>:segments:<idx>`, `job:<id>:recursion_receipts:<idx>`
etc. and delete keys only after `update_task_done` (CleanupKeys pattern,
reference `workflow/src/lib.rs:778-794`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

DEFAULT_TTL = 8 * 3600.0


class HotStore:
    def __init__(self, ttl: float = DEFAULT_TTL):
        self._data = {}
        self._lock = threading.Lock()
        self._ttl = ttl

    def set(self, key: str, value, ttl: Optional[float] = None):
        with self._lock:
            self._data[key] = (value, time.time() + (ttl or self._ttl))

    def get(self, key: str):
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return None
            value, deadline = entry
            if deadline < time.time():
                del self._data[key]
                return None
            return value

    def delete(self, *keys):
        with self._lock:
            for k in keys:
                self._data.pop(k, None)

    def keys(self, prefix: str = ""):
        now = time.time()
        with self._lock:
            return [k for k, (_, dl) in self._data.items()
                    if dl >= now and k.startswith(prefix)]

    def purge_expired(self) -> int:
        now = time.time()
        with self._lock:
            dead = [k for k, (_, dl) in self._data.items() if dl < now]
            for k in dead:
                del self._data[k]
            return len(dead)


# reference key scheme (tasks/mod.rs:22-34)
def segment_key(job_id, idx):
    return f"job:{job_id}:segments:{idx}"


def recursion_receipt_key(job_id, idx):
    return f"job:{job_id}:recursion_receipts:{idx}"


def keccak_receipt_key(job_id, idx):
    return f"job:{job_id}:keccak_receipts:{idx}"


def coproc_succ_key(job_id, idx):
    """Succinct coproc receipt (lift_keccak/union) for a coproc task."""
    return f"job:{job_id}:coproc_succ:{idx}"


def coproc_state_key(job_id, idx):
    return f"job:{job_id}:coproc:{idx}"


def receipt_key(claim_digest_hex):
    return f"receipts:{claim_digest_hex}"


def exec_stats_key(job_id):
    return f"job:{job_id}:exec_stats"
