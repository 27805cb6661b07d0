"""Service supervisor with restart policies.

The port's copy of `boundless_tpu/utils/service_runner.py` (host Python).

Re-design of the broker's `ServiceRunner` (`crates/broker/src/shared/
service_runner.rs`): services carry a Criticality that governs restart
behavior; a shared cancel event implements two-phase shutdown.
"""

from __future__ import annotations

import enum
import threading
import time
import traceback
from typing import Callable, List


class Criticality(enum.Enum):
    CRITICAL = "critical"  # crash escalates: cancels the whole group
    CRITICAL_FAST_RETRY = "critical_fast_retry"  # restart immediately
    NON_CRITICAL = "non_critical"  # restart with backoff


class ServiceRunner:
    def __init__(self):
        self.cancel = threading.Event()
        self._threads: List[threading.Thread] = []
        self.failures: List[tuple] = []

    def spawn(self, name: str, fn: Callable, criticality: Criticality):
        def runner():
            backoff = 0.05
            while not self.cancel.is_set():
                try:
                    fn(self.cancel)
                    return  # clean exit
                except Exception as e:  # noqa: BLE001
                    self.failures.append((name, repr(e)))
                    traceback.print_exc()
                    if criticality == Criticality.CRITICAL:
                        self.cancel.set()
                        return
                    if criticality == Criticality.CRITICAL_FAST_RETRY:
                        continue
                    time.sleep(backoff)
                    backoff = min(backoff * 2, 5.0)

        t = threading.Thread(target=runner, name=name, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def shutdown(self, drain_timeout: float = 5.0):
        """Two-phase shutdown (reference broker.rs:733-760: drain then stop)."""
        self.cancel.set()
        deadline = time.time() + drain_timeout
        for t in self._threads:
            t.join(max(0.0, deadline - time.time()))


def retry(fn: Callable, attempts: int = 3, delay: float = 0.05,
          backoff: float = 2.0, retry_on=(Exception,)):
    """Bounded retry helper (reference boundless-backend futures_retry)."""
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203
            last = e
            if i + 1 < attempts:
                time.sleep(delay * (backoff ** i))
    raise last
