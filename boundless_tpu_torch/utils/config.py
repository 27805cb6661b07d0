"""Config system: file-backed config with hot reload.

The port's copy of `boundless_tpu/utils/config.py` (host Python).

Re-design of the broker's TOML config + `ConfigWatcher`
(`crates/broker/src/shared/config.rs`; template `broker-template.toml`)
over JSON (stdlib-only image). Knobs mirror the reference template:
min_mcycle_price, peak_prove_khz, max_concurrent_preflights/proofs,
priority requestor lists.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class BrokerToml:
    min_mcycle_price: int = 1
    peak_prove_khz: float = 100.0
    max_concurrent_preflights: int = 2
    max_concurrent_proofs: int = 2
    max_collateral: int = 1_000_000
    lock_orders: bool = True
    priority_requestors: List[str] = dataclasses.field(default_factory=list)
    segment_po2: int = 14

    @staticmethod
    def load(path: str) -> "BrokerToml":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(BrokerToml)}
        return BrokerToml(**{k: v for k, v in raw.items() if k in fields})

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


class ConfigWatcher:
    """Polls a config file's mtime and invokes callbacks on change."""

    def __init__(self, path: str, poll: float = 0.2):
        self.path = path
        self.poll = poll
        self.config = BrokerToml.load(path)
        self._mtime = os.path.getmtime(path)
        self._subs: List[Callable] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def subscribe(self, cb: Callable):
        self._subs.append(cb)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _run(self):
        while not self._stop.is_set():
            try:
                mtime = os.path.getmtime(self.path)
                if mtime != self._mtime:
                    self._mtime = mtime
                    self.config = BrokerToml.load(self.path)
                    for cb in self._subs:
                        cb(self.config)
            except (OSError, json.JSONDecodeError):
                pass  # partial write; retry next poll
            time.sleep(self.poll)
