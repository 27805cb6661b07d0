"""Standalone execution service: zkVM-pluggable preflight.

The port's copy of `boundless_tpu/cluster/executor_service.py`, on the
port's executor.

Re-design of `crates/executor` (reference `src/backend.rs:26-99`): an
`ExecutorBackend` protocol + `Registry`, with the rv32im backend
registered — preflight-as-a-service for pricing pipelines that never
prove (the broker's OrderPricer uses this through the Prover duck-type).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Protocol


@dataclasses.dataclass
class ExecutionResult:
    total_cycles: int
    segments: int
    journal: bytes
    exit_code: int
    image_id: str


class ExecutorBackend(Protocol):
    name: str

    def execute(self, image_bytes: bytes, input_bytes: bytes,
                cycle_limit: int) -> ExecutionResult: ...


class Rv32imBackend:
    name = "rv32im"

    def execute(self, image_bytes, input_bytes, cycle_limit=1 << 36):
        import pickle

        from ..zkvm.executor import Executor

        image = pickle.loads(image_bytes)
        res = Executor(image, input_bytes, max_cycles=cycle_limit).run()
        return ExecutionResult(
            total_cycles=res.total_cycles, segments=len(res.segments),
            journal=res.journal, exit_code=res.exit_code,
            image_id=res.image_id.hex())


class Registry:
    """zkVM backend registry (reference Registry :26-99)."""

    def __init__(self):
        self._backends: Dict[str, ExecutorBackend] = {}

    def register(self, backend: ExecutorBackend):
        self._backends[backend.name] = backend

    def get(self, name: str) -> ExecutorBackend:
        if name not in self._backends:
            raise KeyError(f"no executor backend {name!r}; "
                           f"have {sorted(self._backends)}")
        return self._backends[name]

    def names(self):
        return sorted(self._backends)


def default_registry() -> Registry:
    reg = Registry()
    reg.register(Rv32imBackend())
    return reg
