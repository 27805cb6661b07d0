"""Prometheus-style metrics registry.

The port's copy of `boundless_tpu/cluster/metrics.py` (plain Python).

Re-design of the reference's metric registry (`prover/crates/
workflow-common/src/metrics.rs:13-197`): task queue depth by
(stream, priority, state), processing/retry counters, task wait and
duration histograms, and the seconds of the tracer's spans
(`utils/profiling.py`) — exposed in text exposition format via the
cluster API.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple


class Counter:
    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._v += amount

    @property
    def value(self):
        return self._v


class Histogram:
    BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 60.0, 600.0)

    def __init__(self):
        self._counts = [0] * (len(self.BUCKETS) + 1)
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self._sum += v
            self._n += 1
            for i, b in enumerate(self.BUCKETS):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def time(self):
        """Context manager recording elapsed seconds."""
        hist = self

        class _T:
            def __enter__(self):
                self.t0 = time.time()

            def __exit__(self, *a):
                hist.observe(time.time() - self.t0)

        return _T()


class Registry:
    def __init__(self):
        self._metrics: Dict[Tuple[str, tuple], object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(name, labels, Histogram)

    def _get(self, name, labels, cls):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key not in self._metrics:
                self._metrics[key] = cls()
            return self._metrics[key]

    def gauge_set(self, name: str, value: float, **labels):
        c = self.counter(name, **labels)
        with c._lock:
            c._v = value

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        with self._lock:
            items = sorted(self._metrics.items())
        for (name, labels), m in items:
            lab = ",".join(f'{k}="{v}"' for k, v in labels)
            lab = "{" + lab + "}" if lab else ""
            if isinstance(m, Counter):
                lines.append(f"{name}{lab} {m.value}")
            else:
                lines.append(f"{name}_sum{lab} {m._sum}")
                lines.append(f"{name}_count{lab} {m._n}")
        return "\n".join(lines) + "\n"


# Global registry (per-process, like the reference's per-agent exporter).
REGISTRY = Registry()

# Canonical metric names (reference metrics.rs).
TASK_QUEUE_DEPTH = "task_queue_depth"
TASKS_PROCESSED = "tasks_processed_total"
TASKS_RETRIED = "tasks_retried_total"
TASK_DURATION = "task_duration_seconds"
# seconds from a task's becoming ready to its claim (`taskdb.request_work`)
TASK_WAIT = "task_wait_seconds"
# seconds of each closed span of the tracer (`utils/profiling.py`)
SPAN_SECONDS = "span_seconds"
