"""Prometheus-style metrics registry.

The port's copy of the registry of `boundless_tpu/cluster/metrics.py`
(plain Python), below the tracer: `utils/profiling.py` adds each closed
span's seconds to `REGISTRY` under `SPAN_SECONDS`, and `cluster/metrics.py`
binds the same `REGISTRY` beside the cluster's own metric names, which the
cluster API exposes in text exposition format.
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

# seconds of each closed span of the tracer (`utils/profiling.py`)
SPAN_SECONDS = "span_seconds"
