"""What the per-layer metrics that read the port's own spans and counters
share.

The port keeps its tracer in `boundless_tpu_torch/utils/profiling.py`:
each closed span adds its seconds to the port's
`cluster/metrics.REGISTRY` as `span_seconds{span=<name>}`, and the
cluster's taskdb adds each claimed task's wait as `task_wait_seconds`.
A metric file calls `enable_tracer()` when it is loaded, which the
harness does only for a traced run, after the warm-up job, so the run
that gives the end-to-end metrics keeps the tracer off. It reads the
window's delta of the registry (`trace.registry`). A port without the
tracer, or a window in which nothing was recorded, reads None.
"""

from __future__ import annotations

from typing import Optional


def enable_tracer():
    from boundless_tpu_torch.utils import profiling

    enable = getattr(profiling, "enable", None)
    if enable is not None:
        enable()


def registry_mean(trace, metric: str, **labels) -> Optional[float]:
    """Mean of the histogram `metric` over the window, summed over every
    label set that holds `labels`."""
    total, count = 0.0, 0
    for (name, have), (s, n) in trace.registry.items():
        have = dict(have)
        if name == metric and all(have.get(k) == v
                                  for k, v in labels.items()):
            total, count = total + s, count + n
    return total / count if count else None
