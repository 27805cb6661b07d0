"""The cluster's metric names, over the process's metrics registry.

The port's copy of `boundless_tpu/cluster/metrics.py` (plain Python).

Re-design of the reference's metric registry (`prover/crates/
workflow-common/src/metrics.rs:13-197`): task queue depth by
(stream, priority, state), processing/retry counters, task wait and
duration histograms. The registry itself (`REGISTRY`, which also holds
the seconds of the tracer's spans) is `utils/metrics.py`'s, bound here
for the cluster API's text exposition.
"""

from __future__ import annotations

from ..utils.metrics import REGISTRY  # noqa: F401 (the cluster's registry)

# Canonical metric names (reference metrics.rs).
TASK_QUEUE_DEPTH = "task_queue_depth"
TASKS_PROCESSED = "tasks_processed_total"
TASKS_RETRIED = "tasks_retried_total"
TASK_DURATION = "task_duration_seconds"
# seconds from a task's becoming ready to its claim (`taskdb.request_work`)
TASK_WAIT = "task_wait_seconds"
