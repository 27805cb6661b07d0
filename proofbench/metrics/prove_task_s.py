"""Mean seconds of a task of the cluster's `prove` stream (a segment's
witness, proof and lift, with the task's hand-offs), from the port's own
`cluster/metrics.REGISTRY` `task_duration_seconds{stream="prove"}`: host
clocks around whole tasks, the window's tasks alone."""

NAME = "prove_task_s"


def read(trace):
    total, count = 0.0, 0
    for (name, labels), (s, n) in trace.registry.items():
        if name == "task_duration_seconds" and dict(labels).get(
                "stream") == "prove":
            total, count = total + s, count + n
    return total / count if count else None
