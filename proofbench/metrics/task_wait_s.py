"""Mean seconds a cluster task waits in the ready queue, from the moment
it becomes ready to its claim by a worker, over every stream: the port's
own `task_wait_seconds` of `cluster/metrics.REGISTRY`, which the taskdb
records at each claim."""

from proofbench import program_spans

NAME = "task_wait_s"
program_spans.enable_tracer()


def read(trace):
    return program_spans.registry_mean(trace, "task_wait_seconds")
