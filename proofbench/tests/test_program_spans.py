"""The per-layer metrics that read the port's own spans and counters
(`upload_s`, `accum_s`, `task_wait_s`): each reader on a hand-made
registry delta, and loading a reader's file turns the port's tracer on.

    python -m pytest proofbench/tests -q -p no:xdist -o addopts=""
"""

from __future__ import annotations

import pytest

from proofbench import harness, trace

NEW = ("upload_s", "accum_s", "task_wait_s")


def _trace(registry):
    return trace.Trace(spans={}, launches={}, kernels=[], registry=registry,
                       busy_s=1.0, window_s=2.0)


REGISTRY = {
    ("span_seconds", (("span", "upload"),)): (12.0, 4),
    ("span_seconds", (("span", "stark.accum"),)): (0.9, 6),
    ("span_seconds", (("span", "stark.prove"),)): (30.0, 6),
    ("task_wait_seconds", (("stream", "prove"),)): (0.3, 4),
    ("task_wait_seconds", (("stream", "join"),)): (0.1, 2),
    ("task_wait_seconds", (("stream", "exec"),)): (0.2, 2),
    ("task_duration_seconds", (("stream", "prove"),)): (40.0, 4),
    ("tasks_processed_total", (("stream", "prove"),)): (4.0, 0),
}


@pytest.mark.parametrize("name, want", [("upload_s", 3.0),
                                        ("accum_s", 0.15),
                                        ("task_wait_s", 0.075)])
def test_each_reader_reads_its_delta(name, want):
    mod = harness.metric_module(name)
    assert mod.NAME == name
    assert mod.read(_trace(REGISTRY)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(name):
    mod = harness.metric_module(name)
    empty = {k: (0.0, 0) for k in REGISTRY}
    assert mod.read(_trace({})) is None
    assert mod.read(_trace(empty)) is None


@pytest.mark.parametrize("name", NEW)
def test_loading_a_reader_turns_the_tracer_on(name):
    from boundless_tpu_torch.utils import profiling

    profiling.disable()
    try:
        with profiling.span("probe.before"):
            pass
        assert not any(r["name"] == "probe.before"
                       for r in profiling.records())
        harness.metric_module(name)
        with profiling.span("probe.after"):
            pass
        assert profiling.records()[-1]["name"] == "probe.after"
    finally:
        profiling.disable()


def test_a_port_without_the_tracer_loads_the_readers(monkeypatch):
    """The benchmark's files are laid over older checkouts too: there the
    tracer has no `enable`, and the readers load and read nothing."""
    from boundless_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "enable")
    for name in NEW:
        assert harness.metric_module(name).read(_trace({})) is None


def test_the_new_metrics_are_declared_where_they_read():
    bench = harness.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    assert declared["upload_s"]["workloads"] == ["seg20-prove", "rec20-2seg"]
    assert declared["accum_s"]["workloads"] == ["seg20-prove", "rec20-2seg"]
    assert declared["task_wait_s"]["workloads"] == ["rec20-2seg"]
    for name in NEW:
        assert declared[name]["moves"] == "effective_khz"
        for cell in declared[name]["workloads"]:
            assert name in {m["name"] for m in harness.resolve(cell).per_layer}
