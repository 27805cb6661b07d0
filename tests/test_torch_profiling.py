"""The port's tracer (`utils/profiling.py`) and the spans and counters the
port records with it, on the CPU: off, a span records nothing and never
waits for the card; on, spans nest per thread under their request's root,
their seconds reach the cluster's registry, and they export as Chrome
trace events; a segment proof, `field.upload` and a cluster session
record what the benchmark's per-layer metrics read.

One test runs only on the card (marked `cuda`, skipped elsewhere): a
synchronised span around one sponge launch contains that kernel's
`torch.profiler` interval on the same `time.time_ns()` clock. It imports
no JAX; run it on a GPU host with

    python -m pytest --noconftest tests/test_torch_profiling.py -p no:xdist -o addopts=""
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from boundless_tpu_torch.cluster import agent, api, hotstore, storage
from boundless_tpu_torch.cluster import metrics as M
from boundless_tpu_torch.cluster.taskdb import MemoryBackend
from boundless_tpu_torch.core import field as F
from boundless_tpu_torch.recursion import succinct
from boundless_tpu_torch.utils import profiling, serde
from boundless_tpu_torch.zkvm import guests, prove
from boundless_tpu_torch.zkvm.executor import Executor

STAGES = ("stark.commit", "stark.accum", "stark.quotient", "stark.check",
          "stark.deep", "stark.fri")


@pytest.fixture
def tracing():
    """The tracer on for one test; the records it made, from `.new()`."""
    t0 = time.time_ns()
    profiling.enable()

    class Made:
        @staticmethod
        def new():
            return [r for r in profiling.records() if r["t0_ns"] >= t0]

    try:
        yield Made
    finally:
        profiling.disable()


@pytest.fixture
def syncs(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    return calls


def _histogram(name, **labels):
    h = M.REGISTRY.histogram(name, **labels)
    return h._sum, h._n


def test_tracing_off_records_nothing_and_never_waits(syncs):
    profiling.disable()
    before = profiling.records()
    reg = _histogram(M.SPAN_SECONDS, span="test.off")
    with profiling.span("test.off", sync=True, device="cuda") as outer:
        with profiling.span("test.off", sync=True, job="j") as inner:
            pass
    assert outer is inner is None  # one shared null context
    assert profiling.span("a") is profiling.span("b", sync=True)
    assert profiling.records() == before
    assert _histogram(M.SPAN_SECONDS, span="test.off") == reg
    assert syncs == []


def test_sync_waits_for_a_card_only_while_tracing(tracing, syncs):
    with profiling.span("test.sync", sync=True, device="cuda"):
        pass
    assert len(syncs) == 1
    with profiling.span("test.sync", sync=True, device="cpu"), \
            profiling.span("test.sync", device="cuda"):
        pass
    assert len(syncs) == 1
    profiling.disable()
    with profiling.span("test.sync", sync=True, device="cuda"):
        pass
    assert len(syncs) == 1


def test_nesting_gives_parents_and_roots_per_thread(tracing):
    both = threading.Barrier(2)

    def request(k):
        with profiling.span("test.request", job=f"job{k}"):
            both.wait(timeout=10)
            with profiling.span("test.child"):
                both.wait(timeout=10)
                with profiling.span("test.grandchild"):
                    both.wait(timeout=10)
            with profiling.span("test.child"):
                pass

    threads = [threading.Thread(target=request, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    made = [r for r in tracing.new() if r["name"].startswith("test.")]
    assert len(made) == 8
    by_id = {r["id"]: r for r in made}
    roots = [r for r in made if r["parent"] is None]
    assert sorted(r["attrs"]["job"] for r in roots) == ["job0", "job1"]
    for root in roots:
        mine = [r for r in made if r["root"] == root["id"]]
        assert len(mine) == 4
        assert {r["thread"] for r in mine} == {root["thread"]}
        for r in mine:
            if r is root:
                continue
            parent = by_id[r["parent"]]
            assert parent["root"] == root["id"]
            assert parent["t0_ns"] <= r["t0_ns"] <= r["t1_ns"] \
                <= parent["t1_ns"]
            want = "test.child" if r["name"] == "test.grandchild" else \
                "test.request"
            assert parent["name"] == want


def test_registry_holds_each_span_s_seconds(tracing):
    name = f"test.registry.{time.monotonic_ns()}"
    for pause in (0.0, 0.01, 0.002):
        with profiling.span(name):
            time.sleep(pause)
    made = [r for r in tracing.new() if r["name"] == name]
    total, count = _histogram(M.SPAN_SECONDS, span=name)
    assert count == len(made) == 3
    assert total == pytest.approx(
        sum((r["t1_ns"] - r["t0_ns"]) / 1e9 for r in made), abs=1e-9)
    assert total >= 0.012
    assert f'span_seconds_count{{span="{name}"}} 3' in M.REGISTRY.render()


def test_export_chrome_gives_complete_events(tracing, tmp_path):
    with profiling.span("test.chrome", job="j1", task="t1"):
        with profiling.span("test.chrome.child"):
            pass
    path = tmp_path / "spans.json"
    profiling.export_chrome(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert len(events) == len(profiling.records())
    mine = {e["name"]: e for e in events if e["name"].startswith("test.chrome")}
    parent, child = mine["test.chrome"], mine["test.chrome.child"]
    for e in (parent, child):
        assert e["ph"] == "X" and e["dur"] >= 0
        assert {"pid", "tid", "ts", "args"} <= set(e)
    assert parent["args"]["job"] == "j1" and parent["args"]["task"] == "t1"
    assert child["args"]["parent"] == parent["args"]["id"]
    assert child["args"]["root"] == parent["args"]["id"]
    assert parent["ts"] <= child["ts"] <= child["ts"] + child["dur"] \
        <= parent["ts"] + parent["dur"] + 1e-3
    assert abs(parent["ts"] / 1e6 - time.time()) < 600  # epoch microseconds


@pytest.mark.parametrize("dtype", [np.int64, np.uint32])
def test_upload_is_word_equal_to_fp(tracing, dtype):
    rng = np.random.default_rng(7)
    words = rng.integers(0, F.P, size=(64, 5)).astype(dtype)
    words[0, :] = [0, 1, F.P - 1, F.P - 2, 12345]
    got = F.upload(words, "cpu")
    assert got.dtype == torch.int32
    assert torch.equal(got, F.fp(words, "cpu"))
    assert [r["name"] for r in tracing.new()] == ["upload"]


def test_prove_segment_records_its_layers(tracing):
    image = guests.echo()
    seg = Executor(image, guests.words([2, 11, 22]),
                   segment_po2=8).run().segments[0]
    prove._image_ctrl(image, 8, prove.TEST_PS, "cpu")  # not this span's
    r = prove.prove_segment(image, seg, prove.TEST_PS, device="cpu",
                            rng=np.random.default_rng(5))
    assert prove.verify_segment(r, prove.TEST_PS)
    made = tracing.new()
    roots = [s for s in made if s["name"] == "prove_segment"]
    assert len(roots) == 1
    root = roots[0]
    assert root["parent"] is None and root["attrs"] == {
        "po2": 8, "variant": "rv32i", "cols": 392}
    assert all(s["root"] == root["id"] for s in made)

    def children(of):
        return {s["name"]: s for s in made if s["parent"] == of["id"]}

    top = children(root)
    assert set(top) == {"zkvm.witness", "upload", "stark.prove"}
    stages = children(top["stark.prove"])
    assert set(stages) == set(STAGES)
    for parent, kids in ((root, top), (top["stark.prove"], stages)):
        span = parent["t1_ns"] - parent["t0_ns"]
        assert sum(k["t1_ns"] - k["t0_ns"] for k in kids.values()) <= span
        for k in kids.values():
            assert parent["t0_ns"] <= k["t0_ns"] <= k["t1_ns"] \
                <= parent["t1_ns"]
    order = sorted(STAGES, key=lambda n: stages[n]["t0_ns"])
    assert order == list(STAGES)


def _span_table_module(monkeypatch):
    """tools/span_table.py, loaded as a module (it sets the benchmark's
    build paths in the environment, put back after the test)."""
    import importlib.util
    import os

    for key in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        if key in os.environ:
            monkeypatch.setenv(key, os.environ[key])
        else:
            monkeypatch.delenv(key, raising=False)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "span_table.py")
    spec = importlib.util.spec_from_file_location("span_table_tool", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("guest,inputs,variant,cols", [
    ("echo", [2, 11, 22], "rv32i", 392),
    ("muldiv", [1234567, 89], "rv32im", 584)])
def test_segment_spans_name_the_air_and_its_lde(tracing, monkeypatch, guest,
                                                inputs, variant, cols):
    image = getattr(guests, guest)()
    seg = Executor(image, guests.words(inputs),
                   segment_po2=8).run().segments[0]
    prove._image_ctrl(image, 8, prove.TEST_PS, "cpu")
    r = prove.prove_segment(image, seg, prove.TEST_PS, device="cpu",
                            rng=np.random.default_rng(5))
    assert r.variant == variant
    assert prove.verify_segment(r, prove.TEST_PS)
    made = tracing.new()
    by_name = {s["name"]: s for s in made}
    lde_words = 4 * 256 * cols
    assert by_name["prove_segment"]["attrs"] == dict(po2=8, variant=variant,
                                                     cols=cols)
    assert by_name["stark.prove"]["attrs"] == dict(po2=8, variant=variant,
                                                   cols=cols)
    assert by_name["stark.commit"]["attrs"] == dict(
        variant=variant, cols=cols, lde_words=lde_words)
    table = _span_table_module(monkeypatch).span_table(made)
    rows = {row[0]: row for row in table}
    want = f"cols={cols} po2=8 variant={variant}"
    assert rows["prove_segment"][5] == want
    assert rows["prove_segment/stark.prove"][5] == want
    assert rows["prove_segment/stark.prove/stark.commit"][5] == \
        f"cols={cols} lde_words={lde_words} variant={variant}"
    assert rows["prove_segment/upload"][5] == "route=host"


def test_a_claim_records_the_task_s_wait():
    db = MemoryBackend()
    before = _histogram(M.TASK_WAIT, stream="test-wait")
    db.create_job("test-wait", {"kind": "exec"})
    time.sleep(0.03)
    task = db.request_work("test-wait")
    total, count = _histogram(M.TASK_WAIT, stream="test-wait")
    assert count == before[1] + 1
    assert 0.03 <= total - before[0] < 10
    assert task.ready_at > 0 and task.started_at >= task.ready_at
    # a retried task waits again from its new readiness
    db.update_task_retry(task.job_id, task.task_id, "try again")
    db.request_work("test-wait")
    assert _histogram(M.TASK_WAIT, stream="test-wait")[1] == before[1] + 2


def test_a_cluster_session_records_waits_and_task_roots(tracing):
    ctx = agent.ClusterContext(
        db=MemoryBackend(), hot=hotstore.HotStore(),
        store=storage.SharedFs(), ps=prove.TEST_PS, segment_po2=8,
        succinct=succinct.DevModeSystem(), dev_mode=True, device="cpu")
    capi = api.ClusterApi(ctx)
    capi.upload_image("loop", serde.dump_image(guests.loop_guest()))
    capi.upload_input("in", guests.words([900]))
    streams = ("exec", "prove", "join", "aux")
    waits = {s: _histogram(M.TASK_WAIT, stream=s)[1] for s in streams}
    job = capi.create_session(dict(img="loop", input="in",
                                   segment_po2=8))["uuid"]
    threads, agents = agent.run_workers(
        ctx, {s: 2 if s == "prove" else 1 for s in streams})
    try:
        deadline = time.time() + 60
        while capi.session_status(job)["status"] not in ("SUCCEEDED",
                                                         "FAILED"):
            assert time.time() < deadline
            time.sleep(0.05)
    finally:
        for a in agents:
            a.stop()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    assert capi.session_status(job)["status"] == "SUCCEEDED"
    tasks = [t for (j, _), t in ctx.db.tasks.items() if j == job]
    assert len(tasks) > 3 and all(t.retries == 0 for t in tasks)
    claimed = sum(_histogram(M.TASK_WAIT, stream=s)[1] - waits[s]
                  for s in streams)
    assert claimed == len(tasks)
    roots = [r for r in tracing.new() if r["name"].startswith("task.")
             and r["attrs"].get("job") == job]
    assert all(r["parent"] is None for r in roots)
    assert sorted((r["attrs"]["task"], r["name"]) for r in roots) == sorted(
        (t.task_id, f"task.{t.definition['kind']}") for t in tasks)


@pytest.mark.cuda
def test_a_synchronised_span_contains_its_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA sponge has no CPU mode")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from boundless_tpu_torch.kernels import poseidon2 as P2K

    dev = torch.device("cuda", 0)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, F.P, size=(1 << 16, 392)).astype(np.int32)).to(dev)
    P2K.hash_rows(x)  # the build and a warm launch
    torch.cuda.synchronize()
    profiling.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with profiling.span("test.sponge", sync=True, device=dev):
                before = P2K.LAUNCHES
                P2K.hash_rows(x)
                assert P2K.LAUNCHES == before + 1
    finally:
        profiling.disable()
    span = [r for r in profiling.records() if r["name"] == "test.sponge"][-1]
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "sponge" in e.name()]
    assert len(kernels) == 1
    start, end = kernels[0]
    assert span["t0_ns"] <= start < end <= span["t1_ns"], (span, kernels)
