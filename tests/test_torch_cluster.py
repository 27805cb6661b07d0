"""The port's proving cluster on the CPU: planner, taskdb, agent and API.

The planner must emit the JAX package's command sequence; the taskdb
cases of `tests/test_cluster.py` run on both of the port's backends; the
dev-mode sessions of `tests/test_cluster_succinct.py` (a multi-segment
session, composition resolve, a missing assumption, the snark wrap) run
through both packages' clusters, and the port's session receipt must give
the JAX receipt's claim digest, journal and stats. One echo session is
proved for real at po2 8 over HTTP (`succinct=None`, the v1 aggregation),
and its receipt verifies. Every port cluster runs with `device="cpu"`.
"""

import contextlib
import io
import sys
import threading
import time
import types

import pytest

from boundless_tpu import cli as JCLI
from boundless_tpu.cluster import agent as JAGENT
from boundless_tpu.cluster import api as JAPI
from boundless_tpu.cluster import executor_service as JEXS
from boundless_tpu.cluster import hotstore as JHOT
from boundless_tpu.cluster import planner as JPLANNER
from boundless_tpu.cluster import storage as JSTORE
from boundless_tpu.cluster import taskdb as JTASKDB
from boundless_tpu.recursion import succinct as JSU
from boundless_tpu.utils import serde as JSERDE
from boundless_tpu.zkvm import guests as JGUESTS
from boundless_tpu.zkvm import prove as JPROVE
from boundless_tpu_torch import cli
from boundless_tpu_torch.cluster import agent, api, executor_service
from boundless_tpu_torch.cluster import hotstore, storage, taskdb
from boundless_tpu_torch.cluster.planner import Kind, Planner
from boundless_tpu_torch.cluster.taskdb import (MemoryBackend, Priority,
                                                SqliteBackend, TaskState)
from boundless_tpu_torch.recursion import claims, succinct
from boundless_tpu_torch.utils import serde
from boundless_tpu_torch.zkvm import guests, prove

PO2 = 8
BACKENDS = [MemoryBackend, SqliteBackend]

JAX = types.SimpleNamespace(agent=JAGENT, api=JAPI, hot=JHOT, store=JSTORE,
                            taskdb=JTASKDB, serde=JSERDE, succinct=JSU,
                            prove=JPROVE, guests=JGUESTS, dev={})
PORT = types.SimpleNamespace(agent=agent, api=api, hot=hotstore,
                             store=storage, taskdb=taskdb, serde=serde,
                             succinct=succinct, prove=prove, guests=guests,
                             dev={"device": "cpu"})


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _plan(cls, segments, keccaks):
    p = cls()
    for i in range(segments):
        p.enqueue_segment(i)
    for i in range(keccaks):
        p.enqueue_keccak(i)
    p.finish()
    cmds = [(c.kind.value, c.task_id, c.height, c.deps, c.payload)
            for c in p.drain()]
    return cmds, p.root, p.keccak_root


@pytest.mark.parametrize("keccaks", [0, 5])
@pytest.mark.parametrize("segments", range(1, 34))
def test_planner_sequence_equals_jax(segments, keccaks):
    cmds, root, kroot = _plan(Planner, segments, keccaks)
    assert (cmds, root, kroot) == _plan(JPLANNER.Planner, segments, keccaks)
    kinds = [c[0] for c in cmds]
    assert kinds.count("segment") == segments
    assert kinds.count("join") == segments - 1
    assert kinds.count("union") == max(keccaks - 1, 0)
    seen = set()
    for _, tid, _, deps, _ in cmds:  # dependency order
        assert all(d in seen for d in deps)
        seen.add(tid)
    assert cmds[-1][0] == Kind.FINALIZE.value


# ---------------------------------------------------------------------------
# taskdb (the cases of tests/test_cluster.py, on both port backends)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_dag_flow(backend_cls):
    db = backend_cls()
    job = db.create_job("exec", {"kind": "exec"})
    assert db.request_work("exec").task_id == "init"
    db.create_task(job, "p0", "prove", {"i": 0}, [])
    db.create_task(job, "p1", "prove", {"i": 1}, [])
    db.create_task(job, "j0", "join", {}, ["p0", "p1"])
    db.update_task_done(job, "init", {"segments": 2})
    assert db.request_work("join", timeout=0.05) is None
    a = db.request_work("prove")
    b = db.request_work("prove")
    assert {a.task_id, b.task_id} == {"p0", "p1"}
    db.update_task_done(job, a.task_id, {})
    assert db.request_work("join", timeout=0.05) is None
    db.update_task_done(job, b.task_id, {})
    assert db.request_work("join").task_id == "j0"
    db.update_task_done(job, "j0", {"root": "r"})
    assert db.job_state(job)["state"] == taskdb.JobState.DONE
    assert db.task_output(job, "j0") == {"root": "r"}


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_retry_and_fail(backend_cls):
    db = backend_cls()
    job = db.create_job("prove", {"kind": "prove"}, max_retries=1)
    t = db.request_work("prove")
    assert db.update_task_retry(job, t.task_id, "boom") is True
    t = db.request_work("prove")
    assert t.retries == 1
    assert db.update_task_retry(job, t.task_id, "boom2") is False
    st = db.job_state(job)
    assert st["state"] == taskdb.JobState.FAILED and "boom2" in st["error"]


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_lease_requeue(backend_cls):
    db = backend_cls()
    job = db.create_job("prove", {}, timeout_secs=0.01)
    t = db.request_work("prove")
    time.sleep(0.05)
    assert db.requeue_expired() == 1
    t2 = db.request_work("prove")
    assert t2.task_id == t.task_id
    db.update_task_done(job, t2.task_id, {"ok": 1})
    assert db.job_state(job)["state"] == taskdb.JobState.DONE


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_priorities(backend_cls):
    db = backend_cls()
    db.create_job("prove", {"n": "low"}, priority=Priority.LOW)
    db.create_job("prove", {"n": "high"}, priority=Priority.HIGH)
    assert db.request_work("prove").definition["n"] == "high"


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_blocking_claim(backend_cls):
    db = backend_cls()
    got = []
    th = threading.Thread(
        target=lambda: got.append(db.request_work("prove", timeout=2.0)))
    th.start()
    time.sleep(0.05)
    db.create_job("prove", {"x": 1})
    th.join(timeout=3)
    assert got and got[0] is not None


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_stuck_pending_fixer(backend_cls):
    db = backend_cls()
    job = db.create_job("exec", {})
    db.create_task(job, "a", "prove", {}, [])
    db.create_task(job, "b", "join", {}, ["a"])
    db.request_work("prove")
    # mark the dependency done without decrementing its dependents
    if backend_cls is MemoryBackend:
        with db._cond:
            db.tasks[(job, "a")].state = TaskState.DONE
    else:
        with db._lock:
            db._db.execute("UPDATE tasks SET state='done' WHERE job_id=? "
                           "AND task_id='a'", (job,))
            db._db.commit()
    assert db.find_stuck_pending() == [(job, "b")]
    assert db.fix_stuck_pending() == 1
    db.request_work("exec")
    assert db.request_work("join").task_id == "b"


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_fair_share(backend_cls):
    db = backend_cls()
    db.set_user_quota("alice", reserved=2, be_mult=1.0)
    db.set_user_quota("bob", reserved=0, be_mult=3.0)
    jobs = {}
    for user in ("alice", "bob"):
        jobs[user] = db.create_job("prove", {"kind": "prove"}, user=user)
        for i in range(6):
            db.create_task(jobs[user], f"t{i}", "prove", {"i": i}, [])
    first = [db.request_work("prove") for _ in range(2)]
    assert [t.job_id for t in first] == [jobs["alice"]] * 2
    rest = [db.request_work("prove") for _ in range(8)]
    assert sum(1 for t in rest if t.job_id == jobs["bob"]) >= 5


@pytest.mark.parametrize("backend_cls", BACKENDS)
def test_taskdb_fair_share_single_user_fifo(backend_cls):
    db = backend_cls()
    job = db.create_job("prove", {"kind": "prove"})
    for i in range(3):
        db.create_task(job, f"t{i}", "prove", {"i": i}, [])
    db.request_work("prove")  # init
    assert [db.request_work("prove").task_id for _ in range(3)] == \
        ["t0", "t1", "t2"]


def test_aux_agent_runs_maintenance_crons():
    db = MemoryBackend()
    ctx = agent.ClusterContext(db=db, hot=hotstore.HotStore(ttl=0.01),
                               store=storage.SharedFs(), succinct=None,
                               device="cpu")
    db.create_job("prove", {"kind": "x"}, timeout_secs=0.01)
    t = db.request_work("prove")
    ctx.hot.set("ephemeral", 1)
    aux = agent.Agent(ctx, "aux")
    th = threading.Thread(target=aux.poll_work, args=(2.5,), daemon=True)
    th.start()
    got, deadline = None, time.time() + 5
    while got is None and time.time() < deadline:
        got = db.request_work("prove", timeout=0.1)
    aux.stop()
    assert got is not None and got.task_id == t.task_id
    assert ctx.hot.get("ephemeral") is None


def test_context_refuses_a_missing_card(monkeypatch):
    """The cluster proves on the card by default; without one the context
    raises the port's error."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agent.ClusterContext(db=MemoryBackend(), hot=hotstore.HotStore(),
                             store=storage.SharedFs(), succinct=None)


# ---------------------------------------------------------------------------
# dev-mode sessions through both clusters
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True, scope="module")
def zero_lineages():
    """Fill both packages' zero-page lineages before any cluster runs. The
    reference's `paging._ZeroLineage` has no lock: worker threads that
    extend it at once append a level twice, and every memory root after
    that is wrong (the port's copy locks it, `test_zero_lineage_threads`).
    Filled here, the JAX cluster gives its exact claims."""
    from boundless_tpu.zkvm import paging as jpaging
    from boundless_tpu_torch.zkvm import paging

    for pg in (jpaging, paging):
        pg.ZERO[pg.DEPTH]


@pytest.fixture
def fast_switches():
    """Threads switch every microsecond: a lost update shows."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    yield
    sys.setswitchinterval(interval)


def run_threads(n, fn):
    ths = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in ths)


def test_zero_lineage_threads(fast_switches):
    from boundless_tpu_torch.zkvm import paging

    want = [paging.ZERO[d] for d in range(paging.DEPTH + 1)]
    for _ in range(6):
        fresh = paging._ZeroLineage()
        got = [None] * 8
        run_threads(8, lambda i: got.__setitem__(i, fresh[paging.DEPTH]))
        assert got == [want[-1]] * 8
        assert fresh._cache == want


def test_counters_exact_under_threads(fast_switches):
    """The counters that the cluster's worker threads share (the sponge's
    launches, the native evaluations and witnesses) lose no update."""
    from boundless_tpu_torch.kernels import poseidon2 as P2K
    from boundless_tpu_torch.recursion import vm
    from boundless_tpu_torch.zkvm.executor import Executor

    prog = vm.Prog("square")
    b = prog.input()
    prog.assert_eq(prog.pub(0), prog.mul(b, b))
    prog.finalize(256)
    image = guests.echo()
    seg = Executor(image, guests.words([1, 3]), segment_po2=PO2).run(
        ).segments[0]
    launches, by_layout = P2K.LAUNCHES, P2K.LAUNCHES_BY_LAYOUT["lanes1"]
    evals, witnesses = vm.NATIVE_EVALS, prove.NATIVE_WITNESSES

    def work(i):
        for _ in range(2000):
            P2K._count("lanes1")
        for _ in range(3):
            vm.evaluate_native(prog, [(3, 0, 0, 0)], [9])
        prove._gen_witness(image, seg)

    run_threads(16, work)
    assert P2K.LAUNCHES - launches == 16 * 2000
    assert P2K.LAUNCHES_BY_LAYOUT["lanes1"] - by_layout == 16 * 2000
    assert vm.NATIVE_EVALS - evals == 16 * 3
    assert prove.NATIVE_WITNESSES - witnesses == 16


def dev_cluster(p):
    ctx = p.agent.ClusterContext(
        db=p.taskdb.MemoryBackend(), hot=p.hot.HotStore(),
        store=p.store.SharedFs(), ps=p.prove.TEST_PS, segment_po2=PO2,
        succinct=p.succinct.DevModeSystem(), dev_mode=True, **p.dev)
    return ctx, p.api.ClusterApi(ctx)


def run_job(p, ctx, cluster_api, img, input_bytes, timeout=60,
            streams=("exec", "prove", "join", "aux")):
    input_id = f"in-{time.monotonic_ns()}"
    cluster_api.upload_input(input_id, input_bytes)
    job = cluster_api.create_session(dict(img=img, input=input_id,
                                          segment_po2=PO2))["uuid"]
    counts = {s: 2 if s == "prove" else 1 for s in streams}
    threads, agents = p.agent.run_workers(ctx, counts)
    deadline = time.time() + timeout
    try:
        while time.time() < deadline:
            st = cluster_api.session_status(job)
            if st["status"] in ("SUCCEEDED", "FAILED"):
                break
            time.sleep(0.05)
    finally:
        for a in agents:
            a.stop()
        for t in threads:
            t.join(timeout=5)
    return job, cluster_api.session_status(job)


def both(make):
    """`make(package)` run through the JAX cluster and the port's."""
    return make(JAX), make(PORT)


def _summary(p, ctx, job, st):
    session = ctx.store.get("receipts/stark", job)
    return dict(status=st["status"], stats=st.get("stats"),
                digest=session.root.claim.digest(), journal=session.journal,
                image_id=tuple(session.image_id), entry_pc=session.entry_pc,
                mem_root=session.image_mem_root)


def test_devmode_multisegment_session_equals_jax():
    def make(p):
        ctx, capi = dev_cluster(p)
        capi.upload_image("loop", p.serde.dump_image(p.guests.loop_guest()))
        job, st = run_job(p, ctx, capi, "loop", p.guests.words([900]))
        assert st["status"] == "SUCCEEDED", st
        return ctx, job, _summary(p, ctx, job, st)

    (_, _, jres), (ctx, job, res) = both(make)
    assert res == jres
    assert res["stats"]["segments"] > 1
    session = ctx.store.get("receipts/stark", job)
    assert isinstance(session, succinct.SuccinctSessionReceipt)
    assert session.journal == guests.words([900])
    assert succinct.verify_session(session, ctx.succinct)
    c = session.root.claim
    assert c.halted and c.is_genesis(guests.loop_guest().entry)
    assert c.post_journal == claims.fold_words(claims.ZERO_CHAIN, [900])


def test_devmode_composition_resolve_equals_jax():
    def make(p):
        ctx, capi = dev_cluster(p)
        capi.upload_image("echo", p.serde.dump_image(p.guests.echo()))
        capi.upload_image("identity",
                          p.serde.dump_image(p.guests.identity()))
        job1, st1 = run_job(p, ctx, capi, "echo", p.guests.words([2, 7, 9]))
        assert st1["status"] == "SUCCEEDED", st1
        dw = ctx.store.get("receipts/stark", job1).root.claim.digest_words()
        job2, st2 = run_job(p, ctx, capi, "identity", p.guests.words(dw))
        assert st2["status"] == "SUCCEEDED", st2
        return ctx, job2, _summary(p, ctx, job2, st2)

    (_, _, jres), (ctx, job2, res) = both(make)
    assert res == jres
    session = ctx.store.get("receipts/stark", job2)
    assert succinct.verify_session(session, ctx.succinct)
    assert session.root.claim.post_assumptions == claims.ZERO_CHAIN


def test_devmode_missing_assumption_fails_like_jax():
    def make(p):
        ctx, capi = dev_cluster(p)
        capi.upload_image("identity",
                          p.serde.dump_image(p.guests.identity()))
        _, st = run_job(p, ctx, capi, "identity",
                        p.guests.words(list(range(8))), timeout=25)
        return st["status"], "no receipt for assumption" in (
            st.get("error_msg") or "")

    assert both(make) == (("FAILED", True), ("FAILED", True))


def test_devmode_snark_task_equals_jax():
    """The session's wrap through the cluster's snark stream (dev mode)."""
    def make(p):
        ctx, capi = dev_cluster(p)
        capi.upload_image("echo", p.serde.dump_image(p.guests.echo()))
        job, st = run_job(p, ctx, capi, "echo", p.guests.words([1, 5]))
        assert st["status"] == "SUCCEEDED", st
        snark = capi.create_snark({"session_id": job})["uuid"]
        a = p.agent.Agent(ctx, "snark")
        a.poll_work(idle_timeout=0.3)
        assert capi.session_status(snark)["status"] == "SUCCEEDED"
        w = ctx.store.get("receipts/groth16", snark)
        return w.journal, bytes(w.claim_digest), w.dev_mode, w.kind

    jres, res = both(make)
    assert res == jres and res[0] == guests.words([5]) and res[2]


def test_execute_only_and_failed_guest():
    ctx = agent.ClusterContext(db=MemoryBackend(), hot=hotstore.HotStore(),
                               store=storage.SharedFs(), ps=prove.TEST_PS,
                               segment_po2=PO2, succinct=None, device="cpu")
    capi = api.ClusterApi(ctx)
    capi.upload_image("echo", serde.dump_image(guests.echo()))
    capi.upload_input("in0", guests.words([1, 42]))
    job = capi.create_session(dict(img="echo", input="in0",
                                   execute_only=True))["uuid"]
    capi.upload_image("bad", serde.dump_image(guests.build(".word 0xffffffff")))
    capi.upload_input("empty", b"")
    bad = capi.create_session(dict(img="bad", input="empty"))["uuid"]
    agent.Agent(ctx, "exec").poll_work(idle_timeout=0.5)
    st = capi.session_status(job)
    assert st["status"] == "SUCCEEDED", st
    assert st["stats"]["segments"] == 1 and st["stats"]["total_cycles"] > 0
    st = capi.session_status(bad)
    assert st["status"] == "FAILED" and "GuestFault" in st["error_msg"]
    assert "exec/done" in capi.metrics()


def test_executor_service_and_cli_execute_equal_jax():
    image = guests.echo()
    import pickle

    res = executor_service.default_registry().get("rv32im").execute(
        pickle.dumps(image), guests.words([2, 3, 4]))
    jres = JEXS.default_registry().get("rv32im").execute(
        pickle.dumps(JGUESTS.echo()), JGUESTS.words([2, 3, 4]))
    assert res == executor_service.ExecutionResult(**vars(jres))
    argv = ["prover", "execute", "echo", "--input",
            guests.words([1, 9]).hex(), "--po2", str(PO2)]
    outs = []
    for main in (cli.main, JCLI.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and '"segments": 1' in outs[0]


# ---------------------------------------------------------------------------
# a real proof over HTTP
# ---------------------------------------------------------------------------


def test_real_echo_session_over_http():
    ctx = agent.ClusterContext(db=MemoryBackend(), hot=hotstore.HotStore(),
                               store=storage.SharedFs(), ps=prove.TEST_PS,
                               segment_po2=PO2, succinct=None, device="cpu")
    capi = api.ClusterApi(ctx)
    server, thread = api.make_http_server(capi)
    thread.start()
    client = api.BentoClient(f"http://127.0.0.1:{server.server_address[1]}")
    threads, agents = agent.run_workers(
        ctx, {"exec": 1, "prove": 2, "join": 1, "aux": 1})
    try:
        payload = [77, 88, 99]
        client.upload_image("echo", guests.echo())
        client.upload_input("in1", guests.words([len(payload)] + payload))
        job = client.create_session("echo", "in1", segment_po2=PO2)
        st = client.wait(job, timeout=300)
        assert st["status"] == "SUCCEEDED", st
        session = client.receipt(job)
        assert session.journal == guests.words(payload)
        assert session.verify(ps=prove.TEST_PS, image=guests.echo())
        assert client.journal(job) == guests.words(payload)
        assert b"exec" in client._req("GET", "/workers/metrics")
    finally:
        for a in agents:
            a.stop()
        server.shutdown()
