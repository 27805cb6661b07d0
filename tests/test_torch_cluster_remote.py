"""The port's cross-process cluster on the CPU: the HTTP worker plane,
remote workers, kill -9 lease requeue, API keys, and the data plane
(verbs, atomicity, lease requeue, two hosts, a restarted sqlite server).

The non-slow cases of `tests/test_cluster_remote.py` and
`tests/test_dataplane.py`, run on `boundless_tpu_torch` with
`device="cpu"` (remote worker processes with `--device cpu`). This file
imports no JAX. The `cuda` cases skip without a card: there a session runs
with `device="cuda"`, its `receipts/stark` file must hold only CPU tensors,
and a process that sees no card must load it; and `cli cluster serve
--succinct real` proves a session on the card.
"""

import json
import multiprocessing as mp
import os
import pickle
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from boundless_tpu_torch.cluster import remote
from boundless_tpu_torch.cluster.agent import Agent, ClusterContext
from boundless_tpu_torch.cluster.api import (BentoClient, ClusterApi,
                                             make_http_server)
from boundless_tpu_torch.cluster.dataplane import (DataPlaneServer,
                                                   RemoteBackend,
                                                   RemoteHotStore, connect)
from boundless_tpu_torch.cluster.hotstore import HotStore
from boundless_tpu_torch.cluster.storage import SharedFs
from boundless_tpu_torch.cluster.taskdb import MemoryBackend, TaskState
from boundless_tpu_torch.recursion import succinct as S
from boundless_tpu_torch.utils import serde
from boundless_tpu_torch.zkvm import guests, prove

PO2 = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_server(device="cpu", **ctx_kw):
    ctx_kw.setdefault("succinct", None)  # v1 aggregation unless specified
    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                         store=SharedFs(), ps=prove.TEST_PS,
                         segment_po2=PO2, device=device, **ctx_kw)
    api = ClusterApi(ctx)
    server, thread = make_http_server(api)
    thread.start()
    return ctx, api, server, f"http://127.0.0.1:{server.server_address[1]}"


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **extra)
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# the HTTP worker plane (tests/test_cluster_remote.py)
# ---------------------------------------------------------------------------


def test_remote_fabric_planes():
    ctx, api, server, url = start_server(succinct=S.DevModeSystem(),
                                         dev_mode=True)
    try:
        rctx = remote.connect(url, device="cpu")
        assert rctx.segment_po2 == PO2 and rctx.dev_mode is True
        assert rctx.device == "cpu" and hasattr(rctx.succinct, "DEV_ROOT")
        assert rctx.ps == prove.TEST_PS
        rctx.hot.set("job:x:segments:0", {"n": 3, "blob": b"\x01\x02"})
        assert rctx.hot.get("job:x:segments:0") == {"n": 3,
                                                    "blob": b"\x01\x02"}
        rctx.hot.delete("job:x:segments:0")
        assert rctx.hot.get("job:x:segments:0") is None
        rctx.store.put_bytes("inputs", "i", b"raw")
        assert rctx.store.get_bytes("inputs", "i") == b"raw"
        assert rctx.store.exists("inputs", "i")
        assert not rctx.store.exists("inputs", "nope")
        img = guests.echo()
        rctx.store.put("elfs", "echo", img)
        back = rctx.store.get("elfs", "echo")
        assert back.words == img.words and back.entry == img.entry
    finally:
        server.shutdown()


def test_remote_workers_complete_session():
    ctx, api, server, url = start_server(succinct=S.DevModeSystem(),
                                         dev_mode=True)
    agents, threads = [], []
    try:
        rctx = remote.connect(url, device="cpu")
        client = BentoClient(url)
        client.upload_image("echo", guests.echo())
        payload = [5, 6]
        client.upload_input("in0", guests.words([len(payload)] + payload))
        job = client.create_session("echo", "in0", segment_po2=PO2)
        for stream in ("exec", "prove", "join", "aux"):
            a = Agent(rctx, stream, f"r-{stream}")
            agents.append(a)
            threads.append(threading.Thread(target=a.poll_work,
                                            args=(120.0,), daemon=True))
            threads[-1].start()
        st = client.wait(job, timeout=120)
        assert st["status"] == "SUCCEEDED", st
        session = client.receipt(job)
        assert session.journal == guests.words(payload)
        assert isinstance(session, S.SuccinctSessionReceipt)
        assert S.verify_session(session, S.DevModeSystem())
    finally:
        for a in agents:
            a.stop()
        for t in threads:
            t.join(timeout=5)
        server.shutdown()


def test_remote_worker_processes_complete_session():
    """Two worker processes (`python -m boundless_tpu_torch.cluster.remote
    --device cpu`), zero shared memory, complete a dev-mode session."""
    ctx, api, server, url = start_server(succinct=S.DevModeSystem(),
                                         dev_mode=True)
    procs = []
    try:
        client = BentoClient(url)
        client.upload_image("echo", guests.echo())
        payload = [9, 8, 7]
        client.upload_input("in0", guests.words([len(payload)] + payload))
        job = client.create_session("echo", "in0", segment_po2=PO2)
        for streams in ("exec,aux", "prove,join"):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "boundless_tpu_torch.cluster.remote",
                 "--api-url", url, "--stream", streams, "--device", "cpu",
                 "--idle-timeout", "60"],
                env=_env(), stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE))
        st = client.wait(job, timeout=120)
        assert st["status"] == "SUCCEEDED", (
            st, [p.stderr.read()[-800:] if p.poll() is not None else b""
                 for p in procs])
        assert client.receipt(job).journal == guests.words(payload)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        server.shutdown()


def test_kill9_worker_lease_requeue():
    ctx, api, server, url = start_server()
    try:
        job = ctx.db.create_job("prove", {"kind": "raw"}, timeout_secs=1.0)
        victim_src = (
            "import json,sys,time,urllib.request\n"
            f"req=urllib.request.Request('{url}/workers/tasks/claim/prove',"
            "data=json.dumps({'worker_id':'victim'}).encode(),"
            "method='POST')\n"
            "out=json.load(urllib.request.urlopen(req))\n"
            "assert out['task'] is not None, out\n"
            "print('claimed', flush=True)\n"
            "time.sleep(3600)\n")
        victim = subprocess.Popen([sys.executable, "-c", victim_src],
                                  stdout=subprocess.PIPE)
        assert victim.stdout.readline().strip() == b"claimed"
        task = ctx.db.tasks[(job, "init")]
        assert task.state == TaskState.RUNNING
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait()
        time.sleep(1.1)
        assert api.worker_maintenance({"op": "requeue"})["requeued"] == 1
        assert task.state == TaskState.READY

        def post(path, obj):
            req = urllib.request.Request(url + path,
                                         data=json.dumps(obj).encode(),
                                         method="POST")
            return json.load(urllib.request.urlopen(req))

        claimed = post("/workers/tasks/claim/prove",
                       {"worker_id": "survivor"})
        assert claimed["task"]["task_id"] == "init"
        assert claimed["task"]["retries"] == 1
        post("/workers/tasks/done",
             dict(job_id=job, task_id="init", output={"ok": True}))
        assert ctx.db.job_state(job)["state"].value == "done"
    finally:
        server.shutdown()


def test_api_keys_and_session_ownership():
    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                         store=SharedFs(), ps=prove.TEST_PS,
                         segment_po2=PO2, succinct=None, device="cpu")
    api = ClusterApi(ctx, api_keys={"k-alice": "alice", "k-bob": "bob"})
    server, thread = make_http_server(api)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        alice = BentoClient(url, api_key="k-alice")
        bob = BentoClient(url, api_key="k-bob")
        nobody = BentoClient(url)
        img_id = alice.upload_image("echo", guests.echo())
        inp_id = alice.upload_input("i0", guests.words([2, 7, 9]))
        sid = alice.create_session(img_id, inp_id, execute_only=True)
        assert ctx.db.job_user(sid) == "alice"
        assert alice.session_status(sid)["status"] in ("RUNNING",
                                                       "SUCCEEDED")
        with pytest.raises(urllib.error.HTTPError) as ei:
            bob.session_status(sid)
        assert ei.value.code == 401
        with pytest.raises(urllib.error.HTTPError) as ei:
            nobody.create_session(img_id, inp_id)
        assert ei.value.code == 401
    finally:
        server.shutdown()


def test_worker_plane_token():
    """A bearer token guards /workers/*; a non-loopback bind needs one."""
    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                         store=SharedFs(), succinct=None, device="cpu")
    with pytest.raises(ValueError):
        make_http_server(ClusterApi(ctx), host="0.0.0.0")
    server, thread = make_http_server(ClusterApi(ctx), token="s3cret")
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(RuntimeError, match="401"):
            remote.connect(url, device="cpu")
        rctx = remote.connect(url, token="s3cret", device="cpu")
        assert rctx.succinct is None
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# the data plane (tests/test_dataplane.py)
# ---------------------------------------------------------------------------


def test_verbs_roundtrip_and_atomicity():
    srv = DataPlaneServer(port=0).start()
    try:
        db, hot = connect(srv.addr)
        job = db.create_job("exec", {"kind": "t"}, user="alice")
        t = db.request_work("exec", timeout=1.0)
        assert t is not None and t.task_id == "init"
        db.create_task(job, "t1", "exec", {"n": 1}, [])
        db.update_task_done(job, "init", {})
        t = db.request_work("exec", timeout=1.0)
        assert t is not None and t.task_id == "t1"
        db2 = RemoteBackend(srv.addr)
        assert db2.request_work("exec", timeout=0.0) is None
        db.update_task_done(job, "t1", {"ok": 1})
        assert db2.job_state(job)["state"].value == "done"
        assert db2.task_output(job, "t1") == {"ok": 1}
        hot.set("k", {"v": 7, "t": torch.arange(3, dtype=torch.int32)},
                ttl=60)
        got = RemoteHotStore(srv.addr).get("k")
        assert got["v"] == 7 and got["t"].tolist() == [0, 1, 2]
        hot.delete("k")
        assert RemoteHotStore(srv.addr).get("k") is None
    finally:
        srv.shutdown()


def test_dep_decrement_and_retry_over_wire():
    srv = DataPlaneServer(port=0).start()
    try:
        db = RemoteBackend(srv.addr)
        job = db.create_job("exec", {}, user="u")
        init = db.request_work("exec")
        db.create_task(job, "a", "exec", {}, [])
        db.create_task(job, "b", "exec", {}, ["a"], max_retries=1)
        db.update_task_done(job, init.task_id, {})
        assert db.request_work("exec").task_id == "a"
        assert db.request_work("exec") is None
        db.update_task_done(job, "a", {})
        assert db.request_work("exec").task_id == "b"
        assert db.update_task_retry(job, "b", "flake") is True
        t = db.request_work("exec")
        assert t.task_id == "b" and t.retries == 1
        assert db.update_task_retry(job, "b", "flake2") is False
        assert db.job_state(job)["state"].value == "failed"
    finally:
        srv.shutdown()


def _claim_and_die(addr, job):
    db = RemoteBackend(addr)
    assert db.request_work("exec", timeout=2.0) is not None
    os.kill(os.getpid(), signal.SIGKILL)  # die holding the lease


def test_lease_requeue_after_remote_worker_death():
    srv = DataPlaneServer(port=0).start()
    try:
        db = RemoteBackend(srv.addr)
        job = db.create_job("exec", {}, user="u")
        init = db.request_work("exec")
        db.create_task(job, "t", "exec", {}, [], timeout_secs=0.2)
        db.update_task_done(job, init.task_id, {})
        p = mp.get_context("spawn").Process(target=_claim_and_die,
                                            args=(srv.addr, job))
        p.start()
        p.join(60)
        assert p.exitcode == -signal.SIGKILL
        assert db.request_work("exec") is None  # still leased
        time.sleep(0.25)
        assert db.requeue_expired() == 1
        t = db.request_work("exec", timeout=1.0)
        assert t is not None and t.task_id == "t"
        db.update_task_done(job, "t", {})
        assert db.job_state(job)["state"].value == "done"
    finally:
        srv.shutdown()


def _frontend_host(addr, store_root, out_q):
    """One host: its own ClusterContext over the shared data plane, running
    an exec agent."""
    db, hot = connect(addr)
    ctx = ClusterContext(db=db, hot=hot, store=SharedFs(store_root),
                         ps=prove.TEST_PS, segment_po2=8, succinct=None,
                         device="cpu")
    Agent(ctx, "exec").poll_work(idle_timeout=1.5)
    out_q.put("done")


def test_two_host_shared_job():
    srv = DataPlaneServer(port=0).start()
    store = SharedFs()
    try:
        db, hot = connect(srv.addr)
        ctx = ClusterContext(db=db, hot=hot, store=store, ps=prove.TEST_PS,
                             segment_po2=8, succinct=None, device="cpu")
        api = ClusterApi(ctx)
        api.upload_image("echo", serde.dump_image(guests.echo()))
        api.upload_input("in0", guests.words([1, 5]))
        job = api.create_session(dict(img="echo", input="in0",
                                      execute_only=True))["uuid"]
        mpc = mp.get_context("spawn")
        q = mpc.Queue()
        p = mpc.Process(target=_frontend_host,
                        args=(srv.addr, store.root, q))
        p.start()
        assert q.get(timeout=120) == "done"
        p.join(10)
        st = api.session_status(job)
        assert st["status"] == "SUCCEEDED", st
        assert st["stats"]["total_cycles"] > 0
    finally:
        srv.shutdown()


def test_sqlite_server_restart_durability(tmp_path):
    db_path = str(tmp_path / "taskdb.sqlite")
    srv = DataPlaneServer(port=0, sqlite_path=db_path).start()
    addr = srv.addr
    db = RemoteBackend(addr)
    job = db.create_job("exec", {"k": 1}, user="u")
    init = db.request_work("exec")
    db.create_task(job, "t", "exec", {}, [])
    db.update_task_done(job, init.task_id, {})
    srv.shutdown()
    srv2 = DataPlaneServer(host=addr[0], port=addr[1],
                           sqlite_path=db_path).start()
    try:
        t = db.request_work("exec", timeout=2.0)
        assert t is not None and t.task_id == "t"
        db.update_task_done(job, "t", {})
        assert db.job_state(job)["state"].value == "done"
    finally:
        srv2.shutdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

NO_CARD_LOAD = r"""
import pickle, sys, torch
from boundless_tpu_torch.utils import serde
from boundless_tpu_torch.zkvm import prove
assert not torch.cuda.is_available()
with open(sys.argv[1], "rb") as f:
    obj = pickle.load(f)
back = serde.load_session_receipt(serde.dump_session_receipt(obj),
                                  device="cpu")
if sys.argv[2] == "v1":
    assert back.verify(ps=prove.TEST_PS)
print("LOADED", back.journal.hex())
"""


def _tensors(obj, out):
    """Every tensor reachable from `obj` (named tuples, dataclasses,
    containers)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            _tensors(getattr(obj, name), out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dev", "v1"])
def test_card_session_receipt_loads_without_a_card(mode, tmp_path):
    """A session finished with device="cuda" (dev mode, and a real v1
    aggregation proved on the card) leaves a receipts/stark file of CPU
    tensors, which a process that sees no card unpickles and loads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cluster proves on the card")
    kw = (dict(succinct=S.DevModeSystem(), dev_mode=True) if mode == "dev"
          else dict(succinct=None))
    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(),
                         store=SharedFs(str(tmp_path / "store")),
                         ps=prove.TEST_PS, segment_po2=PO2, device="cuda",
                         **kw)
    api = ClusterApi(ctx)
    api.upload_image("echo", serde.dump_image(guests.echo()))
    api.upload_input("in0", guests.words([2, 4, 6]))
    job = api.create_session(dict(img="echo", input="in0"))["uuid"]
    from boundless_tpu_torch.cluster.agent import run_workers

    threads, agents = run_workers(ctx, {"exec": 1, "prove": 1, "join": 1,
                                        "aux": 1})
    try:
        deadline = time.time() + 300
        while api.session_status(job)["status"] not in ("SUCCEEDED",
                                                         "FAILED"):
            assert time.time() < deadline
            time.sleep(0.1)
    finally:
        for a in agents:
            a.stop()
    st = api.session_status(job)
    assert st["status"] == "SUCCEEDED", st
    path = os.path.join(ctx.store.root, "receipts/stark", job)
    with open(path, "rb") as f:
        stored = pickle.load(f)
    found = _tensors(stored, [])
    assert all(t.device.type == "cpu" for t in found)
    if mode == "v1":  # the segment proofs were made on the card
        assert found
    out = subprocess.run([sys.executable, "-c", NO_CARD_LOAD, path, mode],
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"LOADED {guests.words([4, 6]).hex()}" in out.stdout


@pytest.mark.cuda
def test_cli_cluster_serve_proves_on_the_card(tmp_path):
    """`python -m boundless_tpu_torch.cli cluster serve --succinct real`
    brings up the API and workers on the card; an echo session submitted
    over HTTP is proved, lifted and finalized there (CI sizing: seg po2 8,
    2 queries, rec_po2 17)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cluster proves on the card")
    cfg = dict(segment_po2=PO2, proof_system=dict(queries=2,
                                                  fri_min_degree=16),
               recursion=dict(rec_po2=17),
               workers=dict(exec=1, prove=1, join=1, aux=1),
               api=dict(port=0), storage_root=str(tmp_path / "store"))
    cfg_path = tmp_path / "cluster.json"
    cfg_path.write_text(json.dumps(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "boundless_tpu_torch.cli", "cluster", "serve",
         "--succinct", "real", "--config", str(cfg_path)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://127\.0\.0\.1:(\d+) .*device: cuda", line)
        assert m, (line, proc.stderr.read()[-3000:] if proc.poll() else "")
        client = BentoClient(f"http://127.0.0.1:{m.group(1)}")
        client.upload_image("echo", guests.echo())
        client.upload_input("in0", guests.words([2, 31, 41]))
        job = client.create_session("echo", "in0", segment_po2=PO2)
        st = client.wait(job, timeout=600, poll=0.5)
        assert st["status"] == "SUCCEEDED", st
        session = client.receipt(job, device="cuda")
        assert isinstance(session, S.SuccinctSessionReceipt)
        assert session.journal == guests.words([31, 41])
        assert session.root.proof.data_root.device.type == "cuda"
    finally:
        proc.kill()
        proc.wait()
