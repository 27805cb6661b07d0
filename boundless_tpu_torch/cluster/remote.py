"""Cross-process worker fabric: the cluster over HTTP with zero shared
memory.

Re-design of the reference's API-mediated GPU workers: claim/done/retry
endpoints (`prover/crates/api/src/lib.rs:922-1042`), hot-store proxy
(`:1002-1042`) and asset client (`prover/crates/workflow/src/assets.rs:
14-120`). A remote worker process builds a ClusterContext whose db / hot /
store handles are HTTP shims against those endpoints, then runs the
ordinary Agent poll loop unchanged — the same failure semantics carry
over (lease requeue recovers a kill -9'd worker because claims are
lease-based in the server-side taskdb).

The port's copy of `boundless_tpu/cluster/remote.py`. A worker proves on
the device it is given (`--device`, the card unless asked for the CPU):
values it reads over the planes load with their proofs there.
`connect` rebuilds the succinct system from `/workers/config` without
its `variants`, as the reference does, so a worker of a server pinned to
one lift variant builds the default lattice of both.

Usage (one process per worker):

    python -m boundless_tpu_torch.cluster.remote --api-url http://host:port \
        --stream prove [--device cuda] [--idle-timeout 30]
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

from ..prover import stark
from ..utils import serde


class _Http:
    """Tiny status-aware HTTP helper (stdlib only, like BentoClient)."""

    def __init__(self, base_url: str, timeout: float = 60.0,
                 token: str = None):
        self.base = base_url.rstrip("/")
        self.timeout = timeout  # a stalled API server must not hang workers
        self.token = token

    def req(self, method: str, path: str, body: bytes = None,
            headers: dict = None):
        headers = dict(headers or {})
        if self.token:
            headers.setdefault("Authorization", f"Bearer {self.token}")
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def json(self, method: str, path: str, obj=None):
        body = json.dumps(obj).encode() if obj is not None else None
        status, data = self.req(method, path, body)
        if status != 200:
            raise RuntimeError(f"{method} {path} -> {status}: {data[:200]}")
        return json.loads(data)


@dataclass
class RemoteTask:
    """Claimed-task view (what the Agent handlers consume)."""

    job_id: str
    task_id: str
    stream: str
    definition: dict
    retries: int = 0
    max_retries: int = 3


class RemoteTaskDb:
    """taskdb facade over the worker claim/done/retry endpoints."""

    def __init__(self, http: _Http):
        self.http = http

    def request_work(self, stream: str, worker_id: str = "",
                     timeout: float = 0.0):
        deadline = time.time() + timeout
        while True:
            out = self.http.json("POST", f"/workers/tasks/claim/{stream}",
                                 {"worker_id": worker_id})
            t = out.get("task")
            if t is not None:
                return RemoteTask(**t)
            if time.time() >= deadline:
                return None
            time.sleep(min(0.05, max(0.0, deadline - time.time())))

    def create_task(self, job_id: str, task_id: str, stream: str,
                    definition: dict, prereqs: list, **_kw):
        self.http.json("POST", "/workers/tasks/create",
                       dict(job_id=job_id, task_id=task_id, stream=stream,
                            definition=definition, prereqs=prereqs))

    def update_task_done(self, job_id: str, task_id: str, output: dict):
        self.http.json("POST", "/workers/tasks/done",
                       dict(job_id=job_id, task_id=task_id, output=output))

    def update_task_retry(self, job_id: str, task_id: str,
                          error: str) -> bool:
        return self.http.json("POST", "/workers/tasks/retry",
                              dict(job_id=job_id, task_id=task_id,
                                   error=error))["retried"]

    # aux maintenance crons route to the server-side backend
    def requeue_expired(self) -> int:
        return self.http.json("POST", "/workers/maintenance",
                              {"op": "requeue"})["requeued"]

    def fix_stuck_pending(self) -> int:
        return self.http.json("POST", "/workers/maintenance",
                              {"op": "stuck"})["stuck_fixed"]


class RemoteHotStore:
    """Hot-store plane over HTTP (reference /worker/hot/* Redis proxy)."""

    def __init__(self, http: _Http, device="cpu"):
        self.http = http
        self.device = device

    def set(self, key: str, value, ttl: float = None):
        headers = {"X-TTL": str(ttl)} if ttl else {}
        status, data = self.http.req("PUT", f"/workers/hot/{key}",
                                     serde.dump_obj(value, "hot"), headers)
        if status != 200:
            raise RuntimeError(f"hot_set {key}: {status} {data[:200]}")

    def get(self, key: str):
        status, data = self.http.req("GET", f"/workers/hot/{key}")
        if status == 404:
            return None
        if status != 200:
            raise RuntimeError(f"hot_get {key}: {status} {data[:200]}")
        return serde.load_obj(data, "hot", self.device)

    def delete(self, *keys):
        for k in keys:
            self.http.req("DELETE", f"/workers/hot/{k}")

    def purge_expired(self) -> int:
        return self.http.json("POST", "/workers/maintenance",
                              {"op": "purge"})["purged"]


class RemoteStore:
    """Object-store plane over HTTP (reference asset streaming)."""

    def __init__(self, http: _Http, device="cpu"):
        self.http = http
        self.device = device

    def _q(self, bucket, key, mode):
        return "/workers/obj?" + urllib.parse.urlencode(
            dict(bucket=bucket, key=key, mode=mode))

    def get(self, bucket: str, key: str):
        status, data = self.http.req("GET", self._q(bucket, key, "obj"))
        if status == 404:
            return None
        if status != 200:
            raise RuntimeError(f"obj_get {bucket}/{key}: {status}")
        return serde.load_obj(data, "obj", self.device)

    def get_bytes(self, bucket: str, key: str):
        status, data = self.http.req("GET", self._q(bucket, key, "bytes"))
        if status == 404:
            return None
        if status != 200:
            raise RuntimeError(f"obj_get {bucket}/{key}: {status}")
        return data

    def put(self, bucket: str, key: str, obj):
        status, data = self.http.req("PUT", self._q(bucket, key, "obj"),
                                     serde.dump_obj(obj, "obj"))
        if status != 200:
            raise RuntimeError(f"obj_put {bucket}/{key}: {status}")

    def put_bytes(self, bucket: str, key: str, data: bytes):
        status, body = self.http.req("PUT", self._q(bucket, key, "bytes"),
                                     data)
        if status != 200:
            raise RuntimeError(f"obj_put {bucket}/{key}: {status}")

    def exists(self, bucket: str, key: str) -> bool:
        return self.http.json("GET", self._q(bucket, key, "exists"))["exists"]


def _ps_from(d: dict) -> stark.ProofSystem:
    return stark.ProofSystem(queries=d["queries"],
                             fri_min_degree=d["fri_min_degree"],
                             commit_expand=d["commit_expand"])


def connect(base_url: str, token: str = None, device="cuda"):
    """Build a fully remote ClusterContext from /workers/config, proving
    on `device`."""
    from .agent import ClusterContext
    from ..recursion import succinct as S

    http = _Http(base_url, token=token)
    cfg = http.json("GET", "/workers/config")
    system = None
    if cfg["succinct"] == "dev":
        system = S.DevModeSystem()
    elif cfg["succinct"] == "real":
        p = cfg["succinct_params"]
        system = S.get_system(S.SuccinctParams(
            seg_po2=p["seg_po2"], seg_ps=_ps_from(p["seg_ps"]),
            rec_po2=p["rec_po2"], rec_ps=_ps_from(p["rec_ps"])),
            device=device)
    return ClusterContext(
        db=RemoteTaskDb(http), hot=RemoteHotStore(http, device),
        store=RemoteStore(http, device), ps=_ps_from(cfg["ps"]),
        segment_po2=cfg["segment_po2"],
        exec_cycle_limit=cfg["exec_cycle_limit"],
        succinct=system, dev_mode=cfg["dev_mode"], device=device)


def worker_main(argv=None):
    """Entry point: attach to a cluster API and poll one or more streams.

    `--stream a,b` runs one Agent thread per stream in this process (the
    reference sizes worker pools the same way, one container per stream
    set, `prover-compose.yml:80-84`).
    """
    import argparse
    import os
    import threading

    from .agent import Agent

    ap = argparse.ArgumentParser(
        description="boundless-tpu-torch remote worker (HTTP-attached)")
    ap.add_argument("--api-url", required=True)
    ap.add_argument("--stream", required=True,
                    help="comma-separated subset of "
                         "exec,prove,join,coproc,snark,aux")
    ap.add_argument("--worker-id", default="")
    ap.add_argument("--token", default=None,
                    help="bearer token for the worker plane (default: "
                         "$BT_CLUSTER_TOKEN)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="exit after this many idle seconds (default: run "
                         "until SIGTERM)")
    ap.add_argument("--device", default="cuda",
                    help="where this worker proves (default: the card)")
    args = ap.parse_args(argv)
    ctx = connect(args.api_url,
                  token=args.token or os.environ.get("BT_CLUSTER_TOKEN"),
                  device=args.device)
    streams = [s.strip() for s in args.stream.split(",") if s.strip()]
    threads = []
    for s in streams:
        agent = Agent(ctx, s, f"{args.worker_id or os.getpid()}-{s}")
        t = threading.Thread(target=agent.poll_work,
                             args=(args.idle_timeout,))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()


if __name__ == "__main__":
    worker_main()
