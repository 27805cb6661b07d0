"""REST API: Bonsai-compatible surface over the proving cluster.

Re-design of the reference API service (`prover/crates/api/src/lib.rs`,
routes :1162-1194): stdlib http.server (no third-party web framework in the
image), same route shapes:

  PUT  /images/upload/<image_id>          body: BTIM image wire format
  PUT  /inputs/upload/<input_id>          body: raw input bytes
  POST /sessions/create                   {img, input, execute_only?, po2?}
  GET  /sessions/status/<job_id>          {status, stats...}
  GET  /receipts/stark/<job_id>           versioned receipt wire format
  GET  /journal/<job_id>                  raw journal bytes
  POST /snark/create                      {session_id, compress}
  GET  /snark/status/<job_id>
  GET  /workers/metrics                   task-state counts (prometheus-ish)

plus the cross-process worker plane (reference worker claim/hot-store
endpoints, `prover/crates/api/src/lib.rs:922-1042` + `workflow/src/
assets.rs:14-120`):

  POST   /workers/tasks/claim/<stream>    -> task or {"task": null}
  POST   /workers/tasks/done              {job_id, task_id, output, cleanup}
  POST   /workers/tasks/retry             {job_id, task_id, error}
  POST   /workers/maintenance             run aux crons once
  GET    /workers/config                  cluster parameters for workers
  GET/PUT/DELETE /workers/hot/<key>       hot-store value (versioned wire)
  GET/PUT        /workers/obj?bucket=&key=  object-store plane

Falls back to the object store for sessions already GC'd from the taskdb
(reference api/src/lib.rs:545-560).

The port's copy of `boundless_tpu/cluster/api.py`. Hot-store values that
arrive over the worker plane load with their proofs on the cluster's
`device`; `BentoClient.receipt` loads a receipt onto the device its caller
names (the CPU unless asked).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .agent import ClusterContext
from .taskdb import JobState, Priority
from . import hotstore as hs


class ClusterApi:
    """Route handling against a ClusterContext (transport-independent).

    `api_keys`: optional {key: user} map (reference per-user API keys,
    `prover/crates/api/src/helpers.rs:16-24`). When set, every user-plane
    route requires `X-API-Key`; sessions are owned by the resolved user
    (fed to the taskdb's per-user fair-share scheduler) and status/
    receipt reads are restricted to the owner.
    """

    def __init__(self, ctx: ClusterContext, api_keys: dict | None = None):
        self.ctx = ctx
        self.api_keys = api_keys

    def resolve_user(self, key: str | None) -> str:
        if self.api_keys is None:
            return "default"
        user = self.api_keys.get(key or "")
        if user is None:
            raise PermissionError("invalid or missing API key")
        return user

    def _check_owner(self, job_id: str, user: str):
        if self.api_keys is None:
            return
        try:
            owner = self.ctx.db.job_user(job_id)
        except KeyError:
            # Job GC'd: fall back to the durable owner record written at
            # create time. Unknown job => deny (an allow here would let
            # any key read other users' post-GC receipts).
            rec = self.ctx.store.get_bytes("job_owners", job_id)
            owner = rec.decode() if rec is not None else None
            if owner is None:
                raise PermissionError("unknown job") from None
        if owner != user:
            raise PermissionError("not the session owner")

    def _record_owner(self, job_id: str, user: str):
        """Durable owner record so ownership survives taskdb job GC."""
        if self.api_keys is not None:
            self.ctx.store.put_bytes("job_owners", job_id, user.encode())

    # -- uploads --------------------------------------------------------
    def upload_image(self, image_id: str, body: bytes,
                     user: str = "default"):
        """Accepts the safe BTIM wire format (never pickle: untrusted
        input; see utils/serde.py). `user` must already be resolved via
        resolve_user (authn enforced at the transport layer)."""
        from ..utils import serde

        img = serde.load_image(body)
        self.ctx.store.put("elfs", image_id, img)
        return {"ok": True, "image_id": image_id}

    def upload_input(self, input_id: str, body: bytes,
                     user: str = "default"):
        self.ctx.store.put_bytes("inputs", input_id, body)
        return {"ok": True, "input_id": input_id}

    # -- sessions -------------------------------------------------------
    def create_session(self, req: dict, user: str = "default") -> dict:
        job_id = self.ctx.db.create_job(
            "exec",
            dict(kind="exec", image_id=req["img"], input_id=req["input"],
                 execute_only=bool(req.get("execute_only", False)),
                 segment_po2=int(req.get("segment_po2",
                                         self.ctx.segment_po2)),
                 exec_cycle_limit=int(req.get("exec_cycle_limit",
                                              self.ctx.exec_cycle_limit))),
            user=user,
            priority=Priority(int(req.get("priority", Priority.MEDIUM))))
        self._record_owner(job_id, user)
        return {"uuid": job_id}

    def session_status(self, job_id: str, user: str = "default") -> dict:
        self._check_owner(job_id, user)
        try:
            st = self.ctx.db.job_state(job_id)
        except KeyError:
            # job GC'd: fall back to object store (reference :545-560)
            if self.ctx.store.exists("receipts/stark", job_id):
                return {"status": "SUCCEEDED", "stats": None}
            return {"status": "UNKNOWN"}
        stats = self.ctx.hot.get(hs.exec_stats_key(job_id))
        status = {JobState.RUNNING: "RUNNING", JobState.DONE: "SUCCEEDED",
                  JobState.FAILED: "FAILED"}[st["state"]]
        out = {"status": status, "error_msg": st.get("error")}
        if stats:
            out["stats"] = {k: v for k, v in stats.items()
                            if k in ("total_cycles", "segments", "exit_code")}
        return out

    def receipt(self, job_id: str, user: str = "default"):
        """Receipt in the versioned wire format (never pickle on the wire;
        reference serves bincode receipts, finalize.rs:76-88)."""
        from ..utils import serde

        self._check_owner(job_id, user)

        obj = self.ctx.store.get("receipts/stark", job_id)
        if obj is None:
            return None
        return serde.dump_session_receipt(obj)

    def receipt_obj(self, job_id: str):
        return self.ctx.store.get("receipts/stark", job_id)

    def journal(self, job_id: str, user: str = "default"):
        self._check_owner(job_id, user)
        return self.ctx.store.get_bytes("preflight_journals", job_id)

    # -- snark ----------------------------------------------------------
    def create_snark(self, req: dict, user: str = "default") -> dict:
        self._check_owner(req["session_id"], user)
        job_id = self.ctx.db.create_job(
            "snark", dict(kind="snark", source_job=req["session_id"],
                          compress=req.get("compress", "groth16")),
            user=user)
        self._record_owner(job_id, user)
        return {"uuid": job_id}

    # -- cross-process worker plane --------------------------------------
    # Reference: GPU workers are fully API-mediated with zero shared
    # memory — claim/done/retry over HTTP (`prover/crates/api/src/
    # lib.rs:922-1042`) plus a hot-store proxy (`:1002-1042`) and asset
    # streaming (`workflow/src/assets.rs:14-120`).

    def worker_config(self) -> dict:
        """Cluster parameters a remote worker needs to reconstruct an
        equivalent ClusterContext (proof system, succinct mode, po2)."""
        ps = self.ctx.ps
        out = dict(segment_po2=self.ctx.segment_po2,
                   exec_cycle_limit=self.ctx.exec_cycle_limit,
                   dev_mode=self.ctx.dev_mode,
                   ps=dict(queries=ps.queries,
                           fri_min_degree=ps.fri_min_degree,
                           commit_expand=ps.commit_expand),
                   succinct=None)
        s = self.ctx.succinct_sys()
        if s is not None:
            if hasattr(s, "DEV_ROOT"):
                out["succinct"] = "dev"
            else:
                p = s.params
                out["succinct"] = "real"
                out["succinct_params"] = dict(
                    seg_po2=p.seg_po2, rec_po2=p.rec_po2,
                    seg_ps=dict(queries=p.seg_ps.queries,
                                fri_min_degree=p.seg_ps.fri_min_degree,
                                commit_expand=p.seg_ps.commit_expand),
                    rec_ps=dict(queries=p.rec_ps.queries,
                                fri_min_degree=p.rec_ps.fri_min_degree,
                                commit_expand=p.rec_ps.commit_expand))
        return out

    def worker_claim(self, stream: str, worker_id: str) -> dict:
        task = self.ctx.db.request_work(stream, worker_id, timeout=0.0)
        if task is None:
            return {"task": None}
        return {"task": dict(job_id=task.job_id, task_id=task.task_id,
                             stream=task.stream, definition=task.definition,
                             retries=task.retries,
                             max_retries=task.max_retries)}

    def worker_create_task(self, req: dict) -> dict:
        """Remote exec agents drive the planner: they create downstream
        prove/join/resolve/finalize tasks through this endpoint."""
        self.ctx.db.create_task(req["job_id"], req["task_id"], req["stream"],
                                req["definition"], req.get("prereqs") or [])
        return {"ok": True}

    def worker_done(self, req: dict) -> dict:
        self.ctx.db.update_task_done(req["job_id"], req["task_id"],
                                     req.get("output") or {})
        cleanup = req.get("cleanup") or []
        if cleanup:
            self.ctx.hot.delete(*cleanup)
        return {"ok": True}

    def worker_retry(self, req: dict) -> dict:
        retried = self.ctx.db.update_task_retry(
            req["job_id"], req["task_id"], req.get("error", ""))
        return {"retried": bool(retried)}

    def worker_maintenance(self, req: dict) -> dict:
        op = req.get("op", "all")
        out = {}
        if op in ("requeue", "all"):
            out["requeued"] = self.ctx.db.requeue_expired()
        if op in ("stuck", "all"):
            out["stuck_fixed"] = self.ctx.db.fix_stuck_pending()
        if op in ("purge", "all"):
            out["purged"] = self.ctx.hot.purge_expired()
        return out

    def hot_get(self, key: str):
        from ..utils import serde

        value = self.ctx.hot.get(key)
        if value is None:
            return None
        return serde.dump_obj(value, "hot")

    def hot_put(self, key: str, body: bytes, ttl=None):
        from ..utils import serde

        self.ctx.hot.set(key, serde.load_obj(body, "hot", self.ctx.device),
                         ttl=ttl)
        return {"ok": True}

    def hot_delete(self, key: str):
        self.ctx.hot.delete(key)
        return {"ok": True}

    def obj_get(self, bucket: str, key: str, mode: str):
        from ..utils import serde

        if mode == "bytes":
            return self.ctx.store.get_bytes(bucket, key)
        obj = self.ctx.store.get(bucket, key)
        if obj is None:
            return None
        return serde.dump_obj(obj, "obj")

    def obj_put(self, bucket: str, key: str, body: bytes, mode: str):
        from ..utils import serde

        if mode == "bytes":
            self.ctx.store.put_bytes(bucket, key, body)
        else:
            self.ctx.store.put(bucket, key, serde.load_obj(body, "obj"))
        return {"ok": True}

    def obj_exists(self, bucket: str, key: str) -> dict:
        return {"exists": self.ctx.store.exists(bucket, key)}

    # -- metrics --------------------------------------------------------
    def metrics(self) -> dict:
        from . import metrics as M

        counts = self.ctx.db.count_task_states()
        for (stream, state), n in counts.items():
            sv = state if isinstance(state, str) else state.value
            M.REGISTRY.gauge_set(M.TASK_QUEUE_DEPTH, n, stream=stream,
                                 state=sv)
        return {f"{stream}/{state if isinstance(state, str) else state.value}":
                n for (stream, state), n in counts.items()}

    def metrics_text(self) -> str:
        from . import metrics as M

        self.metrics()  # refresh queue-depth gauges
        return M.REGISTRY.render()


def make_http_server(api: ClusterApi, host="127.0.0.1", port=0, token=None,
                     allow_insecure=False):
    """Wrap a ClusterApi in a threaded stdlib HTTP server.

    `token`: shared-secret bearer token checked on every /workers/* route
    (the worker plane can mark tasks done with forged outputs / poison the
    hot store, so it must not be open on a reachable interface; reference
    provisions per-user API keys, `prover/crates/api/src/helpers.rs:16-24`).
    Binding a non-loopback address without a token requires an explicit
    `allow_insecure=True` (trusted-network assumption made visible).
    """
    loopback = host in ("127.0.0.1", "::1", "localhost")
    if not loopback and token is None and not allow_insecure:
        raise ValueError(
            "binding the worker plane on a non-loopback address requires "
            "token=... (or allow_insecure=True on a trusted network)")

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _user(self) -> str:
            return api.resolve_user(self.headers.get("X-API-Key"))

        def _authorized(self, parts) -> bool:
            if token is None or parts[:1] != ["workers"]:
                return True
            got = self.headers.get("Authorization", "")
            return got == f"Bearer {token}"

        def _send(self, code, body, ctype="application/json"):
            if isinstance(body, dict):
                body = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def _route(self):
            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            qs = {k: v[0] for k, v in parse_qs(u.query).items()}
            return u.path.strip("/").split("/"), qs

        def do_PUT(self):
            parts, qs = self._route()
            if not self._authorized(parts):
                return self._send(401, {"error": "unauthorized"})
            try:
                if parts[:2] == ["images", "upload"]:
                    self._send(200, api.upload_image(parts[2], self._body(),
                                                     self._user()))
                elif parts[:2] == ["inputs", "upload"]:
                    self._send(200, api.upload_input(parts[2], self._body(),
                                                     self._user()))
                elif parts[:2] == ["workers", "hot"]:
                    key = "/".join(parts[2:])
                    ttl = self.headers.get("X-TTL")
                    self._send(200, api.hot_put(
                        key, self._body(),
                        ttl=float(ttl) if ttl else None))
                elif parts == ["workers", "obj"]:
                    self._send(200, api.obj_put(
                        qs["bucket"], qs["key"], self._body(),
                        qs.get("mode", "obj")))
                else:
                    self._send(404, {"error": "not found"})
            except PermissionError as e:
                self._send(401, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def do_POST(self):
            parts, qs = self._route()
            if not self._authorized(parts):
                return self._send(401, {"error": "unauthorized"})
            try:
                req = json.loads(self._body() or b"{}")
                if parts == ["sessions", "create"]:
                    self._send(200, api.create_session(req, self._user()))
                elif parts == ["snark", "create"]:
                    self._send(200, api.create_snark(req, self._user()))
                elif parts[:3] == ["workers", "tasks", "claim"]:
                    self._send(200, api.worker_claim(
                        parts[3], req.get("worker_id", "")))
                elif parts == ["workers", "tasks", "create"]:
                    self._send(200, api.worker_create_task(req))
                elif parts == ["workers", "tasks", "done"]:
                    self._send(200, api.worker_done(req))
                elif parts == ["workers", "tasks", "retry"]:
                    self._send(200, api.worker_retry(req))
                elif parts == ["workers", "maintenance"]:
                    self._send(200, api.worker_maintenance(req))
                else:
                    self._send(404, {"error": "not found"})
            except PermissionError as e:
                self._send(401, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def do_DELETE(self):
            parts, _qs = self._route()
            if not self._authorized(parts):
                return self._send(401, {"error": "unauthorized"})
            try:
                if parts[:2] == ["workers", "hot"]:
                    self._send(200, api.hot_delete("/".join(parts[2:])))
                else:
                    self._send(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

        def do_GET(self):
            parts, qs = self._route()
            if not self._authorized(parts):
                return self._send(401, {"error": "unauthorized"})
            try:
                if parts[:2] == ["sessions", "status"]:
                    self._send(200, api.session_status(parts[2],
                                                       self._user()))
                elif parts[:2] == ["snark", "status"]:
                    self._send(200, api.session_status(parts[2],
                                                       self._user()))
                elif parts[:2] == ["receipts", "stark"]:
                    data = api.receipt(parts[2], self._user())
                    if data is None:
                        self._send(404, {"error": "no receipt"})
                    else:
                        self._send(200, data, "application/octet-stream")
                elif parts[:1] == ["journal"]:
                    data = api.journal(parts[1], self._user())
                    if data is None:
                        self._send(404, {"error": "no journal"})
                    else:
                        self._send(200, data, "application/octet-stream")
                elif parts == ["workers", "config"]:
                    self._send(200, api.worker_config())
                elif parts[:2] == ["workers", "hot"]:
                    data = api.hot_get("/".join(parts[2:]))
                    if data is None:
                        self._send(404, {"error": "no value"})
                    else:
                        self._send(200, data, "application/octet-stream")
                elif parts == ["workers", "obj"]:
                    if qs.get("mode") == "exists":
                        self._send(200, api.obj_exists(qs["bucket"],
                                                       qs["key"]))
                    else:
                        data = api.obj_get(qs["bucket"], qs["key"],
                                           qs.get("mode", "obj"))
                        if data is None:
                            self._send(404, {"error": "no object"})
                        else:
                            self._send(200, data,
                                       "application/octet-stream")
                elif parts == ["workers", "metrics"]:
                    self._send(200, api.metrics())
                elif parts == ["metrics"]:
                    self._send(200, api.metrics_text().encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._send(404, {"error": "not found"})
            except PermissionError as e:
                self._send(401, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(500, {"error": str(e)})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    return server, thread


class BentoClient:
    """Minimal client (reference `bento-client` / bonsai-sdk shape)."""

    def __init__(self, base_url: str, api_key: str | None = None):
        self.base = base_url.rstrip("/")
        self.api_key = api_key  # per-user key (reference helpers.rs:16-24)

    def _req(self, method, path, body=None, headers=None):
        import urllib.request

        headers = dict(headers or {})
        if self.api_key is not None:
            headers.setdefault("X-API-Key", self.api_key)
        req = urllib.request.Request(self.base + path, data=body,
                                     method=method, headers=headers)
        with urllib.request.urlopen(req) as resp:
            return resp.read()

    def upload_image(self, image_id: str, image) -> str:
        from ..utils import serde

        self._req("PUT", f"/images/upload/{image_id}",
                  serde.dump_image(image))
        return image_id

    def upload_input(self, input_id: str, data: bytes) -> str:
        self._req("PUT", f"/inputs/upload/{input_id}", data)
        return input_id

    def create_session(self, img: str, input_id: str, **kw) -> str:
        body = json.dumps(dict(img=img, input=input_id, **kw)).encode()
        return json.loads(self._req("POST", "/sessions/create", body))["uuid"]

    def session_status(self, job_id: str) -> dict:
        return json.loads(self._req("GET", f"/sessions/status/{job_id}"))

    def wait(self, job_id: str, timeout=600.0, poll=0.2) -> dict:
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            st = self.session_status(job_id)
            if st["status"] in ("SUCCEEDED", "FAILED"):
                return st
            time.sleep(poll)
        raise TimeoutError(f"session {job_id} still running")

    def receipt(self, job_id: str, device="cpu"):
        """The session receipt, its proof's tensors on `device`."""
        from ..utils import serde

        return serde.load_session_receipt(
            self._req("GET", f"/receipts/stark/{job_id}"), device)

    def journal(self, job_id: str) -> bytes:
        return self._req("GET", f"/journal/{job_id}")

    def create_snark(self, session_id: str, compress="groth16") -> str:
        body = json.dumps(dict(session_id=session_id,
                               compress=compress)).encode()
        return json.loads(self._req("POST", "/snark/create", body))["uuid"]
