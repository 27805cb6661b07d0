"""Multi-host data plane: a standalone taskdb + hot-store server.

The reference's cluster substrate is a Redis/Valkey server running a Lua
function library — every scheduler verb executes atomically inside the
single-threaded server (`prover/crates/taskdb/src/redis_backend.rs:18-618`),
and the hot store rides the same server with TTL'd keys
(`prover/crates/workflow/src/lib.rs:86-90`). That is what lets N HOSTS
(API frontends + agents) share one job: the state lives behind a socket,
not in any one process.

The port's equivalent, same semantics: `serve()` hosts one of the
existing backends (`MemoryBackend` or the durable `SqliteBackend`) plus a
`HotStore` behind a length-prefixed wire protocol; every verb runs inside
the backend's own atomic section, so commands are serialized exactly like
Redis command execution. `RemoteBackend` / `RemoteHotStore` are drop-in
clients implementing the same duck-typed surface the cluster already
consumes (`ClusterContext(db=..., hot=...)`), so any number of API server
processes — on any number of hosts — can front the same data plane.

Blocking claims: `request_work(timeout=...)` parks the CONNECTION server-
side in the backend's condition wait (MemoryBackend) or poll loop
(SqliteBackend) — the reference's RPUSH-notify-list + BLPOP pattern
(`redis_backend.rs:19-141`). Clients keep one socket per thread because a
parked claim owns its socket.

Failure semantics (documented, reference-matching):
  * a client that dies mid-task leaves it Running until its lease expires;
    `requeue_expired` (the aux cron) re-readies it — timeout-based
    worker-death recovery, SURVEY.md §5.3. At-least-once execution.
  * a client that dies while PARKED in request_work simply drops the
    socket; the server thread's claim either returns a task (which is
    then requeued by the lease cron, since nobody works it) or times out.
  * the server itself is the durability boundary: with `--sqlite PATH`
    state survives server restarts (Postgres-gen analogue); with the
    memory backend it does not (Redis-without-AOF analogue).

Wire: 4-byte big-endian length + pickle of (verb, args, kwargs) /
("ok", result) | ("err", message). Like the reference's Redis plane this
is an INTERNAL, trusted fabric — bind it to the cluster network only
(the API server's bearer-token user plane is the public boundary,
`cluster/api.py`).

The port's copy of `boundless_tpu/cluster/dataplane.py`. Torch pickles a
tensor with its device, so hot-store values cross the wire as host
tensors (`RemoteHotStore.set` moves them to the CPU first): a server
without a card can hold them.
"""

from __future__ import annotations

import argparse
import pickle
import socket
import socketserver
import struct
import threading
from typing import Optional

from . import hotstore as hs
from . import taskdb
from ..utils.serde import to_cpu


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("data plane connection closed")
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket):
    (n,) = struct.unpack(">I", _recv_exact(sock, 4))
    return pickle.loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

# The verb surface = the duck-typed backend API the cluster consumes
# (agent.py / api.py call sites). Anything else is rejected.
DB_VERBS = frozenset({
    "set_user_quota", "create_job", "create_task", "request_work",
    "update_task_done", "update_task_failed", "update_task_retry",
    "requeue_expired", "find_stuck_pending", "fix_stuck_pending",
    "job_state", "job_user", "task_output", "count_task_states",
    "delete_job",
})
HOT_VERBS = frozenset({"set", "get", "delete", "keys", "purge_expired"})

# Cap how long one parked claim may hold a server thread; clients re-park.
MAX_BLOCK_SECS = 30.0


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        srv: DataPlaneServer = self.server.dataplane  # type: ignore
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                verb, args, kwargs = _recv_frame(sock)
            except (ConnectionError, EOFError, OSError):
                return
            try:
                if verb == "ping":
                    result = "pong"
                elif verb.startswith("hot."):
                    name = verb[4:]
                    if name not in HOT_VERBS:
                        raise ValueError(f"unknown hot verb {name!r}")
                    result = getattr(srv.hot, name)(*args, **kwargs)
                else:
                    if verb not in DB_VERBS:
                        raise ValueError(f"unknown verb {verb!r}")
                    if verb == "request_work":
                        kwargs["timeout"] = min(
                            float(kwargs.get("timeout", 0.0)),
                            MAX_BLOCK_SECS)
                    result = getattr(srv.db, verb)(*args, **kwargs)
                _send_frame(sock, ("ok", result))
            except (ConnectionError, OSError):
                return
            except Exception as e:  # verb-level error → client exception
                try:
                    _send_frame(sock, ("err", f"{type(e).__name__}: {e}"))
                except OSError:
                    return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class DataPlaneServer:
    """Hosts a taskdb backend + hot store behind the wire protocol."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 sqlite_path: Optional[str] = None,
                 hot_ttl: float = hs.DEFAULT_TTL):
        self.db = (taskdb.SqliteBackend(sqlite_path) if sqlite_path
                   else taskdb.MemoryBackend())
        self.hot = hs.HotStore(ttl=hot_ttl)
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.dataplane = self  # type: ignore
        self.addr = self._tcp.server_address[:2]

    def serve_forever(self):
        self._tcp.serve_forever()

    def start(self) -> "DataPlaneServer":
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return self

    def shutdown(self):
        self._tcp.shutdown()
        self._tcp.server_close()


# ---------------------------------------------------------------------------
# Clients
# ---------------------------------------------------------------------------


class _Conn:
    """One socket per thread (parked claims own their connection)."""

    def __init__(self, addr):
        self.addr = addr
        self._local = threading.local()

    def _sock(self) -> socket.socket:
        s = getattr(self._local, "sock", None)
        if s is None:
            s = socket.create_connection(self.addr, timeout=10.0)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = s
        return s

    def call(self, verb: str, *args, _deadline: float = None, **kwargs):
        s = self._sock()
        s.settimeout((_deadline or 10.0) + 10.0)
        try:
            _send_frame(s, (verb, args, kwargs))
            status, payload = _recv_frame(s)
        except (ConnectionError, OSError):
            # one transparent reconnect (server restart with sqlite
            # durability); verbs are idempotent or at-least-once anyway
            self._local.sock = None
            s = self._sock()
            s.settimeout((_deadline or 10.0) + 10.0)
            _send_frame(s, (verb, args, kwargs))
            status, payload = _recv_frame(s)
        if status == "err":
            raise RuntimeError(f"data plane: {payload}")
        return payload


class RemoteBackend:
    """Drop-in taskdb backend speaking to a DataPlaneServer."""

    def __init__(self, addr):
        self._c = _Conn(addr)

    def __getattr__(self, name):
        if name not in DB_VERBS:
            raise AttributeError(name)

        def verb(*args, **kwargs):
            return self._c.call(name, *args, **kwargs)

        return verb

    def request_work(self, stream: str, worker_id: str = "",
                     timeout: float = 0.0):
        """Blocking claim; re-parks across the server's block cap."""
        import time as _t
        deadline = _t.time() + timeout
        while True:
            chunk = max(0.0, min(deadline - _t.time(), MAX_BLOCK_SECS))
            t = self._c.call("request_work", stream, worker_id=worker_id,
                             timeout=chunk, _deadline=chunk)
            if t is not None or _t.time() >= deadline:
                return t


class RemoteHotStore:
    """Drop-in hot store speaking to a DataPlaneServer."""

    def __init__(self, addr):
        self._c = _Conn(addr)

    def set(self, key, value, ttl=None):
        return self._c.call("hot.set", key, to_cpu(value), ttl=ttl)

    def get(self, key):
        return self._c.call("hot.get", key)

    def delete(self, *keys):
        return self._c.call("hot.delete", *keys)

    def keys(self, prefix: str = ""):
        return self._c.call("hot.keys", prefix)

    def purge_expired(self):
        return self._c.call("hot.purge_expired")


def connect(addr):
    """(taskdb, hot) client pair for ClusterContext wiring."""
    return RemoteBackend(addr), RemoteHotStore(addr)


def main(argv=None):
    ap = argparse.ArgumentParser(description="boundless data-plane server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7350)
    ap.add_argument("--sqlite", default=None,
                    help="durable sqlite path (default: memory backend)")
    args = ap.parse_args(argv)
    srv = DataPlaneServer(args.host, args.port, sqlite_path=args.sqlite)
    print(f"data plane listening on {srv.addr[0]}:{srv.addr[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
