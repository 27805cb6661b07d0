"""Indexer as a durable service + query API.

The port's copy of `boundless_tpu/market/indexer_service.py`, over the
port's `market/chain.py`.

Re-design of the reference indexer stack: `crates/indexer` (chain event
ingestion into Postgres, resumable by block cursor) and the
`crates/indexer-api` lambdas (HTTP query surface over the indexed
aggregates). Here: sqlite for durability (same role as the reference's
external DB — restartable, cross-process) and a stdlib HTTP server for
the query lambdas.

  GET /stats       market-wide aggregates
  GET /provers     per-prover fulfillment counts
  GET /requestors  per-requestor request counts
  GET /events?since=B raw indexed events from block B
  GET /health
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .chain import MarketChain


class IndexerService:
    """Durable chain indexer: raw events + running aggregates in sqlite,
    resumable across restarts from the persisted block cursor."""

    SCHEMA = """
    CREATE TABLE IF NOT EXISTS events (
        block INTEGER, kind TEXT, data TEXT
    );
    CREATE TABLE IF NOT EXISTS cursor (
        id INTEGER PRIMARY KEY CHECK (id = 0), last_block INTEGER
    );
    CREATE TABLE IF NOT EXISTS aggregates (
        key TEXT PRIMARY KEY, value INTEGER
    );
    CREATE TABLE IF NOT EXISTS per_prover (
        address TEXT PRIMARY KEY, fulfilled INTEGER
    );
    CREATE TABLE IF NOT EXISTS per_requestor (
        address TEXT PRIMARY KEY, requests INTEGER
    );
    """

    def __init__(self, chain: MarketChain, db_path: str = ":memory:",
                 poll: float = 0.1):
        self.chain = chain
        self.poll = poll
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.executescript(self.SCHEMA)
        self._db.execute(
            "INSERT OR IGNORE INTO cursor VALUES (0, 0)")
        self._db.commit()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- ingestion ------------------------------------------------------
    def sync(self) -> int:
        """Index new events; returns the number ingested. Idempotent
        across restarts (block cursor persisted transactionally)."""
        with self._lock, self._db:
            (last,) = self._db.execute(
                "SELECT last_block FROM cursor").fetchone()
            n = 0
            newest = last
            for ev in self.chain.events_since(last):
                newest = max(newest, ev.block)
                self._db.execute("INSERT INTO events VALUES (?,?,?)",
                                 (ev.block, ev.kind, json.dumps(ev.data)))
                self._apply(ev)
                n += 1
            self._db.execute("UPDATE cursor SET last_block=?", (newest,))
            return n

    def _bump(self, table, keycol, key, col, by=1):
        self._db.execute(
            f"INSERT INTO {table} VALUES (?, ?) ON CONFLICT({keycol}) "
            f"DO UPDATE SET {col} = {col} + ?", (key, by, by))

    def _agg(self, key, by=1):
        self._bump("aggregates", "key", key, "value", by)

    def _apply(self, ev):
        if ev.kind == "RequestSubmitted":
            self._agg("requests")
            client = ev.data["request_id"].split(":")[0]
            self._bump("per_requestor", "address", client, "requests")
        elif ev.kind == "RequestFulfilled":
            self._agg("fulfilled")
            self._agg("volume", ev.data.get("price", 0))
            self._bump("per_prover", "address", ev.data["prover"],
                       "fulfilled")
        elif ev.kind == "RequestSlashed":
            self._agg("slashed")

    # -- service lifecycle ---------------------------------------------
    def start(self):
        def run():
            while not self._stop.is_set():
                self.sync()
                time.sleep(self.poll)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()

    # -- queries --------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            rows = dict(self._db.execute(
                "SELECT key, value FROM aggregates").fetchall())
        return {"total_requests": rows.get("requests", 0),
                "total_fulfilled": rows.get("fulfilled", 0),
                "total_slashed": rows.get("slashed", 0),
                "total_volume": rows.get("volume", 0)}

    def provers(self) -> dict:
        with self._lock:
            return dict(self._db.execute(
                "SELECT address, fulfilled FROM per_prover").fetchall())

    def requestors(self) -> dict:
        with self._lock:
            return dict(self._db.execute(
                "SELECT address, requests FROM per_requestor").fetchall())

    def events(self, since_block: int = 0) -> list:
        with self._lock:
            rows = self._db.execute(
                "SELECT block, kind, data FROM events WHERE block >= ?",
                (since_block,)).fetchall()
        return [{"block": b, "kind": k, "data": json.loads(d)}
                for b, k, d in rows]


def make_indexer_server(indexer: IndexerService, host="127.0.0.1", port=0):
    """Query lambdas surface (reference crates/indexer-api)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body):
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/stats":
                self._send(200, indexer.stats())
            elif self.path == "/provers":
                self._send(200, indexer.provers())
            elif self.path == "/requestors":
                self._send(200, indexer.requestors())
            elif self.path.startswith("/events"):
                since = 0
                if "since=" in self.path:
                    since = int(self.path.split("since=")[1].split("&")[0])
                self._send(200, {"events": indexer.events(since)})
            elif self.path == "/health":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    return server, thread
