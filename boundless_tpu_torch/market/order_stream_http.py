"""Order-stream REST + WebSocket surface + JSON request codec.

The port's copy of `boundless_tpu/market/order_stream_http.py`.

HTTP layer over market/order_stream.py (reference `crates/order-stream`
axum service, `src/lib.rs:523-539`):

  POST /orders/submit     {request, signature} (JSON codec below)
  GET  /orders?since=N    replay from index N
  GET  /ws/orders?since=N RFC6455 WebSocket: replay then live push
                          (reference WS broadcast,
                          `src/order_stream_client.rs` subscription)
  POST /heartbeat         {address}
  GET  /health

Signature auth is enforced by the underlying OrderStream (submissions are
rejected unless signed by a registered account key). The WebSocket layer
is stdlib-only: SHA-1 key handshake, unmasked server text frames, masked
client frames accepted for close.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def ws_encode_text(payload: bytes, fin: bool = True, opcode: int = 1) -> bytes:
    """One unmasked server->client frame (RFC6455 §5.2)."""
    head = bytes([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < (1 << 16):
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    return head + payload


def ws_decode_frame(rfile):
    """(opcode, payload) from a client or server frame; None at EOF."""
    head = rfile.read(2)
    if len(head) < 2:
        return None
    opcode = head[0] & 0x0F
    masked = head[1] & 0x80
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", rfile.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rfile.read(8))[0]
    mask = rfile.read(4) if masked else b""
    payload = rfile.read(n)
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload

from .order_stream import OrderStream
from .types import (Offer, Predicate, PredicateType, ProofRequest, RequestId,
                    Requirements)


def request_to_json(req: ProofRequest) -> dict:
    return {
        "id": {"client": req.id.client, "index": req.id.index,
               "scs": req.id.smart_contract_signed},
        "requirements": {
            "image_id": req.requirements.image_id,
            "predicate": {"kind": req.requirements.predicate.kind.value,
                          "data": req.requirements.predicate.data.hex()},
            "callback": req.requirements.callback,
            "selector": req.requirements.selector,
        },
        "image_url": req.image_url,
        "input_data": req.input_data.hex(),
        "offer": dataclasses.asdict(req.offer),
    }


def request_from_json(d: dict) -> ProofRequest:
    return ProofRequest(
        id=RequestId(d["id"]["client"], int(d["id"]["index"]),
                     bool(d["id"].get("scs", False))),
        requirements=Requirements(
            image_id=d["requirements"]["image_id"],
            predicate=Predicate(
                PredicateType(d["requirements"]["predicate"]["kind"]),
                bytes.fromhex(d["requirements"]["predicate"]["data"])),
            callback=d["requirements"].get("callback"),
            selector=d["requirements"].get("selector")),
        image_url=d["image_url"],
        input_data=bytes.fromhex(d["input_data"]),
        offer=Offer(**d["offer"]))


def make_order_stream_server(stream: OrderStream, host="127.0.0.1", port=0):
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

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/orders/submit":
                    req = request_from_json(body["request"])
                    stream.submit(req, bytes.fromhex(body["signature"]))
                    self._send(200, {"ok": True})
                elif self.path == "/heartbeat":
                    stream.heartbeat(body["address"])
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "not found"})
            except PermissionError as e:
                self._send(403, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                self._send(400, {"error": str(e)})

        def _ws_orders(self):
            """Upgrade + replay-then-push loop (one thread per client)."""
            key = self.headers.get("Sec-WebSocket-Key", "")
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", _ws_accept_key(key))
            self.end_headers()
            self.close_connection = True
            cursor = 0
            if "since=" in self.path:
                cursor = int(self.path.split("since=")[1].split("&")[0])
            import select as _select

            # Reads are select-gated: ws_decode_frame only starts once the
            # socket is readable, and then blocks until the frame is
            # complete — a poll timeout can never desync the frame stream
            # mid-header. Writes (incl. large replays) are guarded by the
            # outer OSError catch.
            self.connection.settimeout(None)
            try:
                while True:
                    batch = stream.wait_orders(cursor, timeout=0.25)
                    for r, s in batch:
                        msg = json.dumps({"request": request_to_json(r),
                                          "signature": s.hex()}).encode()
                        self.wfile.write(ws_encode_text(msg))
                    cursor += len(batch)
                    # drain client frames; close on opcode 8 / EOF
                    ready, _, _ = _select.select([self.connection], [], [],
                                                 0)
                    if ready:
                        frame = ws_decode_frame(self.rfile)
                        if frame is None or frame[0] == 8:
                            break
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

        def do_GET(self):
            if (self.path.startswith("/ws/orders") and
                    self.headers.get("Upgrade", "").lower() == "websocket"):
                return self._ws_orders()
            if self.path.startswith("/orders"):
                since = 0
                if "since=" in self.path:
                    since = int(self.path.split("since=")[1].split("&")[0])
                orders = stream.orders_since(since)
                self._send(200, {"orders": [
                    {"request": request_to_json(r), "signature": s.hex()}
                    for r, s in orders]})
            elif self.path == "/health":
                self._send(200, {"ok": True})
            else:
                self._send(404, {"error": "not found"})

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    return server, thread


class OrderStreamClient:
    """SDK-side client (reference `src/order_stream_client.rs:266+`)."""

    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def _req(self, method, path, body=None):
        import urllib.request

        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def submit(self, request: ProofRequest, signature: bytes):
        return self._req("POST", "/orders/submit",
                         {"request": request_to_json(request),
                          "signature": signature.hex()})

    def orders_since(self, index: int):
        out = self._req("GET", f"/orders?since={index}")
        return [(request_from_json(o["request"]),
                 bytes.fromhex(o["signature"])) for o in out["orders"]]

    def heartbeat(self, address: str):
        return self._req("POST", "/heartbeat", {"address": address})

    def subscribe_ws(self, since: int = 0, max_orders: int = None,
                     timeout: float = 30.0):
        """Generator of (request, signature) over a live WS subscription
        (reference order_stream_client.rs WebSocket order feed)."""
        import socket as _socket
        from urllib.parse import urlparse

        u = urlparse(self.base)
        sock = _socket.create_connection((u.hostname, u.port or 80),
                                         timeout=timeout)
        try:
            key = base64.b64encode(b"boundless-tpu-ws16").decode()
            sock.sendall(
                (f"GET /ws/orders?since={since} HTTP/1.1\r\n"
                 f"Host: {u.hostname}:{u.port}\r\n"
                 "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                 f"Sec-WebSocket-Key: {key}\r\n"
                 "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            rfile = sock.makefile("rb")
            status = rfile.readline()
            assert b"101" in status, status
            accept = None
            while True:
                line = rfile.readline().strip()
                if not line:
                    break
                name, _, val = line.partition(b": ")
                if name.lower() == b"sec-websocket-accept":
                    accept = val.decode()
            assert accept == _ws_accept_key(key), "bad WS accept key"
            n = 0
            while max_orders is None or n < max_orders:
                frame = ws_decode_frame(rfile)
                if frame is None or frame[0] == 8:
                    return
                if frame[0] != 1:
                    continue  # ping/pong/continuation: ignore
                d = json.loads(frame[1])
                n += 1
                yield (request_from_json(d["request"]),
                       bytes.fromhex(d["signature"]))
        finally:
            try:
                # masked client close frame (RFC6455: client frames mask)
                sock.sendall(b"\x88\x80\x00\x00\x00\x00")
                sock.close()
            except OSError:
                pass
