"""The port's market (`boundless_tpu_torch/market/`) against the JAX
package's, exactly: the same requests, wallets and scripts through both
packages give the same bytes, balances, statuses and events.

Requests are compared by their fields (each package pickles its own
classes, so pickled bytes never compare across packages). The verifier
swap of the reference's `submit_root_and_fulfill` is exercised
deterministically: an event holds the batch path at the entry of its
`chain.fulfill` while a per-fill call with a bad seal runs.
"""

import dataclasses
import importlib
import json
import threading
import types

import numpy as np
import pytest

SEED = 1410
T0 = 1000.0


def _pkg(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        name=root, types=m("market.types"), crypto=m("market.crypto"),
        chain=m("market.chain"), batcher=m("market.batcher"),
        stream=m("market.order_stream"), osh=m("market.order_stream_http"),
        router=m("market.router"), storage=m("market.storage_providers"),
        deployments=m("market.deployments"), bench=m("market.bench"),
        db=m("market.broker.db"), pipeline=m("market.broker.pipeline"),
        guests=m("zkvm.guests"))


JAX = _pkg("boundless_tpu")
PORT = _pkg("boundless_tpu_torch")


def _both(fn):
    """fn(package) in both packages -> (jax value, port value)."""
    return fn(JAX), fn(PORT)


def _alice(P):
    return P.crypto.Wallet.from_seed(b"alice")


def _request(P, index, kind="prefix", journal=b"", image_id="ab" * 32,
             selector=None, offer=None):
    T = P.types
    if kind == "prefix":
        pred = T.Predicate.prefix_match(journal[:4])
    elif kind == "claim":
        pred = T.Predicate(T.PredicateType.CLAIM_MATCH, b"c" * 32)
    else:
        pred = T.Predicate.digest_match(journal)
    offer = offer or T.Offer(min_price=100, max_price=500, bidding_start=T0,
                             ramp_up_period=10.0, lock_timeout=50.0,
                             timeout=100.0, lock_collateral=40)
    return T.ProofRequest(
        id=T.RequestId(_alice(P).address, index),
        requirements=T.Requirements(image_id=image_id, predicate=pred,
                                    selector=selector),
        image_url="local://elfs/x", input_data=bytes(range(index % 7)),
        offer=offer)


def _fields(obj):
    """A request, fill or order as plain values (enums by value)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if hasattr(obj, "value") and hasattr(type(obj), "__members__"):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    return obj


# ---------------------------------------------------------------------------
# crypto and types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (0, 1, 31, 135, 136, 137, 1000))
def test_keccak256_equals_jax(n):
    data = np.random.default_rng(SEED + n).bytes(n)
    j, p = _both(lambda P: P.crypto.keccak256(data))
    assert p == j and len(p) == 32


@pytest.mark.parametrize("seed", (b"alice", b"bob", b"prover-node", b""))
def test_wallet_signature_equals_jax(seed):
    digest = np.random.default_rng(SEED).bytes(32)

    def run(P):
        w = P.crypto.Wallet.from_seed(seed)
        sig = w.sign(digest)
        return (w.address, sig, P.crypto.recover_address(digest, sig))

    j, p = _both(run)
    assert p == j and p[2] == p[0]


@pytest.mark.parametrize("kind", ("prefix", "claim", "digest"))
def test_request_digest_and_id_equal_jax(kind):
    def run(P):
        req = _request(P, 7, kind, journal=b"journal words",
                       selector="0x00000000")
        sig = P.types.sign_request(req, _alice(P))
        return (req.id.encoded(), req.signing_digest(), sig,
                P.types.verify_signature(req, sig), _fields(req))

    j, p = _both(run)
    assert p == j and p[3]


def test_offer_prices_equal_jax():
    ts = [T0 - 1, T0, T0 + 2.5, T0 + 9.99, T0 + 10, T0 + 1e4]

    def run(P):
        o = _request(P, 0).offer
        return ([o.price_at(t) for t in ts], o.expires_at(),
                o.lock_deadline())

    j, p = _both(run)
    assert p == j


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


def _chain_script(P):
    """Submit / lock / fulfil / slash / withdraw on a chain with a scripted
    clock; every call's outcome is recorded (errors by message)."""
    T = P.types
    t = [T0]
    chain = P.chain.MarketChain(lambda f, r: f.seal == b"good",
                                clock=lambda: t[0])
    alice = _alice(P)
    out = []

    def do(name, *args):
        try:
            out.append((name, "ok", getattr(chain, name)(*args)))
        except P.chain.MarketError as e:
            out.append((name, "err", str(e)))

    def fill(req, journal, seal, prover="prover1", claim=b"c" * 32):
        return T.Fulfillment(request_id=req.id, journal=journal,
                             claim_digest=claim, seal=seal, prover=prover)

    do("create_account", alice.address, 10_000)
    do("create_account", "prover1", 1000)
    do("create_account", "prover2", 500)
    do("deposit", "prover2", 50)
    do("withdraw", "prover2", 10_000)
    do("withdraw", "prover2", 100)
    do("deposit_collateral", "prover1", 300)
    do("deposit_collateral", "prover2", 10_000)
    reqs = [_request(P, 1, "claim"), _request(P, 2, "prefix", b"abcdefgh"),
            _request(P, 3, "digest", b"journal3"), _request(P, 4, "prefix")]
    for r in reqs:
        do("submit_request", r, T.sign_request(r, alice))
    do("submit_request", reqs[0], T.sign_request(reqs[0], alice))
    bad = _request(P, 5)
    do("submit_request", bad, b"\0" * 65)
    rid = [r.id.encoded() for r in reqs]
    t[0] = T0 + 2.5
    do("price_request", rid[0])
    do("lock_request", rid[0], "prover1")
    do("lock_request", rid[0], "prover1")
    do("lock_request", rid[1], "prover2")
    do("lock_request", rid[1], "prover1")
    do("lock_request", "0xunknown:1:0", "prover1")
    t[0] = T0 + 5
    do("price_request", rid[0])
    do("fulfill", [fill(reqs[0], b"j1", b"good")])
    do("fulfill", [fill(reqs[1], b"abcdefgh", b"good", prover="prover2")])
    do("fulfill", [fill(reqs[2], b"journal3", b"bad")])
    do("fulfill", [fill(reqs[2], b"journal4", b"good")])
    do("fulfill", [fill(reqs[2], b"journal3", b"good", prover="prover2")])
    do("fulfill", [fill(reqs[0], b"j1", b"good")])
    do("lock_request", rid[3], "prover1")
    do("slash", rid[3], "watcher")
    t[0] = T0 + 60
    do("lock_request", rid[3], "prover2")
    t[0] = T0 + 101
    do("slash", rid[3], "watcher")
    do("slash", rid[3], "watcher")
    do("fulfill", [fill(reqs[3], b"", b"good")])
    do("withdraw", "prover1", 50)
    statuses = [chain.request_status(r) for r in rid + ["0xnone:0:0"]]
    t[0] = T0 + 30
    statuses += [chain.request_status(r) for r in rid]
    events = [(e.kind, e.block, e.data) for e in chain.events_since(0)]
    return (out, dict(chain.balances), dict(chain.collateral), statuses,
            events, sorted(chain.slashed),
            {k: _fields(v) for k, v in chain.locks.items()},
            {k: _fields(v) for k, v in chain.fulfilled.items()})


def test_chain_script_equals_jax():
    j, p = _both(_chain_script)
    assert p == j
    kinds = {e[0] for e in p[4]}
    assert kinds == {"RequestSubmitted", "RequestLocked", "RequestFulfilled",
                     "RequestSlashed"}


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------


def _fills(P, n, kinds=("prefix", "claim", "digest")):
    T = P.types
    alice = _alice(P)
    out = []
    for i in range(n):
        journal = P.guests.words([i, 3 * i + 1, 77])
        req = _request(P, 100 + i, kinds[i % len(kinds)], journal)
        fill = T.Fulfillment(request_id=req.id, journal=journal,
                             claim_digest=b"c" * 32, seal=None,
                             prover="prover1")
        out.append((req, T.sign_request(req, alice), fill))
    return out


@pytest.mark.parametrize("n", (1, 2, 3, 5))
def test_set_root_bytes_equal_jax(n):
    rng = np.random.default_rng(SEED + n)
    digests = [rng.bytes(32) for _ in range(n)]
    journals = [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]

    def run(P):
        B = P.batcher
        leaves = [B.fill_leaf(f"r{i}", digests[i], journals[i])
                  for i in range(n)]
        root = B.merkle_root(leaves)
        paths = [B.merkle_path(leaves, i) for i in range(n)]
        ok = [B.merkle_verify(root, leaves[i], i, paths[i])
              for i in range(n)]
        return leaves, root, paths, ok, B.merkle_root([])

    j, p = _both(run)
    assert p == j and all(p[3])


@pytest.mark.parametrize("n", (1, 2, 3))
def test_assessor_input_and_journal_equal_jax(n):
    def run(P):
        fills = _fills(P, n)
        return (P.batcher.assessor_guest_input_v2(fills),
                P.batcher.expected_assessor_journal(fills),
                P.batcher.assessor_guest_input(
                    _fills(P, n, ("prefix", "claim"))))

    j, p = _both(run)
    assert p == j


def test_assessor_guest_run_equals_jax():
    """Two fills through the assessor guest (two in-guest ECDSA
    recoveries, native execution) give the same receipt in both
    packages; a forged signature faults the guest in both."""
    def run(P):
        fills = _fills(P, 2)
        r = P.batcher.Assessor().assess(fills, "prover1")
        assert P.batcher.Assessor().verify(r, fills)
        forged = [(fills[0][0],
                   P.types.sign_request(fills[0][0],
                                        P.crypto.Wallet.from_seed(b"m")),
                   fills[0][2])]
        with pytest.raises(P.chain.MarketError, match="faulted"):
            P.batcher.Assessor().assess(forged, "prover1")
        return r.root, r.journal, r.dev_mode, r.prover

    j, p = _both(run)
    assert p == j


def _batch_world(P, verifier):
    chain = P.chain.MarketChain(verifier, clock=lambda: T0 + 1)
    chain.create_account(_alice(P).address, funds=10_000)
    chain.create_account("prover1", funds=0)
    assessor = P.batcher.Assessor()
    bp = P.batcher.BatchProcessor(assessor, "prover1", max_batch=2)
    batch = P.batcher.Batch()
    for f in _fills(P, 2):
        chain.submit_request(f[0], f[1])
        batch = bp.update_batch(batch, f)
    return chain, assessor, bp, batch


def test_submit_root_and_fulfill_equals_jax():
    def run(P):
        chain, assessor, bp, batch = _batch_world(P, lambda f, r: False)
        root, receipt, entries = bp.submission(batch)
        bad = list(entries)
        req, sig, fill, idx, path = bad[0]
        bad[0] = (req, sig, fill, idx, [b"\0" * 32] * len(path))
        with pytest.raises(P.chain.MarketError, match="inclusion"):
            P.batcher.submit_root_and_fulfill(chain, assessor, root,
                                              receipt, bad)
        P.batcher.submit_root_and_fulfill(chain, assessor, root, receipt,
                                          entries)
        # the chain's own verifier is in place again
        assert chain.verifier(None, None) is False
        return (batch.state(), dict(chain.balances),
                [chain.request_status(e[0].id.encoded()) for e in entries],
                [(e.kind, e.data) for e in chain.events_since(0)])

    j, p = _both(run)
    assert p == j


@pytest.mark.parametrize("impl", ("port", "jax"))
def test_per_fill_racing_batch_meets_the_chain_verifier(impl):
    """A per-fill `fulfill` with a bad seal, made while a batch submit on
    the same chain is at the entry of its `chain.fulfill`, is rejected
    by the port; the reference's swap of `chain.verifier` lets it through
    (the port's chain serves both, so only the batch function differs)."""
    P = PORT
    submit = (P if impl == "port" else JAX).batcher.submit_root_and_fulfill
    chain, assessor, bp, _ = _batch_world(P, lambda f, r: f.seal == b"good")
    fills = _fills(P, 3)
    batch = P.batcher.Batch()
    for f in fills[:2]:
        batch.fills.append(f)
    batch = bp.close_batch(batch)
    racer = fills[2]
    chain.submit_request(racer[0], racer[1])
    racer[2].seal = b"forged"

    inside, release = threading.Event(), threading.Event()
    real_fulfill = chain.fulfill
    batch_thread = []

    def fulfill(fills, **kw):
        if threading.current_thread() in batch_thread:
            inside.set()
            assert release.wait(30)
        return real_fulfill(fills, **kw)

    chain.fulfill = fulfill
    root, receipt, entries = bp.submission(batch)
    t = threading.Thread(target=submit,
                         args=(chain, assessor, root, receipt, entries))
    batch_thread.append(t)
    t.start()
    try:
        assert inside.wait(30)
        try:
            chain.fulfill([racer[2]])
            accepted = True
        except P.chain.MarketError as e:
            assert "seal verification failed" in str(e)
            accepted = False
    finally:
        release.set()
        t.join(30)
    assert not t.is_alive()
    assert accepted == (impl == "jax")
    assert all(chain.request_status(e[0].id.encoded()) == "fulfilled"
               for e in entries)


# ---------------------------------------------------------------------------
# order stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("prefix", "claim", "digest"))
def test_order_stream_codec_equals_jax(kind):
    def run(P):
        req = _request(P, 9, kind, b"some journal", selector="0xdeadbeef")
        d = P.osh.request_to_json(req)
        assert P.osh.request_from_json(json.loads(json.dumps(d))) == req
        return json.dumps(d, sort_keys=True).encode()

    j, p = _both(run)
    assert p == j
    # a request JAX encodes decodes in the port to the port's own
    req = PORT.osh.request_from_json(json.loads(j))
    assert req == _request(PORT, 9, kind, b"some journal",
                           selector="0xdeadbeef")


def test_ws_frames_equal_jax():
    import io

    for n in (0, 5, 125, 126, 70_000):
        payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
        j, p = _both(lambda P: P.osh.ws_encode_text(payload))
        assert p == j
        assert PORT.osh.ws_decode_frame(io.BytesIO(p)) == (1, payload)
    j, p = _both(lambda P: P.osh._ws_accept_key("dGhlIHNhbXBsZSBub25jZQ=="))
    assert p == j == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_order_stream_http_and_websocket_roundtrip():
    """Submit over HTTP, replay and a live push over the WebSocket, a
    heartbeat, and a bad signature refused (403)."""
    import urllib.error

    P = PORT
    alice = _alice(P)
    stream = P.stream.OrderStream()
    server, thread = P.osh.make_order_stream_server(stream)
    thread.start()
    try:
        osc = P.osh.OrderStreamClient(
            f"http://127.0.0.1:{server.server_address[1]}")
        r0, r1 = _request(P, 20), _request(P, 21, "claim")
        osc.submit(r0, P.types.sign_request(r0, alice))
        got, first, done = [], threading.Event(), threading.Event()

        def run():
            for req, sig in osc.subscribe_ws(since=0, max_orders=2):
                got.append((req, sig))
                first.set()
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert first.wait(10), "no replay over the WebSocket"
        osc.submit(r1, P.types.sign_request(r1, alice))  # live push
        assert done.wait(10), "no live push over the WebSocket"
        assert [r for r, _ in got] == [r0, r1]
        assert got[1][1] == P.types.sign_request(r1, alice)
        assert [o[0] for o in osc.orders_since(0)] == [r0, r1]
        osc.heartbeat("prover-x")
        assert "prover-x" in stream.heartbeats
        with pytest.raises(urllib.error.HTTPError):
            osc.submit(r0, b"\x00" * 65)
    finally:
        server.shutdown()
        server.server_close()


def test_order_stream_durable_equals_jax(tmp_path):
    def run(P):
        db = str(tmp_path / f"{P.name}.sqlite")
        stream = P.stream.OrderStream(db_path=db)
        for i in range(3):
            r = _request(P, 30 + i)
            stream.submit(r, P.types.sign_request(r, _alice(P)))
        with pytest.raises(PermissionError):
            stream.submit(_request(P, 40), b"x" * 65)
        again = P.stream.OrderStream(db_path=db).orders_since(1)
        return [(_fields(r), s) for r, s in again]

    j, p = _both(run)
    assert p == j and len(p) == 2


# ---------------------------------------------------------------------------
# router, storage, deployments, bench rows, order db
# ---------------------------------------------------------------------------


def test_router_dispatch_equals_jax():
    def run(P):
        r = (P.router.default_router() if P is JAX
             else P.router.default_router(device="cpu"))
        dev = {"dev_mode": True, "journal": b"j"}
        out = [r.selectors()]
        for sel in (None, "0xdeadbeef", "0x73c457ba", "0x00000000",
                    "0xffffffff"):
            req = _request(P, 50, selector=sel)
            for seal, journal in ((dev, b"j"), (dev, b"x"), (None, b"j")):
                fill = P.types.Fulfillment(req.id, journal, b"c" * 32, seal,
                                           "p")
                out.append(bool(r.market_verifier("0xdeadbeef")(fill, req)))
        with pytest.raises(P.router.RouterError):
            r.verify("0x12345678", dev, None, None)
        return out

    j, p = _both(run)
    assert p == j


def test_seal_verifiers_refuse_a_missing_card(monkeypatch):
    import torch

    from boundless_tpu_torch.market.broker import cluster_prover

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.router.default_router()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cluster_prover.session_seal_verifier()
    assert cluster_prover.session_seal_verifier(device="cpu") is not None


def test_storage_providers_equal_jax(tmp_path):
    import datetime

    now = datetime.datetime(2026, 1, 2, 3, 4, 5,
                            tzinfo=datetime.timezone.utc)

    def run(P):
        S = P.storage
        mock = S.MockStorageProvider()
        url = mock.upload("elfs/a", b"abc")
        files = S.FileStorageProvider(str(tmp_path / P.name))
        furl = files.upload("elfs/b", b"xyz")
        heads = S._sigv4_headers(
            "PUT", "https://bucket.s3.example.com/elfs/k%20e?b=2&a=1",
            "us-east-1", "AK", "SK", b"payload", now=now)
        return (url, mock.download(url), furl.replace(P.name, ""),
                files.download(furl), heads,
                type(S.provider_for("s3://b", bucket="b")).__name__)

    j, p = _both(run)
    assert p == j


def test_deployments_and_bench_rows_equal_jax():
    def run(P):
        d = [dataclasses.asdict(P.deployments.get(n))
             for n in ("local", "testnet")]
        d.append(dataclasses.asdict(P.deployments.get("local",
                                                      chain_id=5)))
        rows = [P.bench.BenchRow("r", 1_000_000, 10.0, 10.5, 12.5),
                P.bench.BenchRow("s", 5, 10.0)]
        return d, [(r.lock_latency, r.fulfill_latency, r.effective_khz)
                   for r in rows]

    j, p = _both(run)
    assert p == j


def test_order_db_round_trip_equals_jax():
    def run(P):
        db = P.db.OrderDb()
        S = P.pipeline.OrderStatus
        for i, status in enumerate((S.NEW, S.LOCKED, S.PROVING, S.FULFILLED,
                                    S.COMMITTED)):
            order = P.pipeline.Order(request=_request(P, 60 + i),
                                     status=status, cycles=i * 1000 or None,
                                     price=7 * i, error=None)
            db.upsert(order.request.id.encoded(), order)
        return ({k: _fields(v) for k, v in db.load_all().items()},
                sorted(db.in_flight()))

    j, p = _both(run)
    assert p == j


def test_cli_requestor_submit_equals_jax():
    """`requestor submit` in both packages: the same auction, status,
    journal and seal lines (the request id holds the clock)."""
    import contextlib
    import io

    from boundless_tpu import cli as jcli
    from boundless_tpu_torch import cli as pcli

    def run(main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["requestor", "submit", "--image", "echo", "--input",
                  "3,11,22,33", "--key", "cli", "--timeout", "60"])
        lines = buf.getvalue().splitlines()
        return [lines[0].split(": ", 1)[1]] + lines[1:]

    want, got = run(jcli.main), run(pcli.main)
    assert got == want
    assert got[1:3] == ["status: fulfilled",
                        "journal: 0b0000001600000021000000"]
