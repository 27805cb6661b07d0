"""Satellite market services parity: every case of JAX
`tests/test_services.py` run on both the JAX package and the port
(`boundless_tpu_torch/market/services.py`, `market/indexer_service.py`,
`cluster/metrics.py`), and one scripted chain per package indexed by
`Indexer` and `IndexerService` with equal aggregates, tables and events."""

import importlib
import json
import time
import urllib.request as _url

import pytest

PACKAGES = ["boundless_tpu", "boundless_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _alice(pkg):
    return mod(pkg, "market.crypto").Wallet.from_seed(b"alice")


def _mk_chain(pkg, clock):
    chain = mod(pkg, "market.chain").MarketChain(lambda fill, req: True,
                                                 clock=clock)
    chain.create_account(_alice(pkg).address, funds=1000)
    chain.create_account("prover1", funds=1000)
    chain.deposit_collateral("prover1", 200)
    return chain


def _mk_request(pkg, i=1, start=1000.0):
    T = mod(pkg, "market.types")
    offer = T.Offer(min_price=10, max_price=20, bidding_start=start,
                    ramp_up_period=1.0, lock_timeout=5.0, timeout=10.0,
                    lock_collateral=50)
    return T.ProofRequest(
        id=T.RequestId(_alice(pkg).address, i),
        requirements=T.Requirements(image_id="ab",
                                    predicate=T.Predicate.prefix_match(b"")),
        image_url="local://elfs/x", input_data=b"", offer=offer)


def _submit(pkg, chain, i):
    req = _mk_request(pkg, i)
    chain.submit_request(req, mod(pkg, "market.types").sign_request(
        req, _alice(pkg)))
    return req


def _fulfill(pkg, chain, req):
    T = mod(pkg, "market.types")
    chain.lock_request(req.id.encoded(), "prover1")
    chain.fulfill([T.Fulfillment(request_id=req.id, journal=b"x",
                                 claim_digest=b"c" * 32, seal=None,
                                 prover="prover1")])


def test_slasher_slashes_expired(pkg):
    t = [1000.0]
    chain = _mk_chain(pkg, lambda: t[0])
    req = _submit(pkg, chain, 1)
    chain.lock_request(req.id.encoded(), "prover1")
    s = mod(pkg, "market.services").Slasher(chain, "watcher", poll=0.01)
    s.start()
    try:
        time.sleep(0.05)
        assert not s.slashed  # not yet expired
        t[0] = 1011.0
        deadline = time.time() + 2
        while time.time() < deadline and not s.slashed:
            time.sleep(0.01)
        assert s.slashed == [req.id.encoded()]
    finally:
        s.stop()


def test_indexer_aggregates(pkg):
    chain = _mk_chain(pkg, lambda: 1000.0)
    for i in range(3):
        _submit(pkg, chain, i)
    req0 = chain.requests[mod(pkg, "market.types").RequestId(
        _alice(pkg).address, 0).encoded()]
    _fulfill(pkg, chain, req0)
    idx = mod(pkg, "market.services").Indexer(chain)
    agg = idx.sync()
    assert agg.total_requests == 3
    assert agg.total_fulfilled == 1
    assert agg.per_prover_fulfilled == {"prover1": 1}
    assert agg.per_requestor_requests == {_alice(pkg).address: 3}
    assert agg.total_volume > 0
    # incremental sync picks up only new events
    _submit(pkg, chain, 7)
    assert idx.sync().total_requests == 4


def test_distributor_topup(pkg):
    chain = _mk_chain(pkg, time.time)
    chain.create_account("treasury", funds=10_000)
    chain.create_account("op1", funds=5)
    d = mod(pkg, "market.services").Distributor(
        chain, "treasury", ["op1", "prover1"], min_balance=100, top_up=500)
    assert d.run_once() == {"op1": 500}
    assert chain.balances["op1"] == 505


def test_order_generator_submits(pkg):
    chain = _mk_chain(pkg, lambda: 1000.0)
    client = mod(pkg, "market.client").Client(chain, _alice(pkg))
    n = [0]

    def make():
        n[0] += 1
        return _mk_request(pkg, 100 + n[0])

    gen = mod(pkg, "market.services").OrderGenerator(client, make,
                                                     interval=0.0, count=3)
    gen.start()
    deadline = time.time() + 5
    while time.time() < deadline and len(gen.submitted) < 3:
        time.sleep(0.01)
    gen.stop()
    assert len(gen.submitted) == 3
    assert all(rid in chain.requests for rid in gen.submitted)


def test_requestor_list(pkg):
    rl = mod(pkg, "market.services").RequestorList("priority",
                                                   ["alice", "bob"])
    assert rl.validate()
    assert rl.is_member("alice") and not rl.is_member("eve")


def test_metrics_registry(pkg):
    r = mod(pkg, "cluster.metrics").Registry()
    r.counter("tasks_total", stream="prove").inc()
    r.counter("tasks_total", stream="prove").inc(2)
    with r.histogram("dur_seconds", stream="prove").time():
        pass
    text = r.render()
    assert 'tasks_total{stream="prove"} 3.0' in text
    assert 'dur_seconds_count{stream="prove"} 1' in text


def test_indexer_service_durable_resume(pkg, tmp_path):
    """Persistent indexer: aggregates in sqlite, a restart resumes from the
    block cursor without double counting; the query API answers."""
    S = mod(pkg, "market.indexer_service")
    chain = _mk_chain(pkg, lambda: 1000.0)
    db = str(tmp_path / "indexer.db")
    idx = S.IndexerService(chain, db)
    _submit(pkg, chain, 1)
    assert idx.sync() >= 1
    assert idx.stats()["total_requests"] == 1

    idx2 = S.IndexerService(chain, db)
    assert idx2.stats()["total_requests"] == 1
    _fulfill(pkg, chain, _submit(pkg, chain, 2))
    idx2.sync()
    st = idx2.stats()
    assert st["total_requests"] == 2 and st["total_fulfilled"] == 1
    assert idx2.requestors()[_alice(pkg).address] == 2
    assert idx2.provers()["prover1"] == 1

    server, thread = S.make_indexer_server(idx2)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert json.loads(_url.urlopen(base + "/stats").read()
                          )["total_requests"] == 2
        evs = json.loads(_url.urlopen(base + "/events?since=0").read())
        assert len(evs["events"]) >= 2
        assert json.loads(_url.urlopen(base + "/health").read()) == {
            "ok": True}
    finally:
        server.shutdown()


def _scripted(pkg):
    """A chain with submissions, fills, a lock left to expire and a slash;
    -> (Indexer aggregates, IndexerService stats, provers, requestors,
    events)."""
    t = [1000.0]
    chain = _mk_chain(pkg, lambda: t[0])
    reqs = [_submit(pkg, chain, i) for i in range(5)]
    for r in reqs[:2]:
        _fulfill(pkg, chain, r)
    chain.lock_request(reqs[2].id.encoded(), "prover1")
    t[0] = 1011.0
    chain.slash(reqs[2].id.encoded(), "watcher")
    svc = mod(pkg, "market.indexer_service").IndexerService(chain)
    svc.sync()
    agg = mod(pkg, "market.services").Indexer(chain).sync()
    return (agg.__dict__, svc.stats(), svc.provers(), svc.requestors(),
            svc.events(0))


def test_indexers_equal_jax():
    got, want = _scripted("boundless_tpu_torch"), _scripted("boundless_tpu")
    assert got == want
    stats = got[1]
    assert (stats["total_requests"], stats["total_fulfilled"],
            stats["total_slashed"]) == (5, 2, 1)
