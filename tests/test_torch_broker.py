"""The port's broker (`boundless_tpu_torch/market/broker/`) against the JAX
package's, and on the port's cluster.

Dev mode: both packages' `Broker`s, on the JAX tests' `MockProver` shape
(executor-backed, fake seals), fulfil the same signed requests per fill
and in a batch through the in-guest ECDSA assessor; the fills on the
chain are equal field by field. Real: the port's `Broker` drives
`ClusterProver` over the port's cluster (`device="cpu"`, `TEST_PS`, po2 8,
`succinct=None`, the v1 aggregation seal); the chain's verifier checks
the seal's segment STARKs on the CPU, and a seal with one flipped word in
a segment's public io is rejected.
"""

import dataclasses
import hashlib
import importlib
import itertools
import time
import types

import numpy as np
import pytest

PO2 = 8


def _pkg(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        name=root, chain=m("market.chain"), client=m("market.client"),
        crypto=m("market.crypto"), pipeline=m("market.broker.pipeline"),
        storage=m("cluster.storage"), executor=m("zkvm.executor"),
        guests=m("zkvm.guests"))


JAX = _pkg("boundless_tpu")
PORT = _pkg("boundless_tpu_torch")


def _mock_prover(P):
    class MockProver:
        """Executor-backed mock prover (dev-mode style fake seals)."""

        def preflight(self, image, input_data):
            return P.executor.Executor(image, input_data).run().total_cycles

        def prove(self, image, input_data):
            res = P.executor.Executor(image, input_data).run()
            claim = hashlib.sha256(b"claim:" + res.journal).digest()
            seal = {"dev_mode": True, "journal": res.journal,
                    "image_id": res.image_id.hex()}
            return res.journal, seal, claim

    return MockProver()


def mock_verifier(fill, request):
    return (isinstance(fill.seal, dict) and fill.seal.get("dev_mode")
            and fill.seal["journal"] == fill.journal
            and fill.seal["image_id"] == request.requirements.image_id)


def _wait(chain, rids, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(chain.request_status(r) == "fulfilled" for r in rids):
            return
        time.sleep(0.05)
    raise TimeoutError([chain.request_status(r) for r in rids])


def _dev_market(P, payloads, start, **config):
    """Requests with the same ids, offers and signatures in either package
    (a fixed bidding start, a zero ramp so the locked price is the
    maximum), fulfilled by that package's broker on the mock prover.
    Returns ({rid: fill fields}, statuses, balances, collateral)."""
    C = P.client
    alice = P.crypto.Wallet.from_seed(b"alice")
    chain = P.chain.MarketChain(mock_verifier)
    chain.create_account(alice.address, funds=10_000_000)
    chain.create_account("prover1", funds=1_000_000)
    chain.deposit_collateral("prover1", 500_000)
    provider = C.LocalStorageProvider(P.storage.SharedFs())
    client = C.Client(chain, alice, storage_provider=provider)
    counter = itertools.count(1)
    broker = P.pipeline.Broker(
        chain, _mock_prover(P), "prover1",
        P.pipeline.BrokerConfig(min_mcycle_price=0, **config),
        storage=provider)
    broker.start()
    try:
        rids = []
        for payload in payloads:
            req = client.build_request(
                P.guests.echo(), P.guests.words([len(payload)] + payload),
                layers=[C.StorageLayer(provider), C.PreflightLayer(),
                        C.RequirementsLayer(),
                        C.OfferLayer(ramp=0.0, clock=lambda: start),
                        C.RequestIdLayer(alice.address, counter)])
            rids.append(client.submit_onchain(req))
        _wait(chain, rids, 60)
        fills = {}
        for rid in rids:
            f = chain.get_fulfillment(rid)
            fills[rid] = (f.request_id.encoded(), f.journal, f.claim_digest,
                          f.seal, f.prover)
        statuses = [broker.orders[r].status for r in rids]
        return fills, statuses, dict(chain.balances), dict(chain.collateral)
    finally:
        broker.stop()


@pytest.mark.parametrize("batch", (False, True))
def test_dev_mode_broker_fills_equal_jax(batch):
    payloads = ([7, 8, 9], [4, 5]) if batch else ([7, 8, 9],)
    start = float(int(time.time()))
    config = dict(batch_fulfill=True, batch_size=2) if batch else {}
    want = _dev_market(JAX, payloads, start, **config)
    got = _dev_market(PORT, payloads, start, **config)
    assert got == want
    assert got[1] == ["fulfilled"] * len(payloads)
    for payload, fill in zip(payloads, got[0].values()):
        assert fill[1] == PORT.guests.words(payload)
    assert got[2]["prover1"] > 1_000_000 - 500_000


def test_dev_mode_batch_refuses_a_forged_signature():
    """A fill whose signature does not recover to the client makes the
    assessor guest fault: the batch fails and nothing is fulfilled."""
    P = PORT
    from boundless_tpu_torch.market import batcher
    from boundless_tpu_torch.market.types import Fulfillment, sign_request

    alice = P.crypto.Wallet.from_seed(b"alice")
    chain = P.chain.MarketChain(mock_verifier)
    chain.create_account(alice.address, funds=10**7)
    provider = P.client.LocalStorageProvider(P.storage.SharedFs())
    client = P.client.Client(chain, alice, storage_provider=provider)
    req = client.build_request(P.guests.echo(), P.guests.words([1, 42]))
    rid = client.submit_onchain(req)
    res = P.executor.Executor(P.guests.echo(), req.input_data).run()
    fill = Fulfillment(request_id=req.id, journal=res.journal,
                       claim_digest=b"c" * 32, seal=None, prover="prover1")
    forged = sign_request(req, P.crypto.Wallet.from_seed(b"mallory"))
    with pytest.raises(P.chain.MarketError, match="faulted"):
        batcher.Assessor().assess([(req, forged, fill)], "prover1")
    good = chain.request_sigs[rid]
    assert batcher.Assessor().assess([(req, good, fill)], "prover1").journal


def _tampered(seal):
    """`seal` with one word of its first segment's public io flipped."""
    seg = seal.root.segments[0]
    pub = dict(seg.pub)
    io = np.array(pub["io"], copy=True)
    io.flat[0] ^= 1
    pub["io"] = io
    segments = [dataclasses.replace(seg, pub=pub)] + list(
        seal.root.segments[1:])
    return dataclasses.replace(
        seal, root=dataclasses.replace(seal.root, segments=segments))


def test_real_broker_on_the_port_cluster():
    from boundless_tpu_torch.cluster.agent import ClusterContext, run_workers
    from boundless_tpu_torch.cluster.api import ClusterApi
    from boundless_tpu_torch.cluster.hotstore import HotStore
    from boundless_tpu_torch.cluster.storage import SharedFs
    from boundless_tpu_torch.cluster.taskdb import MemoryBackend
    from boundless_tpu_torch.market.broker.cluster_prover import (
        ClusterProver, session_seal_verifier)
    from boundless_tpu_torch.market.broker.pipeline import (Broker,
                                                            BrokerConfig,
                                                            OrderStatus)
    from boundless_tpu_torch.market.chain import MarketChain
    from boundless_tpu_torch.market.client import (Client,
                                                   LocalStorageProvider)
    from boundless_tpu_torch.market.crypto import Wallet
    from boundless_tpu_torch.market.router import default_router
    from boundless_tpu_torch.recursion.receipt import SessionReceipt
    from boundless_tpu_torch.zkvm import guests, prove

    ctx = ClusterContext(db=MemoryBackend(), hot=HotStore(), store=SharedFs(),
                         ps=prove.TEST_PS, segment_po2=PO2, succinct=None,
                         device="cpu")
    threads, agents = run_workers(ctx, {"exec": 1, "prove": 2, "join": 1,
                                        "aux": 1})
    cp = ClusterProver(ClusterApi(ctx), timeout=300)
    verify = session_seal_verifier(ps=prove.TEST_PS, device="cpu")
    alice = Wallet.from_seed(b"alice")
    chain = MarketChain(verify)
    chain.create_account(alice.address, funds=10**9)
    chain.create_account("prover1", funds=10**7)
    chain.deposit_collateral("prover1", 10**6)
    provider = LocalStorageProvider(SharedFs())
    client = Client(chain, alice, storage_provider=provider)
    broker = Broker(chain, cp, "prover1", BrokerConfig(min_mcycle_price=0),
                    storage=provider)
    broker.start()
    try:
        payload = [4242, 17]
        req = client.build_request(guests.echo(),
                                   guests.words([len(payload)] + payload))
        rid = client.submit_onchain(req)
        journal, seal = client.wait_for_fulfillment(rid, timeout=300)
        assert journal == guests.words(payload)
        assert broker.orders[rid].status == OrderStatus.FULFILLED
        assert chain.balances["prover1"] > 10**7 - 10**6
    finally:
        broker.stop()
        for a in agents:
            a.stop()
    assert isinstance(seal, SessionReceipt)
    assert seal.verify(ps=prove.TEST_PS, image=guests.echo())
    fill = chain.get_fulfillment(rid)
    assert verify(fill, req)
    router = default_router(prove.TEST_PS, device="cpu").market_verifier(
        "0x00000000")
    assert router(fill, req)
    bad = dataclasses.replace(fill, seal=_tampered(seal))
    assert not verify(bad, req)
    assert not router(bad, req)


@pytest.mark.parametrize("impl", ("port", "jax"))
def test_two_writers_of_one_key(impl, monkeypatch, tmp_path):
    """The broker's preflight and prove upload an order's image under one
    key from two threads. Writer B runs whole while writer A stands
    between its write and its rename: the port gives each write a
    temporary file of its own, so both publish and A's bytes land last;
    the reference's shared `<path>.tmp` is gone when A renames it."""
    import os

    from boundless_tpu.cluster import storage as jstorage
    from boundless_tpu_torch.cluster import storage as pstorage

    fs = (pstorage if impl == "port" else jstorage).SharedFs(str(tmp_path))
    real_replace = os.replace
    inner = []

    def replace(src, dst):
        if not inner:
            inner.append(src)
            fs.put_bytes("elfs", "img", b"writer B")
        return real_replace(src, dst)

    monkeypatch.setattr(os, "replace", replace)
    if impl == "jax":
        with pytest.raises(FileNotFoundError):
            fs.put_bytes("elfs", "img", b"writer A")
        return
    fs.put_bytes("elfs", "img", b"writer A")
    assert fs.get_bytes("elfs", "img") == b"writer A"
    assert sorted(os.listdir(tmp_path / "elfs")) == ["img"]
