"""Broker: market-facing prover node order pipeline.

The port's copy of `boundless_tpu/market/broker/pipeline.py`.

Re-design of `crates/broker` (reference `src/broker.rs:127-293` wiring):
channel-wired stages, each a thread consuming a queue:

  ChainMonitor / OrderStreamMonitor  ->  OrderEvaluator (capacity gate)
    -> OrderPricer (preflight + mcycle pricing + deadline feasibility
       against peak_prove_khz, reference order_pricer/service.rs)
    -> OrderCommitter -> OrderLocker (lock tx)
    -> OrderProcessor (proving via the cluster)
    -> Submitter (fulfill tx)

plus a ReaperTask cancelling expired committed orders
(`utils/reaper.rs`). Config mirrors broker-template.toml knobs
(min_mcycle_price :30, peak_prove_khz :62, max_concurrent_preflights :97,
max_concurrent_proofs :107).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from typing import Optional

from ..chain import MarketChain
from ..types import Fulfillment, ProofRequest


class PriceOracle:
    """Native-token/USD rate source (reference broker's USD-denominated
    `min_mcycle_price = "0.00002 USD"`, broker-template.toml:30, priced
    through an ETH/USD oracle in order_pricer). `rate` is USD per native
    token; a callable can track an on-chain feed."""

    def __init__(self, usd_per_token=3000.0):
        self._rate = usd_per_token

    def usd_per_token(self) -> float:
        return self._rate() if callable(self._rate) else float(self._rate)

    def usd_to_wei(self, usd: float) -> int:
        return int(usd / self.usd_per_token() * 1e18)


@dataclasses.dataclass
class BrokerConfig:
    min_mcycle_price: int = 1  # floor in wei per Mcycle
    # USD-denominated floor (reference broker-template.toml:30); when set
    # (with an oracle) it overrides the wei floor.
    min_mcycle_price_usd: Optional[float] = None
    price_oracle: Optional[PriceOracle] = None
    peak_prove_khz: float = 100.0  # proving capacity model
    max_concurrent_preflights: int = 2
    max_concurrent_proofs: int = 2
    max_collateral: int = 1_000_000
    lock_orders: bool = True
    # priority requestors skip the min-price gate (reference
    # broker-template.toml:75 priority lists + RequestorMonitor)
    priority_requestors: tuple = ()
    # Batch aggregation: fulfill through the assessor-guest + set-builder
    # path (submitRootAndFulfill; reference BatcherService -> Submitter)
    # instead of per-fill seals. The assessor guest verifies each fill's
    # request signature with in-guest secp256k1 — a wrongly-signed fill
    # faults the guest and the whole batch is rejected because the proof
    # does not exist (assessor-guest/src/main.rs:58-66 semantics).
    batch_fulfill: bool = False
    batch_size: int = 2
    batch_linger_s: float = 0.25


class OrderStatus:
    """Lifecycle states (reference order_types.rs:38-57)."""

    NEW = "new"
    PRICING = "pricing"
    COMMITTED = "committed"
    LOCKED = "locked"
    PROVING = "proving"
    FULFILLED = "fulfilled"
    SKIPPED = "skipped"
    FAILED = "failed"


@dataclasses.dataclass
class Order:
    request: ProofRequest
    status: str = OrderStatus.NEW
    cycles: Optional[int] = None
    price: int = 0
    error: Optional[str] = None
    journal: Optional[bytes] = None


class Broker:
    """One prover node: watches a chain + order stream, proves, fulfills.

    `prover` duck-type: preflight(image, input)->cycles;
    prove(image, input)->(journal, seal, claim_digest).
    """

    def __init__(self, chain: MarketChain, prover, address: str,
                 config: BrokerConfig = BrokerConfig(),
                 storage=None, order_stream=None, clock=time.time,
                 order_db=None):
        self.chain = chain
        self.prover = prover
        self.address = address
        self.config = config
        self.storage = storage
        self.order_stream = order_stream
        self.clock = clock
        self.order_db = order_db  # optional OrderDb for restart resume
        self.orders: dict = {}  # request_id -> Order (sqlite in reference)
        if order_db is not None:
            self.orders.update(order_db.load_all())
        self._evaluate_q: queue.Queue = queue.Queue()
        self._commit_q: queue.Queue = queue.Queue()
        self._prove_q: queue.Queue = queue.Queue()
        self._submit_q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads = []
        self._last_block = 0
        self._preflight_sem = threading.Semaphore(
            config.max_concurrent_preflights)
        self._prove_sem = threading.Semaphore(config.max_concurrent_proofs)

    def _persist(self, rid):
        if self.order_db is not None:
            self.order_db.upsert(rid, self.orders[rid])

    # -- lifecycle ------------------------------------------------------
    def start(self):
        # resume in-flight orders from a previous run (SURVEY §5.4)
        for rid, order in list(self.orders.items()):
            if order.status in (OrderStatus.NEW, OrderStatus.PRICING):
                self._evaluate_q.put(rid)
            elif order.status in (OrderStatus.COMMITTED, OrderStatus.LOCKED,
                                  OrderStatus.PROVING):
                self._prove_q.put(rid)
        if self.order_stream is not None:
            self.order_stream.subscribe(
                lambda req, sig: self._ingest(req))
        for target in (self._chain_monitor, self._evaluator, self._committer,
                       self._processor, self._submitter, self._reaper):
            t = threading.Thread(target=self._supervise, args=(target,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self):
        self._stop.set()

    def _supervise(self, fn):
        """Restart-on-crash supervisor (reference ServiceRunner)."""
        while not self._stop.is_set():
            try:
                fn()
                return
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                time.sleep(0.1)

    # -- stages ---------------------------------------------------------
    def _committed_backlog(self, deadline: float) -> int:
        """Cycles already committed that must complete before `deadline`
        (the reference's backlog term in the feasibility model)."""
        total = 0
        for o in list(self.orders.values()):
            if o.status in (OrderStatus.COMMITTED, OrderStatus.LOCKED,
                            OrderStatus.PROVING) and o.cycles:
                if o.request.offer.expires_at() <= deadline:
                    total += o.cycles
        return total

    def _ingest(self, request: ProofRequest):
        rid = request.id.encoded()
        if rid not in self.orders:
            self.orders[rid] = Order(request=request)
            self._persist(rid)
            self._evaluate_q.put(rid)

    def _chain_monitor(self):
        while not self._stop.is_set():
            for ev in self.chain.events_since(self._last_block):
                self._last_block = max(self._last_block, ev.block)
                if ev.kind == "RequestSubmitted":
                    req = self.chain.requests.get(ev.data["request_id"])
                    if req is not None:
                        self._ingest(req)
            time.sleep(0.05)

    def _evaluator(self):
        """Global capacity gate + pricing (evaluator + pricer stages)."""
        while not self._stop.is_set():
            try:
                rid = self._evaluate_q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._evaluate_order(rid)

    def _evaluate_order(self, rid):
        """One order through preflight -> price floor -> deadline
        feasibility; enqueues to commit on success (synchronous; the
        evaluator thread loop drives it)."""
        order = self.orders[rid]
        order.status = OrderStatus.PRICING
        try:
            with self._preflight_sem:
                image, input_data = self._fetch_assets(order.request)
                cycles = self.prover.preflight(image, input_data)
            order.cycles = cycles
            mcycles = max(1, cycles // 1_000_000)
            price = self.chain.price_request(rid)
            priority = (order.request.id.client
                        in self.config.priority_requestors)
            floor = self.config.min_mcycle_price
            if (self.config.min_mcycle_price_usd is not None
                    and self.config.price_oracle is not None):
                # USD floor through the oracle (broker-template:30)
                floor = self.config.price_oracle.usd_to_wei(
                    self.config.min_mcycle_price_usd)
            if not priority and price < mcycles * floor:
                order.status = OrderStatus.SKIPPED
                order.error = "price below min_mcycle_price"
                self._persist(rid)
                return
            # deadline feasibility against peak_prove_khz NET of the
            # committed backlog due before this order's deadline
            # (reference order_pricer/service.rs:2300-2376: scheduled
            # work consumes capacity ahead of new commitments)
            secs_left = order.request.offer.expires_at() - self.clock()
            provable = self.config.peak_prove_khz * 1000.0 * secs_left
            backlog = self._committed_backlog(
                order.request.offer.expires_at())
            if cycles + backlog > provable:
                order.status = OrderStatus.SKIPPED
                order.error = "deadline infeasible for peak_prove_khz"
                self._persist(rid)
                return
            order.price = price
            order.status = OrderStatus.COMMITTED
            self._persist(rid)
            self._commit_q.put(rid)
        except Exception as e:  # noqa: BLE001
            order.status = OrderStatus.FAILED
            order.error = f"pricing: {e}"

    def _committer(self):
        """Commit + lock (committer + locker stages)."""
        while not self._stop.is_set():
            try:
                rid = self._commit_q.get(timeout=0.1)
            except queue.Empty:
                continue
            order = self.orders[rid]
            try:
                if self.config.lock_orders:
                    self.chain.lock_request(rid, self.address)
                    order.status = OrderStatus.LOCKED
                    self._persist(rid)
                self._prove_q.put(rid)
            except Exception as e:  # noqa: BLE001
                order.status = OrderStatus.SKIPPED
                order.error = f"lock: {e}"

    def _processor(self):
        while not self._stop.is_set():
            try:
                rid = self._prove_q.get(timeout=0.1)
            except queue.Empty:
                continue
            order = self.orders[rid]
            order.status = OrderStatus.PROVING
            try:
                with self._prove_sem:
                    image, input_data = self._fetch_assets(order.request)
                    journal, seal, claim = self.prover.prove(image, input_data)
                order.journal = journal
                self._submit_q.put((rid, journal, seal, claim))
            except Exception as e:  # noqa: BLE001
                order.status = OrderStatus.FAILED
                order.error = f"prove: {e}"

    def _submitter(self):
        if self.config.batch_fulfill:
            return self._batch_submitter()
        while not self._stop.is_set():
            try:
                rid, journal, seal, claim = self._submit_q.get(timeout=0.1)
            except queue.Empty:
                continue
            order = self.orders[rid]
            try:
                self.chain.fulfill([Fulfillment(
                    request_id=order.request.id, journal=journal,
                    claim_digest=claim, seal=seal, prover=self.address)])
                order.status = OrderStatus.FULFILLED
                self._persist(rid)
            except Exception as e:  # noqa: BLE001
                order.status = OrderStatus.FAILED
                order.error = f"submit: {e}"

    def _batch_submitter(self):
        """Aggregation path: collect fills, run the assessor GUEST over
        the batch (in-guest ECDSA + predicates), build the set root and
        land one submitRootAndFulfill (reference batcher/service.rs ->
        submitter/service.rs)."""
        from ..batcher import Assessor, Batch, BatchProcessor, \
            submit_root_and_fulfill

        assessor = Assessor()
        bp = BatchProcessor(assessor, self.address,
                            max_batch=self.config.batch_size)
        pending = []  # (rid, (req, sig, fill))
        last = self.clock()
        while not self._stop.is_set():
            try:
                rid, journal, seal, claim = self._submit_q.get(timeout=0.1)
                order = self.orders[rid]
                req = order.request
                sig = self.chain.request_sigs.get(req.id.encoded(), b"")
                fill = Fulfillment(request_id=req.id, journal=journal,
                                   claim_digest=claim, seal=seal,
                                   prover=self.address)
                pending.append((rid, (req, sig, fill)))
                last = self.clock()
            except queue.Empty:
                pass
            flush = (len(pending) >= self.config.batch_size
                     or (pending
                         and self.clock() - last
                         > self.config.batch_linger_s))
            if not flush:
                continue
            batch = Batch()
            rids = [rid for rid, _ in pending]
            try:
                for _rid, f3 in pending:
                    batch.fills.append(f3)
                batch = bp.close_batch(batch)
                root, receipt, entries = bp.submission(batch)
                submit_root_and_fulfill(self.chain, assessor, root,
                                        receipt, entries)
                for rid in rids:
                    self.orders[rid].status = OrderStatus.FULFILLED
                    self._persist(rid)
            except Exception as e:  # noqa: BLE001
                for rid in rids:
                    self.orders[rid].status = OrderStatus.FAILED
                    self.orders[rid].error = f"submit: {e}"
            pending = []

    def _reaper(self):
        """Cancel expired committed orders (reference utils/reaper.rs)."""
        while not self._stop.is_set():
            now = self.clock()
            for order in list(self.orders.values()):
                if order.status in (OrderStatus.COMMITTED, OrderStatus.LOCKED,
                                    OrderStatus.PROVING):
                    if now > order.request.offer.expires_at():
                        order.status = OrderStatus.FAILED
                        order.error = "expired before fulfillment"
            time.sleep(0.2)

    # -- helpers --------------------------------------------------------
    def _fetch_assets(self, request: ProofRequest):
        # requestor-controlled bytes: safe wire format only (never pickle)
        from ...utils import serde

        data = self.storage.download(request.image_url)
        return serde.load_image(data), request.input_data
