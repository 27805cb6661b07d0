"""Requestor SDK: Client + layered RequestBuilder.

The port's copy of `boundless_tpu/market/client.py`.

Re-design of `crates/boundless-market/src/client.rs` (`Client` :101,
`submit_onchain` :1269, `submit_offchain` :1433) and the typed-layer
`RequestBuilder` (`src/request_builder/mod.rs:107,219`): StorageLayer ->
PreflightLayer -> RequirementsLayer -> OfferLayer -> RequestIdLayer ->
Finalizer. Each layer is a small object with `apply(ctx)`; users can
override any layer, mirroring the reference's composability.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Optional

from .chain import MarketChain
from .types import (Offer, Predicate, ProofRequest, RequestId, Requirements,
                    sign_request)
from ..zkvm.executor import Executor, MemoryImage


@dataclasses.dataclass
class BuilderCtx:
    """Mutable context threaded through the request-builder layers."""

    image: MemoryImage
    input_data: bytes
    image_url: Optional[str] = None
    image_id: Optional[str] = None
    cycles: Optional[int] = None
    journal: Optional[bytes] = None
    requirements: Optional[Requirements] = None
    offer: Optional[Offer] = None
    request_id: Optional[RequestId] = None


class StorageLayer:
    """Upload the guest image to a storage provider -> image_url."""

    def __init__(self, provider):
        self.provider = provider

    def apply(self, ctx: BuilderCtx):
        from ..utils import serde

        ctx.image_id = ctx.image.image_id().hex()
        ctx.image_url = self.provider.upload(
            f"elfs/{ctx.image_id}", serde.dump_image(ctx.image))


class PreflightLayer:
    """Execute-only dry run for the cycle count + journal
    (reference preflight_layer.rs:37). Uses the native C++ interpreter
    (~100x the Python executor) with a Python fallback."""

    def apply(self, ctx: BuilderCtx):
        from ..zkvm.executor import GuestFault, fast_execute

        try:
            cycles, _, journal = fast_execute(ctx.image, ctx.input_data)
            ctx.cycles = cycles
            ctx.journal = journal
            return
        except GuestFault:
            raise
        except Exception:  # lib build/load issues: fall back to Python
            pass
        res = Executor(ctx.image, ctx.input_data).run()
        ctx.cycles = res.total_cycles
        ctx.journal = res.journal


class RequirementsLayer:
    def __init__(self, predicate: Optional[Predicate] = None,
                 selector: Optional[str] = None):
        self.predicate = predicate
        self.selector = selector

    def apply(self, ctx: BuilderCtx):
        pred = self.predicate or Predicate.digest_match(ctx.journal)
        ctx.requirements = Requirements(image_id=ctx.image_id,
                                        predicate=pred,
                                        selector=self.selector)


class OfferLayer:
    """Price the auction from the preflight cycle count
    (reference offer_layer.rs:338)."""

    def __init__(self, mcycle_price: int = 1000, ramp: float = 30.0,
                 lock_timeout: float = 120.0, timeout: float = 600.0,
                 collateral: int = 10_000, clock=time.time):
        self.mcycle_price = mcycle_price
        self.ramp = ramp
        self.lock_timeout = lock_timeout
        self.timeout = timeout
        self.collateral = collateral
        self.clock = clock

    def apply(self, ctx: BuilderCtx):
        mcycles = max(1, ctx.cycles // 1_000_000 if ctx.cycles else 1)
        base = mcycles * self.mcycle_price
        ctx.offer = Offer(min_price=base, max_price=base * 4,
                          bidding_start=self.clock(),
                          ramp_up_period=self.ramp,
                          lock_timeout=self.lock_timeout,
                          timeout=self.timeout,
                          lock_collateral=self.collateral)


class RequestIdLayer:
    def __init__(self, client_addr: str, counter):
        self.client_addr = client_addr
        self.counter = counter

    def apply(self, ctx: BuilderCtx):
        ctx.request_id = RequestId(self.client_addr, next(self.counter))


class LocalStorageProvider:
    """File-backed storage provider (reference providers: S3/GCS/IPFS/file —
    src/storage/providers/)."""

    def __init__(self, store):
        self.store = store  # SharedFs

    def upload(self, key: str, data: bytes) -> str:
        bucket, _, name = key.partition("/")
        self.store.put_bytes(bucket, name, data)
        return f"local://{key}"

    def download(self, url: str) -> bytes:
        assert url.startswith("local://")
        bucket, _, name = url[len("local://"):].partition("/")
        return self.store.get_bytes(bucket, name)


class Client:
    """Requestor client (reference Client/ClientBuilder)."""

    def __init__(self, chain: MarketChain, wallet,
                 storage_provider=None, order_stream=None, clock=time.time):
        """`wallet`: a crypto.Wallet — the client address is derived from
        its key (EIP-712 + ECDSA recovery; no shared secrets)."""
        self.chain = chain
        self.wallet = wallet
        self.address = wallet.address
        self.storage = storage_provider
        self.order_stream = order_stream
        self.clock = clock
        self._counter = itertools.count(int(clock() * 1000) % 10_000_000)

    # -- request building ----------------------------------------------
    def build_request(self, image: MemoryImage, input_data: bytes,
                      layers=None) -> ProofRequest:
        ctx = BuilderCtx(image=image, input_data=input_data)
        layers = layers or [
            StorageLayer(self.storage),
            PreflightLayer(),
            RequirementsLayer(),
            OfferLayer(clock=self.clock),
            RequestIdLayer(self.address, self._counter),
        ]
        for layer in layers:
            layer.apply(ctx)
        return ProofRequest(id=ctx.request_id,
                            requirements=ctx.requirements,
                            image_url=ctx.image_url,
                            input_data=input_data, offer=ctx.offer)

    # -- submission -----------------------------------------------------
    def submit_onchain(self, request: ProofRequest) -> str:
        sig = sign_request(request, self.wallet)
        self.chain.submit_request(request, sig)
        return request.id.encoded()

    def submit_offchain(self, request: ProofRequest) -> str:
        assert self.order_stream is not None, "no order-stream configured"
        sig = sign_request(request, self.wallet)
        self.order_stream.submit(request, sig)
        return request.id.encoded()

    # -- polling --------------------------------------------------------
    def wait_for_fulfillment(self, request_id: str, timeout: float = 300.0,
                             poll: float = 0.1):
        deadline = self.clock() + timeout
        while self.clock() < deadline:
            status = self.chain.request_status(request_id)
            if status == "fulfilled":
                fill = self.chain.get_fulfillment(request_id)
                return fill.journal, fill.seal
            if status in ("expired", "slashed"):
                raise TimeoutError(f"request {request_id} {status}")
            time.sleep(poll)
        raise TimeoutError(f"request {request_id} not fulfilled in time")
