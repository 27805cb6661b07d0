"""Verifier router: seal-selector -> verifier-class dispatch.

The port's copy of `boundless_tpu/market/router.py`.

Re-design of the reference's `BoundlessRouter` + `RiscZeroVerifierRouter`
(`contracts/src/router/BoundlessRouter.sol`, `crates/boundless-backend/src/
router.rs:36-230`): fulfillment seals carry a 4-byte selector; the router
maps selectors to verifier classes (stark set-inclusion, groth16,
blake3-groth16, dev) so markets and backends stay seal-agnostic.
"""

from __future__ import annotations

from typing import Callable, Dict

from ..groth16.wrap import (SELECTOR_BLAKE3_GROTH16, SELECTOR_DEV_MODE,
                            SELECTOR_GROTH16, Groth16Receipt)
from ..groth16 import wrap as g16


class RouterError(Exception):
    pass


class VerifierRouter:
    def __init__(self):
        self._classes: Dict[str, Callable] = {}

    def register(self, selector: str, verify_fn: Callable):
        """verify_fn(seal, fill, request) -> bool."""
        self._classes[selector] = verify_fn

    def selectors(self):
        return sorted(self._classes)

    def verify(self, selector: str, seal, fill, request) -> bool:
        fn = self._classes.get(selector)
        if fn is None:
            raise RouterError(f"no verifier for selector {selector}")
        return fn(seal, fill, request)

    def market_verifier(self, default_selector: str):
        """Adapter matching MarketChain's verifier callback: dispatches on
        the request's required selector (or the default)."""

        def _verify(fill, request):
            sel = request.requirements.selector or default_selector
            try:
                return self.verify(sel, fill.seal, fill, request)
            except RouterError:
                return False

        return _verify


def default_router(ps=None, device="cuda") -> VerifierRouter:
    """Router with the built-in seal classes registered. A session STARK
    seal is verified on `device` (the card unless the caller asks for the
    CPU): a stored receipt holds host tensors, so the seal moves there
    first. A CUDA device without a card raises here."""
    from ..recursion.receipt import SessionReceipt
    from ..utils import serde
    from ..zkvm.prove import _device

    dev = _device(device)
    router = VerifierRouter()

    def stark_verify(seal, fill, request):
        return (isinstance(seal, SessionReceipt)
                and seal.journal == fill.journal
                and serde.to_device(seal, dev).verify(ps=ps))

    def groth16_verify(seal, fill, request):
        return (isinstance(seal, Groth16Receipt)
                and seal.journal == fill.journal
                and g16.verify(seal))

    SELECTOR_STARK = "0x00000000"  # session STARK (aggregation receipt)
    router.register(SELECTOR_STARK, stark_verify)
    router.register(SELECTOR_GROTH16, groth16_verify)
    router.register(SELECTOR_BLAKE3_GROTH16, groth16_verify)

    def dev_verify(seal, fill, request):
        return (isinstance(seal, dict) and seal.get("dev_mode")
                and seal.get("journal") == fill.journal)

    router.register(SELECTOR_DEV_MODE, dev_verify)
    return router
