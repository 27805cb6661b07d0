"""Per-chain deployment registry.

The port's copy of `boundless_tpu/market/deployments.py`.

Re-design of the SDK `Deployment` registry
(`crates/boundless-market/src/deployments.rs:126-180`): named deployments
carrying market/verifier/collateral endpoints, with overrides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Deployment:
    name: str
    chain_id: int
    market_address: str
    verifier_router: str
    collateral_token: str
    order_stream_url: Optional[str] = None
    indexer_url: Optional[str] = None


BUILTIN: Dict[str, Deployment] = {
    "local": Deployment(
        name="local", chain_id=31337,
        market_address="market:local",
        verifier_router="router:local",
        collateral_token="zkc:local",
        order_stream_url="inproc://order-stream",
        indexer_url="inproc://indexer"),
    "testnet": Deployment(
        name="testnet", chain_id=11155111,
        market_address="market:testnet",
        verifier_router="router:testnet",
        collateral_token="zkc:testnet"),
}


def get(name: str, **overrides) -> Deployment:
    base = BUILTIN[name]
    return dataclasses.replace(base, **overrides) if overrides else base
