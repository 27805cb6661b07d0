"""A trace group's columns cut into blocks over a tp group's devices.

The prover's data type for the mesh's column (tp) axis
(`parallel/mesh.py`): a `ShardedTrace` holds an (N, C) trace as
contiguous column blocks cut by `column_split`, block k on the group's
device k, the first device the leader. `prover/stark.py` interpolates,
extends and commits each block on its own device, and `core/merkle.py`
chains the leaf hash through the blocks in column order (every block but
the last a multiple of the sponge's rate wide), so a proof is word for
word the one of the whole trace on one device.

`MOVED_BYTES` counts the bytes a proof moves between the positions of its
group (to and from the leader, and the sponge state from shard to shard),
whether or not the two positions name the same card; placing the traces
(`mesh.shard_batched_prover`'s `shard_fn`) is not counted.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from .poseidon2 import RATE  # every shard but the last is a multiple

MOVED_BYTES = 0
_MOVED_LOCK = threading.Lock()  # dp groups prove from threads


def column_split(c: int, tp: int) -> list:
    """[(start, stop), ...]: C columns cut into at most tp contiguous
    blocks in column order, all of one width that is a multiple of RATE
    but the last (narrower), the width as small as that allows; no block
    is empty (C = 392, tp = 2: 208 | 184; C = 40, tp = 3: 16 | 16 | 8)."""
    if tp < 1:
        raise ValueError(f"tp must be at least 1, got {tp}")
    width = RATE * -(-c // (RATE * tp))
    return [(a, min(a + width, c)) for a in range(0, c, width)]


def check_group(devices) -> None:
    """Raise ValueError unless the devices are all of one type: a group
    that mixed the CPU with a card would prove part of a segment on the
    CPU."""
    kinds = {torch.device(d).type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"a tp group mixes device types {sorted(kinds)}: "
                         f"{[str(d) for d in devices]}")


@dataclasses.dataclass(frozen=True)
class ShardedTrace:
    """A trace group's (N, C) columns as contiguous blocks in column order,
    block k on the group's device k; blocks[0]'s device is the leader."""

    blocks: tuple

    def __post_init__(self):
        check_group(b.device for b in self.blocks)
        if not self.blocks or len({b.shape[0] for b in self.blocks}) != 1:
            raise ValueError("a sharded trace needs blocks of equal rows")
        if any(b.shape[1] % RATE for b in self.blocks[:-1]):
            raise ValueError(f"every block but the last must be a multiple "
                             f"of {RATE} columns: "
                             f"{[b.shape[1] for b in self.blocks]}")

    @classmethod
    def of(cls, trace, devices) -> "ShardedTrace":
        """Cut `trace` by `column_split` over `devices` (empty blocks
        dropped: their devices get no shard)."""
        devices = [torch.device(d) for d in devices]
        return cls(tuple(trace[:, a:b].to(devices[k]).contiguous()
                         for k, (a, b) in enumerate(
                             column_split(trace.shape[1], len(devices)))))

    @property
    def leader(self) -> torch.device:
        return self.blocks[0].device

    def gather(self):
        """The whole (N, C) trace on the leader."""
        if len(self.blocks) == 1:
            return self.blocks[0]
        return torch.cat([self.blocks[0]] + [move(b, self.leader)
                                             for b in self.blocks[1:]], 1)


def move(x, device):
    """x on `device`, counted in MOVED_BYTES: a copy between two positions
    of a tp group (no copy when both name one device)."""
    global MOVED_BYTES
    with _MOVED_LOCK:
        MOVED_BYTES += x.numel() * x.element_size()
    return x.to(device, non_blocking=True)
