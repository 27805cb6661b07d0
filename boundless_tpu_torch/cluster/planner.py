"""Incremental join-tree planner (MMR-style peaks).

The port's copy of `boundless_tpu/cluster/planner.py` (plain Python).

Re-design of the reference's binary join-tree builder
(`prover/crates/taskdb/src/planner/mod.rs:91-116`, `task.rs:9-18`):
segments stream in one at a time; equal-height peaks merge into Join
nodes immediately, so joins overlap with still-running segment proofs
(SURVEY.md §2.5 P2). Keccak/coprocessor work gets a mirrored Union tree;
`finish` collapses the remaining peaks and emits the Finalize command.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Kind(enum.Enum):
    SEGMENT = "segment"  # prove + lift one segment
    JOIN = "join"  # join two recursion receipts
    KECCAK = "keccak"  # prove one coprocessor claim
    UNION = "union"  # union two coprocessor receipts
    FINALIZE = "finalize"  # wrap the root receipt


@dataclasses.dataclass(frozen=True)
class Command:
    kind: Kind
    task_id: int
    height: int
    deps: tuple  # task ids this command consumes
    payload: Optional[object] = None  # e.g. segment index


class Planner:
    """Feed segments/keccaks with enqueue_*; drain with next_task().

    Commands are emitted in dependency order: a Join appears only after
    both of its children have been emitted.
    """

    def __init__(self):
        self._next_id = 0
        self._queue = []
        self._peaks = []  # stack of (task_id, height), ascending heights
        self._keccak_peaks = []
        self._finished = False
        self.root: Optional[int] = None
        self.keccak_root: Optional[int] = None

    def _alloc(self, kind, height, deps, payload=None) -> int:
        tid = self._next_id
        self._next_id += 1
        self._queue.append(Command(kind, tid, height, tuple(deps), payload))
        return tid

    def _merge(self, peaks, join_kind):
        while len(peaks) >= 2 and peaks[-1][1] == peaks[-2][1]:
            right = peaks.pop()
            left = peaks.pop()
            tid = self._alloc(join_kind, left[1] + 1, (left[0], right[0]))
            peaks.append((tid, left[1] + 1))

    def enqueue_segment(self, segment_index) -> int:
        assert not self._finished
        tid = self._alloc(Kind.SEGMENT, 0, (), payload=segment_index)
        self._peaks.append((tid, 0))
        self._merge(self._peaks, Kind.JOIN)
        return tid

    def enqueue_keccak(self, claim_index) -> int:
        assert not self._finished
        tid = self._alloc(Kind.KECCAK, 0, (), payload=claim_index)
        self._keccak_peaks.append((tid, 0))
        self._merge(self._keccak_peaks, Kind.UNION)
        return tid

    def _collapse(self, peaks, join_kind):
        # Fold remaining peaks right-to-left regardless of height.
        while len(peaks) >= 2:
            right = peaks.pop()
            left = peaks.pop()
            h = max(left[1], right[1]) + 1
            tid = self._alloc(join_kind, h, (left[0], right[0]))
            peaks.append((tid, h))
        return peaks[0][0] if peaks else None

    def finish(self) -> int:
        """Collapse peaks; emit Finalize; returns the finalize task id."""
        assert not self._finished
        self._finished = True
        self.root = self._collapse(self._peaks, Kind.JOIN)
        self.keccak_root = self._collapse(self._keccak_peaks, Kind.UNION)
        deps = tuple(t for t in (self.root, self.keccak_root) if t is not None)
        return self._alloc(Kind.FINALIZE, 0, deps)

    def next_task(self) -> Optional[Command]:
        if self._queue:
            return self._queue.pop(0)
        return None

    def drain(self):
        out = []
        while (c := self.next_task()) is not None:
            out.append(c)
        return out
