"""Device mesh, data-parallel segment proving and column sharding.

The port's counterpart of `boundless_tpu/parallel/mesh.py`. The reference
design has two axes:

  dp — segments: the throughput axis; independent proofs run one group
       each. Across hosts this axis is the cluster's task plane (taskdb +
       hot store), so dp inside a host composes with worker fan-out.
  tp — trace columns inside one proof: the LDE/NTT/Merkle work of
       different columns is independent until the DEEP combination. The
       JAX package leaves this split to XLA's GSPMD partitioner
       (`P("dp", None, "tp")` for the data, `P(None, "tp")` for ctrl);
       the port splits by hand.

`shard_batched_prover` runs segment i on dp group i % dp, one host thread
per group, each proving its segments one after the other with
`stark.prove`. Within a group `mesh.devices[g, :]` the ctrl and data
traces go in as `ShardedTrace`s: their columns cut by `column_split` into
contiguous blocks, one on each of the group's devices (a group may name
one device twice). Each shard interpolates, extends and commits its own
columns (the leaf hash chained through the shards in column order, a
(N, 24) sponge state crossing each boundary), evaluates its own DEEP taps
and its part of the DEEP combination's weighted sums; the group's first
device, the leader, gathers the 4N evaluations and runs the transcript,
the accumulator, the quotient, the check commit, FRI and the openings
(`prover/stark.py`). A segment's proof is word for word the one
`stark.prove` gives for its whole trace on one device: the prover is
deterministic given the trace (the blinding sits in the witness), every
split falls on a sponge block boundary, and the weighted sums are exact.

The column-block type, `column_split`, `move` and its `MOVED_BYTES`
count live below the prover, in `core/sharded.py`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from ..core import sharded
from ..prover import stark


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of torch devices."""

    devices: np.ndarray  # (dp, tp) object array of torch.device
    axis_names: tuple = ("dp", "tp")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices=None, dp=None, devices=None) -> Mesh:
    """Create a (dp, tp) mesh over the first n devices: every CUDA device
    unless `devices` names others (several CPU devices in a test)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if not n or n > len(devices):
        raise ValueError(f"a mesh of {n} devices over {len(devices)} "
                         f"available (no CUDA device: pass devices=)")
    if dp is None:
        dp = 1
        for cand in (8, 4, 2):
            if n % cand == 0 and cand <= n:
                dp = cand
                break
    tp = n // dp
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices[:dp * tp]):
        grid[i // tp, i % tp] = d
    return Mesh(grid)


def _unbatch(pub_b, count: int) -> list:
    """Per-segment publics from a list, a tensor with a leading batch axis
    or a dataclass of such tensors."""
    if isinstance(pub_b, (list, tuple)):
        return list(pub_b)
    if dataclasses.is_dataclass(pub_b):
        return [dataclasses.replace(pub_b, **{
            f.name: getattr(pub_b, f.name)[i]
            for f in dataclasses.fields(pub_b)}) for i in range(count)]
    return [pub_b[i] for i in range(count)]


def _to(pub, device):
    if dataclasses.is_dataclass(pub):
        return dataclasses.replace(pub, **{
            f.name: getattr(pub, f.name).to(device)
            for f in dataclasses.fields(pub)})
    return pub.to(device)


def _shard(trace, group):
    """`trace` as a ShardedTrace over `group` (left as it is once it is
    one)."""
    return trace if isinstance(trace, sharded.ShardedTrace) else \
        sharded.ShardedTrace.of(trace, group)


def shard_batched_prover(air, po2, ps, mesh: Mesh):
    """Returns (fn, shard_fn): fn(data_b, pub_b, ctrl) proves a batch of
    segments under the mesh and returns their SegmentProofs in order;
    shard_fn places segment i's data as a ShardedTrace over dp group
    i % dp and its publics on that group's leader ahead of time (fn
    places whatever is not placed yet, and shards the shared ctrl over
    each group). data_b: (B, N, C) tensor or B (N, C) tensors; pub_b: B
    publics, or one batched along a leading axis; ctrl: the control trace
    every segment shares (None: the AIR's own, built on each leader)."""
    dp, _ = mesh.devices.shape
    groups = [list(mesh.devices[g]) for g in range(dp)]
    for group in groups:
        sharded.check_group(group)

    def shard_fn(data_b, pub_b, ctrl):
        count = len(data_b)
        pubs = _unbatch(pub_b, count)
        return ([_shard(data_b[i], groups[i % dp]) for i in range(count)],
                [_to(pubs[i], groups[i % dp][0]) for i in range(count)], ctrl)

    def fn(data_b, pub_b, ctrl):
        data, pubs, _ = shard_fn(data_b, pub_b, ctrl)  # no-op once placed
        if ctrl is None and air.ctrl_cols and not getattr(
                air, "ctrl_dynamic", False):
            ctrl = air.ctrl_trace(1 << po2, groups[0][0])
        ctrls = [None if ctrl is None else _shard(ctrl, group)
                 for group in groups]
        proofs = [None] * len(data)
        errors = []

        def run(g):
            dev = groups[g][0]
            on = (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext())
            try:
                with on:
                    for i in range(g, len(data), dp):
                        proofs[i] = stark.prove(air, data[i], pubs[i], po2,
                                                ps, ctrls[g])
            except Exception as e:  # noqa: BLE001 (re-raised below)
                errors.append(e)

        threads = [threading.Thread(target=run, args=(g,),
                                    name=f"dp{g}") for g in range(dp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return proofs

    return fn, shard_fn
