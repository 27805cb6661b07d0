"""Device mesh and data-parallel segment proving.

The port's counterpart of `boundless_tpu/parallel/mesh.py`. The reference
design has two axes:

  dp — segments: the throughput axis; independent proofs run one group
       each. Across hosts this axis is the cluster's task plane (taskdb +
       hot store), so dp inside a host composes with worker fan-out.
  tp — trace columns inside one proof: the LDE/NTT/Merkle work of
       different columns is independent until the DEEP combination. The
       JAX package leaves this split to XLA's GSPMD partitioner; the port
       has no counterpart yet (ROADMAP.md, Queue 1), so
       `shard_batched_prover` refuses a mesh with tp > 1.

The port's data-parallel prover runs segment i on dp group i % dp, one
host thread per group, each proving its segments one after the other with
`stark.prove` on its group's device. A segment's proof is the one
`stark.prove` gives for it alone: the prover is deterministic given the
trace (the blinding sits in the witness).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch


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


def shard_batched_prover(air, po2, ps, mesh: Mesh):
    """Returns (fn, shard_fn): fn(data_b, pub_b, ctrl) proves a batch of
    segments under the mesh and returns their SegmentProofs in order;
    shard_fn places segment i's (data, publics) on dp group i % dp ahead
    of time (fn moves whatever is not placed yet, and the shared ctrl to
    each group). data_b: (B, N, C) tensor or B (N, C) tensors; pub_b: B
    publics, or one batched along a leading axis; ctrl: the control trace
    every segment shares (or None)."""
    from ..prover import stark

    dp, tp = mesh.devices.shape
    if tp > 1:
        raise NotImplementedError(
            f"column sharding (tp = {tp}) is not ported: the port proves "
            f"each segment on one device (ROADMAP.md, Queue 1); build the "
            f"mesh with tp = 1")
    groups = [mesh.devices[g, 0] for g in range(dp)]

    def shard_fn(data_b, pub_b, ctrl):
        count = len(data_b)
        pubs = _unbatch(pub_b, count)
        return ([data_b[i].to(groups[i % dp]) for i in range(count)],
                [_to(pubs[i], groups[i % dp]) for i in range(count)], ctrl)

    def fn(data_b, pub_b, ctrl):
        data, pubs, _ = shard_fn(data_b, pub_b, ctrl)  # no-op once placed
        ctrls = [None if ctrl is None else ctrl.to(d) for d in groups]
        proofs = [None] * len(data)
        errors = []

        def run(g):
            dev = groups[g]
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
