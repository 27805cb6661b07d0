"""The port's tracer: spans at its layer boundaries, on the clock of the
profiler's device events.

`span(name, sync=False, device=None, **attrs)` is a context manager. While
tracing is off (the default) it returns one shared null context after a
flag check: nothing is recorded and nothing waits for the card. After
`enable()`, each span records its name, its own id, its parent's id and
its root's id (spans nest per thread; a span opened where none is open is
a root, the request: a segment proof, a cluster task with its `job` and
`task`), the thread, its attributes, and `time.time_ns()` at open and
close. That is the host clock `torch.profiler` gives the card's events,
so spans and the device trace share one timeline. `sync=True` waits for
`device` (the current CUDA device when None, if CUDA is in use) before the
span closes, and only while tracing is on.

The newest `MAX_RECORDS` closed spans are kept in memory (`records()`,
`export_chrome(path)` as Chrome trace events), and each closed span adds
its seconds to `cluster/metrics.REGISTRY.histogram("span_seconds",
span=name)`: the registry the cluster's `/metrics` exposes.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

from ..cluster import metrics as M

MAX_RECORDS = 1 << 16

_NULL = contextlib.nullcontext()
_on = False
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


def enable():
    """Record every span opened from now on, on every thread."""
    global _on
    _on = True


def disable():
    global _on
    _on = False


def span(name: str, sync: bool = False, device=None, **attrs):
    """A span named `name` around the `with` block (see the module)."""
    if not _on:
        return _NULL
    return _Span(name, sync, device, attrs)


def records() -> list:
    """The kept spans, oldest first: dicts of `name`, `id`, `parent`,
    `root`, `thread`, `t0_ns`, `t1_ns` and `attrs`."""
    return list(_records)


def export_chrome(path: str):
    """The kept spans as Chrome trace events (`ph` "X", microseconds on
    the `time.time_ns()` clock), one JSON object at `path`."""
    pid = os.getpid()
    events = [dict(name=r["name"], ph="X", ts=r["t0_ns"] / 1e3,
                   dur=(r["t1_ns"] - r["t0_ns"]) / 1e3, pid=pid,
                   tid=r["thread"],
                   args=dict(r["attrs"], id=r["id"], parent=r["parent"],
                             root=r["root"]))
              for r in records()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f, default=str)


def _synchronize(device):
    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    __slots__ = ("name", "sync", "device", "attrs", "id", "parent", "root",
                 "t0")

    def __init__(self, name, sync, device, attrs):
        self.name, self.sync, self.device, self.attrs = (name, sync, device,
                                                         attrs)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer else None
        self.root = outer.root if outer else self.id
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if self.sync and exc_type is None:
                _synchronize(self.device)
        finally:
            t1 = time.time_ns()
            _local.stack.pop()
            _records.append(dict(
                name=self.name, id=self.id, parent=self.parent,
                root=self.root, thread=threading.get_ident(), t0_ns=self.t0,
                t1_ns=t1, attrs=self.attrs))
            M.REGISTRY.histogram(M.SPAN_SECONDS, span=self.name).observe(
                (t1 - self.t0) / 1e9)
        return False
