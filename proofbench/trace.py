"""The traced run's instruments, installed from the benchmark's own files.

Spans and launch records wrap the port's functions at run time (nothing
of the port is edited) and come off when the window closes:

* a span records the host clock around a call (and, with `sync`, waits
  for the card before it stops), on every thread; `inside` keeps only the
  calls made while another span is open on the same thread;
* a launch record counts, from a kernel entry point's arguments, the
  instructions and bytes of each launch on the card (`roofline.py`).

`torch.profiler` (CUDA activity alone) traces the window: the device's
busy seconds are the union of its operations' intervals, the idle gaps
are named by the spans open on the host at their middle (the method of
the port's `tools/profile_torch.py`, with intervals in place of summed
kernel times).

A metric file (`metrics/<name>.py`) declares what it needs:

    SPANS = [(module, "attr" or "Class.attr", span name, {options})]
    LAUNCHES = [(module, "attr", counter)]  # counter(*args, **kw) ->
                                            # (instructions, bytes) or None
    def read(trace) -> value or None
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import threading
import time
from typing import Dict, List, Optional, Tuple

# spans that name the host's work in the idle gaps, whichever metrics
# a cell reads
LABEL_SPANS = [
    ("boundless_tpu_torch.zkvm.executor", "Executor.run", "execute", {}),
    ("boundless_tpu_torch.zkvm.prove", "_gen_witness", "witness", {}),
    ("boundless_tpu_torch.zkvm.prove", "prove_segment", "prove_segment", {}),
    ("boundless_tpu_torch.core.field", "fp", "field.fp", {}),
    ("boundless_tpu_torch.prover.stark", "prove", "stark.prove", {}),
    ("boundless_tpu_torch.recursion.succinct", "SuccinctSystem.lift",
     "lift", {}),
    ("boundless_tpu_torch.recursion.succinct", "SuccinctSystem.join",
     "join", {}),
    ("boundless_tpu_torch.recursion.air", "data_trace", "native_eval", {}),
    ("boundless_tpu_torch.cluster.api", "BentoClient.wait", "client.wait",
     {}),
]
TOP = 10


@dataclasses.dataclass
class Trace:
    """What the readers read."""

    spans: Dict[str, List[float]]  # span name -> seconds of each call
    launches: Dict[str, List[Tuple[float, float]]]  # metric -> (instr, B)
    kernels: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    registry: Dict[tuple, Tuple[float, int]]  # (metric, labels) -> delta
    busy_s: float
    window_s: float

    def kernel_seconds(self, parts) -> Tuple[float, int]:
        """Device seconds and count of the kernels whose names hold any of
        `parts`."""
        hits = [e - s for n, s, e in self.kernels
                if any(p in n for p in parts)]
        return sum(hits) / 1e9, len(hits)


@dataclasses.dataclass
class LayerResult:
    values: Dict[str, Optional[float]]
    busy_s: float
    window_s: float
    breakdown: dict


def _owner(module: str, attr: str):
    obj = importlib.import_module(module)
    *path, name = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, name


def _registry():
    from boundless_tpu_torch.cluster import metrics as M

    with M.REGISTRY._lock:
        items = list(M.REGISTRY._metrics.items())
    out = {}
    for key, m in items:
        if hasattr(m, "_sum"):
            out[key] = (m._sum, m._n)
        else:
            out[key] = (m.value, 0)
    return out


class Recorder:
    def __init__(self, metric_modules, on_card: bool):
        self.mods = metric_modules
        self.on_card = on_card
        self.spans: Dict[str, List[float]] = collections.defaultdict(list)
        self.timeline: List[Tuple[str, int, int]] = []
        self.launches: Dict[str, list] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._undo = []
        self._prof = None
        specs = {}
        for spec in LABEL_SPANS:
            specs[spec[2]] = spec
        for m in metric_modules:
            for spec in getattr(m, "SPANS", []):
                specs[spec[2]] = spec
        self.span_specs = list(specs.values())
        self.launch_specs = [(m.NAME, spec) for m in metric_modules
                             for spec in getattr(m, "LAUNCHES", [])]

    # -- wrappers ------------------------------------------------------

    def _open(self) -> collections.Counter:
        if not hasattr(self._local, "open"):
            self._local.open = collections.Counter()
        return self._local.open

    def _wrap_span(self, module, attr, name, opts):
        owner, key = _owner(module, attr)
        fn = getattr(owner, key)
        inside, sync = opts.get("inside"), opts.get("sync", False)
        rec = self

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            open_ = rec._open()
            if inside is not None and not open_[inside]:
                return fn(*args, **kwargs)
            t0, w0 = time.perf_counter(), time.time_ns()
            open_[name] += 1
            try:
                out = fn(*args, **kwargs)
                if sync and rec.on_card:
                    import torch

                    torch.cuda.synchronize()
            finally:
                open_[name] -= 1
            dt, w1 = time.perf_counter() - t0, time.time_ns()
            with rec._lock:
                rec.spans[name].append(dt)
                rec.timeline.append((name, w0, w1))
            return out

        self._undo.append((owner, key, fn))
        setattr(owner, key, spanned)

    def _wrap_launch(self, metric, module, attr, counter):
        owner, key = _owner(module, attr)
        fn = getattr(owner, key)
        rec = self

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            work = counter(*args, **kwargs)
            if work is not None:
                with rec._lock:
                    rec.launches[metric].append(work)
            return fn(*args, **kwargs)

        self._undo.append((owner, key, fn))
        setattr(owner, key, counted)

    # -- the window ----------------------------------------------------

    def start(self):
        for module, attr, name, opts in self.span_specs:
            self._wrap_span(module, attr, name, opts)
        for metric, (module, attr, counter) in self.launch_specs:
            self._wrap_launch(metric, module, attr, counter)
        self._registry0 = _registry()
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._w0 = time.time_ns()

    def stop(self) -> LayerResult:
        w1 = time.time_ns()
        kernels = []
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            kernels = _device_events(self._prof, self._w0, w1)
        for owner, key, fn in reversed(self._undo):
            setattr(owner, key, fn)
        self._undo = []
        reg1 = _registry()
        delta = {k: (v[0] - self._registry0.get(k, (0, 0))[0],
                     v[1] - self._registry0.get(k, (0, 0))[1])
                 for k, v in reg1.items()}
        intervals = _union([(s, e) for _, s, e in kernels])
        busy = sum(e - s for s, e in intervals) / 1e9
        window = (w1 - self._w0) / 1e9
        trace = Trace(dict(self.spans), dict(self.launches), kernels, delta,
                      busy, window)
        values = {m.NAME: m.read(trace) for m in self.mods}
        return LayerResult(values, busy, window,
                           self._breakdown(kernels, intervals, w1))

    def _breakdown(self, kernels, intervals, w1) -> dict:
        by_name = collections.Counter()
        for n, s, e in kernels:
            by_name[n] += (e - s) / 1e9
        gaps, prev = [], self._w0
        for s, e in intervals + [(w1, w1)]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        named = collections.Counter()
        pieces = _host_pieces(self.timeline, self._w0, w1)
        k = 0
        for s, e in gaps:  # both lists in time order
            while pieces[k][1] <= s:
                k += 1
            j = k
            while j < len(pieces) and pieces[j][0] < e:
                a, b, label = pieces[j]
                named[label] += (min(b, e) - max(a, s)) / 1e9
                j += 1
        return dict(
            device_ops=[[n, t] for n, t in by_name.most_common(TOP)],
            idle_gaps=[[n, t] for n, t in named.most_common(TOP)])


def _host_pieces(timeline, w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """The window cut where a span opens or closes: (start, end, the
    names of the spans open there, joined by "+"), in time order."""
    edges = sorted([(a, 1, n) for n, a, _ in timeline]
                   + [(b, -1, n) for n, _, b in timeline])
    open_ = collections.Counter()
    pieces, t = [], w0
    for when, step, name in edges + [(w1, 0, "")]:
        when = min(max(when, w0), w1)
        if when > t:
            label = "+".join(sorted(n for n, c in open_.items() if c)) \
                or "outside every span"
            pieces.append((t, when, label))
            t = when
        open_[name] += step
    return pieces or [(w0, w1, "outside every span")]


def _device_events(prof, w0: int, w1: int) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every operation on the card in the
    window [w0, w1] of host epoch nanoseconds (the profiler's own clock).
    A trace whose clock does not meet the window's cannot be read: the
    traced run fails rather than guess an alignment."""
    from torch.autograd import DeviceType

    raw = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    if raw and not any(s < w1 and e > w0 for _, s, e in raw):
        raise RuntimeError(
            f"trace: no device operation meets the window [{w0}, {w1}] ns "
            f"(device events span {min(s for _, s, _ in raw)}.."
            f"{max(e for _, _, e in raw)} ns)")
    out = []
    for name, s, e in raw:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            out.append((name, s, e))
    return out


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
