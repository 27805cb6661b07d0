"""The benchmark's driver: one cell, one seed, one measured window.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name `BENCHMARK.json` gives:

* `configs/<config>.json`: the deployment (segment size, proof systems,
  the program's words, the cluster's pools) and `path`, the name of the
  driver in `paths/<path>.py` that runs one job of it on the port;
* `traffic/<traffic>.json`: the parameters the one generator
  (`traffic.py`) reads;
* `metrics/<metric>.py`: a per-layer reader (`read(trace)`), with the
  spans and kernel launches it needs recorded in the traced run.

A run: set-up (the path's own, then one warm-up job), a closed loop of
jobs for `--seconds` (no job starts after that; the one in flight
finishes), then the reference's judgement of a sample of the jobs drawn
from the seed, once the port's state is freed. The last line on standard
output is the result, the last lines on standard error the compared
numbers beside their limits.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from . import traffic as T

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = float(1 << 30)
# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "boundless_tpu")
# jobs of a run that the reference judges (the last to finish always in)
SAMPLE_JOBS = 3


class JobFailed(Exception):
    pass


@dataclasses.dataclass
class Done:
    """One job completed: its cycles, its end on the host clock and what
    the port returned (for the reference's judgement)."""

    index: int
    cycles: int
    t_end: float
    output: dict


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A file of the benchmark as a module of its own (names may hold
    characters that an import statement does not take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(workload: str, bench: Optional[dict] = None,
            root: str = ROOT) -> Cell:
    """The cell `workload` with its configuration, traffic and metrics."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load_json(os.path.join(root, cfg["file"]))
    traffic = _load_json(os.path.join(root, "proofbench", "traffic",
                                      f"{w['traffic']}.json"))
    T.check_arrivals(traffic)

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in reported]
    return Cell(w["name"], int(w["chips"]), config, traffic, e2e, layer)


def metric_module(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "proofbench", "metrics",
                                    f"{name}.py"), f"proofbench_metric_{name}")


def path_module(config: dict, root: str = ROOT):
    name = config["path"]
    return load_module(os.path.join(root, "proofbench", "paths",
                                    f"{name}.py"), f"proofbench_path_{name}")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(modules)}
                  & set(FORBIDDEN))


def _written_bytes() -> Optional[int]:
    """Bytes this process has written to storage so far, where the
    kernel reports it."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def _sample(n_done: int, k: int, seed: int) -> List[int]:
    """k of the n_done jobs, drawn from the seed; the largest job index
    (the last to finish) is always among them."""
    if n_done <= k:
        return list(range(n_done))
    rng = np.random.default_rng([seed, 0x5A17])
    rest = rng.choice(n_done - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n_done - 1]


def measure(cell: Cell, seed: int, seconds: float, trace: bool,
            device, t_start: float,
            path_options: Optional[dict] = None) -> dict:
    """Set up, warm up, run the window and judge; returns the result line
    as a dict (the compared numbers under "checks", its last key)."""
    import torch

    from . import trace as TR

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)  # the CUDA context
    t_cuda = time.perf_counter()
    path = path_module(cell.config).Path(cell.config, device,
                                         **(path_options or {}))
    t_path = time.perf_counter()
    gen = T.jobs(cell.traffic, cell.config, seed)
    path.run_job(T.warmup_job(cell.traffic, cell.config))
    if on_card:
        torch.cuda.synchronize()
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start

    recorder = None
    if trace:
        recorder = TR.Recorder([metric_module(m["name"])
                                for m in cell.per_layer], on_card)
        recorder.start()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    done: List[Done] = []
    failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        job = next(gen)
        try:
            out = path.run_job(job)
        except Exception:  # noqa: BLE001 -- a failed job is counted
            failed += 1
            print(f"job {job.index} failed:\n{traceback.format_exc()}",
                  file=sys.stderr)
            continue
        done.append(Done(job.index, out["cycles"], time.perf_counter(), out))
    t_last = max([d.t_end for d in done], default=time.perf_counter())
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    layer = recorder.stop() if recorder else None

    result = dict(correct=False, attempted=len(done) + failed, failed=failed)
    metrics: Dict[str, dict] = {}
    cycles = sum(d.cycles for d in done)
    values = {"effective_khz": cycles / (t_last - t0) / 1000.0
              if done else None,
              "peak_gib": peak / GIB, "setup_s": setup_s}
    if not trace:
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    result["metrics"] = metrics
    result["device"] = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(0) if on_card else "cpu",
        count=cell.chips, memory_peak_bytes=int(peak))
    ends = [t0] + [d.t_end for d in done]
    result["jobs"] = dict(completed=len(done), cycles=cycles,
                          window_s=t_last - t0,
                          job_s=[b - a for a, b in zip(ends, ends[1:])])
    result["setup_split_s"] = dict(start_and_cuda=t_cuda - t_start,
                                   path=t_path - t_cuda,
                                   warmup_job=t_warm - t_path)
    result["written_bytes"] = _written_bytes()

    # the judgement, once the window has closed and the state is freed
    picked = [done[i] for i in _sample(len(done), SAMPLE_JOBS, seed)]
    outputs = [(d.index, path.export(d.output)) for d in picked]
    path.close()
    del path, done, picked
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    loaded = forbidden_modules()
    if loaded:
        result["forbidden_modules"] = loaded

    if trace:
        for m in cell.per_layer:
            v = layer.values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        result["device"].update(busy_s=layer.busy_s, window_s=layer.window_s)
        result["breakdown"] = layer.breakdown

    from .reference import check

    t_ref = time.perf_counter()
    checks = check.judge(cell.config, outputs, device)
    result["reference_s"] = time.perf_counter() - t_ref
    checks["jobs_judged"] = dict(value=len(outputs), limit=1,
                                 rule="at least")
    result["correct"] = (check.passes(checks) and failed == 0
                         and not loaded)
    result["checks"] = checks
    return result


def print_result(result: dict):
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']}, "
              f"{c.get('rule', 'at most')})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
