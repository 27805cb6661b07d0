"""The one traffic generator: jobs drawn from a mix's parameters and a seed.

A mix (`traffic/<name>.json`) is a closed loop with one job in flight:
a prover working through its backlog of locked orders. Each job runs the
configuration's program once on fresh input. The mix gives the fill of
a job, `fill` = [lo, hi], as a share of 2^segment_po2 cycles of the
configuration, over `sizes` evenly spaced steps. Every seed draws the
same set of sizes, in its own order (a new permutation for each pass over
the set), and takes `jitter_iterations` at most off each job's loop count,
so that no two seeds send the same inputs and all send the same work to
within a few cycles. `loop` and `in_flight` name the arrival model; the
harness drives only a closed loop with one job in flight, and a mix that
asks for another is refused.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Job:
    index: int
    input_words: List[int]
    cycles: int  # what the program's cycle formula gives for the input


def _iterations(cycles: int, program: dict) -> int:
    per, fixed = program["cycles_per_iteration"], program["cycles_fixed"]
    return max(0, (cycles - fixed) // per)


def _cycles(iterations: int, program: dict) -> int:
    return program["cycles_per_iteration"] * iterations \
        + program["cycles_fixed"]


def targets(traffic: dict, config: dict) -> List[int]:
    """The mix's job sizes in cycles, smallest first."""
    lo, hi = traffic["fill"]
    cap = 1 << config["segment_po2"]
    return [int(f * cap) for f in np.linspace(lo, hi, traffic["sizes"])]


def check_arrivals(traffic: dict):
    """Refuse a mix whose arrival model the harness does not drive."""
    model = (traffic.get("loop"), traffic.get("in_flight"))
    if model != ("closed", 1):
        raise ValueError(f"traffic {traffic.get('name')!r}: loop "
                         f"{model[0]!r} with {model[1]!r} in flight is not "
                         "driven; only a closed loop with 1 in flight is")


def jobs(traffic: dict, config: dict, seed: int) -> Iterator[Job]:
    """The run's jobs, endless, in the seed's order."""
    sizes = targets(traffic, config)
    rng = np.random.default_rng(int(seed))
    program = config["program"]
    index = 0
    while True:
        for k in rng.permutation(len(sizes)):
            n = _iterations(sizes[k], program) - int(
                rng.integers(0, traffic["jitter_iterations"]))
            yield Job(index, [n], _cycles(n, program))
            index += 1


def warmup_job(traffic: dict, config: dict) -> Job:
    """The set-up's job: the mix's middle size, the same for every seed."""
    sizes = targets(traffic, config)
    n = _iterations(sizes[len(sizes) // 2], config["program"])
    return Job(-1, [n], _cycles(n, config["program"]))
