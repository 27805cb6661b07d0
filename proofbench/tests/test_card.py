"""Faults planted in the cluster cell's timed path fail `correct` (on the
card: the cell at its own size, a short window). Skips without a card.

    python3 -m pytest --noconftest proofbench/tests/test_card.py \\
        -p no:xdist -o addopts="" -m cuda
"""

from __future__ import annotations

import time

import pytest

from proofbench import harness

SEED = 2 ** 33 + 777


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_an_answer_altered_in_the_cluster_fails(monkeypatch):
    dev = _card()
    from boundless_tpu_torch.zkvm import prove

    real = prove.prove_segment

    def altered(*args, **kwargs):
        r = real(*args, **kwargs)
        io = r.pub["io"].copy()
        io[1, 2] ^= 1  # the committed journal word's low limb
        r.pub = dict(r.pub, io=io)
        return r

    cell = harness.resolve("rec20-2seg")
    path = harness.path_module(cell.config)
    monkeypatch.setattr(path.Path, "run_job", _after_warmup(
        path.Path.run_job, lambda: monkeypatch.setattr(
            prove, "prove_segment", altered)))
    monkeypatch.setattr(harness, "path_module",
                        lambda config, root=harness.ROOT: path)
    r = harness.measure(cell, SEED, 5.0, False, dev, time.perf_counter())
    assert not r["correct"]
    assert r["failed"] or r["checks"]["claim_fields_wrong"]["value"]


@pytest.mark.cuda
def test_an_altered_recursion_proof_fails(monkeypatch):
    dev = _card()
    from boundless_tpu_torch.recursion import succinct

    real = succinct.SuccinctSystem.lift

    def altered(self, *args, **kwargs):
        r = real(self, *args, **kwargs)
        taps = r.proof.taps_data.clone()
        taps[0, 0, 0] ^= 1
        r.proof = r.proof._replace(taps_data=taps)
        return r

    cell = harness.resolve("rec20-2seg")
    path = harness.path_module(cell.config)
    monkeypatch.setattr(path.Path, "run_job", _after_warmup(
        path.Path.run_job, lambda: monkeypatch.setattr(
            succinct.SuccinctSystem, "lift", altered)))
    monkeypatch.setattr(harness, "path_module",
                        lambda config, root=harness.ROOT: path)
    r = harness.measure(cell, SEED + 1, 5.0, False, dev, time.perf_counter())
    assert not r["correct"]
    assert r["failed"] or r["checks"]["proofs_rejected"]["value"]


def _after_warmup(run_job, plant):
    """run_job, with the fault planted once the warm-up job is done."""
    def wrapped(self, job):
        if job.index >= 0:
            plant()
        return run_job(self, job)
    return wrapped
