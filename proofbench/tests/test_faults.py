"""The judgement fails what it should, on the CPU at a size a test holds.

Each test drives a whole run of the segment cell through
`harness.measure` (the harness's look for a card skipped: the port runs
on the CPU) with po2-8 segments and an 8-query rate-1/4 proof system, and reads
`correct`: a sound run passes; the control (the port proving at the
control's rate, below the configuration's) and each planted fault
(an answer altered where it is produced, half of the jobs' proofs left
out) fail.

    python -m pytest proofbench/tests -q -p no:xdist -o addopts=""
"""

from __future__ import annotations

import copy
import time

import pytest

from proofbench import harness

SMALL_PS = dict(queries=8, fri_min_degree=16, commit_expand=4)
SEED = 2 ** 33 + 4242


def _cell():
    cell = harness.resolve("seg20-prove")
    cell = copy.deepcopy(cell)
    cell.config["segment_po2"] = 8
    cell.config["proof_system"] = dict(SMALL_PS)
    return cell


def _run(seconds=1.0, **options):
    return harness.measure(_cell(), SEED, seconds, False, "cpu",
                           time.perf_counter(), path_options=options)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["checks"]["proofs_rejected"]["value"] == 0
    assert r["checks"]["claim_fields_wrong"]["value"] == 0


def test_the_control_fails():
    """The configuration states rate 1/4 here; the port proving at the
    control's rate 1/2 (its own path, the step that would tempt a change)
    is refused."""
    control = _cell().config["control"]["proof_system"]
    assert control["commit_expand"] < SMALL_PS["commit_expand"]
    r = _run(proof_system=dict(SMALL_PS,
                               commit_expand=control["commit_expand"]))
    assert not r["correct"]
    assert r["checks"]["proofs_rejected"]["value"] >= 1


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from boundless_tpu_torch.zkvm import prove

    real = prove.prove_segment

    def altered(*args, **kwargs):
        r = real(*args, **kwargs)
        io = r.pub["io"].copy()
        io[1, 2] ^= 1  # the committed journal word's low limb
        r.pub = dict(r.pub, io=io)
        return r

    monkeypatch.setattr(prove, "prove_segment", altered)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["claim_fields_wrong"]["value"] >= 1


def test_an_altered_proof_fails(monkeypatch):
    from boundless_tpu_torch.zkvm import prove

    real = prove.prove_segment

    def altered(*args, **kwargs):
        r = real(*args, **kwargs)
        taps = r.proof.taps_data.clone()
        taps[0, 0, 0] ^= 1
        r.proof = r.proof._replace(taps_data=taps)
        return r

    monkeypatch.setattr(prove, "prove_segment", altered)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["proofs_rejected"]["value"] >= 1


@pytest.mark.parametrize("keep", [0])
def test_half_of_the_jobs_left_unproved_fails(monkeypatch, keep):
    """Every other job's proof left out (the jobs still counted)."""
    path_cls = harness.path_module(_cell().config).Path
    real = path_cls.run_job
    calls = []

    def half(self, job):
        out = real(self, job)
        calls.append(job.index)
        if len(calls) % 2 == keep:
            out["receipts"] = []
        return out

    monkeypatch.setattr(path_cls, "run_job", half)
    monkeypatch.setattr(harness, "path_module",
                        lambda config, root=harness.ROOT: type(
                            "M", (), {"Path": path_cls}))
    r = _run(seconds=0.5)
    assert not r["correct"]
    assert r["checks"]["proofs_rejected"]["value"] >= 1


def test_a_job_that_raises_is_counted_failed(monkeypatch):
    """A job whose proof raises: the run still ends with a result, the
    job counted failed."""
    path_cls = harness.path_module(_cell().config).Path
    real = path_cls.run_job

    def broken(self, job):
        if job.index >= 0:  # the warm-up job passes
            raise RuntimeError("planted fault")
        return real(self, job)

    monkeypatch.setattr(path_cls, "run_job", broken)
    monkeypatch.setattr(harness, "path_module",
                        lambda config, root=harness.ROOT: type(
                            "M", (), {"Path": path_cls}))
    r = _run(seconds=0.5)
    assert not r["correct"]
    assert r["failed"] >= 1 and r["attempted"] == r["failed"]
