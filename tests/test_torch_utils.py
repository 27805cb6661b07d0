"""Config watcher, service runner and executor-service registry parity:
every case of JAX `tests/test_utils.py` run on both the JAX package and
the port (`boundless_tpu_torch/utils/config.py`,
`utils/service_runner.py`, `cluster/executor_service.py`), plus the
config's file bytes (the port's tracer: `tests/test_torch_profiling.py`)."""

import importlib
import os
import pickle
import tempfile
import time

import pytest

PACKAGES = ["boundless_tpu", "boundless_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_config_roundtrip_and_hot_reload(pkg):
    C = mod(pkg, "utils.config")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "broker.json")
        C.BrokerToml(min_mcycle_price=5, peak_prove_khz=250.0).save(path)
        w = C.ConfigWatcher(path, poll=0.02)
        assert w.config.min_mcycle_price == 5
        seen = []
        w.subscribe(lambda c: seen.append(c.peak_prove_khz))
        w.start()
        try:
            time.sleep(0.05)
            cfg = C.BrokerToml.load(path)
            cfg.peak_prove_khz = 999.0
            cfg.save(path)
            os.utime(path)
            deadline = time.time() + 2
            while time.time() < deadline and not seen:
                time.sleep(0.02)
            assert seen and seen[-1] == 999.0
            assert w.config.peak_prove_khz == 999.0
        finally:
            w.stop()


def test_config_files_equal_jax(tmp_path):
    """Both packages write the same bytes and read each other's files
    (unknown keys ignored)."""
    paths = []
    for pkg in PACKAGES:
        p = tmp_path / f"{pkg}.json"
        mod(pkg, "utils.config").BrokerToml(
            min_mcycle_price=3, priority_requestors=["0xab"],
            segment_po2=17).save(str(p))
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    (tmp_path / "extra.json").write_text(
        '{"lock_orders": false, "not_a_knob": 1}')
    for pkg in PACKAGES:
        cfg = mod(pkg, "utils.config").BrokerToml.load(
            str(tmp_path / "extra.json"))
        assert cfg.lock_orders is False and cfg.segment_po2 == 14


def test_service_runner_restart_and_critical(pkg):
    S = mod(pkg, "utils.service_runner")
    r = S.ServiceRunner()
    calls = []

    def flaky(cancel):
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("boom")
        cancel.wait(5)

    r.spawn("flaky", flaky, S.Criticality.CRITICAL_FAST_RETRY)
    deadline = time.time() + 2
    while time.time() < deadline and len(calls) < 3:
        time.sleep(0.01)
    assert len(calls) >= 3

    def fatal(cancel):
        raise RuntimeError("fatal")

    r.spawn("fatal", fatal, S.Criticality.CRITICAL)
    deadline = time.time() + 2
    while time.time() < deadline and not r.cancel.is_set():
        time.sleep(0.01)
    assert r.cancel.is_set()  # critical crash cancels the group
    r.shutdown(drain_timeout=1)
    assert ("fatal", repr(RuntimeError("fatal"))) in r.failures


def test_non_critical_backs_off(pkg):
    S = mod(pkg, "utils.service_runner")
    r = S.ServiceRunner()
    calls = []

    def once_bad(cancel):
        calls.append(time.time())
        if len(calls) == 1:
            raise ValueError("transient")

    r.spawn("nc", once_bad, S.Criticality.NON_CRITICAL)
    deadline = time.time() + 2
    while time.time() < deadline and len(calls) < 2:
        time.sleep(0.01)
    r.shutdown(drain_timeout=1)
    assert len(calls) == 2 and calls[1] - calls[0] >= 0.04
    assert r.failures == [("nc", repr(ValueError("transient")))]


def test_retry_helper(pkg):
    retry = mod(pkg, "utils.service_runner").retry
    attempts = []

    def sometimes():
        attempts.append(1)
        if len(attempts) < 3:
            raise ValueError("nope")
        return 42

    assert retry(sometimes, attempts=5, delay=0.001) == 42
    with pytest.raises(ValueError):
        retry(lambda: (_ for _ in ()).throw(ValueError("always")),
              attempts=2, delay=0.001)


def test_executor_service_registry(pkg):
    guests = mod(pkg, "zkvm.guests")
    reg = mod(pkg, "cluster.executor_service").default_registry()
    assert reg.names() == ["rv32im"]
    res = reg.get("rv32im").execute(pickle.dumps(guests.echo()),
                                    guests.words([1, 99]), 1 << 20)
    assert res.exit_code == 0
    assert res.journal == guests.words([99])
    with pytest.raises(KeyError):
        reg.get("sp1")
