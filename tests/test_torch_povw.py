"""PoVW parity: every case of JAX `tests/test_povw.py` run on both the JAX
package and the port (`boundless_tpu_torch/market/povw.py`), with equal
results; `WorkLog.record_receipt` on one dev-mode session built by each
package, crediting the same cycles under the same claim digest."""

import dataclasses
import importlib
import time

import pytest

PACKAGES = ["boundless_tpu", "boundless_tpu_torch"]


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return request.param


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def test_worklog_and_prorata_mint(pkg):
    P = mod(pkg, "market.povw")
    t = [0.0]
    log = P.WorkLog(epoch_seconds=10.0, clock=lambda: t[0])
    log.record("p1", 3_000_000, b"c1")
    log.record("p2", 1_000_000, b"c2")
    with pytest.raises(ValueError):
        log.record("p1", 1, b"c1")  # double-count rejected
    t[0] = 15.0  # epoch 0 closed
    mc = P.MintCalculator(log, epoch_reward=1000)
    assert mc.mint_for_epoch(0) == {"p1": 750, "p2": 250}
    with pytest.raises(ValueError):
        mc.mint_for_epoch(0)  # double mint
    with pytest.raises(ValueError):
        mc.mint_for_epoch(1)  # epoch open


def test_empty_epoch_mint(pkg):
    P = mod(pkg, "market.povw")
    log = P.WorkLog(epoch_seconds=10.0, clock=lambda: 100.0)
    assert P.MintCalculator(log).mint_for_epoch(3) == {}


def test_version_registry(pkg):
    vr = mod(pkg, "market.povw").VersionRegistry(min_version=(1, 2, 0))
    assert vr.check((1, 2, 0))
    assert vr.check((2, 0, 0))
    assert not vr.check((1, 1, 9))


def test_broker_telemetry_snapshots(pkg):
    Telemetry = mod(pkg, "market.broker.telemetry").Telemetry

    class FakeBroker:
        address = "p1"
        orders = {}

    class FakeStream:
        def __init__(self):
            self.beats = []

        def heartbeat(self, addr):
            self.beats.append(addr)

    stream = FakeStream()
    tel = Telemetry(FakeBroker(), stream, interval=0.01)
    tel.start()
    deadline = time.time() + 2
    while time.time() < deadline and len(tel.snapshots) < 3:
        time.sleep(0.01)
    tel.stop()
    assert len(tel.snapshots) >= 3
    assert stream.beats and stream.beats[0] == "p1"
    assert tel.snapshots[0]["total"] == 0


def test_emission_schedule_decay_and_split(pkg):
    s = mod(pkg, "market.povw").EmissionSchedule(
        initial_epoch_emission=1_000_000, decay_num=999, decay_den=1000,
        povw_bps=7500)
    assert s.emissions_for_epoch(0) == 1_000_000
    assert s.emissions_for_epoch(1) == 999_000
    assert s.emissions_for_epoch(2) == 998_001
    assert s.povw_emissions(0) == 750_000
    assert s.staking_emissions(0) == 250_000
    assert (s.povw_emissions(5) + s.staking_emissions(5)
            == s.emissions_for_epoch(5))


def test_emission_schedules_equal():
    J = mod("boundless_tpu", "market.povw").EmissionSchedule()
    T = mod("boundless_tpu_torch", "market.povw").EmissionSchedule()
    for ep in (0, 1, 7, 100, 1000):
        assert (T.emissions_for_epoch(ep), T.povw_emissions(ep),
                T.staking_emissions(ep)) == (
            J.emissions_for_epoch(ep), J.povw_emissions(ep),
            J.staking_emissions(ep))


def test_staking_ledger_delegation_and_rewards(pkg):
    led = mod(pkg, "market.povw").StakingLedger()
    led.stake("alice", 300)
    led.stake("bob", 100)
    led.delegate_rewards("bob", "carol")
    led.delegate_votes("alice", "bob")
    led.snapshot_epoch(1)
    assert led.vote_powers(1) == {"bob": 400}
    assert led.staking_rewards(1, 1000) == {"alice": 750, "carol": 250}
    led.initiate_unstake("alice")
    led.snapshot_epoch(2)
    assert led.staking_rewards(2, 1000) == {"carol": 1000}
    assert led.complete_unstake("alice") == 300


def test_povw_rewards_stake_cap(pkg):
    P = mod(pkg, "market.povw")
    t = [0.0]
    log = P.WorkLog(epoch_seconds=10.0, clock=lambda: t[0])
    led = P.StakingLedger()
    led.stake("p1", 1_000_000)  # heavily staked: uncapped
    led.stake("p2", 100)        # barely staked: capped
    led.snapshot_epoch(0)
    log.record("p1", 600, b"c1")
    log.record("p2", 400, b"c2")
    t[0] = 15.0  # epoch 0 closed
    pr = P.PovwRewards(log, led, P.EmissionSchedule(
        initial_epoch_emission=1_000_000, povw_bps=10_000))
    out = pr.compute_epoch(0)
    assert out["p1"].proportional_rewards == 600_000
    assert not out["p1"].is_capped
    assert out["p2"].proportional_rewards == 400_000
    assert out["p2"].is_capped and out["p2"].capped_rewards == 100
    with pytest.raises(ValueError):
        pr.compute_epoch(0)


def _dev_session(pkg, po2=10):
    """(session, dev-mode system, segments, last joined receipt) of the loop
    guest through one package's DevModeSystem (as `test_povw.py`)."""
    claims = mod(pkg, "recursion.claims")
    succinct = mod(pkg, "recursion.succinct")
    guests = mod(pkg, "zkvm.guests")
    paging = mod(pkg, "zkvm.paging")
    prove = mod(pkg, "zkvm.prove")
    Executor = mod(pkg, "zkvm.executor").Executor

    sys_ = succinct.DevModeSystem()
    image = guests.loop_guest()
    res = Executor(image, guests.words([300]), segment_po2=po2).run()
    pre = {t: claims.ZERO_CHAIN for t in claims.CHAIN_TAGS}
    kw = {} if pkg == "boundless_tpu" else {"device": "cpu"}
    recs = []
    for seg in res.segments:
        sr = prove.dev_receipt(image, seg, ps=prove.TEST_PS, **kw)
        recs.append(sys_.lift(sr, dict(pre), pre_mem=seg.pre_mem,
                              seg_index=seg.index))
        pre = {4: recs[-1].claim.post_journal,
               5: recs[-1].claim.post_input,
               6: recs[-1].claim.post_assumptions,
               8: recs[-1].claim.post_coproc}
    cur = recs[0]
    for r in recs[1:]:
        cur = sys_.join(cur, r)
    words = [int.from_bytes(res.journal[i: i + 4], "little")
             for i in range(0, len(res.journal), 4)]
    session = succinct.finalize_session(
        cur, words, entry_pc=image.entry,
        image_mem_root=paging.image_root(image))
    return session, sys_, len(res.segments), cur


def test_worklog_receipt_backed_cycles(pkg):
    """The credited cycles come from the VERIFIED claim's segments counter;
    a tampered counter changes the claim digest and verification fails."""
    P = mod(pkg, "market.povw")
    po2 = 10
    session, sys_, segments, cur = _dev_session(pkg, po2)
    log = P.WorkLog(epoch_seconds=10.0, clock=lambda: 0.0)
    assert log.record_receipt("p1", session, sys_, seg_po2=po2) \
        == segments << po2
    with pytest.raises(ValueError):
        log.record_receipt("p1", session, sys_, seg_po2=po2)
    forged_claim = dataclasses.replace(
        cur.claim, post_segments=cur.claim.post_segments + 100)
    forged = dataclasses.replace(session, root=dataclasses.replace(
        cur, claim=forged_claim))
    with pytest.raises(ValueError):
        log.record_receipt("p2", forged, sys_, seg_po2=po2)


def test_record_receipt_equals_jax():
    """One dev-mode session per package: the same credited cycles under
    the same claim digest, and the same mint."""
    out = []
    for pkg in PACKAGES:
        P = mod(pkg, "market.povw")
        session, sys_, _, _ = _dev_session(pkg)
        t = [0.0]
        log = P.WorkLog(epoch_seconds=10.0, clock=lambda: t[0])
        cycles = log.record_receipt("p1", session, sys_, seg_po2=10)
        log.record("p2", 3 * cycles, b"other")
        t[0] = 10.0
        out.append((cycles, [dataclasses.astuple(e) for e in log.entries],
                    P.MintCalculator(log).mint_for_epoch(0)))
    assert out[0] == out[1]
    assert out[1][2] == {"p1": 250_000, "p2": 750_000}
