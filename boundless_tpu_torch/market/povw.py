"""Proof-of-Verifiable-Work (PoVW): work-log accounting + reward minting.

The port's copy of `boundless_tpu/market/povw.py`: host code, apart from
`WorkLog.record_receipt`, whose `verify_session` runs on the device the
session receipt lives on (the Poseidon2 sponge kernel on the card).

Re-design of `crates/povw` (LogUpdaterService, MintCalculatorProver —
reference `src/lib.rs:5-17`, `mint_calculator.rs:679`) and the epoch/stake
semantics of `crates/rewards`/`crates/zkc`: provers accumulate verified
work (proved cycles) into per-epoch work logs; mint rewards are computed
pro-rata per epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


@dataclasses.dataclass
class WorkLogEntry:
    prover: str
    epoch: int
    cycles: int
    claim_digest: bytes


class WorkLog:
    """Append-only per-prover work log (reference log-updater guest role:
    here host-validated against session receipts)."""

    def __init__(self, epoch_seconds: float = 60.0, clock=time.time):
        self.entries: List[WorkLogEntry] = []
        self.epoch_seconds = epoch_seconds
        self.clock = clock
        self._seen: set = set()

    def current_epoch(self) -> int:
        return int(self.clock() // self.epoch_seconds)

    def record(self, prover: str, cycles: int, claim_digest: bytes):
        if claim_digest in self._seen:
            raise ValueError("work already recorded for this claim")
        self._seen.add(claim_digest)
        self.entries.append(WorkLogEntry(prover, self.current_epoch(),
                                         cycles, claim_digest))

    def record_receipt(self, prover: str, session, system,
                       seg_po2: int) -> int:
        """Record work backed by a PROVEN session receipt (the reference
        log-updater guest's role, `crates/povw/src/lib.rs:5-17`).

        The cycle count is NOT an input: it is read from the verified
        claim's segments counter (claim v3 wire 57 — every lift proves
        post_segments = pre_segments + 1 in-circuit and joins chain it),
        so work = post_segments << seg_po2 padded cycles is exactly what
        the prover proved. A forged count would need a forged claim
        digest, which `verify_session` rejects (on the device of the
        receipt's proof). Returns the credited cycles."""
        from ..recursion import claims as rclaims
        from ..recursion import succinct as rsucc

        if not rsucc.verify_session(session, system):
            raise ValueError("povw: session receipt failed verification")
        c = session.root.claim
        segments = int(c.post_segments) - int(c.pre_segments)
        if segments <= 0:
            raise ValueError("povw: receipt proves no segments")
        cycles = segments << seg_po2
        digest = rclaims.digest_bytes(c.digest())
        self.record(prover, cycles, digest)
        return cycles

    def epoch_totals(self, epoch: int) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.entries:
            if e.epoch == epoch:
                out[e.prover] = out.get(e.prover, 0) + e.cycles
        return out


class MintCalculator:
    """Pro-rata epoch rewards (reference PovwMint/mint-calculator)."""

    def __init__(self, log: WorkLog, epoch_reward: int = 1_000_000):
        self.log = log
        self.epoch_reward = epoch_reward
        self.minted: Dict[int, Dict[str, int]] = {}

    def mint_for_epoch(self, epoch: int) -> Dict[str, int]:
        if epoch in self.minted:
            raise ValueError("epoch already minted")
        if epoch >= self.log.current_epoch():
            raise ValueError("epoch not yet closed")
        totals = self.log.epoch_totals(epoch)
        total = sum(totals.values())
        rewards = ({} if total == 0 else
                   {p: self.epoch_reward * c // total
                    for p, c in totals.items()})
        self.minted[epoch] = rewards
        return rewards


@dataclasses.dataclass
class VersionRegistry:
    """Min-version gating (reference contracts/src/VersionRegistry.sol +
    broker version_check service)."""

    min_version: tuple = (0, 1, 0)

    def check(self, version: tuple) -> bool:
        return tuple(version) >= tuple(self.min_version)


# ---------------------------------------------------------------------------
# ZKC emissions + staking rewards (reference crates/zkc + crates/rewards)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EmissionSchedule:
    """Per-epoch token emissions split between PoVW and staking
    (reference IZKC.getEmissionsForEpoch / getPoVWEmissionsForEpoch;
    the initial rate, decay, and split are deployment parameters of the
    ZKC contract — configurable here)."""

    initial_epoch_emission: int = 1_000_000
    decay_num: int = 999  # geometric decay per epoch: num/den
    decay_den: int = 1000
    povw_bps: int = 7500  # PoVW share in basis points; rest to staking

    def emissions_for_epoch(self, epoch: int) -> int:
        e = self.initial_epoch_emission
        # integer geometric decay (exact, no float drift)
        e = e * pow(self.decay_num, epoch) // pow(self.decay_den, epoch)
        return e

    def povw_emissions(self, epoch: int) -> int:
        return self.emissions_for_epoch(epoch) * self.povw_bps // 10_000

    def staking_emissions(self, epoch: int) -> int:
        total = self.emissions_for_epoch(epoch)
        return total - total * self.povw_bps // 10_000


@dataclasses.dataclass
class StakingPosition:
    """One staker (reference rewards/src/staking.rs StakingPosition)."""

    staked: int = 0
    is_withdrawing: bool = False
    rewards_delegate: str = None  # None -> self
    vote_delegate: str = None


class StakingLedger:
    """Stake positions + delegation + per-epoch power snapshots
    (reference rewards/src/staking.rs event fold + powers.rs)."""

    def __init__(self):
        self.positions: Dict[str, StakingPosition] = {}
        self._epoch_power: Dict[int, Dict[str, int]] = {}

    def _pos(self, owner: str) -> StakingPosition:
        return self.positions.setdefault(owner, StakingPosition())

    def stake(self, owner: str, amount: int):
        p = self._pos(owner)
        if p.is_withdrawing:
            raise ValueError("position is withdrawing")
        p.staked += amount

    def initiate_unstake(self, owner: str):
        self._pos(owner).is_withdrawing = True

    def complete_unstake(self, owner: str) -> int:
        p = self._pos(owner)
        if not p.is_withdrawing:
            raise ValueError("unstake not initiated")
        amount, p.staked, p.is_withdrawing = p.staked, 0, False
        return amount

    def delegate_rewards(self, owner: str, to: str):
        self._pos(owner).rewards_delegate = to

    def delegate_votes(self, owner: str, to: str):
        self._pos(owner).vote_delegate = to

    def snapshot_epoch(self, epoch: int):
        """Freeze staking power for an epoch (withdrawing stake has no
        power, matching veZKC semantics)."""
        self._epoch_power[epoch] = {
            o: p.staked for o, p in self.positions.items()
            if p.staked > 0 and not p.is_withdrawing}

    def power_of(self, epoch: int, owner: str) -> int:
        return self._epoch_power.get(epoch, {}).get(owner, 0)

    def vote_powers(self, epoch: int) -> Dict[str, int]:
        """Voting power folded onto vote delegates (reference
        rewards/src/powers.rs compute_delegation_powers)."""
        out: Dict[str, int] = {}
        for owner, power in self._epoch_power.get(epoch, {}).items():
            tgt = self.positions[owner].vote_delegate or owner
            out[tgt] = out.get(tgt, 0) + power
        return out

    def staking_rewards(self, epoch: int, emissions: int) -> Dict[str, int]:
        """Pro-rata staking rewards, paid to the rewards delegate
        (reference staking.rs StakerRewardInfo)."""
        powers = self._epoch_power.get(epoch, {})
        total = sum(powers.values())
        out: Dict[str, int] = {}
        if total == 0:
            return out
        for owner, power in powers.items():
            tgt = self.positions[owner].rewards_delegate or owner
            out[tgt] = out.get(tgt, 0) + emissions * power // total
        return out


@dataclasses.dataclass
class WorkLogRewardInfo:
    """Per-work-log epoch reward row (reference rewards/src/povw.rs)."""

    work_log_id: str
    work: int
    proportional_rewards: int
    capped_rewards: int
    reward_cap: int
    is_capped: bool
    recipient: str


class PovwRewards:
    """Epoch PoVW rewards with stake-based caps + delegation
    (reference rewards/src/povw.rs compute_povw_rewards_for_epoch:
    proportional = work * emissions / total_work, then min(cap) where
    the cap scales with the work log's staked ZKC)."""

    def __init__(self, log: WorkLog, staking: StakingLedger,
                 schedule: EmissionSchedule = None,
                 cap_per_stake_bps: int = 10_000):
        self.log = log
        self.staking = staking
        self.schedule = schedule or EmissionSchedule()
        self.cap_per_stake_bps = cap_per_stake_bps
        self.minted: Dict[int, Dict[str, WorkLogRewardInfo]] = {}

    def reward_cap(self, epoch: int, prover: str) -> int:
        return (self.staking.power_of(epoch, prover)
                * self.cap_per_stake_bps // 10_000)

    def compute_epoch(self, epoch: int) -> Dict[str, WorkLogRewardInfo]:
        if epoch in self.minted:
            raise ValueError("epoch already minted")
        if epoch >= self.log.current_epoch():
            raise ValueError("epoch not yet closed")
        emissions = self.schedule.povw_emissions(epoch)
        totals = self.log.epoch_totals(epoch)
        total_work = sum(totals.values())
        out: Dict[str, WorkLogRewardInfo] = {}
        for prover, work in totals.items():
            prop = emissions * work // total_work if total_work else 0
            cap = self.reward_cap(epoch, prover)
            capped = min(prop, cap)
            pos = self.staking.positions.get(prover)
            recipient = (pos.rewards_delegate if pos and
                         pos.rewards_delegate else prover)
            out[prover] = WorkLogRewardInfo(
                work_log_id=prover, work=work, proportional_rewards=prop,
                capped_rewards=capped, reward_cap=cap,
                is_capped=capped < prop, recipient=recipient)
        self.minted[epoch] = out
        return out
