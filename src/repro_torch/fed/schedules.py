"""Time-varying adversary schedules, resolved on the host at round
boundaries (counterpart of ``repro.fed.schedules``; numpy only, the same
calls, so the same schedules).

The attack family switches at round boundaries, the strength eta ramps
linearly, and the Byzantine identity set can rotate through the
population.  A round only ever sees the resolved (attack, eta, identity)
values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.types import ATTACKS

@dataclasses.dataclass(frozen=True)
class AttackPhase:
    """One contiguous segment of the adversary's timeline; ``eta_end`` /
    ``ramp_rounds`` describe a linear eta ramp from the phase's start."""
    attack: str
    start: int = 0                     # first round (inclusive)
    eta: Optional[float] = None        # None => attack default
    eta_end: Optional[float] = None
    ramp_rounds: int = 0

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(
                f"unknown attack {self.attack!r}; known: {ATTACKS}")
        if self.eta_end is not None and self.ramp_rounds <= 0:
            raise ValueError("eta_end requires ramp_rounds > 0")
        if self.eta_end is not None and self.eta is None:
            raise ValueError("eta_end requires a starting eta")

    def eta_at(self, r: int) -> Optional[float]:
        if self.eta_end is None:
            return self.eta
        frac = min(1.0, max(0.0, (r - self.start) / self.ramp_rounds))
        return float(self.eta + frac * (self.eta_end - self.eta))


@dataclasses.dataclass(frozen=True)
class AttackSchedule:
    """Piecewise attack timeline; the phase with the largest start <= r wins."""
    phases: tuple[AttackPhase, ...] = (AttackPhase("none"),)

    def __post_init__(self):
        starts = [p.start for p in self.phases]
        if not starts or starts[0] != 0:
            raise ValueError("first phase must start at round 0")
        if starts != sorted(starts):
            raise ValueError("phases must be sorted by start round")

    def resolve(self, r: int) -> tuple[str, Optional[float]]:
        """(attack family, eta) in effect at round ``r``."""
        phase = self.phases[0]
        for p in self.phases:
            if p.start <= r:
                phase = p
        return phase.attack, phase.eta_at(r)


def constant_attack(attack: str, eta: Optional[float] = None) -> AttackSchedule:
    return AttackSchedule((AttackPhase(attack, 0, eta),))


def switch_attack(*segments: tuple) -> AttackSchedule:
    """``switch_attack((0, "alie", 8.0), (30, "foe", 20.0))``: switch
    family / eta at the given round boundaries."""
    return AttackSchedule(tuple(
        AttackPhase(attack, start, eta)
        for start, attack, eta in
        ((s[0], s[1], s[2] if len(s) > 2 else None) for s in segments)))


def ramp_eta(attack: str, eta0: float, eta1: float,
             ramp_rounds: int) -> AttackSchedule:
    """Single family, eta linearly ramped from eta0 to eta1."""
    return AttackSchedule((AttackPhase(attack, 0, eta0, eta1, ramp_rounds),))


@dataclasses.dataclass(frozen=True)
class FixedByzantine:
    """The last ``f`` of ``n_clients`` are Byzantine forever."""
    n_clients: int
    f: int

    def ids(self, r: int) -> np.ndarray:
        return np.arange(self.n_clients - self.f, self.n_clients)


@dataclasses.dataclass(frozen=True)
class RotatingByzantine:
    """A contiguous block of ``f`` ids that shifts by ``stride`` every
    ``period`` rounds, wrapping around; round 0 starts at the last-``f``
    block."""
    n_clients: int
    f: int
    period: int = 5
    stride: Optional[int] = None   # default: shift by f (disjoint blocks)

    def ids(self, r: int) -> np.ndarray:
        stride = self.f if self.stride is None else self.stride
        shift = (r // self.period) * stride
        return np.sort((np.arange(self.f) + (self.n_clients - self.f) + shift)
                       % self.n_clients)
