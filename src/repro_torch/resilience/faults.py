"""Fault injection for the resilience layer (counterpart of
``repro.resilience.faults``).

A :class:`FaultPlan` rides on
:class:`~repro_torch.resilience.store.CheckpointConfig` and makes the
snapshot store misbehave deterministically, so the kill / resume parity
tests prove recovery instead of assuming it:

- ``kill_at=k``: the k-th snapshot (0-based, counting ``save()`` calls in
  this process) completes **durably** (pending writes drained, manifest
  updated), then :class:`SimulatedPreemption` is raised.  Resuming must
  land exactly on that boundary.
- ``torn_at=k``: the k-th snapshot file is written **truncated** and the
  manifest is left pointing at the previous snapshot (as if the process
  died between the data write and the manifest update), then
  :class:`SimulatedPreemption` is raised.  Resuming must land on the
  previous complete snapshot and ignore the torn file.
"""
from __future__ import annotations

import dataclasses


class SimulatedPreemption(BaseException):
    """Raised by a :class:`FaultPlan` to emulate a process kill.

    Derives from ``BaseException`` (like ``KeyboardInterrupt``) so generic
    ``except Exception`` recovery code in run loops cannot swallow it.
    """

    def __init__(self, ordinal: int, round_: int):
        super().__init__(
            f"simulated preemption after snapshot #{ordinal} (round {round_})")
        self.ordinal = ordinal
        self.round = round_


class CheckpointError(RuntimeError):
    """Clean refusal to restore, with a recovery hint attached."""

    def __init__(self, message: str, *, hint: str = ""):
        super().__init__(message + (f"\nhint: {hint}" if hint else ""))
        self.hint = hint


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Deterministic snapshot-store faults (indices are 0-based save
    ordinals)."""

    kill_at: int | None = None
    torn_at: int | None = None

    def __post_init__(self):
        if self.kill_at is not None and self.torn_at is not None:
            raise ValueError("FaultPlan: set at most one of kill_at / torn_at")
