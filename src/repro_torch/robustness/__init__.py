"""Adversarial robustness (counterpart of ``repro.robustness``): the
in-round quarantine guard, and the breakdown-frontier sweeps
(``run_breakdown`` / ``frontier_table``, :mod:`repro_torch.robustness.
breakdown`), imported lazily: they pull in the fed / fleet layers, which
import the guard from here."""
from repro_torch.robustness.guard import (
    QuarantineConfig, quarantine_stack, quarantine_stack_lanes,
)

__all__ = ["QuarantineConfig", "quarantine_stack", "quarantine_stack_lanes",
           "BreakdownAttack", "DEFAULT_ATTACKS", "DEFAULT_RULES",
           "frontier_table", "run_breakdown"]

_BREAKDOWN_NAMES = ("BreakdownAttack", "DEFAULT_ATTACKS", "DEFAULT_RULES",
                    "frontier_table", "run_breakdown")


def __getattr__(name):
    if name in _BREAKDOWN_NAMES:
        from repro_torch.robustness import breakdown
        return getattr(breakdown, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
