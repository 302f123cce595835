"""Adversarial robustness (counterpart of ``repro.robustness``): the
in-round quarantine guard.  The breakdown-frontier sweeps
(``run_breakdown`` / ``frontier_table``) are not ported yet (ROADMAP
queue 1, item 10)."""
from repro_torch.robustness.guard import (
    QuarantineConfig, quarantine_stack, quarantine_stack_lanes,
)

__all__ = ["QuarantineConfig", "quarantine_stack", "quarantine_stack_lanes"]
