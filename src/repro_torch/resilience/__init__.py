"""Preemption-safe resumable runs (counterpart of ``repro.resilience``).

Segment-boundary carry snapshots (async, double-buffered, atomic
manifest), deterministic fault injection, and the restore helpers that
``train_loop``, ``fed.run_rounds`` and ``FleetRunner`` share.  The
continuous fleet service snapshots itself through the same store
(``repro_torch.serving.FleetService.restore``).
"""
from .experiment import (
    CarryCheckpointer,
    check_signature,
    concat_metrics,
    metric_columns,
    resolve_checkpoint,
    restore_carry,
    restored_metrics,
)
from .faults import CheckpointError, FaultPlan, SimulatedPreemption
from .store import CheckpointConfig, SnapshotStore

__all__ = [
    "CarryCheckpointer",
    "CheckpointConfig",
    "CheckpointError",
    "FaultPlan",
    "SimulatedPreemption",
    "SnapshotStore",
    "check_signature",
    "concat_metrics",
    "metric_columns",
    "resolve_checkpoint",
    "restore_carry",
    "restored_metrics",
]
