"""Runtime telemetry (counterpart of ``repro.obs``; the in-round health
taps are not ported yet: ROADMAP queue 1, item 10)."""
from repro_torch.obs.runtime import (
    DispatchRecord, KernelDecision, Runtime, counters, event, history, inc,
    last_dispatch, now, reset, span, span_at,
)

__all__ = [
    "Runtime", "event", "span", "span_at", "now", "inc", "history",
    "counters", "reset", "DispatchRecord", "KernelDecision", "last_dispatch",
]
