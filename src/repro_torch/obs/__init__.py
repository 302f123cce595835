"""Telemetry (counterpart of ``repro.obs``): the in-round health taps
(:mod:`repro_torch.obs.taps`, toggled by the owners' ``taps`` config
flags) and the runtime event registry with its JSONL and Chrome-trace
exporters (:mod:`repro_torch.obs.runtime`)."""
from repro_torch.obs.runtime import (
    DispatchRecord, KernelDecision, Runtime, counters, dispatch_history,
    event, export_chrome_trace, export_jsonl, get_runtime, history,
    import_jsonl, inc, last_dispatch, now, reset, snapshot, span, span_at,
)
from repro_torch.obs.taps import (
    TAP_FIELDS, HealthTaps, health_taps, health_taps_lanes,
)

__all__ = [
    "HealthTaps", "health_taps", "health_taps_lanes", "TAP_FIELDS",
    "Runtime", "get_runtime", "event", "span", "span_at", "now", "inc",
    "history", "counters", "snapshot", "reset", "export_jsonl",
    "export_chrome_trace", "import_jsonl",
    "DispatchRecord", "KernelDecision", "dispatch_history", "last_dispatch",
]
