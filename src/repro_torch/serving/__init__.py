"""Serving (counterpart of ``repro.serving``): the static-batch decode
engine (``ServeEngine``, ``greedy_decode``) and the continuous fleet
service."""
from repro_torch.serving.engine import (
    FleetService, JobHandle, ServeEngine, greedy_decode,
)

__all__ = ["FleetService", "JobHandle", "ServeEngine", "greedy_decode"]
