"""Serving (counterpart of ``repro.serving``): the continuous fleet
service.  ``ServeEngine`` / ``greedy_decode`` wait for ROADMAP queue 1,
item 14."""
from repro_torch.serving.engine import FleetService, JobHandle

__all__ = ["FleetService", "JobHandle"]
