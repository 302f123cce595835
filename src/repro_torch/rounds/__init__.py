"""Round segments and host plans (counterpart of ``repro.rounds``)."""
from repro_torch.rounds.engine import WHOLE_RUN, split_segments
from repro_torch.rounds.options import ENGINES, RoundOptions, resolve_options
from repro_torch.rounds.plan import cadence_boundaries, stack_rounds

__all__ = ["WHOLE_RUN", "split_segments", "ENGINES", "RoundOptions",
           "resolve_options", "cadence_boundaries", "stack_rounds"]
