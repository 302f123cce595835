"""Segmented round engine, options and host plans (counterpart of
``repro.rounds``).

* :class:`RoundEngine` drives a per-round body segment by segment, its
  metrics fetched once a run (:meth:`RoundEngine.run`) or once a round
  (:meth:`RoundEngine.run_loop`);
* :func:`split_segments` / :func:`cadence_boundaries` place the segment
  ends;
* the plan helpers resolve what a loop decides per round into (R, ...)
  operands: attack schedules (:func:`resolve_attack_operands`), per-round
  seeds (:func:`round_seeds`, where the reference splits PRNG keys) and
  stacked host batches (:func:`stack_rounds`).

The fed server and the fleet own their round bodies and plans.
"""
from repro_torch.rounds.engine import (
    WHOLE_RUN, RoundEngine, fetch_columns, fetch_metrics, split_segments,
)
from repro_torch.rounds.options import ENGINES, RoundOptions, resolve_options
from repro_torch.rounds.plan import (
    cadence_boundaries, resolve_attack_operands, round_generator,
    round_seeds, schedule_families, stack_rounds,
)

__all__ = ["WHOLE_RUN", "RoundEngine", "fetch_columns", "fetch_metrics",
           "split_segments",
           "ENGINES", "RoundOptions", "resolve_options",
           "cadence_boundaries", "resolve_attack_operands",
           "round_generator", "round_seeds", "schedule_families",
           "stack_rounds"]
