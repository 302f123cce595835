"""Host-side round plans: what a round loop decides per round, resolved
up front into (R, ...) operand arrays (counterpart of
``repro.rounds.plan``; numpy only).

The fleet needs two of the reference's helpers: stacking per-round host
plans and the cadence cuts.  Its ``iterated_split_keys`` has no
counterpart (the port's lanes draw from a ``torch.Generator`` each), and
``resolve_attack_operands`` / ``schedule_families`` wait for the scan
engine of the fed server (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from repro_torch.tree import tree_map

PyTree = Any


def stack_rounds(per_round: Sequence[PyTree]) -> PyTree:
    """Stack R per-round host pytrees into one pytree of (R, ...) arrays."""
    if not per_round:
        raise ValueError("no rounds to stack")
    return tree_map(lambda *xs: np.stack(xs, axis=0), *per_round)


def cadence_boundaries(rounds: int, *cadences: int) -> tuple[int, ...]:
    """Every round index where one of the cadences fires: the segments
    must END there so the host sees the state where a per-round loop
    would have evaluated it."""
    cuts: set[int] = set()
    for every in cadences:
        if every and every > 0:
            cuts.update(range(every, rounds + 1, every))
    return tuple(sorted(cuts))
