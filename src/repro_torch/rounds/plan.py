"""Host-side round plans: what a round loop decides per round, resolved
up front into (R, ...) operand arrays (counterpart of
``repro.rounds.plan``; numpy only, apart from :func:`round_seeds`).

The reference's ``iterated_split_keys`` (the subkey sequence of a
``key, sub = split(key)`` loop) has no counterpart: the port cannot
reproduce threefry.  A run's per-round randomness comes instead from one
``torch.Generator`` seeded with the run's seed, drawn in round order
(:func:`round_seeds`), so a segmented run and a per-round loop see the
same draws.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map

PyTree = Any


def stack_rounds(per_round: Sequence[PyTree]) -> PyTree:
    """Stack R per-round host pytrees into one pytree of (R, ...) arrays."""
    if not per_round:
        raise ValueError("no rounds to stack")
    return tree_map(lambda *xs: np.stack(xs, axis=0), *per_round)


def round_seeds(seed: int, rounds: int) -> np.ndarray:
    """(R,) int64 per-round seeds, drawn in round order from one
    ``torch.Generator`` seeded with ``seed``: round r draws its bucket
    permutation and its feature-poisoning noise from a generator seeded
    with entry r (:func:`round_generator`)."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2 ** 62, (rounds,), generator=gen,
                         dtype=torch.int64).numpy()


def round_generator(seed) -> torch.Generator:
    """The CPU generator of one round, from its :func:`round_seeds` entry."""
    return torch.Generator().manual_seed(int(seed))


def schedule_families(schedule) -> tuple[str, ...]:
    """The attack families of a schedule in first-appearance order (the
    fed server's engine-cache key)."""
    return tuple(dict.fromkeys(p.attack for p in schedule.phases))


def resolve_attack_operands(
        schedule, rounds: int
        ) -> tuple[tuple[str, ...], dict, list[tuple[str, Optional[float]]]]:
    """Resolve an attack schedule into round operands.

    Returns ``(families, operands, meta)``: ``operands`` holds
    ``attack_id (R,) int32`` (index into ``families``) and ``eta (R,)
    float32``; ``meta`` is the per-round ``(attack name, raw eta)`` the
    histories record.  Unset etas are 0.0, the fed loop's convention
    (only alie / foe read eta)."""
    families = schedule_families(schedule)
    index = {name: i for i, name in enumerate(families)}
    ids = np.empty((rounds,), np.int32)
    etas = np.empty((rounds,), np.float32)
    meta: list[tuple[str, Optional[float]]] = []
    for r in range(rounds):
        attack, eta = schedule.resolve(r)
        ids[r] = index[attack]
        etas[r] = 0.0 if eta is None else eta
        meta.append((attack, eta))
    return families, {"attack_id": ids, "eta": etas}, meta


def cadence_boundaries(rounds: int, *cadences: int) -> tuple[int, ...]:
    """Every round index where one of the cadences fires: the segments
    must END there so the host sees the state where a per-round loop
    would have evaluated it."""
    cuts: set[int] = set()
    for every in cadences:
        if every and every > 0:
            cuts.update(range(every, rounds + 1, every))
    return tuple(sorted(cuts))
