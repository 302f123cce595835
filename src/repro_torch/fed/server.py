"""Federated server, host part: the configuration, the cohort's Byzantine
budget and cohort sampling (counterpart of the host half of
``repro.fed.server``).  ``FedServer`` and ``run_rounds``, the
single-scenario engine, are not ported yet (ROADMAP queue 1, item 7);
the fleet (:mod:`repro_torch.fleet`) drives these pieces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np

from repro_torch.core.types import AggregatorSpec
from repro_torch.fed.clients import ClientConfig


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Static description of the federated system.  ``poison`` and
    ``guard`` (data poisoning, in-round quarantine) are accepted for
    parity with the reference's config and refused by the fleet until
    their ports land (ROADMAP queue 1, items 7 and 10)."""
    n_clients: int
    clients_per_round: int          # m <= n_clients
    f: int = 0                      # Byzantine clients in the POPULATION
    agg: AggregatorSpec = AggregatorSpec()
    client: ClientConfig = ClientConfig()
    track_kappa_hat: bool = True
    taps: bool = False
    poison: Optional[Any] = None
    guard: Optional[Any] = None

    def __post_init__(self):
        if not 0 < self.clients_per_round <= self.n_clients:
            raise ValueError("need 0 < clients_per_round <= n_clients")
        if self.f >= self.n_clients / 2:
            raise ValueError("population must be majority-honest (f < n/2)")


def cohort_breakdown(m: int) -> int:
    """Largest tolerable f for an m-row aggregation (f < m/2)."""
    return (m - 1) // 2


def rescale_f(f_total: int, n_total: int, m: int) -> int:
    """Byzantine budget of an m-client cohort sampled from (n_total,
    f_total): ceil(f_total * m / n_total), clipped to the cohort's
    breakdown point."""
    if f_total == 0:
        return 0
    return min(math.ceil(f_total * m / n_total), cohort_breakdown(m))


def sample_cohort(rng: np.random.Generator, n_clients: int, m: int,
                  byz_ids: np.ndarray, m_byz: int) -> np.ndarray:
    """Cohort ids, honest rows first, Byzantine rows LAST."""
    byz_ids = np.asarray(byz_ids)
    honest_ids = np.setdiff1d(np.arange(n_clients), byz_ids)
    h = rng.choice(honest_ids, size=m - m_byz, replace=False)
    b = rng.choice(byz_ids, size=m_byz, replace=False) if m_byz else \
        np.empty((0,), np.int64)
    return np.concatenate([np.sort(h), np.sort(b)]).astype(np.int32)
