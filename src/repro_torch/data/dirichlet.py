"""Dirichlet-alpha heterogeneity partitioning (paper §6.1 / Appendix 14.4).

Given class-labeled data, worker i's class distribution is a draw
p_i ~ Dir(alpha * 1_C); samples are assigned accordingly.  Small alpha
(0.1) = extreme heterogeneity (workers see ~one class); alpha = 10 is near
IID.  The same mechanism skews token *topics* for the LM corpora.
"""
from __future__ import annotations

import numpy as np


def dirichlet_proportions(n_workers: int, n_classes: int, alpha: float,
                          seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.dirichlet([alpha] * n_classes, size=n_workers)  # (W, C)


def partition_by_class(labels: np.ndarray, n_workers: int, alpha: float,
                       seed: int = 0) -> list[np.ndarray]:
    """Index lists per worker, sampled by per-worker Dirichlet class mixes.

    Every worker receives the same number of samples (len // n_workers) so
    worker batches stay rectangular; surplus indices are dropped.
    """
    rng = np.random.default_rng(seed)
    props = dirichlet_proportions(n_workers, int(labels.max()) + 1, alpha, seed)
    by_class = [list(rng.permutation(np.where(labels == c)[0]))
                for c in range(int(labels.max()) + 1)]
    per_worker = len(labels) // n_workers
    out = []
    for w in range(n_workers):
        want = rng.multinomial(per_worker, props[w])
        idx: list[int] = []
        for c, k in enumerate(want):
            take = min(k, len(by_class[c]))
            idx.extend(by_class[c][:take])
            by_class[c] = by_class[c][take:]
        # Backfill from whatever classes still have data.
        while len(idx) < per_worker:
            for c in np.argsort([-len(b) for b in by_class]):
                if by_class[c]:
                    idx.append(by_class[c].pop())
                    if len(idx) == per_worker:
                        break
        out.append(np.asarray(idx[:per_worker]))
    return out


def heterogeneity_g2(grads: np.ndarray) -> float:
    """Empirical G^2 of Assumption 1 from a stack of per-worker gradients."""
    mean = grads.mean(axis=0)
    return float(np.mean(np.sum((grads - mean) ** 2, axis=-1)))
