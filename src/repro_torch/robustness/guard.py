"""In-round gradient quarantine: graceful degradation for faulty workers
(counterpart of ``repro.robustness.guard``).

The guard screens the worker stack inside the round, before aggregation:

* non-finite rows (any nan / inf entry in any leaf) are always
  quarantined;
* rows whose global norm exceeds ``norm_factor`` times the median
  finite-row norm are quarantined (compared in squared space; 0 disables
  this screen);
* quarantined rows are replaced by the coordinate-wise lower median of
  the kept rows, an inlier by construction, so the aggregator sees a
  well-formed stack.

Quarantined rows still count against the f budget: the round's metrics
carry ``quarantined_count`` and the server emits an ``obs.runtime``
``robustness.quarantine`` event per run.  On a round where no screen
fires the guard is a bitwise no-op on the stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels._common import sort_nan_last
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """Static guard description.  ``norm_factor``: quarantine rows whose
    global norm exceeds this multiple of the median finite-row norm; 0.0
    disables the norm screen (non-finite screening is always on)."""

    norm_factor: float = 10.0

    def __post_init__(self):
        if self.norm_factor < 0:
            raise ValueError(f"norm_factor must be >= 0, got "
                             f"{self.norm_factor}")


def quarantine_stack(tree: PyTree, cfg: QuarantineConfig
                     ) -> tuple[PyTree, dict]:
    """Screen a worker-stacked pytree; returns (screened tree, info) with
    ``info = {"mask": (n,) float32 (1 = quarantined), "count": int32}``:
    :func:`quarantine_stack_lanes` on one lane."""
    leaves = tree_leaves(tree)
    out, info = quarantine_stack_lanes([leaf[None] for leaf in leaves], cfg)
    return (tree_unflatten(tree_structure(tree), [o[0] for o in out]),
            {"mask": info["mask"][0], "count": info["count"][0]})


def quarantine_stack_lanes(tree: PyTree, cfg: QuarantineConfig
                           ) -> tuple[PyTree, dict]:
    """The guard on a lane axis: leaves (B, n, ...), each lane screened on
    its own (its median norm, its kept-row median); ``info = {"mask": (B,
    n) float32, "count": (B,) int32}``.  The fleet runs it on the attacked
    lane stack, as the reference vmaps the one-stack guard.

    The replacement runs on every call and keeps the original rows through
    ``torch.where`` (the reference branches with ``lax.cond``; an
    unconditional select needs no host sync and is the same bitwise: a
    clean stack comes back bit for bit).  Its sorts rank NaN last on the
    card too (``sort_nan_last``)."""
    leaves = tree_leaves(tree)
    nl, n = leaves[0].shape[:2]
    dev = leaves[0].device

    finite = torch.ones((nl, n), dtype=torch.bool, device=dev)
    sq = torch.zeros((nl, n), dtype=torch.float32, device=dev)
    for leaf in leaves:
        h = leaf.float().reshape(nl, n, -1)
        ok = torch.isfinite(h)
        finite = finite & ok.all(dim=2)
        # A non-finite row still gets a finite sq, so the median of the
        # finite rows below stays well defined.
        sq = sq + (torch.where(ok, h, 0.0) ** 2).sum(dim=2)

    bad = ~finite
    if cfg.norm_factor:
        srt = sort_nan_last(torch.where(finite, sq, float("inf")), 1)
        cnt = finite.to(torch.int32).sum(dim=1)
        med = srt.gather(1, torch.clamp_min((cnt - 1) // 2, 0)
                         .long()[:, None])
        # med = +inf when no row is finite: the screen is then vacuous.
        bad = bad | (finite & (sq > cfg.norm_factor ** 2 * med))

    keep = ~bad
    kept = keep.to(torch.int32).sum(dim=1)
    mid = torch.clamp_min((kept - 1) // 2, 0).long()
    out = []
    for leaf in leaves:
        x = leaf.float()
        sel = keep.reshape((nl, n) + (1,) * (x.dim() - 2))
        # Lower median of the kept rows: +inf sentinels push the
        # quarantined rows past the midpoint index.
        ys = sort_nan_last(torch.where(sel, x, float("inf")), 1)
        idx = mid.reshape((nl, 1) + (1,) * (x.dim() - 2)).expand(
            (nl, 1) + tuple(x.shape[2:]))
        fallback = ys.gather(1, idx)
        fallback = torch.where(torch.isfinite(fallback), fallback, 0.0)
        out.append(torch.where(sel, x, fallback).to(leaf.dtype))

    info = {"mask": bad.float(), "count": bad.sum(dim=1, dtype=torch.int32)}
    return tree_unflatten(tree_structure(tree), out), info
