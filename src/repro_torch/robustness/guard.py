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
    ``info = {"mask": (n,) float32 (1 = quarantined), "count": int32}``.

    The replacement runs on every call and keeps the original rows through
    ``torch.where`` (the reference branches with ``lax.cond``; an
    unconditional select needs no host sync and is the same bitwise: a
    clean stack comes back bit for bit).  Its sorts rank NaN last on the
    card too (``sort_nan_last``)."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    dev = leaves[0].device

    finite = torch.ones((n,), dtype=torch.bool, device=dev)
    sq = torch.zeros((n,), dtype=torch.float32, device=dev)
    for leaf in leaves:
        h = leaf.float().reshape(n, -1)
        ok = torch.isfinite(h)
        finite = finite & ok.all(dim=1)
        # A non-finite row still gets a finite sq, so the median of the
        # finite rows below stays well defined.
        sq = sq + (torch.where(ok, h, 0.0) ** 2).sum(dim=1)

    bad = ~finite
    if cfg.norm_factor:
        srt = sort_nan_last(torch.where(finite, sq, float("inf")), 0)
        cnt = finite.to(torch.int32).sum()
        med = srt.index_select(0, torch.clamp_min((cnt - 1) // 2, 0)
                               .reshape(1).long())[0]
        # med = +inf when no row is finite: the screen is then vacuous.
        bad = bad | (finite & (sq > cfg.norm_factor ** 2 * med))

    keep = ~bad
    kept = keep.to(torch.int32).sum()
    mid = torch.clamp_min((kept - 1) // 2, 0).reshape(1).long()
    out = []
    for leaf in leaves:
        x = leaf.float()
        sel = keep.reshape((-1,) + (1,) * (x.dim() - 1))
        # Lower median of the kept rows: +inf sentinels push the
        # quarantined rows past the midpoint index.
        ys = sort_nan_last(torch.where(sel, x, float("inf")), 0)
        fallback = ys.index_select(0, mid)[0]
        fallback = torch.where(torch.isfinite(fallback), fallback, 0.0)
        out.append(torch.where(sel, x, fallback).to(leaf.dtype))

    info = {"mask": bad.float(), "count": bad.sum(dtype=torch.int32)}
    return tree_unflatten(tree_structure(tree), out), info
