"""In-round robustness health taps: per-round aggregator diagnostics
(counterpart of ``repro.obs.taps``).

The paper's mechanism is *mixing* (NNM, Alg. 2): honest workers absorb
Byzantine influence by averaging their n-f nearest neighbours, and the
robust output should track the honest mean up to the heterogeneity
floor.  :func:`health_taps` computes, after a round's deployed aggregate:

* ``dist_honest`` — ||R - mean(honest)||, the quantity Theorem 1 bounds
  by kappa' G^2;
* ``cos_honest`` — the cosine of R against the honest mean;
* ``neighbor_count`` — per worker j, how many NNM rows selected j;
* ``mix_mass`` — per-worker column mass of the row-stochastic NNM matrix
  over n (sums to 1); ``byz_mix_mass`` / ``honest_mix_mass`` split it by
  the honest-first row convention;
* ``trim_frac`` — for cwtm (with or without NNM), the fraction of
  coordinates on which row i of the (mixed) stack lies outside the kept
  band ``[sorted[f], sorted[n-1-f]]``;
* ``quarantined_*`` — the guard's screen, split honest / Byzantine.

Taps are side outputs computed with torch ops (the reference computes
them in plain ``jnp``, outside any Pallas kernel): a tapped round equals
an untapped one bit for bit.  Their tensors stay on the device and ride
the round's metrics as ``taps.<field>`` columns (:func:`tap_metrics`), so
they reach the host in the round engine's one transfer.

They reuse what the round already computed: the aggregation's
``internals`` (:func:`repro_torch.core.robust.robust_aggregate`) give the
NNM matrix and, on the torch backend, the mixed and sorted stacks; the
kappa-hat pass gives ||R - mbar||^2, R . mbar and ||mbar||^2.  The kernel
backend (K2 / K4) writes neither a mixed nor a sorted stack, so the trim
taps recompute the mix and the sort :data:`TAP_CHUNK` columns at a time
and never hold a full-width copy; each row's trimmed coordinates are
counted in int64 (exact at any width; the reference's fp32 sum is exact
below 2^24 coordinates a leaf) and divided once.

:func:`health_taps_lanes` is the fleet's lane form: leaves (B, n, ...),
``f`` and ``n_honest`` (B,) device tensors, the reference's ``dyn=True``
taps under ``vmap``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import gram as gramlib
from repro_torch.core import robust as robust_lib
from repro_torch.kernels._common import sort_nan_last
from repro_torch.tree import tree_leaves

PyTree = Any
Tensor = torch.Tensor

_EPS = 1e-20

#: Columns per chunk of the trim taps' recomputed mix and sort.
TAP_CHUNK = 1 << 22


class HealthTaps(NamedTuple):
    """Per-round robustness diagnostics; a field whose precondition is not
    met (no NNM, not a trim rule, no guard) is ``None``."""
    dist_honest: Any                        # ||R - honest mean||
    cos_honest: Any                         # cos(R, honest mean)
    neighbor_count: Optional[Any] = None    # (n,) NNM selections of worker j
    mix_mass: Optional[Any] = None          # (n,) share of the mix weight
    byz_mix_mass: Optional[Any] = None      # sum over the Byzantine rows
    honest_mix_mass: Optional[Any] = None   # sum over the honest rows
    trim_frac: Optional[Any] = None         # (n,) trimmed-coordinate share
    quarantined_count: Optional[Any] = None       # rows the guard replaced
    quarantine_mask_honest: Optional[Any] = None  # (n,) quarantined & honest
    quarantine_mask_byz: Optional[Any] = None     # (n,) quarantined & byz

    def to_dict(self) -> dict:
        """The present fields only."""
        return {k: v for k, v in self._asdict().items() if v is not None}


TAP_FIELDS = HealthTaps._fields


def tap_metrics(taps: HealthTaps) -> dict:
    """``{"taps.<field>": tensor}``: the taps as round metric columns."""
    return {f"taps.{k}": v for k, v in taps.to_dict().items()}


def tap_columns(cols: dict) -> dict:
    """The ``taps.<field>`` entries of a metrics dict, keyed by field."""
    return {k[len("taps."):]: v for k, v in cols.items()
            if k.startswith("taps.")}


def _trim_counts(leaves: list, m: Optional[Tensor], f: Tensor,
                 mixed: Optional[list], sorted_leaves: Optional[list]
                 ) -> tuple[Tensor, int]:
    """(B, n) int64 counts of the coordinates each row of the mixed stack
    has outside its lane's kept band, and the coordinate count.  The mixed
    and sorted stacks are read from ``mixed`` / ``sorted_leaves`` when the
    aggregation kept them, else rebuilt a :data:`TAP_CHUNK`-column chunk at
    a time (``m`` rounded to the leaf's dtype, as the mix rounds it)."""
    b, n = leaves[0].shape[:2]
    dev = leaves[0].device
    cnt = torch.zeros((b, n), dtype=torch.int64, device=dev)
    lo_idx = f.reshape(b, 1, 1)
    hi_idx = (n - 1 - f).reshape(b, 1, 1)
    total = 0
    for i, leaf in enumerate(leaves):
        x = leaf.reshape(b, n, -1)
        y_all = None if mixed is None else mixed[i].reshape(b, n, -1)
        s_all = None if sorted_leaves is None \
            else sorted_leaves[i].reshape(b, n, -1)
        d = x.shape[2]
        total += d
        for c0 in range(0, d, TAP_CHUNK):
            c1 = min(c0 + TAP_CHUNK, d)
            if y_all is not None:
                y = y_all[..., c0:c1].float()
            elif m is None:
                y = x[..., c0:c1].float()
            else:
                y = m.to(x.dtype).float() @ x[..., c0:c1].float()
            ys = sort_nan_last(y, 1) if s_all is None \
                else s_all[..., c0:c1].float()
            w = c1 - c0
            lo = ys.gather(1, lo_idx.expand(b, 1, w))
            hi = ys.gather(1, hi_idx.expand(b, 1, w))
            cnt += ((y < lo) | (y > hi)).sum(dim=2)
            del y, ys
    return cnt, total


def _honest_moments(leaves: list, r_leaves: list, n_honest: Tensor,
                    internals: dict, reduce) -> tuple[Tensor, Tensor, Tensor]:
    """(B,) ||R - mbar||^2, R . mbar and ||mbar||^2: the kappa-hat pass's,
    when it stashed them, else one masked pass of its own (the reference's
    standalone form: a non-finite Byzantine row spreads NaN), summed over
    the column blocks by ``reduce``."""
    if "honest_sq_dist" not in internals:
        from repro_torch.training.trainer import kappa_hat_masked
        internals = {}
        kappa_hat_masked(r_leaves, leaves, n_honest, internals=internals)
        return tuple(reduce(internals[k]) for k in
                     ("honest_sq_dist", "honest_dot", "honest_mean_sq"))
    return (internals["honest_sq_dist"], internals["honest_dot"],
            internals["honest_mean_sq"])


def _no_reduce(t: Tensor) -> Tensor:
    return t


def _lane_internals(internals: Optional[dict]) -> dict:
    """A static aggregate's internals with a lane axis of one."""
    out = {}
    for k, v in (internals or {}).items():
        out[k] = [t[None] for t in v] if isinstance(v, list) else v[None]
    return out


def health_taps_lanes(stack: PyTree, aggregate: PyTree, *, n_honest, f,
                      rule: str, pre: Optional[str],
                      internals: Optional[dict] = None,
                      quarantine: Optional[dict] = None,
                      static_f: Optional[int] = None,
                      reduce=None) -> HealthTaps:
    """The taps of every lane: ``stack`` leaves (B, n, ...), ``aggregate``
    leaves (B, ...), ``n_honest`` and ``f`` (B,) int tensors (never read
    on the host).  ``internals`` is what
    :func:`~repro_torch.core.robust.batched_robust_aggregate` and
    :func:`~repro_torch.training.kappa_hat_masked` filled (lane-stacked);
    ``quarantine`` the lane guard's info (``mask`` (B, n), ``count``
    (B,)).  Fields come back (B,) or (B, n).  ``static_f`` (the static
    form's int f) rebuilds a missing NNM matrix with the static rule and
    skips the trim taps' work when it is 0.

    NNM taps need ``pre == "nnm"``; trim taps ``rule == "cwtm"`` with pre
    None or "nnm" (under bucketing the trim acts on bucket means).

    ``reduce`` (the sharded trainer): the leaves are one column block of
    the stack and the aggregate, and ``reduce(t)`` sums ``t`` over the
    blocks (the kappa-hat sums in ``internals`` are summed already)."""
    internals = internals if internals is not None else {}
    reduce = reduce or _no_reduce
    leaves = tree_leaves(stack)
    r_leaves = tree_leaves(aggregate)
    b, n = leaves[0].shape[:2]
    dev = leaves[0].device
    nh = torch.as_tensor(n_honest, device=dev).reshape(b)
    fl = torch.as_tensor(f, device=dev).to(torch.int64).reshape(b)
    w = (torch.arange(n, device=dev)[None] < nh[:, None]).float()

    d2, dot, hsq = _honest_moments(leaves, r_leaves, nh, internals, reduce)
    nr = reduce(sum(torch.sum((r.float() ** 2).reshape(b, -1), dim=1)
                    for r in r_leaves))
    taps: dict[str, Any] = {
        "dist_honest": torch.sqrt(d2),
        "cos_honest": dot / (torch.sqrt(nr) * torch.sqrt(hsq) + _EPS)}

    if quarantine is not None:
        qm = quarantine["mask"].float()
        taps["quarantined_count"] = quarantine["count"].float()
        taps["quarantine_mask_honest"] = qm * w
        taps["quarantine_mask_byz"] = qm * (1.0 - w)

    m = None
    if pre == "nnm":
        m = internals.get("mix_matrix")
        if m is None:           # standalone: rebuild it from the stack
            if static_f is not None:
                g = robust_lib.tree_gram([leaf[0] for leaf in leaves])
                m = gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(g),
                                       static_f)[None]
            else:
                g = robust_lib.tree_gram_lanes(leaves)
                m = gramlib.nnm_matrix_dyn(gramlib.pdist_sq_from_gram(g), fl)
        col = m.sum(dim=1) / float(n)           # row-stochastic: sums to 1
        taps["neighbor_count"] = (m > 0).float().sum(dim=1)
        taps["mix_mass"] = col
        taps["byz_mix_mass"] = (col * (1.0 - w)).sum(dim=1)
        taps["honest_mix_mass"] = (col * w).sum(dim=1)

    if rule == "cwtm" and pre in (None, "nnm"):
        if static_f == 0:
            # A plain mean: nothing is trimmed.
            taps["trim_frac"] = torch.zeros((b, n), dtype=torch.float32,
                                            device=dev)
        else:
            cnt, total = _trim_counts(leaves, m, fl, internals.get("mixed"),
                                      internals.get("sorted_leaves"))
            if reduce is not _no_reduce:
                cnt = reduce(cnt)
                total = int(reduce(torch.tensor(total, device=dev)))
            taps["trim_frac"] = cnt.float() / float(total)
    return HealthTaps(**taps)


def health_taps(stack: PyTree, aggregate: PyTree, *, n_honest: int, f: int,
                rule: str, pre: Optional[str],
                internals: Optional[dict] = None,
                quarantine: Optional[dict] = None,
                reduce=None) -> HealthTaps:
    """The taps of one round: ``stack`` the post-attack (and post-guard)
    worker-stacked pytree the aggregator consumed (honest rows first),
    ``aggregate`` its output; ``n_honest`` and ``f`` ints.
    ``internals`` is the dict :func:`~repro_torch.core.robust.
    robust_aggregate` and :func:`~repro_torch.core.theory.tree_kappa_hat`
    filled (``mix_matrix``, ``mixed``, ``sorted_leaves``,
    ``honest_sq_dist``, ``honest_dot``, ``honest_mean_sq``); without it
    the taps recompute what they need from ``stack``.  ``quarantine`` is
    the guard's info (``mask`` (n,), ``count``)."""
    lane_q = None if quarantine is None else {
        "mask": quarantine["mask"][None],
        "count": torch.as_tensor(quarantine["count"]).reshape(1)}
    out = health_taps_lanes(
        [leaf[None] for leaf in tree_leaves(stack)],
        [r[None] for r in tree_leaves(aggregate)],
        n_honest=torch.tensor([n_honest]), f=torch.tensor([f]), rule=rule,
        pre=pre, internals=_lane_internals(internals), quarantine=lane_q,
        static_f=int(f), reduce=reduce)
    return HealthTaps(**{k: v[0] for k, v in out.to_dict().items()})
