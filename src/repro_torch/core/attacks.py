"""Byzantine gradient attacks (paper §6.1 / Appendix 14.3), static f.

Counterpart of ``repro.core.attacks`` for the non-adaptive families: every
attack produces the f Byzantine rows from the honest rows.  ALIE / FOE / SF
share ``B_t = sbar_t + eta * a_t`` with sbar_t the honest mean.  Label
flipping acts through the data pipeline; ``lf`` is a passthrough here.
mimic and the ``_opt`` eta line searches are still to be ported (ROADMAP
queue 1, item 3).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor

#: Families :func:`apply_attack_tree` runs.
STATIC_ATTACKS = ("none", "lf", "alie", "foe", "sf", "nan", "inf")


def _finite_moments(h: Tensor, finite: Optional[Tensor] = None
                    ) -> tuple[Tensor, Tensor]:
    """Coordinate-wise (mean, std) of an fp32 stack, excluding rows that
    hold a non-finite entry, so a nan/inf worker cannot poison the
    moment-based attacks.  When every row is finite the plain mean / std
    (ddof 0) are used, as in the reference.  ``finite`` is the (rows,)
    finite-row mask when the caller computed it over a wider leaf than
    ``h`` (a column chunk of it)."""
    if finite is None:
        finite = torch.isfinite(h.reshape(h.shape[0], -1)).all(dim=1)
    if bool(finite.all()):
        return h.mean(dim=0), h.std(dim=0, correction=0)
    sel = finite.reshape((-1,) + (1,) * (h.ndim - 1))
    cnt = torch.clamp_min(finite.float().sum(), 1.0)
    mean = torch.where(sel, h, 0.0).sum(dim=0) / cnt
    var = torch.where(sel, (h - mean) ** 2, 0.0).sum(dim=0) / cnt
    return mean, torch.sqrt(var)


def byzantine_row(name: str, honest: Tensor, *,
                  eta: Optional[float] = None,
                  finite: Optional[Tensor] = None) -> Tensor:
    """The one Byzantine vector of a coordinate-wise family, computed from
    an fp32 honest stack (nh, ...) -> (...); ``finite`` as in
    :func:`_finite_moments`."""
    if name in ("nan", "inf"):
        fill = float("nan") if name == "nan" else float("inf")
        return torch.full(honest.shape[1:], fill, dtype=torch.float32,
                          device=honest.device)
    if name == "alie":
        mean, std = _finite_moments(honest, finite)
        return mean + (1.0 if eta is None else eta) * std
    if name in ("foe", "sf"):
        e = 2.0 if name == "sf" or eta is None else eta
        return (1.0 - e) * _finite_moments(honest, finite)[0]
    raise ValueError(f"unknown attack {name!r}; ported: {STATIC_ATTACKS}")


def apply_attack_tree(name: str, tree, f: int, *,
                      eta: Optional[float] = None):
    """Attacked worker-stacked pytree (worker axis leading on every leaf):
    the last f rows of every leaf become the family's Byzantine vector.
    Returns new leaves; ``tree`` is left untouched."""
    if f == 0 or name in ("none", "lf"):
        return tree
    if name not in STATIC_ATTACKS:
        raise NotImplementedError(
            f"attack {name!r} is not ported yet (ROADMAP queue 1, item 3); "
            f"ported: {STATIC_ATTACKS}")
    n = tree_leaves(tree)[0].shape[0]
    nh = n - f

    def go(leaf):
        out = leaf.clone()
        out[nh:] = byzantine_row(name, leaf[:nh].float(), eta=eta).to(leaf.dtype)
        return out

    return tree_map(go, tree)


def attack_flat_(name: str, flat: Tensor, f: int, *,
                 eta: Optional[float] = None,
                 segments: Optional[list] = None,
                 chunk: int = 1 << 24) -> Tensor:
    """In-place form of :func:`apply_attack_tree` on a flat (n, D) stack
    whose leaves occupy the column ``segments`` [(offset, size), ...]
    (one leaf spanning D when None).

    The families are coordinate-wise, so each leaf is processed in column
    chunks of ``chunk`` (temporaries stay at (n, chunk)); the finite-row
    test of :func:`_finite_moments` is taken over the whole leaf, as the
    reference takes it."""
    if f == 0 or name in ("none", "lf"):
        return flat
    if name not in STATIC_ATTACKS:
        raise NotImplementedError(
            f"attack {name!r} is not ported yet (ROADMAP queue 1, item 3); "
            f"ported: {STATIC_ATTACKS}")
    nh = flat.shape[0] - f
    for off, size in segments or [(0, flat.shape[1])]:
        leaf = flat[:nh, off:off + size]
        finite = torch.isfinite(leaf).all(dim=1)
        for c0 in range(0, size, chunk):
            cols = slice(off + c0, off + min(c0 + chunk, size))
            byz = byzantine_row(name, flat[:nh, cols].float(), eta=eta,
                                finite=finite)
            flat[nh:, cols] = byz.to(flat.dtype)
    return flat
