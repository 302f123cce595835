"""Byzantine gradient attacks (paper §6.1 / Appendix 14.3).

Counterpart of ``repro.core.attacks`` for the non-adaptive families: every
attack produces the f Byzantine rows from the honest rows.  ALIE / FOE / SF
share ``B_t = sbar_t + eta * a_t`` with sbar_t the honest mean; mimic copies
the honest row most aligned with the honest stack's top principal
direction.  Label flipping acts through the data pipeline; ``lf`` is a
passthrough here.  The ``_opt`` eta line searches are still to be ported
(ROADMAP queue 1, item 3).

Two forms: the static one (:func:`apply_attack_tree`, a Python int f; per
round of a scheduled run :func:`apply_attack_scan`), and the lane-dynamic
one of the fleet (:func:`apply_attack_dyn`,
:func:`apply_attack_batched`): f and eta are tensors, one per lane, and the
honest statistics are taken under row masks.  The family of each lane is
known on the host from the round plan, so only the families present run.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.robust import tree_gram
from repro_torch.kernels.gram import gram_batched_ref, gram_ref
from repro_torch.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

Tensor = torch.Tensor

#: Families :func:`apply_attack_tree` runs.
STATIC_ATTACKS = ("none", "lf", "alie", "foe", "sf", "mimic", "nan", "inf")


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


def _mimic_target(g: Tensor) -> Tensor:
    """The mimic target from the honest Gram g (nh, nh): one power
    iteration of the centred Gram, seeded with its diagonal (the centred
    row energies; the ones vector lies in its null space)."""
    c = g - g.mean(0, keepdim=True) - g.mean(1, keepdim=True) + g.mean()
    v = c @ (c @ torch.diagonal(c))
    return torch.argmax(torch.abs(v))


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
    if name == "mimic":
        target = _mimic_target(tree_gram(tree_map(lambda l: l[:nh], tree)))

    def go(leaf):
        out = leaf.clone()
        if name == "mimic":
            byz = leaf[target].float()
        else:
            byz = byzantine_row(name, leaf[:nh].float(), eta=eta)
        out[nh:] = byz.to(leaf.dtype)
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
    if name == "mimic":
        g = sum(gram_ref(flat[:nh, off:off + size])
                for off, size in segments or [(0, flat.shape[1])])
        flat[nh:] = flat[_mimic_target(g)]
        return flat
    for off, size in segments or [(0, flat.shape[1])]:
        leaf = flat[:nh, off:off + size]
        finite = torch.isfinite(leaf).all(dim=1)
        for c0 in range(0, size, chunk):
            cols = slice(off + c0, off + min(c0 + chunk, size))
            byz = byzantine_row(name, flat[:nh, cols].float(), eta=eta,
                                finite=finite)
            flat[nh:, cols] = byz.to(flat.dtype)
    return flat


#: Families that read a per-round eta (the fed server's ``use_eta``).
ETA_ATTACKS = ("alie", "foe")


def check_static_families(families) -> None:
    """Raise for a family the static path does not run: the ``_opt`` eta
    searches (not ported yet) and unknown names."""
    for name in families:
        if name not in STATIC_ATTACKS:
            if name in ("alie_opt", "foe_opt"):
                raise NotImplementedError(
                    f"attack {name!r} is not ported yet (ROADMAP queue 1, "
                    "item 3)")
            raise ValueError(f"unknown attack {name!r}; ported: "
                             f"{STATIC_ATTACKS}")


def apply_attack_scan(families: tuple, attack_id: int, tree, f: int, *,
                      eta: Optional[float] = None,
                      segments: Optional[list] = None):
    """The attack of one round of a scheduled run (counterpart of the
    reference's ``apply_attack_scan``): ``families`` is the run's family
    tuple and ``attack_id`` this round's index into it, a host int (the
    reference's traced ``lax.switch`` index; the port picks the branch in
    Python).  The branch is :func:`apply_attack_tree` verbatim, with
    ``eta`` passed only to the families that read it (alie / foe).

    ``tree`` is a worker-stacked pytree (new leaves are returned), or,
    when ``segments`` is given, a flat (n, D) stack attacked in place
    (:func:`attack_flat_`)."""
    if f == 0 or not families:
        return tree
    check_static_families(families)
    name = families[int(attack_id)]
    eta = eta if name in ETA_ATTACKS else None
    if segments is not None:
        return attack_flat_(name, tree, f, eta=eta, segments=segments)
    return apply_attack_tree(name, tree, f, eta=eta)


# ---------------------------------------------------------------------------
# Lane-dynamic attacks (fleet engine): per-lane f and eta are tensors, the
# family a host int per lane.  Honest statistics use row masks
# (row < n - f) instead of static slices.  The ``_opt`` families are not
# lane-dynamic (their eta search re-runs the aggregator per grid point).
# ---------------------------------------------------------------------------

#: Branch order of the reference's ``apply_attack_dyn``; "lf" shares the
#: passthrough branch 0 with "none" (LF acts through the data pipeline).
DYN_ATTACK_FAMILIES = ("none", "alie", "foe", "sf", "mimic", "nan", "inf")


def dyn_attack_id(name: str) -> int:
    """Map an attack name to its lane-dynamic family index."""
    if name == "lf":
        return 0
    if name in ("alie_opt", "foe_opt"):
        raise ValueError(
            f"{name!r} is not lane-dynamic (its eta search re-runs the "
            "aggregator per grid point); run it through the static path")
    if name not in DYN_ATTACK_FAMILIES:
        raise ValueError(f"unknown attack {name!r}; lane-dynamic families: "
                         f"{DYN_ATTACK_FAMILIES} (+ 'lf')")
    return DYN_ATTACK_FAMILIES.index(name)


def _lane_view(v: Tensor, ndim: int) -> Tensor:
    """A (B,) or (B, n) tensor shaped to broadcast against (B, n, ...)."""
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.dim()))


def _finite_rows(h: Tensor) -> Tensor:
    """(B, n) bool: rows of a (B, n, ...) stack that are finite throughout."""
    return torch.isfinite(h.reshape(h.shape[0], h.shape[1], -1)).all(dim=2)


def _masked_moments(leaves: list, w: Tensor) -> list:
    """Per leaf of a lane-batched stack (B, n, ...), the (mean, std) over
    the rows where ``w`` (B, n) is 1, dropping rows that hold a non-finite
    entry in that leaf (count adjusted).  Rows are excluded by selection,
    not by multiplication (0 * nan = nan)."""
    stats = []
    for leaf in leaves:
        h = leaf.float()
        w_eff = w * _finite_rows(h).float()
        sel = _lane_view(w_eff > 0, h.dim())
        cnt = _lane_view(torch.clamp_min(w_eff.sum(dim=1), 1.0), h.dim() - 1)
        mean = torch.where(sel, h, 0.0).sum(dim=1) / cnt
        var = torch.where(sel, (h - mean[:, None]) ** 2, 0.0).sum(dim=1) / cnt
        stats.append((mean, torch.sqrt(var)))
    return stats


def _mimic_rows(leaves: list, stats: list, w: Tensor) -> list:
    """Per leaf, the (B, ...) row each lane's mimic copies: the honest row
    most aligned with the top principal direction of the masked, centred
    honest stack (one power iteration in coefficient space)."""
    c = None
    for leaf, (mean, _) in zip(leaves, stats):
        h = leaf.float()
        keep = _lane_view((w * _finite_rows(h).float()) > 0, h.dim())
        centered = torch.where(keep, h - mean[:, None], 0.0)
        g = gram_batched_ref(centered.reshape(h.shape[0], h.shape[1], -1))
        c = g if c is None else c + g
    diag = torch.diagonal(c, dim1=-2, dim2=-1)
    v = (c @ (c @ diag[..., None]))[..., 0]
    target = torch.argmax(torch.abs(v) * w, dim=1)
    lanes = torch.arange(w.shape[0], device=w.device)
    return [leaf.float()[lanes, target] for leaf in leaves]


def apply_attack_batched(attack_ids, tree, fs, *, etas,
                         lane_ids: Optional[Tensor] = None):
    """Lane-batched attack: every leaf carries a leading LANE axis (B, n,
    ...); ``attack_ids`` (B host ints, :data:`DYN_ATTACK_FAMILIES`
    indices), ``fs`` (B,) int and ``etas`` (B,) float are per lane.  Rows
    >= n - f of lane b become its family's Byzantine vector; lanes of the
    passthrough family and f = 0 are left as they are.  Only the families
    present are computed (each over all lanes, then selected by lane).
    ``lane_ids``: the same ids already on the stack's device (saves a
    host-to-device copy, which waits for the device, in a round loop)."""
    ids = [int(a) for a in attack_ids]
    for a in ids:
        if not 0 <= a < len(DYN_ATTACK_FAMILIES):
            raise ValueError(f"attack id {a} out of range of "
                             f"{DYN_ATTACK_FAMILIES}")
    leaves = tree_leaves(tree)
    present = sorted(set(ids) - {0})
    if not present:
        return tree
    dev = leaves[0].device
    b, n = leaves[0].shape[:2]
    f = torch.as_tensor(fs, device=dev).to(torch.int64).reshape(b)
    eta = torch.as_tensor(etas, device=dev).float().reshape(b)
    row = torch.arange(n, device=dev)
    nh = n - f
    w = (row[None] < nh[:, None]).float()
    if lane_ids is None:
        lane_ids = torch.tensor(ids, device=dev)
    stats = _masked_moments(leaves, w) if any(
        a in (1, 2, 3, 4) for a in present) else None
    byz = [torch.zeros((b,) + tuple(l.shape[2:]), dtype=torch.float32,
                       device=dev) for l in leaves]
    for a in present:
        name = DYN_ATTACK_FAMILIES[a]
        if name == "alie":
            vals = [m + _lane_view(eta, m.dim()) * sd for m, sd in stats]
        elif name == "foe":
            vals = [(1.0 - _lane_view(eta, m.dim())) * m for m, _ in stats]
        elif name == "sf":
            vals = [-m for m, _ in stats]
        elif name == "mimic":
            vals = _mimic_rows(leaves, stats, w)
        else:
            fill = float("nan") if name == "nan" else float("inf")
            vals = [torch.full_like(v, fill) for v in byz]
        here = lane_ids == a
        byz = [torch.where(_lane_view(here, v.dim()), v, cur)
               for v, cur in zip(vals, byz)]
    rows = (row[None] >= nh[:, None]) & (lane_ids != 0)[:, None]
    out = [torch.where(_lane_view(rows, leaf.dim()), v[:, None],
                       leaf.float()).to(leaf.dtype)
           for leaf, v in zip(leaves, byz)]
    return tree_unflatten(tree_structure(tree), out)


def apply_attack_dyn(attack_id: int, tree, f, *, eta):
    """One lane of :func:`apply_attack_batched`: leaves (n, ...), a host
    family index, an int (tensor) f and a float (tensor) eta."""
    lanes = tree_map(lambda leaf: leaf[None], tree)
    out = apply_attack_batched([attack_id], lanes, torch.as_tensor(f).reshape(1),
                               etas=torch.as_tensor(eta).reshape(1))
    return tree_map(lambda leaf: leaf[0], out)
