"""Byzantine gradient attacks (paper §6.1 / Appendix 14.3).

Counterpart of ``repro.core.attacks``: every attack produces the f
Byzantine rows from the honest rows.  ALIE / FOE / SF share ``B_t =
sbar_t + eta * a_t`` with sbar_t the honest mean; mimic copies the honest
row most aligned with the honest stack's top principal direction; nan /
inf model faulty workers.  The optimized variants ``alie_opt`` /
``foe_opt`` (the paper's optimized ALIE / FOE protocol) grid-search eta
over :data:`_ETA_GRID` for the largest ||F(attacked) - honest mean||^2,
F being the deployed aggregator, passed as ``agg_closure`` (the attacker
is omniscient).  Label flipping acts through the data pipeline; ``lf`` is
a passthrough here.

Three forms: the dense API on one (n - f, d) honest stack
(:func:`apply_attack`, :data:`ATTACKS`), the static one over
worker-stacked pytrees (:func:`apply_attack_tree`, a Python int f; in
place on a flat (n, D) stack :func:`attack_flat_`; per round of a
scheduled run :func:`apply_attack_scan`), and the lane-dynamic one of the
fleet (:func:`apply_attack_dyn`, :func:`apply_attack_batched`): f and eta
are tensors, one per lane, and the honest statistics are taken under row
masks.  The family of each lane is known on the host from the round
plan, so only the families present run.  The eta searches are static
only, as in the reference.

The chosen eta of a search stays a 0-d device tensor (no host read), the
first largest damage winning, a NaN damage counting as the largest
(``torch.argmax``, as ``jnp.argmax``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.robust import tree_gram
from repro_torch.core.types import ATTACKS as ATTACK_NAMES
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.gram import gram_batched_ref, gram_ref
from repro_torch.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

Tensor = torch.Tensor

#: eta grid of the optimized attacks (log-ish spacing around the published
#: sweet spots), the reference's.
_ETA_GRID = (0.05, 0.1, 0.2, 0.5, 0.8, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0, 20.0)

#: Column chunk of :func:`attack_flat_`.
ATTACK_CHUNK = 1 << 24


def _finite_moments(h: Tensor, finite: Optional[Tensor] = None,
                    all_finite: Optional[bool] = None, with_std: bool = True
                    ) -> tuple[Tensor, Optional[Tensor]]:
    """Coordinate-wise (mean, std) of an fp32 stack, excluding rows that
    hold a non-finite entry, so a nan/inf worker cannot poison the
    moment-based attacks.  When every row is finite the plain mean / std
    (ddof 0) are used, as in the reference.  ``finite`` is the (rows,)
    finite-row mask when the caller computed it over a wider leaf than
    ``h`` (a column chunk of it), ``all_finite`` its ``all()`` when the
    caller has read it already; the std is None without ``with_std``."""
    if finite is None:
        finite = torch.isfinite(h.reshape(h.shape[0], -1)).all(dim=1)
    if all_finite is None:
        all_finite = bool(finite.all())
    if all_finite:
        return h.mean(dim=0), (h.std(dim=0, correction=0) if with_std
                               else None)
    sel = finite.reshape((-1,) + (1,) * (h.ndim - 1))
    cnt = torch.clamp_min(finite.float().sum(), 1.0)
    mean = torch.where(sel, h, 0.0).sum(dim=0) / cnt
    if not with_std:
        return mean, None
    var = torch.where(sel, (h - mean) ** 2, 0.0).sum(dim=0) / cnt
    return mean, torch.sqrt(var)


# ---------------------------------------------------------------------------
# The dense API: one honest (n - f, d) stack -> the attacked (n, d) stack.
# ---------------------------------------------------------------------------

def _mean_std(honest: Tensor) -> tuple[Tensor, Tensor]:
    return _finite_moments(honest.float())


def _rows(byz: Tensor, f: int) -> Tensor:
    return byz.expand((f,) + tuple(byz.shape))


def alie(honest: Tensor, f: int, eta=1.0, **_) -> Tensor:
    """A Little Is Enough: sbar + eta * coordinate-wise std."""
    mean, std = _mean_std(honest)
    return _rows(mean + eta * std, f)


def foe(honest: Tensor, f: int, eta=2.0, **_) -> Tensor:
    """Fall of Empires: (1 - eta) * sbar  (a_t = -sbar)."""
    mean, _ = _mean_std(honest)
    return _rows((1.0 - eta) * mean, f)


def sign_flip(honest: Tensor, f: int, **_) -> Tensor:
    """Sign flipping: B_t = -sbar (FOE with eta = 2)."""
    return foe(honest, f, eta=2.0)


def mimic(honest: Tensor, f: int, *, target=None, **_) -> Tensor:
    """Mimic: all Byzantine workers copy one honest worker, the one most
    aligned with the top principal direction of the centred honest stack
    by one power iteration in STACK space, seeded with the per-coordinate
    energy (the dense form; the pytree form iterates in Gram space).
    ``target`` overrides with an explicit worker index."""
    h = honest.float()
    if target is None:
        centered = h - h.mean(dim=0, keepdim=True)
        v = (centered ** 2).sum(dim=0)
        v = centered.T @ (centered @ v)
        norm = torch.linalg.vector_norm(v) + 1e-12
        target = torch.argmax(torch.abs(centered @ (v / norm)))
    return _rows(h[target], f)


def nan_rows(honest: Tensor, f: int, **_) -> Tensor:
    """Non-finite fault family: f rows of NaN."""
    return _rows(torch.full(honest.shape[1:], float("nan"),
                            dtype=torch.float32, device=honest.device), f)


def inf_rows(honest: Tensor, f: int, **_) -> Tensor:
    """f rows of +inf (fp overflow fault)."""
    return _rows(torch.full(honest.shape[1:], float("inf"),
                            dtype=torch.float32, device=honest.device), f)


def _pick(etas: Tensor, damages: Tensor) -> Tensor:
    """The eta of the largest damage, a 0-d tensor on the device (no host
    read): ``torch.argmax`` takes the first maximum and counts NaN as the
    maximum, as ``jnp.argmax`` does."""
    return etas.gather(0, torch.argmax(damages).reshape(1)).reshape(())


def _grid(device) -> Tensor:
    return torch.tensor(_ETA_GRID, dtype=torch.float32, device=device)


def _optimized(base: Callable, honest: Tensor, f: int,
               agg_closure: Callable, **kw) -> Tensor:
    """Grid-search eta maximizing ||F(attacked) - honest mean||^2, F the
    deployed aggregator ``agg_closure``: (n, d) stack -> (d,)."""
    h = honest.float()
    mean = h.mean(dim=0)
    etas = _grid(honest.device)
    damages = torch.stack([
        torch.sum((agg_closure(torch.cat([h, base(honest, f, eta=etas[i],
                                                  **kw)])).float()
                   - mean) ** 2)
        for i in range(len(_ETA_GRID))])
    return base(honest, f, eta=_pick(etas, damages), **kw)


def alie_opt(honest: Tensor, f: int, *, agg_closure: Callable, **kw) -> Tensor:
    return _optimized(alie, honest, f, agg_closure, **kw)


def foe_opt(honest: Tensor, f: int, *, agg_closure: Callable, **kw) -> Tensor:
    return _optimized(foe, honest, f, agg_closure, **kw)


ATTACKS: dict[str, Callable] = {
    "alie": alie,
    "foe": foe,
    "sf": sign_flip,
    "mimic": mimic,
    "alie_opt": alie_opt,
    "foe_opt": foe_opt,
    "nan": nan_rows,
    "inf": inf_rows,
}


def _require_agg_closure(name: str, agg_closure) -> None:
    """Optimized attacks grid-search eta against the DEPLOYED aggregator;
    without the closure there is nothing to optimize against."""
    if name.endswith("_opt") and agg_closure is None:
        raise ValueError(
            f"optimized attack {name!r} requires agg_closure= (the deployed "
            "aggregation rule as a stack -> aggregate callable); pass it or "
            f"use the non-adaptive {name.removesuffix('_opt')!r}")


def apply_attack(name: str, honest: Tensor, f: int, **kw) -> Tensor:
    """Attacked full stack (n, d): the honest rows (fp32) followed by f
    Byzantine rows.  "none" and "lf" return ``honest`` untouched (LF acts
    through the data pipeline)."""
    if f == 0 or name in ("none", "lf"):
        return honest
    if name not in ATTACKS:
        raise ValueError(f"unknown attack {name!r}; known: {sorted(ATTACKS)}")
    _require_agg_closure(name, kw.get("agg_closure"))
    byz = ATTACKS[name](honest, f, **kw)
    return torch.cat([honest.float(), byz], dim=0)


# ---------------------------------------------------------------------------
# Pytree-stack attacks (the trainer and the fed server): the last f rows
# of every leaf are overwritten; coordinate-wise families apply leaf-wise,
# mimic's target is picked in Gram space.
# ---------------------------------------------------------------------------

def byzantine_row(name: str, honest: Tensor, *,
                  eta=None, finite: Optional[Tensor] = None,
                  all_finite: Optional[bool] = None) -> Tensor:
    """The one Byzantine vector of a coordinate-wise family, computed from
    an fp32 honest stack (nh, ...) -> (...); ``eta`` a float or a 0-d
    fp32 tensor; ``finite`` / ``all_finite`` as in
    :func:`_finite_moments`."""
    if name in ("nan", "inf"):
        fill = float("nan") if name == "nan" else float("inf")
        return torch.full(honest.shape[1:], fill, dtype=torch.float32,
                          device=honest.device)
    if name not in ("alie", "foe", "sf"):
        raise ValueError(f"unknown attack {name!r}; known: {ATTACK_NAMES}")
    mean, std = _finite_moments(honest, finite, all_finite,
                                with_std=name == "alie")
    return _from_moments(name, mean, std, eta)


def _from_moments(name: str, mean: Tensor, std: Optional[Tensor],
                  eta) -> Tensor:
    """alie / foe / sf's Byzantine vector from the honest moments."""
    if name == "alie":
        return mean + (1.0 if eta is None else eta) * std
    e = 2.0 if name == "sf" or eta is None else eta
    return (1.0 - e) * mean


def _mimic_target(g: Tensor) -> Tensor:
    """The mimic target from the honest Gram g (nh, nh): one power
    iteration of the centred Gram, seeded with its diagonal (the centred
    row energies; the ones vector lies in its null space)."""
    c = g - g.mean(0, keepdim=True) - g.mean(1, keepdim=True) + g.mean()
    v = c @ (c @ torch.diagonal(c))
    return torch.argmax(torch.abs(v))


def _check_name(name: str) -> None:
    if name not in ATTACK_NAMES:
        raise ValueError(f"unknown attack {name!r}; known: {ATTACK_NAMES}")


def _damage(agg_leaves: list, plain: Tensor, segments: list) -> Tensor:
    """Sum over leaves, in order, of ||agg - honest mean||^2 in fp32: the
    honest mean is the PLAIN mean of the leaf's honest rows (the
    reference's ``_tree_eta_search``), here ``plain[off:off + size]`` for
    the leaf at segment (off, size)."""
    tot = torch.zeros((), dtype=torch.float32, device=plain.device)
    for a, (off, size) in zip(agg_leaves, segments):
        tot = tot + torch.sum((a.reshape(-1).float()
                               - plain[off:off + size]) ** 2)
    return tot


def apply_attack_tree(name: str, tree, f: int, *, eta=None,
                      agg_closure: Optional[Callable] = None):
    """Attacked worker-stacked pytree (worker axis leading on every leaf):
    the last f rows of every leaf become the family's Byzantine vector.
    Returns new leaves; ``tree`` is left untouched.  ``agg_closure``
    (tree -> aggregated tree) drives the ``_opt`` eta search, run by
    :func:`attack_flat_` on one (n, D) copy of the stack whose column
    views the closure sees as the tree."""
    if f == 0 or name in ("none", "lf"):
        return tree
    _check_name(name)
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    nh = n - f
    if name.endswith("_opt"):
        layout = kdispatch.stack_layout(tree)
        flat = torch.cat([leaf.reshape(n, -1) for leaf in leaves], dim=1)
        close = agg_closure and (
            lambda fl: agg_closure(kdispatch.stack_views(fl, layout)))
        attack_flat_(name, flat, f, agg_closure=close,
                     segments=[(off, size) for off, size, _ in layout.segments])
        return tree_unflatten(layout.structure, [
            v.to(leaf.dtype) for v, leaf in
            zip(tree_leaves(kdispatch.stack_views(flat, layout)), leaves)])
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


def _chunks(segments: list, chunk: int):
    """(segment index, column slice) of every ``chunk``-wide column chunk
    of every segment, each segment cut from its own offset."""
    for i, (off, size) in enumerate(segments):
        for c0 in range(0, size, chunk):
            yield i, slice(off + c0, off + min(c0 + chunk, size))


def _write_byz_(name: str, flat: Tensor, nh: int, segments: list, eta,
                finite: list, chunk: int, moments=None) -> None:
    """Overwrite rows nh: of every segment with the family's Byzantine
    vector, column chunk by column chunk; ``finite`` holds each segment's
    (nh,) finite-row mask and its ``all()`` as a Python bool.
    ``moments``: the honest (mean, std) of :func:`_honest_moments`, else
    taken from the honest rows chunk by chunk."""
    for i, cols in _chunks(segments, chunk):
        if moments is None:
            mask, all_fin = finite[i]
            byz = byzantine_row(name, flat[:nh, cols].float(), eta=eta,
                                finite=mask, all_finite=all_fin)
        else:
            mean, std = moments
            byz = _from_moments(name, mean[cols],
                                None if std is None else std[cols], eta)
        flat[nh:, cols] = byz.to(flat.dtype)


def _honest_moments(name: str, flat: Tensor, nh: int, segments: list,
                    finite: list, chunk: int) -> tuple:
    """An eta search's honest statistics, which no candidate changes, as
    (D,) fp32 vectors over the stack's columns: the family's (mean, std)
    of :func:`_finite_moments` (std None for foe), and the plain mean of
    the damage (the same tensor as the mean when every honest row is
    finite).  At most 3 D floats."""
    d = flat.shape[1]
    mean = torch.empty(d, dtype=torch.float32, device=flat.device)
    std = torch.empty_like(mean) if name == "alie" else None
    plain = mean if all(fin for _, fin in finite) else torch.empty_like(mean)
    for i, cols in _chunks(segments, chunk):
        h = flat[:nh, cols].float()
        m, s = _finite_moments(h, *finite[i], with_std=std is not None)
        mean[cols] = m
        if std is not None:
            std[cols] = s
        if plain is not mean:
            plain[cols] = h.mean(dim=0)
    return (mean, std), plain


def attack_flat_(name: str, flat: Tensor, f: int, *, eta=None,
                 segments: Optional[list] = None,
                 agg_closure: Optional[Callable] = None,
                 internals: Optional[dict] = None,
                 chunk: int = ATTACK_CHUNK,
                 reduce: Optional[Callable] = None) -> Tensor:
    """In-place form of :func:`apply_attack_tree` on a flat (n, D) stack
    whose leaves occupy the column ``segments`` [(offset, size), ...]
    (one leaf spanning D when None).

    The families are coordinate-wise, so each leaf is processed in column
    chunks of ``chunk`` (temporaries stay at (n, chunk)); the finite-row
    test of :func:`_finite_moments` is taken over the whole leaf, as the
    reference takes it.  An ``_opt`` search writes each candidate's f
    rows into this one buffer in turn (the grid :data:`_ETA_GRID`), calls
    ``agg_closure`` on it ((n, D) -> an aggregate whose leaves follow
    ``segments``), and writes the best eta's rows last: no second stack
    exists.  The honest moments are taken once for the search
    (:func:`_honest_moments`).  ``internals`` (a dict) receives the
    chosen ``"eta"`` and the ``"damages"`` of the grid, as device
    tensors.

    ``reduce`` (the sharded trainer): ``flat`` is one column block of a
    wider stack, ``segments`` hold every leaf's part of it (size 0 for a
    leaf outside it, so that every block lists the same leaves), and
    ``reduce(t, op)`` all-reduces ``t`` ("sum" / "min") over the blocks:
    the finite-row masks (whole leaves), mimic's honest Gram and the
    search's damages, the sums over D; everything else is per column."""
    if f == 0 or name in ("none", "lf"):
        return flat
    _check_name(name)
    nh = flat.shape[0] - f
    segments = segments or [(0, flat.shape[1])]
    if name == "mimic":
        g = torch.zeros((nh, nh), dtype=torch.float32, device=flat.device)
        for off, size in segments:
            if size:
                g = g + gram_ref(flat[:nh, off:off + size])
        if reduce is not None:
            g = reduce(g, "sum")
        flat[nh:] = flat[_mimic_target(g)]
        return flat
    masks = torch.stack([torch.isfinite(flat[:nh, off:off + size]).all(dim=1)
                         for off, size in segments])
    if reduce is not None:
        masks = reduce(masks.to(torch.int32), "min").bool()
    finite = [(mask, _host_all(mask)) for mask in masks]
    if name.endswith("_opt"):
        _require_agg_closure(name, agg_closure)
        name = name.removesuffix("_opt")
        moments, plain = _honest_moments(name, flat, nh, segments, finite,
                                         chunk)
        etas = _grid(flat.device)
        damages = []
        for i in range(len(_ETA_GRID)):
            _write_byz_(name, flat, nh, segments, etas[i], finite, chunk,
                        moments)
            damages.append(_damage(tree_leaves(agg_closure(flat)), plain,
                                   segments))
        damages = torch.stack(damages)
        if reduce is not None:
            damages = reduce(damages, "sum")
        eta = _pick(etas, damages)
        if internals is not None:
            internals.update(eta=eta, damages=damages)
        _write_byz_(name, flat, nh, segments, eta, finite, chunk, moments)
        return flat
    _write_byz_(name, flat, nh, segments, eta, finite, chunk)
    return flat


def _host_all(mask: torch.Tensor) -> bool:
    """``bool(mask.all())``, read on the host to pick the all-finite path.
    A fake tensor (``launch.dryrun``) holds no values: it reads as all
    true, what a run on finite rows reads."""
    return True if is_fake(mask) else bool(mask.all())


#: Families that read a per-round eta (the fed server's ``use_eta``).
ETA_ATTACKS = ("alie", "foe")


def check_static_families(families) -> None:
    """Raise for a name the static path does not know."""
    for name in families:
        _check_name(name)


def apply_attack_scan(families: tuple, attack_id: int, tree, f: int, *,
                      eta=None, segments: Optional[list] = None,
                      agg_closure: Optional[Callable] = None,
                      internals: Optional[dict] = None):
    """The attack of one round of a scheduled run (counterpart of the
    reference's ``apply_attack_scan``): ``families`` is the run's family
    tuple and ``attack_id`` this round's index into it, a host int (the
    reference's traced ``lax.switch`` index; the port picks the branch in
    Python).  The branch is :func:`apply_attack_tree` verbatim, with
    ``eta`` passed only to the families that read it (alie / foe) and
    ``agg_closure`` reaching the ``_opt`` searches (required as soon as
    ``families`` holds one, as in the reference).

    ``tree`` is a worker-stacked pytree (new leaves are returned), or,
    when ``segments`` is given, a flat (n, D) stack attacked in place
    (:func:`attack_flat_`, whose closure takes that stack; ``internals``
    receives a search's eta there)."""
    if f == 0 or not families:
        return tree
    for name in families:
        _check_name(name)
        _require_agg_closure(name, agg_closure)
    name = families[int(attack_id)]
    eta = eta if name in ETA_ATTACKS else None
    if segments is not None:
        return attack_flat_(name, tree, f, eta=eta, segments=segments,
                            agg_closure=agg_closure, internals=internals)
    return apply_attack_tree(name, tree, f, eta=eta, agg_closure=agg_closure)


# ---------------------------------------------------------------------------
# Lane-dynamic attacks (fleet engine): per-lane f and eta are tensors, the
# family a host int per lane.  Honest statistics use row masks
# (row < n - f) instead of static slices.  The ``_opt`` families are not
# lane-dynamic (their eta search re-runs the aggregator per grid point),
# in both packages.
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
