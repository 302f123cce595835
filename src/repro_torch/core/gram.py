"""Gram-space machinery for robust aggregation (static f).

Krum, Multi-Krum, GM (Weiszfeld), AutoGM and MDA depend on the worker
stack ``x : (n, d)`` only through its Gram matrix ``G = x @ x.T``; the
output is a linear combination ``coeff @ x``.  This module is the small
(n, n) side of that pipeline: everything that maps G -> coefficients.
Counterpart of ``repro.core.gram``: the static forms, and the ``*_dyn``
rank-mask forms of the fleet, in which f is an int tensor.  The ``*_dyn``
forms take any leading lane axes: d2 / g of shape (..., n, n) with f of
shape (...), so one call serves every lane of a fleet bucket.

Neighbour selection uses a STABLE ascending sort of the distances' IEEE
total-order keys and takes the first k indices.  That reproduces
``jax.lax.top_k(-d2, k)``, which breaks ties toward the lower index — and
ties are the normal case on the main path, where ALIE and sign-flip make
the f Byzantine rows identical — and ranks a NaN distance by its sign bit.
``torch.topk`` promises no order on ties, so it is not used.
The ``*_dyn`` forms rank with a double STABLE argsort, as ``jnp.argsort``
(stable by default) does in the reference.
"""
from __future__ import annotations

import itertools
import math

import torch

Tensor = torch.Tensor


def gram(x: Tensor) -> Tensor:
    """Plain Gram matrix of a (n, d) stack in fp32."""
    x = x.float()
    return x @ x.T


def pdist_sq_from_gram(g: Tensor) -> Tensor:
    """Pairwise squared distances ||x_i - x_j||^2 from the Gram matrix,
    floored at 0 (rounding can make tiny negatives); leading lane axes
    allowed."""
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = diag[..., :, None] - 2.0 * g + diag[..., None, :]
    return torch.clamp_min(d2, 0.0)


def mixed_gram(g: Tensor, m: Tensor) -> Tensor:
    """Gram matrix of the mixed stack Y = M @ X, i.e. M G M^T (leading lane
    axes allowed)."""
    return m @ g @ m.mT


def _total_order_key(d: Tensor) -> Tensor:
    """int32 keys that sort fp32 ``d`` in IEEE total order:
    -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN."""
    b = d.float().contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _smallest_k(d: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, indices) of the k smallest entries along the last axis in
    IEEE total order, ties to the lower index: the ``lax.top_k(-d, k)``
    selection, which ranks a NaN with its sign bit set (x86's inf - inf)
    nearest and one with it clear (the card's) last.  Sorting the bits
    keeps that order off the device's float sort; each value is gathered
    with its own bits."""
    _, idx = torch.sort(_total_order_key(d), dim=-1, stable=True)
    idx = idx[..., :k]
    return torch.gather(d, -1, idx), idx


def _one_hot_sum(idx: Tensor, n: int) -> Tensor:
    """Sum of one-hot rows of ``idx`` over its last axis (fp32)."""
    out = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.float32,
                      device=idx.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.float32))


def nnm_matrix(d2: Tensor, f: int) -> Tensor:
    """NNM mixing matrix from squared distances (paper Alg. 2): row i
    averages the n-f nearest neighbours of x_i, itself included."""
    n = d2.shape[0]
    k = n - f
    _, idx = _smallest_k(d2, k)
    return _one_hot_sum(idx, n) / float(k)


def _krum_scores(d2: Tensor, f: int) -> Tensor:
    n = d2.shape[0]
    neigh, _ = _smallest_k(d2, n - f)
    return neigh.sum(dim=1)


def krum_coeff(d2: Tensor, f: int) -> Tensor:
    """One-hot selection of the candidate with the smallest sum of squared
    distances to its n-f nearest neighbours (first index on ties)."""
    n = d2.shape[0]
    best = torch.argmin(_krum_scores(d2, f))
    return torch.nn.functional.one_hot(best, n).float()


def multikrum_coeff(d2: Tensor, f: int) -> Tensor:
    """Multi-Krum: average of the n-f best Krum-scoring candidates."""
    n = d2.shape[0]
    k = n - f
    _, best = _smallest_k(_krum_scores(d2, f), k)
    return _one_hot_sum(best, n) / float(k)


def gm_coeff(g: Tensor, f: int, iters: int = 8, eps: float = 1e-8) -> Tensor:
    """Weiszfeld coefficients for the geometric median, in gram space:
    ||y - x_i||^2 = w G w^T - 2 (G w)_i + G_ii with y = w @ x (the smoothed
    update of Pillutla et al.)."""
    del f  # GM does not need f; kept for interface uniformity.
    n = g.shape[0]
    diag = torch.diagonal(g)
    w = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        gw = g @ w
        quad = w @ gw
        d2 = torch.clamp_min(diag - 2.0 * gw + quad, 0.0)
        inv = 1.0 / torch.sqrt(d2 + eps)
        w = inv / inv.sum()
    return w


def project_simplex(v: Tensor) -> Tensor:
    """Euclidean projection of v onto the probability simplex (sort-based,
    Duchi et al. 2008)."""
    n = v.shape[0]
    u = torch.sort(v).values.flip(0)
    css = torch.cumsum(u, 0)
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=v.device)
    cond = u + (1.0 - css) / idx > 0.0
    rho = torch.clamp_min(cond.int().sum() - 1, 0)
    theta = (1.0 - css[rho]) / (rho + 1).float()
    return torch.clamp_min(v + theta, 0.0)


def autogm_coeff(g: Tensor, f, *, lamb: float = 1.0, outer_iters: int = 4,
                 gm_iters: int = 8, gm_eps: float = 1e-8) -> Tensor:
    """Adaptively-weighted geometric median (AutoGM), in gram space:
    alternating simplex-projected weights and a weighted Weiszfeld solve;
    ``lamb`` is in units of the mean distance to the uniform-weight GM."""
    del f  # AutoGM adapts weights from distances; kept for uniformity.
    n = g.shape[0]
    diag = torch.diagonal(g)

    def dists(c):
        gc = g @ c
        quad = c @ gc
        return torch.sqrt(torch.clamp_min(diag - 2.0 * gc + quad, 0.0) + gm_eps)

    def weiszfeld(w, c):
        for _ in range(gm_iters):
            inv = w / dists(c)
            c = inv / torch.clamp_min(inv.sum(), gm_eps)
        return c

    uniform = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    c = weiszfeld(uniform, uniform)
    lamb_eff = torch.clamp_min(torch.tensor(lamb, dtype=torch.float32,
                                            device=g.device) * dists(c).mean(),
                               gm_eps)
    for _ in range(outer_iters):
        w = project_simplex(-dists(c) / (2.0 * lamb_eff))
        c = weiszfeld(w, c)
    return c


_MDA_EXACT_LIMIT = 60_000


def _subsets(n: int, f: int) -> Tensor:
    """All (n-f)-subsets of [n] (host-side enumeration)."""
    return torch.tensor(list(itertools.combinations(range(n), n - f)),
                        dtype=torch.int64)


def mda_coeff(d2: Tensor, f: int) -> Tensor:
    """Minimum-diameter averaging: exact subset enumeration for
    C(n, f) <= 60k, greedy diameter pruning beyond."""
    n = d2.shape[0]
    if f == 0:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=d2.device)
    if math.comb(n, f) <= _MDA_EXACT_LIMIT:
        subs = _subsets(n, f).to(d2.device)                 # (S, n-f)
        sub_d = d2[subs[:, :, None], subs[:, None, :]]       # (S, n-f, n-f)
        diam = sub_d.amax(dim=(1, 2))
        best = subs[torch.argmin(diam)]
        return _one_hot_sum(best, n) / float(n - f)
    alive = torch.ones((n,), dtype=torch.float32, device=d2.device)
    for _ in range(f):
        masked = torch.where(alive[None, :] * alive[:, None] > 0, d2,
                             torch.tensor(-math.inf, device=d2.device))
        worst = torch.argmax(masked.amax(dim=1))
        alive[worst] = 0.0
    return alive / alive.sum()


def coeff_for_rule(rule: str, g: Tensor, f: int, *, gm_iters: int = 8,
                   gm_eps: float = 1e-8, autogm_lamb: float = 1.0,
                   autogm_iters: int = 4) -> Tensor:
    """Dispatch: Gram matrix -> linear-combination coefficients."""
    n = g.shape[0]
    if rule == "average":
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
    if rule == "gm":
        return gm_coeff(g, f, iters=gm_iters, eps=gm_eps)
    if rule == "autogm":
        return autogm_coeff(g, f, lamb=autogm_lamb, outer_iters=autogm_iters,
                            gm_iters=gm_iters, gm_eps=gm_eps)
    d2 = pdist_sq_from_gram(g)
    if rule == "krum":
        return krum_coeff(d2, f)
    if rule == "multikrum":
        return multikrum_coeff(d2, f)
    if rule == "mda":
        return mda_coeff(d2, f)
    raise ValueError(f"{rule!r} is not a gram-space rule")


# ---------------------------------------------------------------------------
# Dynamic-f forms (fleet engine): f is an int tensor, one per lane, so one
# call serves lanes with different Byzantine budgets.  Selection goes
# through rank masks instead of top-k slices.  Leading axes of d2 / g are
# lane axes; f has exactly those axes (a 0-d f for one (n, n) matrix).
# ---------------------------------------------------------------------------

def _lane_int(f, like: Tensor) -> Tensor:
    """f as an int64 tensor on ``like``'s device."""
    return torch.as_tensor(f, device=like.device).to(torch.int64)


def _row_ranks(d2: Tensor) -> Tensor:
    """rank[..., i, j] = position of j in the ascending order of row i
    (0 = nearest); ties to the lower index (two stable argsorts)."""
    order = torch.argsort(d2, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def nnm_matrix_dyn(d2: Tensor, f) -> Tensor:
    """:func:`nnm_matrix` with an int-tensor f: row i averages the n-f
    nearest neighbours of x_i, selected by the rank mask rank < n-f.
    Ranks by the float sort (NaN last), as the reference's dynamic path
    does, not by the static forms' total order."""
    n = d2.shape[-1]
    keep = (n - _lane_int(f, d2))[..., None, None]
    mask = (_row_ranks(d2) < keep).float()
    return mask / keep.float()


def _krum_scores_dyn(d2: Tensor, f) -> Tensor:
    """Sum of the n-f smallest distances per candidate row."""
    n = d2.shape[-1]
    srt = torch.sort(d2, dim=-1).values
    keep = (torch.arange(n, device=d2.device)
            < (n - _lane_int(f, d2))[..., None, None]).float()
    return (srt * keep).sum(dim=-1)


def krum_coeff_dyn(d2: Tensor, f) -> Tensor:
    """:func:`krum_coeff` with an int-tensor f (first index on ties)."""
    n = d2.shape[-1]
    best = torch.argmin(_krum_scores_dyn(d2, f), dim=-1)
    return torch.nn.functional.one_hot(best, n).float()


def multikrum_coeff_dyn(d2: Tensor, f) -> Tensor:
    """:func:`multikrum_coeff` with an int-tensor f: the average of the
    n-f best-scoring rows."""
    n = d2.shape[-1]
    keep = (n - _lane_int(f, d2))[..., None]
    rank = _row_ranks(_krum_scores_dyn(d2, f))
    return (rank < keep).float() / keep.float()


def _gm_coeff_lanes(g: Tensor, iters: int, eps: float) -> Tensor:
    """:func:`gm_coeff` over leading lane axes of g (..., n, n)."""
    n = g.shape[-1]
    diag = torch.diagonal(g, dim1=-2, dim2=-1)
    w = torch.full(g.shape[:-1], 1.0 / n, dtype=torch.float32,
                   device=g.device)
    for _ in range(iters):
        gw = (g @ w[..., None])[..., 0]
        quad = (w * gw).sum(dim=-1, keepdim=True)
        d2 = torch.clamp_min(diag - 2.0 * gw + quad, 0.0)
        inv = 1.0 / torch.sqrt(d2 + eps)
        w = inv / inv.sum(dim=-1, keepdim=True)
    return w


def _project_simplex_lanes(v: Tensor) -> Tensor:
    """:func:`project_simplex` along the last axis of v (..., n)."""
    n = v.shape[-1]
    u = torch.sort(v, dim=-1).values.flip(-1)
    css = torch.cumsum(u, dim=-1)
    idx = torch.arange(1, n + 1, dtype=torch.float32, device=v.device)
    cond = u + (1.0 - css) / idx > 0.0
    rho = torch.clamp_min(cond.int().sum(dim=-1) - 1, 0).to(torch.int64)
    theta = (1.0 - css.gather(-1, rho[..., None])) / (rho[..., None] + 1).float()
    return torch.clamp_min(v + theta, 0.0)


def _autogm_coeff_lanes(g: Tensor, *, lamb: float, outer_iters: int,
                        gm_iters: int, gm_eps: float) -> Tensor:
    """:func:`autogm_coeff` over leading lane axes of g (..., n, n)."""
    n = g.shape[-1]
    diag = torch.diagonal(g, dim1=-2, dim2=-1)

    def dists(c):
        gc = (g @ c[..., None])[..., 0]
        quad = (c * gc).sum(dim=-1, keepdim=True)
        return torch.sqrt(torch.clamp_min(diag - 2.0 * gc + quad, 0.0) + gm_eps)

    def weiszfeld(w, c):
        for _ in range(gm_iters):
            inv = w / dists(c)
            c = inv / torch.clamp_min(inv.sum(dim=-1, keepdim=True), gm_eps)
        return c

    uniform = torch.full(g.shape[:-1], 1.0 / n, dtype=torch.float32,
                         device=g.device)
    c = weiszfeld(uniform, uniform)
    lamb_eff = torch.clamp_min(lamb * dists(c).mean(dim=-1, keepdim=True),
                               gm_eps)
    for _ in range(outer_iters):
        w = _project_simplex_lanes(-dists(c) / (2.0 * lamb_eff))
        c = weiszfeld(w, c)
    return c


def coeff_for_rule_dyn(rule: str, g: Tensor, f, *, gm_iters: int = 8,
                       gm_eps: float = 1e-8, autogm_lamb: float = 1.0,
                       autogm_iters: int = 4) -> Tensor:
    """:func:`coeff_for_rule` with an int-tensor f (the rule stays a
    Python string).  MDA has no dynamic form (its subset enumeration
    depends on f); GM and AutoGM never read f."""
    n = g.shape[-1]
    if rule == "average":
        return torch.full(g.shape[:-1], 1.0 / n, dtype=torch.float32,
                          device=g.device)
    if rule == "gm":
        return _gm_coeff_lanes(g, gm_iters, gm_eps)
    if rule == "autogm":
        return _autogm_coeff_lanes(g, lamb=autogm_lamb,
                                   outer_iters=autogm_iters,
                                   gm_iters=gm_iters, gm_eps=gm_eps)
    d2 = pdist_sq_from_gram(g)
    if rule == "krum":
        return krum_coeff_dyn(d2, f)
    if rule == "multikrum":
        return multikrum_coeff_dyn(d2, f)
    if rule == "mda":
        raise ValueError("mda has no dynamic-f form (subset enumeration "
                         "depends on f); use the static path or another rule")
    raise ValueError(f"{rule!r} is not a gram-space rule")
