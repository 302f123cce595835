"""Robust aggregation rules on 2-D worker stacks ``x : (n, d) -> (d,)``.

Counterpart of ``repro.core.aggregators``: the dense reference forms.  The
pipeline in :mod:`repro_torch.core.robust` re-expresses the gram rules as
coefficient math plus one combination and the coordinate rules as
leaf-streamed sorts.  Internal arithmetic is fp32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import gram as gramlib
from repro_torch.core.types import AggregatorSpec
from repro_torch.kernels._common import sort_nan_last

Tensor = torch.Tensor


def _median(x: Tensor) -> Tensor:
    """``jnp.median`` along axis 0: the mean of the two middle values for
    even n, and NaN in any column that holds a NaN."""
    n = x.shape[0]
    xs = torch.sort(x, dim=0).values
    med = xs[n // 2] if n % 2 == 1 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    return torch.where(torch.isnan(x).any(dim=0),
                       torch.full_like(med, float("nan")), med)


def cwmed(x: Tensor, f: int = 0) -> Tensor:
    """Coordinate-wise median (paper Eq. 13)."""
    del f
    return _median(x.float())


def cwtm(x: Tensor, f: int) -> Tensor:
    """Coordinate-wise trimmed mean: drop the f largest and f smallest
    values per coordinate, average the middle n-2f (paper §8.1.1)."""
    n = x.shape[0]
    if not 0 <= f < n / 2:
        raise ValueError(f"need 0 <= f < n/2, got f={f}, n={n}")
    if f == 0:
        return x.float().mean(dim=0)
    return sort_nan_last(x.float(), 0)[f: n - f].mean(dim=0)


def meamed(x: Tensor, f: int) -> Tensor:
    """Mean-around-median (Xie et al.): per coordinate, average the n-f
    values closest to the coordinate-wise median."""
    n = x.shape[0]
    x = x.float()
    med = _median(x)[None]
    order = torch.argsort(torch.abs(x - med), dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    return xs[: n - f].mean(dim=0)


def average(x: Tensor, f: int = 0) -> Tensor:
    del f
    return x.float().mean(dim=0)


def _gram_rule(rule: str, x: Tensor, f: int, **kw) -> Tensor:
    c = gramlib.coeff_for_rule(rule, gramlib.gram(x), f, **kw)
    return c @ x.float()


def krum(x: Tensor, f: int) -> Tensor:
    return _gram_rule("krum", x, f)


def multikrum(x: Tensor, f: int) -> Tensor:
    return _gram_rule("multikrum", x, f)


def geometric_median(x: Tensor, f: int = 0, iters: int = 8,
                     eps: float = 1e-8) -> Tensor:
    return _gram_rule("gm", x, f, gm_iters=iters, gm_eps=eps)


def autogm(x: Tensor, f: int = 0, lamb: float = 1.0, iters: int = 4,
           gm_iters: int = 8, eps: float = 1e-8) -> Tensor:
    """Adaptively-weighted geometric median (see ``gram.autogm_coeff``)."""
    return _gram_rule("autogm", x, f, autogm_lamb=lamb, autogm_iters=iters,
                      gm_iters=gm_iters, gm_eps=eps)


def mda(x: Tensor, f: int) -> Tensor:
    return _gram_rule("mda", x, f)


RULES = {
    "average": average,
    "krum": krum,
    "multikrum": multikrum,
    "gm": geometric_median,
    "autogm": autogm,
    "cwmed": cwmed,
    "cwtm": cwtm,
    "mda": mda,
    "meamed": meamed,
}


def get_rule(name: str):
    try:
        return RULES[name]
    except KeyError:
        raise ValueError(f"unknown rule {name!r}; known: {sorted(RULES)}")


def aggregate(x: Tensor, spec: AggregatorSpec, *,
              generator: Optional[torch.Generator] = None,
              perm: Optional[Tensor] = None) -> Tensor:
    """Full pipeline on a dense (n, d) stack: pre-aggregation + rule.
    ``generator`` / ``perm`` (the reference's ``key``) give the bucket
    permutation of ``pre="bucketing"``, the paper's randomized baseline."""
    from repro_torch.core.bucketing import bucketing as _bucketing
    from repro_torch.core.nnm import nnm as _nnm

    f = spec.f
    if spec.pre == "nnm":
        x = _nnm(x, f)
    elif spec.pre == "bucketing":
        if generator is None and perm is None:
            raise ValueError("bucketing requires a torch.Generator or a perm")
        x, f = _bucketing(x, f, generator=generator, perm=perm,
                          bucket_size=spec.bucket_size)
    elif spec.pre not in (None, "none"):
        raise ValueError(f"unknown pre-aggregation {spec.pre!r}")
    rule = spec.rule
    if rule == "gm":
        return geometric_median(x, f, iters=spec.gm_iters, eps=spec.gm_eps)
    if rule == "autogm":
        return autogm(x, f, lamb=spec.autogm_lamb, iters=spec.autogm_iters,
                      gm_iters=spec.gm_iters, eps=spec.gm_eps)
    return get_rule(rule)(x, f)
