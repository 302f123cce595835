"""Theoretical quantities from the paper, as executable code.

Counterpart of ``repro.core.theory``: the Table 1 coefficients and their
compositions (``kappa``, ``kappa_lower_bound``, ``nnm_kappa``,
``nnm_variance_factor``, ``composed_kappa`` with the bucketing /
hierarchical stage, ``bucketed_population``), the breakdown points, the
convergence bounds of Theorems 1-2 and Prop. 1 (plain Python floats, the
reference's formulas in its order), and the kappa-hat estimators of
Eq. (26): per step over a pytree (``tree_kappa_hat``) and over one
(n, d) stack (``empirical_kappa_hat``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.bucketing import clamp_bucket_size, num_buckets
from repro_torch.tree import tree_leaves

#: Column chunk of the kappa-hat reduction: bounds its temporaries at
#: (n, chunk) fp32 however wide a leaf is (the embedding of a full-width
#: LM is 47M columns per worker).
KAPPA_CHUNK = 1 << 22


def kappa(rule: str, n: int, f: int) -> float:
    """Exact (f, kappa)-robustness coefficient proved in Appendix 8.1."""
    if rule == "average" and f == 0:
        return 0.0
    if n <= 2 * f:
        raise ValueError("kappa undefined for n <= 2f")
    r = f / (n - 2 * f)
    if rule == "cwtm":
        return 6.0 * r * (1.0 + r)            # Prop. 2
    if rule == "krum":
        return 6.0 * (1.0 + r)                # Prop. 3
    if rule in ("gm", "cwmed", "autogm"):
        return 4.0 * (1.0 + r) ** 2           # Prop. 4/5 (AutoGM surrogate)
    if rule == "average":
        return 0.0
    raise ValueError(f"no proved kappa for rule {rule!r}")


def kappa_lower_bound(n: int, f: int) -> float:
    """Universal lower bound (Prop. 6): kappa >= f/(n-2f)."""
    return f / (n - 2 * f)


def nnm_kappa(base_kappa: float, n: int, f: int) -> float:
    """Lemma 1: F∘NNM is (f, kappa')-robust with kappa' <= 8f/(n-f)(kappa+1)."""
    return 8.0 * f / (n - f) * (base_kappa + 1.0)


def nnm_variance_factor(n: int, f: int) -> float:
    """Lemma 5: var(Y_S) + bias^2 <= [8f/(n-f)] var(X_S)."""
    return 8.0 * f / (n - f)


def bucketed_population(n: int, f: int, bucket_size: int | None = None
                        ) -> tuple[int, int]:
    """(n_buckets, f') after an s-sized bucketing stage.

    The population shrinks to ceil(n/s) while each Byzantine input
    contaminates at most one bucket, so f' = f.  Raises when the reduced
    population can no longer tolerate f (n_buckets <= 2f)."""
    s = clamp_bucket_size(n, bucket_size, f)
    n_b = num_buckets(n, s)
    if f > 0 and n_b <= 2 * f:
        raise ValueError(
            f"bucket_size={s} reduces n={n} to {n_b} buckets, which cannot "
            f"tolerate f={f} (need n_buckets > 2f)")
    return n_b, f


def composed_kappa(rule: str, n: int, f: int, pre: str | None = None, *,
                   hier: bool = False,
                   bucket_size: int | None = None) -> float:
    """Kappa of the composed pipeline [bucketing ->] pre -> rule.

    Lemma 1 for ``pre="nnm"``; the bare Table 1 coefficient otherwise.
    ``pre="bucketing"`` and ``hier=True`` both insert an s-sized
    bucketing stage, and the downstream coefficients are evaluated at the
    reduced population (ceil(n/s), f); hier composes with a further
    ``pre="nnm"`` stage on the reduced stack."""
    if pre == "bucketing":
        if hier:
            raise ValueError(
                "hier already inserts a bucketing stage; pre='bucketing' "
                "would bucket twice")
        n, f = bucketed_population(n, f, bucket_size)
        pre = None
    elif hier:
        n, f = bucketed_population(n, f, bucket_size)
    base = kappa(rule, n, f)
    if pre in (None, "none"):
        return base
    if pre == "nnm":
        return nnm_kappa(base, n, f)
    raise ValueError(f"no composed kappa for pre-aggregation {pre!r}")


#: Rules with a finite breakdown point under the paper's n > 2f adaptation.
ROBUST_RULES = frozenset({"krum", "multikrum", "gm", "autogm", "cwmed",
                          "cwtm", "mda", "meamed"})


def max_tolerable_f(rule: str, n: int, *, pre: str | None = None) -> int:
    """Largest Byzantine count the rule tolerates on n workers."""
    if pre not in (None, "none", "nnm", "bucketing"):
        raise ValueError(f"unknown pre-aggregation {pre!r}")
    if n < 1:
        raise ValueError(f"need n >= 1, got n={n}")
    if rule == "average":
        return 0
    if rule not in ROBUST_RULES:
        raise ValueError(f"no breakdown point for rule {rule!r}")
    return (n - 1) // 2


def breakdown_point(rule: str, n: int, f: int = 0, *,
                    pre: str | None = None) -> float:
    """Theoretical breakdown point f*/n of ``rule`` on n workers."""
    fmax = max_tolerable_f(rule, n, pre=pre)
    if not 0 <= f <= fmax:
        raise ValueError(
            f"f={f} outside [0, {fmax}] = tolerable range of {rule!r} "
            f"(pre={pre!r}) on n={n} workers")
    return fmax / n


def dgd_bound(kappa_: float, g_sq: float, smooth_l: float, loss_gap: float,
              steps: int) -> float:
    """Theorem 1: ||grad L_H(theta_hat)||^2 <= 4 kappa G^2 + 4 L Delta / T."""
    return 4.0 * kappa_ * g_sq + 4.0 * smooth_l * loss_gap / steps


def dshb_bound(kappa_: float, g_sq: float, sigma_sq: float, smooth_l: float,
               loss_gap: float, n: int, f: int, steps: int) -> float:
    """Theorem 2 expected-error bound with the paper's explicit constants."""
    a1 = 36.0
    a2 = 6.0 * math.sqrt(max(loss_gap, 0.0))
    a3 = 1728.0 * smooth_l
    a4 = 288.0 * smooth_l
    a5 = 6.0 * smooth_l * a2 ** 2
    a_k = math.sqrt(a3 * kappa_ + a4 / (n - f))
    sigma = math.sqrt(sigma_sq)
    t = float(steps)
    bound = a1 * kappa_ * g_sq + a2 * a_k * sigma / math.sqrt(t) + a5 / t
    if a_k > 0:
        bound += a2 * a4 * sigma / (n * a_k * t ** 1.5)
    return bound


def dshb_hyperparams(smooth_l: float, loss_gap: float, kappa_: float,
                     sigma_sq: float, n: int, f: int, steps: int
                     ) -> tuple[float, float]:
    """Theorem 2's (learning rate, momentum beta) prescription."""
    a2 = 6.0 * math.sqrt(max(loss_gap, 1e-12))
    a3 = 1728.0 * smooth_l
    a4 = 288.0 * smooth_l
    a_k = math.sqrt(a3 * kappa_ + a4 / (n - f))
    sigma = math.sqrt(max(sigma_sq, 1e-12))
    gamma = min(1.0 / (24.0 * smooth_l),
                a2 / (2.0 * a_k * sigma * math.sqrt(steps)))
    beta = math.sqrt(max(0.0, 1.0 - 24.0 * gamma * smooth_l))
    return gamma, beta


def resilience_lower_bound(n: int, f: int, g_sq: float) -> float:
    """Prop. 1 / Appendix 12 explicit constant: eps >= f/(4(n-2f)) G^2."""
    return f / (4.0 * (n - 2 * f)) * g_sq


def kappa_hat_sums(agg, stack, n_honest: int, *,
                   moments: bool = False) -> torch.Tensor:
    """The fp32 sums of :func:`tree_kappa_hat` over worker-stacked pytrees:
    ||R - mbar||^2 and mean_i ||m_i - mbar||^2 over the first
    ``n_honest`` rows, and with ``moments`` also R . mbar and ||mbar||^2
    (a (4,) tensor, else (2,)), each summed over the leaves' column chunks
    of :data:`KAPPA_CHUNK`.  Every term is a sum over columns, so a column
    block's sums add up across blocks (the sharded trainer all-reduces
    them)."""
    leaves = tree_leaves(stack)
    dev = leaves[0].device
    num = torch.zeros((), dtype=torch.float32, device=dev)
    den = torch.zeros((), dtype=torch.float32, device=dev)
    dot = torch.zeros((), dtype=torch.float32, device=dev)
    msq = torch.zeros((), dtype=torch.float32, device=dev)
    for a, s in zip(tree_leaves(agg), leaves):
        n = s.shape[0]
        s2 = s.reshape(n, -1)
        a1 = a.reshape(-1)
        for c0 in range(0, s2.shape[1], KAPPA_CHUNK):
            h = s2[:n_honest, c0:c0 + KAPPA_CHUNK].float()
            mbar = h.mean(dim=0)
            ac = a1[c0:c0 + KAPPA_CHUNK].float()
            num += torch.sum((ac - mbar) ** 2)
            den += torch.mean(torch.sum((h - mbar) ** 2, dim=1))
            if moments:
                dot += torch.sum(ac * mbar)
                msq += torch.sum(mbar * mbar)
    return torch.stack([num, den, dot, msq] if moments else [num, den])


def kappa_hat_from_sums(sums: torch.Tensor,
                        internals: Optional[dict] = None) -> torch.Tensor:
    """sqrt(||R - mbar||^2 / (mean_i ||m_i - mbar||^2 + 1e-20)) from
    :func:`kappa_hat_sums`; ``internals`` (the sums taken with
    ``moments``) as :func:`tree_kappa_hat` fills it."""
    num, den = sums[0], sums[1]
    if internals is not None:
        internals.update(honest_sq_dist=num, honest_dot=sums[2],
                         honest_mean_sq=sums[3])
    return torch.sqrt(num / (den + 1e-20))


def tree_kappa_hat(agg, stack, n_honest: int,
                   internals: Optional[dict] = None) -> torch.Tensor:
    """Paper Eq. (26) over worker-stacked pytrees, in fp32:
    ||R - mbar||^2 / mean_i ||m_i - mbar||^2 over the first ``n_honest``
    rows, returned as its square root.  Leaves are reduced in column chunks
    of :data:`KAPPA_CHUNK` (:func:`kappa_hat_sums`).

    ``internals`` (the health taps' input, :mod:`repro_torch.obs.taps`):
    pass a dict and the same chunk loop also sums R . mbar and ||mbar||^2;
    they are stored with ||R - mbar||^2 as ``"honest_dot"``,
    ``"honest_mean_sq"`` and ``"honest_sq_dist"`` (0-d fp32), so the taps
    need no D-sized honest mean and no second pass over the stack."""
    return kappa_hat_from_sums(
        kappa_hat_sums(agg, stack, n_honest, moments=internals is not None),
        internals)


def empirical_kappa_hat(agg_out: torch.Tensor, stack: torch.Tensor,
                        honest_idx=None) -> torch.Tensor:
    """kappa_hat_t of Eq. (26) for one (n, d) stack: sqrt(||R - mbar||^2 /
    mean_i ||m_i - mbar||^2), with mbar the plain mean of the honest rows
    (``stack`` itself, or its rows ``honest_idx``)."""
    h = stack if honest_idx is None else stack[torch.as_tensor(honest_idx)]
    h = h.float()
    mbar = h.mean(dim=0)
    num = torch.sum((agg_out.float() - mbar) ** 2)
    den = torch.mean(torch.sum((h - mbar) ** 2, dim=-1)) + 1e-20
    return torch.sqrt(num / den)
