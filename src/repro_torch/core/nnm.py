"""Nearest-Neighbor Mixing (NNM) — the paper's core contribution (Alg. 2).

Counterpart of ``repro.core.nnm``: each row of ``x : (n, d)`` becomes the
average of its n-f nearest rows (itself included).  :func:`nnm` selects
the neighbours from the Gram factorisation; :func:`nnm_direct` is the
literal Alg. 2 on explicit distances, kept as the test oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core import gram as gramlib


def nnm_matrix_from_stack(x: torch.Tensor, f: int) -> torch.Tensor:
    """(n, n) row-stochastic mixing matrix for a dense stack."""
    return gramlib.nnm_matrix(gramlib.pdist_sq_from_gram(gramlib.gram(x)), f)


def nnm(x: torch.Tensor, f: int) -> torch.Tensor:
    """Apply NNM to a dense (n, d) stack; returns the mixed stack Y."""
    return nnm_matrix_from_stack(x, f) @ x.float()


def nnm_direct(x: torch.Tensor, f: int) -> torch.Tensor:
    """Literal Alg. 2: explicit pairwise squared distances, then the n - f
    nearest rows of each (``torch.topk`` of the negated distances, the
    reference's ``top_k`` idiom) averaged.  O(n^2 d); must equal
    :func:`nnm` up to tie-breaking."""
    n = x.shape[0]
    xf = x.float()
    d2 = torch.sum((xf[:, None, :] - xf[None, :, :]) ** 2, dim=-1)
    _, idx = torch.topk(-d2, n - f, dim=1)
    return xf[idx].mean(dim=1)
