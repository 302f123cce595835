"""Nearest-Neighbor Mixing (NNM) — the paper's core contribution (Alg. 2).

Counterpart of ``repro.core.nnm``: each row of ``x : (n, d)`` becomes the
average of its n-f nearest rows (itself included).
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
