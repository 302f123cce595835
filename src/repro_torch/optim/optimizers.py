"""Server-side optimizers: (init, update) pairs over parameter dicts.

Counterpart of ``repro.optim.optimizers``.  They consume the robustly
aggregated direction R_t; worker momentum (D-SHB) lives in the trainer.
``update`` returns new parameter tensors (it does not write into
``params``) so a caller can keep the iterate it started from.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, float], tuple[PyTree, PyTree]]
    # update(direction, opt_state, params, lr) -> (new_params, new_state)


OptState = PyTree


_SQ_SUM: list = [None]


@contextlib.contextmanager
def sharded_norm(sq_sum: Optional[Callable[[list], torch.Tensor]]):
    """Inside the scope :func:`global_norm` hands the per-leaf sums of
    squares to ``sq_sum`` (the model-sharded trainer: its split leaves'
    sums all-reduced over the model axis, its replicated ones once)."""
    prev = _SQ_SUM[0]
    _SQ_SUM[0] = sq_sum
    try:
        yield
    finally:
        _SQ_SUM[0] = prev


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(leaf.float() ** 2) for leaf in tree_leaves(tree)]
    if _SQ_SUM[0] is not None:
        return torch.sqrt(_SQ_SUM[0](sq))
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda leaf: leaf * scale.to(leaf.dtype), tree)


def sgd(*, weight_decay: float = 0.0, clip: float | None = None) -> Optimizer:
    def init(params):
        return ()

    def update(direction, state, params, lr):
        if clip is not None:
            direction = clip_by_global_norm(direction, clip)

        def upd(p, d):
            d32 = d.float()
            if weight_decay:
                d32 = d32 + weight_decay * p.float()
            return (p.float() - lr * d32).to(p.dtype)

        return tree_map(upd, params, direction), state

    return Optimizer(init, update)


def adam(*, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, clip: float | None = None) -> Optimizer:
    """Server-side Adam over the robust direction (beyond-paper option)."""
    def init(params):
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        return {"m": zeros, "v": tree_map(torch.clone, zeros), "t": 0}

    def update(direction, state, params, lr):
        if clip is not None:
            direction = clip_by_global_norm(direction, clip)
        t = state["t"] + 1
        m = tree_map(lambda m_, d: b1 * m_ + (1 - b1) * d.float(),
                     state["m"], direction)
        v = tree_map(lambda v_, d: b2 * v_ + (1 - b2) * torch.square(d.float()),
                     state["v"], direction)
        # fp32 bias corrections, as the reference forms them.
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(t))
        bc2 = float(f32(1) - f32(b2) ** f32(t))

        def upd(p, m_, v_):
            step = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype)

        return (tree_map(upd, params, m, v), {"m": m, "v": v, "t": t})

    return Optimizer(init, update)
