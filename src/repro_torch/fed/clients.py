"""Vectorized federated clients: one ``torch.func.vmap`` over the cohort.

Counterpart of ``repro.fed.clients``.  The cohort's client pass is one
``vmap`` of ``grad`` over the sampled clients, in two flavours chosen by
``ClientConfig.local_steps``:

* ``local_steps == 0``: each client sends its (momentum-blended) gradient
  at the server parameters;
* ``local_steps == K > 0``: each client runs K SGD steps from the
  broadcast parameters and sends the pseudo-gradient
  (theta_0 - theta_K) / (K * local_lr), scaled to one gradient.

Client momentum (D-SHB, paper Alg. 3) lives server-side as full
(n_clients, ...) stacks, one per parameter leaf (jax's leaf order); a
round gathers the sampled rows, blends and scatters them back.  Batches
carry a cohort axis and a local-step axis: (m, max(local_steps, 1),
batch, ...) on every leaf.  Everything here is plain torch, so the fleet
adds its lane axis with a second ``vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.tree import tree_leaves, tree_map, tree_structure, tree_unflatten

PyTree = Any
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClientConfig:
    """Static per-client computation config."""
    local_steps: int = 0        # 0 => send gradient at server params
    local_lr: float = 0.05      # client-side SGD step size (local_steps > 0)
    algorithm: str = "dshb"     # dshb (client momentum) | dgd
    beta: float = 0.9           # momentum coefficient (dshb)


def init_client_momentum(params: PyTree, n_clients: int) -> list[Tensor]:
    """Full-population momentum stacks, one (n_clients, ...) fp32 tensor
    per parameter leaf, in jax's leaf order."""
    return [torch.zeros((n_clients,) + tuple(p.shape), dtype=torch.float32,
                        device=p.device) for p in tree_leaves(params)]


def gather_rows(momentum: list[Tensor], idx: Tensor) -> list[Tensor]:
    """Momentum rows of the sampled cohort, (m, ...) per leaf."""
    return [torch.index_select(m, 0, idx.to(torch.int64)) for m in momentum]


def scatter_rows(momentum: list[Tensor], idx: Tensor,
                 rows: list[Tensor]) -> list[Tensor]:
    """The full stacks with the cohort rows replaced (new tensors)."""
    idx = idx.to(torch.int64)
    return [m.index_copy(0, idx, r) for m, r in zip(momentum, rows)]


def autograd_grad_and_value(f: Callable) -> Callable:
    """``torch.func.grad_and_value(f)`` for leaf lists on plain autograd:
    ``(gradient leaves, value)``.  Outside ``vmap`` it is the cheaper of
    the two: at full width (smollm-360m, one client) ``torch.func``'s
    wrapped tensors cost more host time and a larger peak
    (``chip_smoke.py`` phase 12b times both)."""
    def run(leaves, wbatch):
        req = [leaf.detach().requires_grad_(True) for leaf in leaves]
        value = f(req, wbatch)
        return torch.autograd.grad(value, req), value.detach()
    return run


def client_send(loss_fn: Callable, params: PyTree, cbatch: PyTree,
                ccfg: ClientConfig, *, local_lr=None,
                grad_and_value: Callable = grad_and_value
                ) -> tuple[Tensor, list[Tensor]]:
    """One client's ``(loss, send leaves)`` from its (L, batch, ...)
    batch at the server ``params``, before any momentum blend: the
    gradient on slice 0 (``local_steps == 0``), else one SGD step a batch
    slice (L of them, as the reference's scan over the slices) and the
    pseudo-gradient (theta_0 - theta_L) / (local_steps * local_lr).
    ``grad_and_value``: ``torch.func``'s (required under
    :func:`client_updates`' ``vmap``) or :func:`autograd_grad_and_value`
    (one client at a time, one gradient alive)."""
    skeleton = tree_structure(params)
    robust_p = tree_leaves(params)

    def loss_of(rp, wbatch):
        loss, _ = loss_fn(tree_unflatten(skeleton, rp), wbatch)
        return loss

    if ccfg.local_steps == 0:
        g, loss = grad_and_value(loss_of)(
            robust_p, tree_map(lambda leaf: leaf[0], cbatch))
        return loss, [gg.float() for gg in g]
    k = ccfg.local_steps
    lr = ccfg.local_lr if local_lr is None else local_lr
    rp, ls = robust_p, []
    for step in range(tree_leaves(cbatch)[0].shape[0]):
        wb = tree_map(lambda leaf: leaf[step], cbatch)
        g, loss = grad_and_value(loss_of)(rp, wb)
        rp = [(p.float() - lr * gg.float()).to(p.dtype)
              for p, gg in zip(rp, g)]
        ls.append(loss)
    delta = [(a.float() - b.float()) / (k * lr)
             for a, b in zip(robust_p, rp)]
    return torch.stack(ls).mean(), delta


def client_updates(loss_fn: Callable, params: PyTree,
                   cohort_momentum: list[Tensor], batch: PyTree,
                   ccfg: ClientConfig, *, beta=None, local_lr=None
                   ) -> tuple[Tensor, list[Tensor], list[Tensor]]:
    """The vmapped cohort pass of one server (:func:`client_send` over the
    cohort axis).

    ``loss_fn(params, worker_batch) -> (scalar, aux)``; ``params`` are the
    server parameters; ``cohort_momentum`` the gathered rows (m, ...) per
    leaf; ``batch`` leaves (m, L, batch, ...).  ``beta`` / ``local_lr``
    override the config's constants (tensors: the fleet's per-lane
    values).  Returns ``(losses (m,), transmitted stack, new cohort
    momentum)``, the stack a list of (m, ...) fp32 leaves."""
    losses, sends = vmap(lambda cbatch: client_send(
        loss_fn, params, cbatch, ccfg, local_lr=local_lr))(batch)

    if ccfg.algorithm == "dshb":
        b = torch.as_tensor(ccfg.beta if beta is None else beta,
                            dtype=torch.float32)
        sends = [b * m + (1 - b) * g for m, g in zip(cohort_momentum, sends)]
        new_momentum = sends
    else:
        new_momentum = cohort_momentum
    return losses, sends, new_momentum
