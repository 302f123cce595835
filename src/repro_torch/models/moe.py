"""Mixture-of-Experts with top-k routing and capacity-based dispatch.

Counterpart of ``repro.models.moe``.  Tokens are dispatched per group,
where a group is one batch row (GShard-style): the dispatch buffer is
(B, E, C, d), positions within each (group, expert) come from a stable
argsort of the expert assignments, and tokens beyond the capacity C drop.
The router is fp32 whatever the model's dtype; arctic's dense residual
SwiGLU lives under ``moe`` as ``dense``.  Includes the Switch load-balance
auxiliary loss.  The reference computes all of it outside any Pallas
kernel, so plain torch ops are its port.

On a model mesh the experts are split over the model axis when they
divide (``MeshAxes.shard_expert``: the router's expert columns too,
gathered back), else every expert's ``ff_inner``.  The router, the
capacity dispatch and the aux loss are computed whole on every rank, so
every rank routes the same way; each rank runs its experts (or its ff
block of every expert) on the dispatch buffer, and the combine's partial
sums are summed in fp32 over the model axis, cast once
(``common.exit_sum``).  Under ``seq_par`` the block's input is the
gathered sequence (``lm.DecoderLM``), so routing, capacity and aux are
the whole sequence's, as on one device; the combine's partials are
reduce-scattered over the sequence and the aux's gradient enters from
one model rank (``common.first_rank_grad``).

Expert FSDP (``MeshAxes.expert_fsdp``, ZeRO-3 style): each rank also
holds only its data-axis block of every expert table, ``ff_inner`` when
the experts split over the model axis (arctic), ``expert_embed`` when
they do not (mixtral at model 16).  A table is all-gathered over the
data axes just before its layer uses it and dropped after it
(``common.fsdp_gather``; under ``cfg.remat`` the whole table lives only
inside its block's forward and its recomputation), and its gradient is
reduce-scattered back in fp32, so a rank's gradient of its block is the
sum over the data ranks' workers.  The trainer's selective robustness
(``TrainerConfig.fsdp_keys``) takes that sum as the tables' direction.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, mlp
from repro_torch.models.common import ParamDesc

Tensor = torch.Tensor


#: One layer's logical axes of each expert table.
TABLE_AXES = {"wi": ("expert", "expert_embed", "ff_inner"),
              "wg": ("expert", "expert_embed", "ff_inner"),
              "wo": ("expert", "ff_inner", "expert_embed")}


def moe_params(cfg: ModelConfig, layers: int) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    L = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    p = {
        "router": ParamDesc(L + (d, e), torch.float32,
                            axes=lax + ("embed", "expert")),
        "wi": ParamDesc(L + (e, d, ff), cfg.dtype,
                        axes=lax + TABLE_AXES["wi"]),
        "wg": ParamDesc(L + (e, d, ff), cfg.dtype,
                        axes=lax + TABLE_AXES["wg"]),
        "wo": ParamDesc(L + (e, ff, d), cfg.dtype,
                        axes=lax + TABLE_AXES["wo"]),
    }
    if cfg.moe_dense_ff:
        p["dense"] = mlp.swiglu_params(cfg, layers, d_ff=cfg.moe_dense_ff)
    return p


def top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest entries of the last axis, largest first, the lower
    index first among equal values (``jax.lax.top_k``'s order), the same
    on every device: a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(x: Tensor, probs: Tensor, k: int, cap: int):
    """Every group (batch row) at once.  x: (B, t, d); probs: (B, t, e).
    Returns (buf (B, e, cap, d), flat_assign (B, t*k), pos (B, t*k),
    weights (B, t*k))."""
    b, t, d = x.shape
    e = probs.shape[-1]
    gates, assign = top_k(probs, k)                          # (B, t, k)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)

    flat = assign.reshape(b, t * k)
    order = torch.argsort(flat, dim=-1, stable=True)
    counts = torch.zeros((b, e), dtype=torch.long, device=x.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    ar = torch.arange(t * k, device=x.device).expand(b, -1)
    pos_sorted = ar - torch.gather(starts, 1, torch.gather(flat, 1, order))
    pos = torch.empty_like(flat).scatter_(1, order, pos_sorted)
    keep = pos < cap
    pos_c = torch.clamp_max(pos, cap - 1)
    w = (gates.reshape(b, t * k) * keep).to(x.dtype)

    xk = torch.repeat_interleave(x, k, dim=1)                # (B, t*k, d)
    grp = torch.arange(b, device=x.device)[:, None].expand(b, t * k)
    # A dropped token adds its ZERO row to slot cap - 1: accumulate, so a
    # kept token there is not overwritten (the reference's .at[].add).
    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    buf.index_put_((grp, flat, pos_c), xk * keep[..., None].to(x.dtype),
                   accumulate=True)
    return buf, flat, pos_c, w


def moe_block(p: dict, x: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  Groups = batch rows."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = int(cfg.capacity_factor * s * k / e) + 1

    mesh = common.model_mesh()
    split_experts = mesh is not None and common.get_mesh_axes().shard_expert
    if split_experts and common.seq_split():
        # This rank's expert columns, an fp32 column-parallel product.
        logits = common.gather_from_model(
            common.column_parallel(x, p["router"]))
    elif split_experts:
        # This rank's expert columns of the router, gathered whole.
        logits = common.gather_from_model(
            common.copy_to_model(x).float() @ p["router"])
    else:
        logits = x.float() @ p["router"]                     # (B, S, e)
    probs = torch.softmax(logits, dim=-1)

    # Load-balance aux (Switch): e * mean_e( fraction_e * router_prob_e ).
    top1 = torch.argmax(probs, dim=-1)
    frac = torch.nn.functional.one_hot(top1, e).float().mean(dim=(0, 1))
    aux = cfg.router_aux_weight * e * torch.sum(frac * probs.mean(dim=(0, 1)))

    aux = common.first_rank_grad(aux)

    buf, flat, pos_c, w = _dispatch(x, probs, k, cap)
    e0, e1 = common.model_block(e) if split_experts else (0, e)
    if mesh is not None:
        buf = common.copy_to_model(buf)[:, e0:e1]
    # Expert FSDP: each table whole over the data axes for this use only.
    wi = common.fsdp_gather(p["wi"], TABLE_AXES["wi"])
    wg = common.fsdp_gather(p["wg"], TABLE_AXES["wg"])
    wo = common.fsdp_gather(p["wo"], TABLE_AXES["wo"])
    h = torch.nn.functional.silu(torch.einsum("becd,edf->becf", buf, wg)) * \
        torch.einsum("becd,edf->becf", buf, wi)
    del wi, wg
    out_buf = torch.einsum("becf,efd->becd", h, wo)
    del wo

    # Combine: gather each (token, k) slot back and weight by its gate.
    grp = torch.arange(b, device=x.device)[:, None]
    if mesh is None:
        picked = out_buf[grp, flat, pos_c]                   # (B, s*k, d)
        out = (picked * w[..., None]).reshape(b, s, k, d).sum(dim=2)
    else:
        local = flat - e0
        inside = (local >= 0) & (local < e1 - e0)
        # Each slot's product in the model dtype, as on one device; the
        # slots of other ranks' experts add exact zeros.
        picked = out_buf[grp, local.clamp(0, e1 - e0 - 1), pos_c]
        wl = common.copy_to_model(w) * inside.to(w.dtype)
        part = (picked * wl[..., None]).reshape(b, s, k, d).sum(dim=2)
        out = common.exit_sum(part, part.dtype)

    if "dense" in p:                                         # arctic residual
        out = out + mlp.swiglu(p["dense"], x)
    return out, aux
