"""Parameter descriptors and shared layer math (counterpart of
``repro.models.common``, without the mesh / sharding machinery)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # stddev multiplier (normal) / value (ones)


def _is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def materialize(tree, seed: int, device: torch.device):
    """Initialize a ParamDesc tree from one seeded ``torch.Generator``,
    leaves in jax's order, with the reference's stds (``scale /
    sqrt(fan_in)``, fan_in = shape[-2] for a >=2-D "normal" leaf, else
    shape[-1]) and constants (a "ones" leaf holds ``scale``).  The numbers
    differ from the reference's threefry draws; tests carry the
    reference's parameters across with ``interop``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def init_one(d: ParamDesc) -> Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.full(d.shape, d.scale or 1.0, dtype=d.dtype,
                              device=device)
        if d.init in ("normal", "embed"):
            fan_in = d.shape[-2] if len(d.shape) >= 2 and d.init == "normal" \
                else d.shape[-1]
            std = d.scale / math.sqrt(max(1, fan_in))
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return (w.mul_(std)).to(d.dtype)
        raise ValueError(d.init)

    leaves = [init_one(d) for d in tree_leaves(tree)]
    return tree_unflatten(tree_structure(tree), leaves)


def masked_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean next-token cross-entropy over the positions with labels >= 0."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def layer_views(blocks: dict) -> list[dict]:
    """Per-layer parameter dicts of a layer-stacked (L, ...) tree:
    ``unbind`` views of its leaves (one stacked gradient per leaf)."""
    skeleton = tree_structure(blocks)
    cols = [leaf.unbind(0) for leaf in tree_leaves(blocks)]
    return [tree_unflatten(skeleton, list(per)) for per in zip(*cols)]


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor, beta: Tensor, eps: float = 1e-5
               ) -> Tensor:
    """Two-pass fp32 mean and variance, gain and bias in fp32, cast back
    (the reference's arithmetic, written out)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * gamma.float() + beta.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 1e4,
               device: Optional[torch.device] = None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 1e4) -> Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs     # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int,
                         device: Optional[torch.device] = None) -> Tensor:
    """(seq, dim) sin | cos table, built in float64 numpy and returned in
    fp32, as the reference builds it."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    emb = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(emb.astype(np.float32)).to(device)
