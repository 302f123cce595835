"""Parameter descriptors and shared layer math (counterpart of
``repro.models.common``, without the mesh / sharding machinery)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"          # normal | zeros | ones | embed


def _is_desc(x) -> bool:
    return isinstance(x, ParamDesc)


def materialize(tree, seed: int, device: torch.device):
    """Initialize a ParamDesc tree from one seeded ``torch.Generator``,
    leaves in jax's order, with the reference's stds (``1 /
    sqrt(fan_in)``, fan_in = shape[-2] for a >=2-D "normal" leaf, else
    shape[-1]).  The numbers differ from the reference's threefry draws;
    tests carry the reference's parameters across with ``interop``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def init_one(d: ParamDesc) -> Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=d.dtype, device=device)
        if d.init in ("normal", "embed"):
            fan_in = d.shape[-2] if len(d.shape) >= 2 and d.init == "normal" \
                else d.shape[-1]
            std = 1.0 / math.sqrt(max(1, fan_in))
            w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return (w.mul_(std)).to(d.dtype)
        raise ValueError(d.init)

    leaves = [init_one(d) for d in tree_leaves(tree)]
    return tree_unflatten(tree_structure(tree), leaves)


def rms_norm(x: Tensor, gamma: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


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
