"""SwiGLU feed-forward block (counterpart of ``repro.models.mlp.swiglu``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc


def swiglu_params(cfg: ModelConfig, layers: int, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    L = (layers,) if layers else ()
    return {
        "wi": ParamDesc(L + (d, ff), cfg.dtype),
        "wg": ParamDesc(L + (d, ff), cfg.dtype),
        "wo": ParamDesc(L + (ff, d), cfg.dtype),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]
