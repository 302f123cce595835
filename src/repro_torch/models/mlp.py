"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper); the
counterpart of ``repro.models.mlp``."""
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


def gelu_mlp_params(cfg: ModelConfig, layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = (layers,) if layers else ()
    return {
        "wi": ParamDesc(L + (d, ff), cfg.dtype),
        "bi": ParamDesc(L + (ff,), cfg.dtype, "zeros"),
        "wo": ParamDesc(L + (ff, d), cfg.dtype),
        "bo": ParamDesc(L + (d,), cfg.dtype, "zeros"),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    h = torch.nn.functional.gelu(x @ p["wi"] + p["bi"], approximate="tanh")
    return h @ p["wo"] + p["bo"]
