"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper); the
counterpart of ``repro.models.mlp``.  On a model mesh the ff dimension is
split: the input projections are column-parallel, the output projection
row-parallel (``common.row_parallel``), so the block's output is the
all-reduced whole on every rank."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDesc


def swiglu_params(cfg: ModelConfig, layers: int, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    L = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    return {
        "wi": ParamDesc(L + (d, ff), cfg.dtype, axes=lax + ("embed", "ff")),
        "wg": ParamDesc(L + (d, ff), cfg.dtype, axes=lax + ("embed", "ff")),
        "wo": ParamDesc(L + (ff, d), cfg.dtype, axes=lax + ("ff", "embed")),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(common.column_parallel(x, p["wg"])) * \
        common.column_parallel(x, p["wi"])
    return common.row_parallel(h, p["wo"], x.dtype)


def gelu_mlp_params(cfg: ModelConfig, layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    return {
        "wi": ParamDesc(L + (d, ff), cfg.dtype, axes=lax + ("embed", "ff")),
        "bi": ParamDesc(L + (ff,), cfg.dtype, "zeros", axes=lax + ("ff",)),
        "wo": ParamDesc(L + (ff, d), cfg.dtype, axes=lax + ("ff", "embed")),
        "bo": ParamDesc(L + (d,), cfg.dtype, "zeros", axes=lax + ("embed",)),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    h = torch.nn.functional.gelu(common.column_parallel(x, p["wi"]) + p["bi"],
                                 approximate="tanh")
    return common.row_parallel(h, p["wo"], x.dtype) + p["bo"]
