"""Architecture registry: public --arch ids -> ModelConfig.

Only the archs whose family the port runs are registered; the others
arrive with their families (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=128,
    tiny vocab, fp32 (the reference's ``reduced_config`` widths)."""
    cfg = get_config(arch)
    kw = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
    )
    kw.update(dtype=torch.float32, name=cfg.name + "-reduced")
    return cfg.replace(**kw)


__all__ = ["ARCH_IDS", "ModelConfig", "get_config", "reduced_config"]
