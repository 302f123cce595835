"""Architecture registry: public --arch ids -> ModelConfig.

The reference's ten archs: the attention family (dense, MoE, VLM),
rwkv6-3b (SSM), zamba2-2.7b (hybrid) and whisper-base (encoder-decoder).
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, InputShape, ModelConfig

_ARCH_MODULES = {
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """CPU-smoke variant of the same family: 2 layers, d_model<=128,
    <=4 experts, small SSM heads, tiny vocab, fp32 (the reference's
    ``reduced_config``)."""
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
    if cfg.num_experts:
        kw.update(num_experts=4, moe_dense_ff=64 if cfg.moe_dense_ff else 0)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_heads=4, ssm_head_dim=16, ssm_state=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(attn_every=1)
    if cfg.family == "encdec":
        kw.update(encoder_layers=2, encoder_seq=32)
    if cfg.family == "vlm":
        kw.update(num_patches=8, vision_dim=64)
    kw.update(dtype=torch.float32, name=cfg.name + "-reduced")
    return cfg.replace(**kw)


__all__ = ["ARCH_IDS", "InputShape", "ModelConfig", "SHAPES", "get_config",
           "reduced_config"]
