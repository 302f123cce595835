"""Model registry: ModelConfig -> assembled model object."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import FAMILIES, DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family in FAMILIES:
        return DecoderLM(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, item 14)")
