"""Model registry: ModelConfig -> assembled model object."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import FAMILIES, DecoderLM


def build_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    if cfg.family in FAMILIES:
        return DecoderLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
