"""Architecture configuration schema (torch dtypes).

Counterpart of ``repro.configs.base`` for the families the port runs so
far (dense decoders); the MoE / SSM / hybrid / encdec / VLM fields arrive
with their families.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    source: str = ""                 # citation bracket from the assignment

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult
