"""Architecture configuration schema + input-shape registry (torch dtypes).

Counterpart of ``repro.configs.base`` for every family: dense, MoE,
VLM, SSM (rwkv6), hybrid (zamba2) and encoder-decoder (whisper).  The
reference's ``scan_unroll`` (a ``lax.scan`` knob) and ``gqa_einsum`` (a
decode option) have no meaning here and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 2
    moe_dense_ff: int = 0            # parallel dense residual FFN (arctic)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / rwkv6) ---
    ssm_state: int = 0               # N (mamba2 state) or unused for rwkv
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    # --- hybrid (zamba2) ---
    attn_every: int = 0              # shared attn block cadence; 0 = never
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # frames after the (stubbed) conv frontend
    # --- VLM (internvl2) ---
    num_patches: int = 0
    vision_dim: int = 0
    # --- numerics / execution ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    remat: bool = False              # activation checkpointing around each block
    source: str = ""                 # citation bracket from the assignment

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid native; attention via SWA."""
        if self.family in ("ssm", "hybrid"):
            return True
        if self.family == "encdec":
            return False             # whisper: <=448-token decode grammar
        return True                  # dense/moe/vlm via sliding_window override


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult
