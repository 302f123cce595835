"""Launch-time config resolution: shape-dependent overrides + skips.

Counterpart of ``repro.launch.launch_config``.  ``fsdp_keys_for`` picks
selective robustness (``TrainerConfig.fsdp_keys``) for the giant MoE
configs: ask it of the FULL config, before any cut in depth, since the
expert table it weighs grows with the layer count.
"""
from __future__ import annotations

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig

#: expert-table size (params) above which experts go FSDP + selective
#: robustness (per-worker state is Theta(n |theta|)).
FSDP_EXPERT_THRESHOLD = 20e9

FSDP_KEYS = ("['moe']['wi']", "['moe']['wg']", "['moe']['wo']")

#: long_500k sliding-window override for full-attention archs (the
#: assignment's sanctioned sub-quadratic variant).
LONG_CONTEXT_WINDOW = 4096


def expert_param_count(cfg: ModelConfig) -> float:
    if not cfg.num_experts:
        return 0.0
    return 3.0 * cfg.num_experts * cfg.d_model * cfg.d_ff * cfg.num_layers


def wants_fsdp_experts(cfg: ModelConfig) -> bool:
    return expert_param_count(cfg) > FSDP_EXPERT_THRESHOLD


def skip_reason(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.supports_long_decode():
        return ("whisper enc-dec: <=448-token decode grammar; 524k-token "
                "decode is not a meaningful configuration (DESIGN.md)")
    return None


def launch_config(arch: str, shape_name: str) -> ModelConfig:
    """Full-scale config with shape-dependent execution overrides."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    overrides: dict = {}
    if shape.kind == "train":
        overrides["remat"] = True
    if shape_name == "long_500k" and cfg.family not in ("ssm", "hybrid") \
            and cfg.sliding_window is None:
        overrides["sliding_window"] = LONG_CONTEXT_WINDOW
    return cfg.replace(**overrides) if overrides else cfg


def fsdp_keys_for(cfg: ModelConfig) -> tuple[str, ...]:
    return FSDP_KEYS if wants_fsdp_experts(cfg) else ()
