"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

[arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_heads=80, ssm_head_dim=64, ssm_expand=2,
    attn_every=6,
    source="arXiv:2411.15242",
)
