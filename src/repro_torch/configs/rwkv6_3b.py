"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent per-channel decay.

[arXiv:2404.05892]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    ssm_heads=40, ssm_head_dim=64,
    source="arXiv:2404.05892",
)
