"""internvl2-2b [vlm] — InternViT (stub frontend) + InternLM2 decoder.

[arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
    d_ff=8192, vocab_size=92553, head_dim=128,
    num_patches=256, vision_dim=1024,
    source="arXiv:2404.16821",
)
