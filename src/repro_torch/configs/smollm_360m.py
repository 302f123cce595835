"""smollm-360m [dense] — llama-arch small; GQA kv=5.

[hf:HuggingFaceTB/SmolLM-135M]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5,
    d_ff=2560, vocab_size=49152, head_dim=64, tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
