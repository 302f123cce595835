"""minitron-8b [dense] — pruned nemotron; huge vocab.

[arXiv:2407.14679]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=16384, vocab_size=256000, head_dim=128,
    source="arXiv:2407.14679",
)
