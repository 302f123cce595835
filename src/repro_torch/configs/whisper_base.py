"""whisper-base [audio] — enc-dec transformer; conv frontend stubbed
(the batch carries precomputed frame embeddings).

[arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    encoder_layers=6, encoder_seq=1500,
    source="arXiv:2212.04356",
)
