"""Model zoo of the port: dense, MoE, VLM, RWKV6, Zamba2-hybrid and the
whisper encoder-decoder."""
from repro_torch.models.common import ParamDesc, materialize
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.lm import DecoderLM
from repro_torch.models.registry import build_model

__all__ = ["DecoderLM", "EncDecLM", "ParamDesc", "build_model", "materialize"]
