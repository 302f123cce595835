"""Model zoo of the port: the attention family (dense, MoE, VLM) so far."""
from repro_torch.models.common import ParamDesc, materialize
from repro_torch.models.lm import DecoderLM
from repro_torch.models.registry import build_model

__all__ = ["DecoderLM", "ParamDesc", "build_model", "materialize"]
