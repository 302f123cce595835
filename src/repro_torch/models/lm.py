"""Decoder language model, dense family (counterpart of
``repro.models.lm.DecoderLM``).

Parameters are a plain dict keyed like the reference's tree, with
layer-stacked (L, ...) block leaves, so carrying weights across packages
is names plus ``torch.from_numpy`` and the flattening orders agree.  The
layer loop is a Python loop over ``unbind`` views of the stacked leaves
(one stacked gradient per leaf in backward).  MoE / SSM / hybrid / VLM /
encdec and decode come later (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, mlp
from repro_torch.models.common import ParamDesc, materialize, rms_norm
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any
Tensor = torch.Tensor


def _padded_vocab(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab_size, 128)


class DecoderLM:
    """Decoder-only LM; the port runs the dense family."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, "
                "item 14)")
        self.cfg = cfg

    def param_descs(self) -> PyTree:
        cfg = self.cfg
        d, L = cfg.d_model, cfg.num_layers
        pv = _padded_vocab(cfg)
        tree: dict = {
            "embed": ParamDesc((pv, d), cfg.dtype, "embed"),
            "final_norm": ParamDesc((d,), cfg.dtype, "ones"),
            "blocks": {
                "attn": attention.attn_params(cfg, L),
                "ln0": ParamDesc((L, d), cfg.dtype, "ones"),
                "ln1": ParamDesc((L, d), cfg.dtype, "ones"),
                "mlp": mlp.swiglu_params(cfg, L),
            },
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = ParamDesc((d, pv), cfg.dtype)
        return tree

    def init(self, seed: int, device: torch.device) -> PyTree:
        return materialize(self.param_descs(), seed, device)

    def _layers(self, blocks: dict) -> list[dict]:
        """Per-layer parameter dicts: ``unbind`` views of the stacked leaves."""
        skeleton = tree_structure(blocks)
        cols = [leaf.unbind(0) for leaf in tree_leaves(blocks)]
        return [tree_unflatten(skeleton, list(per)) for per in zip(*cols)]

    def _logits(self, params, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (x @ head).float()

    def forward(self, params, batch: dict) -> Tensor:
        """Full-sequence logits (B, S, padded vocab) in fp32."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"].long()]
        for p in self._layers(params["blocks"]):
            x = x + attention.attention(p["attn"],
                                        rms_norm(x, p["ln0"], cfg.norm_eps), cfg)
            x = x + mlp.swiglu(p["mlp"], rms_norm(x, p["ln1"], cfg.norm_eps))
        return self._logits(params, x)

    def loss(self, params, batch: dict) -> tuple[Tensor, dict]:
        """Next-token cross-entropy over positions with labels >= 0."""
        logits = self.forward(params, batch)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return ce, {"ce": ce}
