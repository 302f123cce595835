"""Decoder language model, attention family (counterpart of
``repro.models.lm.DecoderLM``'s ``dense | moe | vlm`` branch).

Parameters are a plain dict keyed like the reference's tree, with
layer-stacked (L, ...) block leaves, so carrying weights across packages
is names plus ``torch.from_numpy`` and the flattening orders agree.  The
layer loop is a Python loop over ``unbind`` views of the stacked leaves
(one stacked gradient per leaf in backward); ``cfg.remat`` wraps each
block in ``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint``.  MoE blocks add the router's load-balance aux to the
loss.  The VLM prepends projected patch embeddings (a stub vision
frontend, as in the reference) and reads the loss on text positions only.
SSM / hybrid / encdec and decode come later (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, mlp, moe
from repro_torch.models.common import ParamDesc, materialize, rms_norm
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any
Tensor = torch.Tensor

#: The families the port's DecoderLM runs.
FAMILIES = ("dense", "moe", "vlm")


def _padded_vocab(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab_size, 128)


def _norm_desc(cfg: ModelConfig, layers: int, n: int) -> dict:
    L = (layers,) if layers else ()
    return {f"ln{i}": ParamDesc(L + (cfg.d_model,), cfg.dtype, "ones")
            for i in range(n)}


class DecoderLM:
    """Decoder-only LM; the port runs the dense, moe and vlm families."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
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
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = ParamDesc((d, pv), cfg.dtype)
        blocks = {"attn": attention.attn_params(cfg, L), **_norm_desc(cfg, L, 2)}
        if cfg.family == "moe":
            blocks["moe"] = moe.moe_params(cfg, L)
        else:
            blocks["mlp"] = mlp.swiglu_params(cfg, L)
        tree["blocks"] = blocks
        if cfg.family == "vlm":
            tree["projector"] = {
                "w1": ParamDesc((cfg.vision_dim, d), cfg.dtype),
                "w2": ParamDesc((d, d), cfg.dtype),
                "ln": ParamDesc((cfg.vision_dim,), cfg.dtype, "ones"),
            }
        return tree

    def init(self, seed: int, device: torch.device) -> PyTree:
        return materialize(self.param_descs(), seed, device)

    def _layers(self, blocks: dict) -> list[dict]:
        """Per-layer parameter dicts: ``unbind`` views of the stacked leaves."""
        skeleton = tree_structure(blocks)
        cols = [leaf.unbind(0) for leaf in tree_leaves(blocks)]
        return [tree_unflatten(skeleton, list(per)) for per in zip(*cols)]

    def _embed(self, params, batch: dict) -> Tensor:
        cfg = self.cfg
        x = params["embed"][batch["tokens"].long()]
        if cfg.family == "vlm":
            pr = params["projector"]
            p = rms_norm(batch["patches"].to(cfg.dtype), pr["ln"], cfg.norm_eps)
            # jax.nn.gelu's default is the tanh approximation.
            p = torch.nn.functional.gelu(p @ pr["w1"], approximate="tanh") @ pr["w2"]
            x = torch.cat([p.to(x.dtype), x], dim=1)
        return x

    def _block(self, h: Tensor, p: dict) -> tuple[Tensor, Tensor]:
        cfg = self.cfg
        h = h + attention.attention(p["attn"], rms_norm(h, p["ln0"], cfg.norm_eps),
                                    cfg)
        if cfg.family == "moe":
            f, aux = moe.moe_block(p["moe"], rms_norm(h, p["ln1"], cfg.norm_eps),
                                   cfg)
        else:
            f = mlp.swiglu(p["mlp"], rms_norm(h, p["ln1"], cfg.norm_eps))
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h + f, aux

    def _run_blocks(self, params, x: Tensor) -> tuple[Tensor, Tensor]:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in self._layers(params["blocks"]):
            if self.cfg.remat:
                x, aux_l = checkpoint(self._block, x, p, use_reentrant=False)
            else:
                x, aux_l = self._block(x, p)
            aux = aux + aux_l
        return x, aux

    def _logits(self, params, x: Tensor) -> Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (x @ head).float()

    def forward(self, params, batch: dict) -> Tensor:
        """Full-sequence logits (B, S, padded vocab) in fp32 (a VLM's S
        counts its patches)."""
        x, _ = self._run_blocks(params, self._embed(params, batch))
        return self._logits(params, x)

    def loss(self, params, batch: dict) -> tuple[Tensor, dict]:
        """Next-token cross-entropy over text positions with labels >= 0,
        plus the MoE aux; returns (ce + aux, {"ce", "aux"})."""
        cfg = self.cfg
        x, aux = self._run_blocks(params, self._embed(params, batch))
        if cfg.family == "vlm":
            x = x[:, cfg.num_patches:]          # text positions only
        logits = self._logits(params, x)
        labels = batch["labels"].long()
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
        mask = (labels >= 0).float()
        ce = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return ce + aux, {"ce": ce, "aux": aux}
