"""Decoder language model: dense / MoE / VLM / RWKV6 / Zamba2-hybrid
(counterpart of ``repro.models.lm.DecoderLM``).

Parameters are a plain dict keyed like the reference's tree, with
layer-stacked (L, ...) block leaves, so carrying weights across packages
is names plus ``torch.from_numpy`` and the flattening orders agree.  The
layer loop is a Python loop over ``unbind`` views of the stacked leaves
(one stacked gradient per leaf in backward); ``cfg.remat`` wraps each
block in ``torch.utils.checkpoint`` (non-reentrant), the reference's
``jax.checkpoint``.  MoE blocks add the router's load-balance aux to the
loss.  The VLM prepends projected patch embeddings (a stub vision
frontend, as in the reference) and reads the loss on text positions only.
The SSM family (rwkv6) runs time mix and channel mix per layer; the
hybrid (zamba2) runs its Mamba2 layers in groups of ``attn_every``, each
group followed by the one shared attention + SwiGLU block (one set of
leaves, its gradient summed over the groups); ``remat`` wraps the Mamba2
block and the shared block separately.  The encoder-decoder family is
:class:`repro_torch.models.encdec.EncDecLM`; cached decode comes later
(ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, mlp, moe, rwkv, ssm
from repro_torch.models.common import (
    ParamDesc, layer_views, masked_ce, materialize, rms_norm,
)

PyTree = Any
Tensor = torch.Tensor

#: The families DecoderLM runs (encdec is EncDecLM's).
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def _padded_vocab(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab_size, 128)


def _norm_desc(cfg: ModelConfig, layers: int, n: int) -> dict:
    L = (layers,) if layers else ()
    return {f"ln{i}": ParamDesc(L + (cfg.d_model,), cfg.dtype, "ones")
            for i in range(n)}


class DecoderLM:
    """Decoder-only LM for the families dense, moe, vlm, ssm and hybrid."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"DecoderLM runs no family {cfg.family!r}")
        if cfg.family == "hybrid" and cfg.num_layers % cfg.attn_every:
            raise ValueError(
                f"hybrid depth {cfg.num_layers} is not a multiple of "
                f"attn_every={cfg.attn_every}")
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
        if cfg.family == "ssm":            # rwkv6
            tree["blocks"] = {"rwkv": rwkv.rwkv_params(cfg, L),
                              **_norm_desc(cfg, L, 2)}
        elif cfg.family == "hybrid":       # zamba2
            tree["blocks"] = {"ssm": ssm.ssm_params(cfg, L),
                              **_norm_desc(cfg, L, 1)}
            tree["shared"] = {"attn": attention.attn_params(cfg, 0),
                              "mlp": mlp.swiglu_params(cfg, 0),
                              **_norm_desc(cfg, 0, 2)}
        else:
            blocks = {"attn": attention.attn_params(cfg, L),
                      **_norm_desc(cfg, L, 2)}
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
        if cfg.family == "ssm":
            h = h + rwkv.time_mix(p["rwkv"], rms_norm(h, p["ln0"], cfg.norm_eps),
                                  cfg)
            h = h + rwkv.channel_mix(p["rwkv"],
                                     rms_norm(h, p["ln1"], cfg.norm_eps), cfg)
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        h = h + attention.attention(p["attn"], rms_norm(h, p["ln0"], cfg.norm_eps),
                                    cfg)
        if cfg.family == "moe":
            f, aux = moe.moe_block(p["moe"], rms_norm(h, p["ln1"], cfg.norm_eps),
                                   cfg)
        else:
            f = mlp.swiglu(p["mlp"], rms_norm(h, p["ln1"], cfg.norm_eps))
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h + f, aux

    def _mamba_block(self, h: Tensor, p: dict) -> Tensor:
        return h + ssm.ssm_block(p["ssm"], rms_norm(h, p["ln0"],
                                                    self.cfg.norm_eps), self.cfg)

    def _shared_block(self, h: Tensor, shared: dict) -> Tensor:
        cfg = self.cfg
        h = h + attention.attention(shared["attn"],
                                    rms_norm(h, shared["ln0"], cfg.norm_eps), cfg)
        return h + mlp.swiglu(shared["mlp"],
                              rms_norm(h, shared["ln1"], cfg.norm_eps))

    def _remat(self, fn, *args):
        if self.cfg.remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def _run_blocks(self, params, x: Tensor) -> tuple[Tensor, Tensor]:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.family == "hybrid":
            every = self.cfg.attn_every
            for i, p in enumerate(layer_views(params["blocks"])):
                x = self._remat(self._mamba_block, x, p)
                if (i + 1) % every == 0:
                    x = self._remat(self._shared_block, x, params["shared"])
            return x, aux
        for p in layer_views(params["blocks"]):
            x, aux_l = self._remat(self._block, x, p)
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
        ce = masked_ce(self._logits(params, x), batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
