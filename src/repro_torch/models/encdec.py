"""Whisper-style encoder-decoder (counterpart of ``repro.models.encdec``).

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: the batch carries precomputed frame embeddings ``frames`` of
shape (B, encoder_seq, d_model).  Downstream is real: a non-causal
encoder, a causal decoder with cross attention over per-layer k / v
computed from the encoder output, layer norms with biases, GELU MLPs,
sinusoidal positions on both frames and tokens (no rope), and an untied
head over the padded vocab.  Parameters are layer-stacked (L, ...) dicts
keyed like the reference's tree.  ``cfg.remat`` is not read (the
reference does not remat this family).  Cached decode keeps per-layer
cross k / v of the encoder output beside the self-attention KV cache
(:meth:`EncDecLM.prefill_cache`) and steps one token at a time
(:meth:`EncDecLM.decode_step`), its position from :func:`_sinusoid_at`.
The descs carry the reference's axes and pad their heads under a
``MeshAxes`` scope, where the padded model runs whole on one device.

On a model mesh (``common.model_mesh``) the family trains split: the
encoder's non-causal attention and both stacks' GELU MLPs are column- /
row-parallel, the decoder's cross attention takes q column-parallel from
its input and k / v from the encoder output (column-parallel when the kv
heads split, so the encoder output's gradient is all-reduced; whole and
repeated otherwise), and the vocabulary splits over the embedding
(``common.embed_lookup``) and the head (:meth:`EncDecLM.loss` takes the
split ``common.masked_ce`` of this rank's logits; :meth:`EncDecLM.
forward` gathers them).  Cached decode on a model mesh runs on this
rank's shard of the cache: :meth:`EncDecLM.prefill_cache` encodes this
data rank's rows of the frames split, the cross k / v are the rank's kv
heads when they split, and :meth:`EncDecLM.decode_step` gathers the
logits over the model axis, as ``DecoderLM.decode_step`` does.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, common, mlp
from repro_torch.models.common import (
    ParamDesc, layer_norm, layer_views, masked_ce, materialize,
    sinusoidal_positions,
)

PyTree = Any
Tensor = torch.Tensor


def _ln_desc(cfg: ModelConfig, layers: int, n: int) -> dict:
    L = (layers,) if layers else ()
    axes = (("layers",) if layers else ()) + ("embed",)
    out = {}
    for i in range(n):
        out[f"ln{i}_g"] = ParamDesc(L + (cfg.d_model,), cfg.dtype, "ones",
                                    axes=axes)
        out[f"ln{i}_b"] = ParamDesc(L + (cfg.d_model,), cfg.dtype, "zeros",
                                    axes=axes)
    return out


class EncDecLM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM runs the encdec family, not "
                             f"{cfg.family!r}")
        self.cfg = cfg

    def param_descs(self) -> PyTree:
        cfg = self.cfg
        d = cfg.d_model
        pv = pad_to(cfg.vocab_size, 128)
        enc_blocks = {"attn": attention.attn_params(cfg, cfg.encoder_layers),
                      "mlp": mlp.gelu_mlp_params(cfg, cfg.encoder_layers),
                      **_ln_desc(cfg, cfg.encoder_layers, 2)}
        dec_blocks = {"self_attn": attention.attn_params(cfg, cfg.num_layers),
                      "cross_attn": attention.attn_params(cfg, cfg.num_layers),
                      "mlp": mlp.gelu_mlp_params(cfg, cfg.num_layers),
                      **_ln_desc(cfg, cfg.num_layers, 3)}
        return {
            "embed": ParamDesc((pv, d), cfg.dtype, "embed",
                               axes=("vocab", "embed")),
            "encoder": enc_blocks,
            "enc_norm": _ln_desc(cfg, 0, 1),
            "decoder": dec_blocks,
            "dec_norm": _ln_desc(cfg, 0, 1),
            "lm_head": ParamDesc((d, pv), cfg.dtype, axes=("embed", "vocab")),
        }

    def init(self, seed: int, device: torch.device) -> PyTree:
        return materialize(self.param_descs(), seed, device)

    # -- encoder ------------------------------------------------------------

    def encode(self, params, frames: Tensor) -> Tensor:
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
        for p in layer_views(params["encoder"]):
            x = x + attention.attention(
                p["attn"], layer_norm(x, p["ln0_g"], p["ln0_b"], cfg.norm_eps),
                cfg, causal=False, use_rope=False)
            x = x + mlp.gelu_mlp(
                p["mlp"], layer_norm(x, p["ln1_g"], p["ln1_b"], cfg.norm_eps))
        en = params["enc_norm"]
        return layer_norm(x, en["ln0_g"], en["ln0_b"], cfg.norm_eps)

    def _cross_kv(self, params, enc: Tensor) -> tuple[Tensor, Tensor]:
        """Per-layer cross k / v from the encoder output: (L, B, S, hkv,
        hd); on a model mesh with split kv heads this rank's, from
        column-parallel products."""
        cfg = self.cfg
        b, s = enc.shape[:2]
        split_kv = common.model_mesh() is not None and \
            common.get_mesh_axes().shard_kv
        proj = common.column_parallel if split_kv else torch.matmul
        ks, vs = [], []
        for p in layer_views(params["decoder"]["cross_attn"]):
            k, v = proj(enc, p["wk"]), proj(enc, p["wv"])
            if cfg.qkv_bias:
                k, v = k + p["bk"], v + p["bv"]
            ks.append(k.reshape(b, s, -1, cfg.head_dim))
            vs.append(v.reshape(b, s, -1, cfg.head_dim))
        return torch.stack(ks), torch.stack(vs)

    # -- decoder ------------------------------------------------------------

    def _decode_blocks(self, params, x: Tensor, ck: Tensor, cv: Tensor
                       ) -> Tensor:
        cfg = self.cfg
        eps = cfg.norm_eps
        for p, k_l, v_l in zip(layer_views(params["decoder"]), ck, cv):
            x = x + attention.attention(
                p["self_attn"], layer_norm(x, p["ln0_g"], p["ln0_b"], eps),
                cfg, causal=True, use_rope=False)
            x = x + attention.attention(
                p["cross_attn"], layer_norm(x, p["ln1_g"], p["ln1_b"], eps),
                cfg, kv_override=(k_l, v_l))
            x = x + mlp.gelu_mlp(
                p["mlp"], layer_norm(x, p["ln2_g"], p["ln2_b"], eps))
        return x

    def _logits(self, params, x: Tensor) -> Tensor:
        """fp32 logits; on a model mesh this rank's vocabulary block."""
        dn = params["dec_norm"]
        x = layer_norm(x, dn["ln0_g"], dn["ln0_b"], self.cfg.norm_eps)
        return common.column_parallel(x, params["lm_head"]).float()

    def _hidden(self, params, batch: dict) -> Tensor:
        """The decoder's last hidden states over the batch's tokens."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"])
        ck, cv = self._cross_kv(params, enc)
        x = common.embed_lookup(params["embed"], batch["tokens"])
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
        return self._decode_blocks(params, x, ck, cv)

    def forward(self, params, batch: dict) -> Tensor:
        """Full-sequence logits (B, S, padded vocab) in fp32; on a model
        mesh the ranks' vocabulary blocks gathered."""
        return common.gather_from_model(
            self._logits(params, self._hidden(params, batch)))

    def loss(self, params, batch: dict) -> tuple[Tensor, dict]:
        """Next-token cross-entropy over labels >= 0; returns (ce, {"ce",
        "aux"}) with a zero aux."""
        ce = masked_ce(self._logits(params, self._hidden(params, batch)),
                       batch["labels"])
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                                  device=ce.device)}

    # -- cached decode ------------------------------------------------------

    def cache_descs(self, batch: int, max_seq: int) -> PyTree:
        """The self-attention ``k`` / ``v`` (L, B, max_seq, hkv, hd) and the
        cross ``cross_k`` / ``cross_v`` (L, B, encoder_seq, hkv, hd), all
        zeros in the model dtype; the cross pair's batch over the data
        axes and its kv heads over the model axis when they split."""
        cfg = self.cfg
        ctx = common.get_mesh_axes()
        kv_sharded = bool(ctx and ctx.shard_kv and ctx.model_par > 1)
        cross = ParamDesc((cfg.num_layers, batch, cfg.encoder_seq,
                           attention.hkv_of(cfg), cfg.head_dim), cfg.dtype,
                          "zeros",
                          axes=("layers", "batch" if batch > 1 else None, None,
                                "kv" if kv_sharded else None, None))
        return {**attention.cache_desc(cfg, cfg.num_layers, batch, max_seq),
                "cross_k": cross, "cross_v": cross}

    def init_cache(self, batch: int, max_seq: int,
                   device: torch.device) -> PyTree:
        """A zero cache, the cross k / v zeros too (what a serving engine
        that never sees frames starts from); :meth:`prefill_cache` fills
        them from the frames."""
        return materialize(self.cache_descs(batch, max_seq), 0, device)

    def prefill_cache(self, params, frames: Tensor, batch: int,
                      max_seq: int) -> PyTree:
        """Encode ``frames`` (B, encoder_seq, d) once; the cache's cross k /
        v are the per-layer projections of the encoder output, its self
        k / v zeros.  On a model mesh ``frames`` are the whole batch's:
        this data rank encodes its rows (``common.batch_block``) and keeps
        its shard of the cache (the cross pair's kv heads when they
        split)."""
        cfg = self.cfg
        lo, hi = common.batch_block(batch)
        with torch.inference_mode():
            enc = self.encode(params, frames[lo:hi])
            ck, cv = self._cross_kv(params, enc)
            self_kv = materialize(
                attention.cache_desc(cfg, cfg.num_layers, batch, max_seq), 0,
                enc.device)
        return {**self_kv, "cross_k": ck, "cross_v": cv}

    def decode_step(self, params, cache: PyTree, tokens: Tensor, pos: int,
                    *, batch: Optional[int] = None,
                    max_seq: Optional[int] = None) -> tuple[Tensor, PyTree]:
        """One decode step.  tokens: (B, 1) ints; pos: a host int.  Returns
        (logits (B, 1, padded vocab) fp32, cache), the self k / v written
        IN PLACE (the cross pair is only read); runs under
        ``torch.inference_mode()``.  On a model mesh as
        ``DecoderLM.decode_step``: this rank's shard and rows, the whole
        cache's ``batch`` / ``max_seq``."""
        cfg = self.cfg
        eps = cfg.norm_eps
        seq_axes = attention.cache_seq_axes(cfg, batch, max_seq)
        with torch.inference_mode():
            x = common.embed_lookup(params["embed"], tokens)
            x = x + _sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)
            dec = params["decoder"]
            if attention.replicated(cfg):
                # Replicated attention: the self and cross q / o leaves of
                # every layer whole, gathered in one collective.
                dec = dict(dec)
                dec["self_attn"], dec["cross_attn"] = attention.decode_qo(
                    dec["self_attn"], dec["cross_attn"])
            for p, ck, cv, xk, xv in zip(
                    layer_views(dec), cache["k"].unbind(0),
                    cache["v"].unbind(0), cache["cross_k"].unbind(0),
                    cache["cross_v"].unbind(0)):
                a, _, _ = attention.decode_attention(
                    p["self_attn"], layer_norm(x, p["ln0_g"], p["ln0_b"], eps),
                    ck, cv, pos, cfg, use_rope=False, seq_axes=seq_axes)
                x = x + a
                c, _, _ = attention.decode_attention(
                    p["cross_attn"], layer_norm(x, p["ln1_g"], p["ln1_b"], eps),
                    ck, cv, pos, cfg, kv_override=(xk, xv))
                x = x + c
                x = x + mlp.gelu_mlp(
                    p["mlp"], layer_norm(x, p["ln2_g"], p["ln2_b"], eps))
            return common.gather_from_model(self._logits(params, x)), cache


def _sinusoid_at(pos: int, dim: int, device: torch.device) -> Tensor:
    """The (1, 1, dim) sin | cos position at ``pos``, computed in fp32
    (``pos / 10000^(2i / dim)``), as the reference's decode computes it
    (its forward's table is float64 numpy: :func:`sinusoidal_positions`)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    angle = torch.full((), float(pos), dtype=torch.float32, device=device) / \
        torch.pow(10000.0, 2 * i / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)])[None, None, :]
