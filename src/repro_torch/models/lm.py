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
:class:`repro_torch.models.encdec.EncDecLM`.

On a model mesh (``common.model_mesh``: a :class:`~repro_torch.models.
common.MeshAxes` scope whose model axis the active mesh holds) every
family trains split: each rank holds its shard of every leaf
(``common.shard_slice``), the vocabulary is split over the embedding
(``common.embed_lookup``: a masked lookup, then an all-reduce) and the
head (``common.masked_ce`` all-reduces the max, the sum of exponentials
and the label's logit; :meth:`DecoderLM.forward` gathers the logits),
tied embeddings included.  The blocks split by heads / ff / experts
(``attention``, ``mlp``, ``moe``), rwkv6's time and channel mix and the
Mamba2 mixer by their heads (``rwkv``, ``ssm``); zamba2's shared block
runs split once per group, its gradient summed over the groups as on one
device.  The VLM's projector is replicated: its input gradient arrives
whole, the blocks' column-parallel products having all-reduced it.

``MeshAxes.seq_par`` (the reference's ``_sp`` points) holds the residual
stream as this rank's block of the sequence between the sub-blocks
(``common.seq_parallel``): the embedding's sum over the vocabulary
blocks is reduce-scattered over the sequence (a VLM's patches, then its
text), each norm runs on the block, each attention / MLP / MoE / time-
or channel-mix / Mamba2 sub-block gathers the whole sequence at its entry
(``common.gather_seq``: the token shifts, the conv window and rope's
global positions see it whole) and reduce-scatters its row-parallel exit
(``common.exit_sum``); the final norm runs on the block and the sequence
is gathered before the split head and ``masked_ce``.  The sequence must
divide over the model axis (:func:`check_model_mesh`).  ``expert_fsdp``
is the MoE tables' (``moe``).  Decode has no ``_sp`` in the reference
and ignores ``seq_par``.

Cached decode (:meth:`DecoderLM.decode_step`) steps one token through
every layer against a stacked cache (:meth:`DecoderLM.init_cache`): the
KV cache for dense / moe / vlm, the RWKV state and token shifts for ssm,
the Mamba2 state and conv window plus one KV slot per shared-block group
for hybrid.  The cache is updated in place.  On a model mesh the cache
is this rank's shard as the descs lay it out (the batch over the data
axes; the KV cache's kv heads, or a long span's sequence, the RWKV
state's heads and the Mamba2 state's heads and conv channels over the
model axis), the tokens are this data rank's rows, and the logits are
gathered over the model axis into the whole padded vocabulary, as the
reference returns them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, common, mlp, moe, rwkv, ssm
from repro_torch.models.common import (
    ParamDesc, layer_views, masked_ce, materialize, rms_norm,
)
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any
Tensor = torch.Tensor

#: The families DecoderLM runs (encdec is EncDecLM's).
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")


def check_model_mesh(cfg: ModelConfig, seq_len: Optional[int] = None) -> None:
    """Raise for what a model mesh cannot run: under ``seq_par`` a
    sequence of ``seq_len`` positions (a VLM's patches included) that
    does not split over the model axis."""
    axes = common.get_mesh_axes()
    if seq_len is None or common.model_mesh() is None or not axes.seq_par:
        return
    if seq_len % axes.model_par:
        raise ValueError(f"seq_par: a sequence of {seq_len} positions does "
                         f"not split over {axes.model_par} model ranks")


def _padded_vocab(cfg: ModelConfig) -> int:
    return pad_to(cfg.vocab_size, 128)


def _norm_desc(cfg: ModelConfig, layers: int, n: int) -> dict:
    L = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    return {f"ln{i}": ParamDesc(L + (cfg.d_model,), cfg.dtype, "ones",
                                axes=lax + ("embed",)) for i in range(n)}


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
            "embed": ParamDesc((pv, d), cfg.dtype, "embed",
                               axes=("vocab", "embed")),
            "final_norm": ParamDesc((d,), cfg.dtype, "ones", axes=("embed",)),
        }
        if not cfg.tie_embeddings:
            tree["lm_head"] = ParamDesc((d, pv), cfg.dtype,
                                        axes=("embed", "vocab"))
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
                "w1": ParamDesc((cfg.vision_dim, d), cfg.dtype,
                                axes=(None, "embed")),
                "w2": ParamDesc((d, d), cfg.dtype, axes=("embed", "embed")),
                "ln": ParamDesc((cfg.vision_dim,), cfg.dtype, "ones",
                                axes=(None,)),
            }
        return tree

    def init(self, seed: int, device: torch.device) -> PyTree:
        return materialize(self.param_descs(), seed, device)

    def _seq_par(self) -> bool:
        """Hold the residual stream as sequence blocks (``MeshAxes.
        seq_par`` on a model mesh; the reference's ``_sp`` points)."""
        axes = common.get_mesh_axes()
        return bool(axes is not None and axes.seq_par
                    and common.model_mesh() is not None)

    def _seq_params(self, params):
        """Under sequence parallelism every leaf the model axis does not
        split is read through ``common.reduce_grads`` once: its gradient
        on a rank is a part (``common.seq_parallel``)."""
        axes = common.get_mesh_axes()
        specs = common.leaf_specs(self.param_descs())
        leaves = [leaf if axes.model in spec else common.reduce_grads(leaf)
                  for leaf, spec in zip(tree_leaves(params), specs)]
        return tree_unflatten(tree_structure(params), leaves)

    def _embed(self, params, batch: dict) -> Tensor:
        cfg = self.cfg
        prefix = None
        if cfg.family == "vlm":
            pr = params["projector"]
            p = rms_norm(batch["patches"].to(cfg.dtype), pr["ln"], cfg.norm_eps)
            # jax.nn.gelu's default is the tanh approximation.
            prefix = torch.nn.functional.gelu(p @ pr["w1"],
                                              approximate="tanh") @ pr["w2"]
        return common.embed_lookup(params["embed"], batch["tokens"], prefix)

    def _block(self, h: Tensor, p: dict) -> tuple[Tensor, Tensor]:
        cfg = self.cfg
        enter = common.gather_seq
        if cfg.family == "ssm":
            h = h + rwkv.time_mix(p["rwkv"],
                                  enter(rms_norm(h, p["ln0"], cfg.norm_eps)),
                                  cfg)
            h = h + rwkv.channel_mix(
                p["rwkv"], enter(rms_norm(h, p["ln1"], cfg.norm_eps)), cfg)
            return h, torch.zeros((), dtype=torch.float32, device=h.device)
        h = h + attention.attention(
            p["attn"], enter(rms_norm(h, p["ln0"], cfg.norm_eps)), cfg)
        x = enter(rms_norm(h, p["ln1"], cfg.norm_eps))
        if cfg.family == "moe":
            f, aux = moe.moe_block(p["moe"], x, cfg)
        else:
            f = mlp.swiglu(p["mlp"], x)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h + f, aux

    def _mamba_block(self, h: Tensor, p: dict) -> Tensor:
        return h + ssm.ssm_block(p["ssm"], common.gather_seq(
            rms_norm(h, p["ln0"], self.cfg.norm_eps)), self.cfg)

    def _shared_block(self, h: Tensor, shared: dict) -> Tensor:
        cfg = self.cfg
        h = h + attention.attention(shared["attn"], common.gather_seq(
            rms_norm(h, shared["ln0"], cfg.norm_eps)), cfg)
        return h + mlp.swiglu(shared["mlp"], common.gather_seq(
            rms_norm(h, shared["ln1"], cfg.norm_eps)))

    def _remat(self, fn, *args):
        if self.cfg.remat:
            on = common.seq_split()
            return checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
                common.seq_parallel(on), common.seq_parallel(on)))
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

    def _head(self, params, x: Tensor, skip: int = 0) -> Tensor:
        """Logits of positions ``skip`` onward: the final norm (on this
        rank's block under sequence parallelism, the whole sequence then
        gathered), then the head, column-parallel over the vocabulary."""
        cfg = self.cfg
        if common.seq_split():
            x = common.gather_seq(rms_norm(x, params["final_norm"],
                                           cfg.norm_eps))[:, skip:]
        else:
            x = rms_norm(x[:, skip:], params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return common.column_parallel(x, head).float()

    def _trunk(self, params, batch: dict) -> tuple[Tensor, Tensor]:
        cfg = self.cfg
        check_model_mesh(cfg, batch["tokens"].shape[-1] + (
            cfg.num_patches if cfg.family == "vlm" else 0))
        x = self._embed(params, batch)
        return self._run_blocks(params, x)

    def forward(self, params, batch: dict) -> Tensor:
        """Full-sequence logits (B, S, padded vocab) in fp32 (a VLM's S
        counts its patches); on a model mesh the ranks' vocabulary blocks
        gathered."""
        with common.seq_parallel(self._seq_par()):
            if common.seq_split():
                params = self._seq_params(params)
            x, _ = self._trunk(params, batch)
            return common.gather_from_model(self._head(params, x))

    def loss(self, params, batch: dict) -> tuple[Tensor, dict]:
        """Next-token cross-entropy over text positions with labels >= 0,
        plus the MoE aux; returns (ce + aux, {"ce", "aux"})."""
        cfg = self.cfg
        with common.seq_parallel(self._seq_par()):
            if common.seq_split():
                params = self._seq_params(params)
            x, aux = self._trunk(params, batch)
            skip = cfg.num_patches if cfg.family == "vlm" else 0
            ce = masked_ce(self._head(params, x, skip), batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    # -- decode -------------------------------------------------------------

    def cache_descs(self, batch: int, max_seq: int) -> PyTree:
        cfg = self.cfg
        if cfg.family == "ssm":
            return rwkv.rwkv_cache_desc(cfg, cfg.num_layers, batch)
        if cfg.family == "hybrid":
            groups = cfg.num_layers // cfg.attn_every
            return {"ssm": ssm.ssm_cache_desc(cfg, cfg.num_layers, batch),
                    "attn": attention.cache_desc(cfg, groups, batch, max_seq)}
        return attention.cache_desc(cfg, cfg.num_layers, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int,
                   device: torch.device) -> PyTree:
        """A zero cache for ``batch`` rows of up to ``max_seq`` positions."""
        return materialize(self.cache_descs(batch, max_seq), 0, device)

    def decode_step(self, params, cache: PyTree, tokens: Tensor, pos: int,
                    *, batch: Optional[int] = None,
                    max_seq: Optional[int] = None) -> tuple[Tensor, PyTree]:
        """One decode step.  tokens: (B, 1) ints; pos: the position, a host
        int.  Returns (logits (B, 1, padded vocab) fp32, cache).

        The cache is written IN PLACE and returned as the same dict (the
        reference returns a new cache): a caller that needs the old one
        clones it first.  Runs under ``torch.inference_mode()``.  A VLM
        embeds tokens only, as the reference's decode does.  MoE runs
        :func:`repro_torch.models.moe.moe_block` on the (B, 1, d) slice:
        capacity ``int(cf * k / e) + 1`` per batch row, which one token
        never overflows (with the experts split too: every rank routes
        the whole row).

        On a model mesh ``cache`` is this rank's shard, ``tokens`` this
        data rank's rows, and ``batch`` / ``max_seq`` the whole cache's,
        as :meth:`init_cache` took them (a KV cache's shard cannot tell
        whether its sequence splits: ``attention.cache_seq_axes``)."""
        cfg = self.cfg
        eps = cfg.norm_eps
        seq_axes = () if cfg.family == "ssm" else \
            attention.cache_seq_axes(cfg, batch, max_seq)
        with torch.inference_mode():
            x = common.embed_lookup(params["embed"], tokens)
            layers = layer_views(params["blocks"])
            if cfg.family == "ssm":
                for p, st, tsh, csh in zip(layers, cache["state"].unbind(0),
                                           cache["tshift"].unbind(0),
                                           cache["cshift"].unbind(0)):
                    y, st2, tsh2 = rwkv.time_mix_decode(
                        p["rwkv"], rms_norm(x, p["ln0"], eps), st, tsh, cfg)
                    x = x + y
                    y, csh2 = rwkv.channel_mix_decode(
                        p["rwkv"], rms_norm(x, p["ln1"], eps), csh, cfg)
                    x = x + y
                    st.copy_(st2)
                    tsh.copy_(tsh2)
                    csh.copy_(csh2)
            elif cfg.family == "hybrid":
                shared, every = params["shared"], cfg.attn_every
                sc, ac = cache["ssm"], cache["attn"]
                ks, vs = ac["k"].unbind(0), ac["v"].unbind(0)
                cw, cb = ssm.conv_weights(params["blocks"]["ssm"])
                for i, (p, st, cv, w, b) in enumerate(zip(
                        layers, sc["state"].unbind(0), sc["conv"].unbind(0),
                        cw.unbind(0), cb.unbind(0))):
                    y, st2, cv2 = ssm.ssm_decode_step(
                        p["ssm"], rms_norm(x, p["ln0"], eps), st, cv, (w, b),
                        cfg)
                    x = x + y
                    st.copy_(st2)
                    cv.copy_(cv2)
                    if (i + 1) % every == 0:
                        grp = i // every
                        a, _, _ = attention.decode_attention(
                            shared["attn"], rms_norm(x, shared["ln0"], eps),
                            ks[grp], vs[grp], pos, cfg, seq_axes=seq_axes)
                        x = x + a
                        x = x + mlp.swiglu(shared["mlp"],
                                           rms_norm(x, shared["ln1"], eps))
            else:
                for p, ck, cv in zip(layers, cache["k"].unbind(0),
                                     cache["v"].unbind(0)):
                    a, _, _ = attention.decode_attention(
                        p["attn"], rms_norm(x, p["ln0"], eps), ck, cv, pos,
                        cfg, seq_axes=seq_axes)
                    x = x + a
                    h = rms_norm(x, p["ln1"], eps)
                    if cfg.family == "moe":
                        f, _ = moe.moe_block(p["moe"], h, cfg)
                    else:
                        f = mlp.swiglu(p["mlp"], h)
                    x = x + f
            return common.gather_from_model(self._head(params, x)), cache
