"""GQA attention: the full-sequence (training) form and cached
single-token decode.

Counterpart of ``repro.models.attention``: plain einsum attention with a
causal mask (or none: whisper's encoder), optional QKV biases (qwen2 /
codeqwen), an optional sliding window under the causal mask (mixtral),
rope unless ``use_rope=False`` (whisper), cross attention over external k
/ v (``kv_override``: no mask, no rope), and the kv heads repeated to the
q-head count.  :func:`decode_attention` reads a (B, span, hkv, hd) KV
cache (a ring of the window for a windowed arch) and contracts the
q-head groups against the shared kv heads, the reference's default
grouped form.  The reference computes all of it outside any Pallas
kernel, so plain torch ops are its port.

Under a :class:`~repro_torch.models.common.MeshAxes` scope the heads are
padded to the mesh (:func:`resolved_heads`, the reference's policy).  On
a model mesh (``common.model_mesh``) each rank holds its block of the q
heads; the kv heads split with them when ``shard_kv``, else they are
computed whole on every rank and repeated to the q-head count before the
rank takes its q heads' share, so no group crosses a shard (reference
``attention.py:1-7``).  With fewer q heads than model ranks the reference
replicates attention: the q / o blocks are gathered and every rank runs
it whole (:func:`_replicated`; decode refuses that case).  q / k / v are column-parallel, ``wo``
row-parallel (``common.row_parallel``).  Cross attention splits the same
way: its k / v (``kv_override``) are this rank's kv heads when
``shard_kv`` (whisper's ``EncDecLM._cross_kv`` makes them column-
parallel from the encoder output), else whole and repeated.

Decode on a model mesh reads this rank's shard of the KV cache
(:func:`cache_desc`'s axes): its batch rows, its kv heads when they split
with the q heads, else all of them (the rank's q heads read the groups
they use), and, for spans above 8192 whose kv heads do not split, its
block of the sequence.  Each rank then attends over its own slots and the
ranks that split the sequence combine flash-decode style
(:func:`decode_attention`); where the model axis splits the sequence,
every rank forms all the q heads (all-gathered) and keeps its own after
the combine, for the row-parallel ``wo``.
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import ParamDesc, apply_rope

Tensor = torch.Tensor
NEG_INF = -1e30


def resolved_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(q heads, kv heads), padded to the active scope's model axis
    (``common.pad_heads``; the config's counts without a scope)."""
    ctx = common.get_mesh_axes()
    par = ctx.model_par if ctx else 1
    pad_kv = bool(ctx and ctx.pad_kv_to_mesh)
    hq, hkv, _, _ = common.pad_heads(cfg.num_heads, cfg.num_kv_heads, par,
                                     pad_kv=pad_kv)
    return hq, hkv


def hkv_of(cfg: ModelConfig) -> int:
    return resolved_heads(cfg)[1]


def attn_params(cfg: ModelConfig, layers: int) -> dict:
    hq, hkv = resolved_heads(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    L = (layers,) if layers else ()
    lax = ("layers",) if layers else ()
    p = {
        "wq": ParamDesc(L + (d, hq * hd), cfg.dtype, axes=lax + ("embed", "heads")),
        "wk": ParamDesc(L + (d, hkv * hd), cfg.dtype, axes=lax + ("embed", "kv")),
        "wv": ParamDesc(L + (d, hkv * hd), cfg.dtype, axes=lax + ("embed", "kv")),
        "wo": ParamDesc(L + (hq * hd, d), cfg.dtype, axes=lax + ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDesc(L + (hq * hd,), cfg.dtype, "zeros", axes=lax + ("heads",))
        p["bk"] = ParamDesc(L + (hkv * hd,), cfg.dtype, "zeros", axes=lax + ("kv",))
        p["bv"] = ParamDesc(L + (hkv * hd,), cfg.dtype, "zeros", axes=lax + ("kv",))
    return p


def _repeat_kv(k: Tensor, hq: int) -> Tensor:
    hkv = k.shape[-2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=-2)


def heads_split(cfg: ModelConfig) -> bool:
    """Whether the model axis splits the q heads (the reference's
    ``pad_heads``: not when there are fewer q heads than model ranks)."""
    ctx = common.get_mesh_axes()
    return bool(ctx) and common.pad_heads(cfg.num_heads, cfg.num_kv_heads,
                                          ctx.model_par)[2]


def _replicated(p: dict, x: Tensor, cfg: ModelConfig, **kw) -> Tensor:
    """:func:`attention` with fewer q heads than model ranks: the
    reference replicates it.  The split q / o leaves' blocks (their
    columns cut evenly, not by heads) are gathered whole
    (``common.gather_from_model``) and every rank runs the one-device
    attention; under sequence parallelism each keeps its sequence
    block."""
    whole = dict(p)
    for k in ("wq", "bq"):
        if k in whole:
            whole[k] = common.gather_from_model(whole[k])
    whole["wo"] = common.gather_from_model(whole["wo"].mT).mT
    with common.mesh_axes_scope(None):
        out = attention(whole, x, cfg, **kw)
    return common.seq_rows(out)


def attention(p: dict, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
              use_rope: bool = True,
              kv_override: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """Full-sequence attention.  x: (B, S, d) -> (B, S, d).

    ``kv_override`` supplies external (k, v) head tensors (B, S_kv, hkv,
    hd) for cross attention (whisper's decoder); no mask and no rope then
    apply, and the layer's own ``wk`` / ``wv`` are not read.  On a model
    mesh x is replicated and the output is the all-reduced whole; the
    override holds this rank's kv heads when they split (``shard_kv``),
    else all of them."""
    b, s, _ = x.shape
    hq, hkv = resolved_heads(cfg)
    hd = cfg.head_dim
    cross = kv_override is not None
    mesh = common.model_mesh()
    if mesh is not None and not heads_split(cfg):
        return _replicated(p, x, cfg, causal=causal, use_rope=use_rope,
                           kv_override=kv_override)
    split_kv = mesh is not None and common.get_mesh_axes().shard_kv
    q0, q1 = common.model_block(hq)
    q = common.column_parallel(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, q1 - q0, hd)
    if cross:
        k, v = kv_override
    elif split_kv:
        k = common.column_parallel(x, p["wk"])
        v = common.column_parallel(x, p["wv"])
    else:
        k, v = x @ p["wk"], x @ p["wv"]
    if not cross:
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(b, s, k.shape[-1] // hd, hd)
        v = v.reshape(b, s, v.shape[-1] // hd, hd)
        if use_rope:
            positions = torch.arange(s, device=x.device)[None, :]
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    if mesh is None or split_kv:
        k = _repeat_kv(k, q1 - q0)
        v = _repeat_kv(v, q1 - q0)
    else:
        # Replicated kv: repeat to every q head, then this rank's share.
        k = _repeat_kv(common.copy_to_model(k), hq)[:, :, q0:q1]
        v = _repeat_kv(common.copy_to_model(v), hq)[:, :, q0:q1]
    q = common.constrain(q, "batch", None, "heads", None, full=(b, s, hq, hd))

    # fp32 logits of the exact products (the reference's
    # preferred_element_type=f32 contraction).
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    if causal and not cross:
        qi = torch.arange(s, device=x.device)[:, None]
        kj = torch.arange(s, device=x.device)[None, :]
        mask = qi >= kj
        if cfg.sliding_window:
            mask = mask & (qi - kj < cfg.sliding_window)
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return common.row_parallel(out.reshape(b, s, (q1 - q0) * hd), p["wo"],
                               x.dtype)


# ---------------------------------------------------------------------------
# KV-cache decode.
# ---------------------------------------------------------------------------

def cache_span(cfg: ModelConfig, max_seq: int) -> int:
    """Cached positions: the window for a windowed arch (a ring), else
    ``max_seq``."""
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def cache_desc(cfg: ModelConfig, layers: int, batch: int, max_seq: int) -> dict:
    """The KV cache: ``k`` and ``v``, each (layers, batch, span, hkv, hd)
    zeros in the model dtype, with the reference's axes: batch over the
    data axes when batch > 1; kv heads over the model axis when they
    divide, else the sequence (long spans only, flash-decode style);
    batch-1 long-context caches also spread the sequence over the data
    axes; spans up to 8192 keep the sequence whole.  On a model mesh
    ``init_cache`` materializes this rank's shard of it."""
    ctx = common.get_mesh_axes()
    kv_sharded = bool(ctx and ctx.shard_kv and ctx.model_par > 1)
    span = cache_span(cfg, max_seq)
    if batch == 1:
        b_axis = None
        seq_axis = "seq_shard" if kv_sharded else "seq_both"
    else:
        b_axis = "batch"
        seq_axis = None if kv_sharded else "seq_model"
    if span <= 8192:
        seq_axis = None
    shape = (layers, batch, span, hkv_of(cfg), cfg.head_dim)
    axes = ("layers", b_axis, seq_axis, "kv" if kv_sharded else None, None)
    return {"k": ParamDesc(shape, cfg.dtype, "zeros", axes=axes),
            "v": ParamDesc(shape, cfg.dtype, "zeros", axes=axes)}


def cache_seq_axes(cfg: ModelConfig, batch: Optional[int],
                   max_seq: Optional[int]) -> tuple:
    """The mesh axes a KV cache's sequence lies over (:func:`cache_desc`'s
    spec for the whole ``batch`` and ``max_seq``), () when it is whole on
    every rank.  Off a model mesh always ().  On one the cache's shard
    alone cannot tell (a 16384-slot span split in two looks like an
    8192-slot one), so the whole geometry is required."""
    mesh = common.model_mesh()
    if mesh is None:
        return ()
    if batch is None or max_seq is None:
        raise ValueError("decode on a model mesh takes the cache's whole "
                         "batch= and max_seq= (a shard cannot tell how its "
                         "sequence splits)")
    spec = common.leaf_spec(cache_desc(cfg, 1, batch, max_seq)["k"])
    names = common.spec_axes(spec[2] if len(spec) > 2 else None)
    return names if mesh.size(names) > 1 else ()


def _group_kv(ck: Tensor, cv: Tensor, h0: int, h1: int, hq: int,
              split_kv: bool) -> tuple[Tensor, Tensor, int]:
    """The kv heads that q heads [h0, h1) read and the group size of the
    grouped contraction.  Split kv heads are already the rank's (its q
    heads' groups); whole ones are sliced to the rank's groups, or to the
    one group its q heads are part of (4 q heads over 1 kv head at par 2:
    2 a rank, the shared head), else picked head by head."""
    if split_kv:
        return ck, cv, (h1 - h0) // ck.shape[-2]
    g = hq // ck.shape[-2]
    if h0 % g == 0 and h1 % g == 0:
        return ck[:, :, h0 // g:h1 // g], cv[:, :, h0 // g:h1 // g], g
    if h0 // g == (h1 - 1) // g:
        k0 = h0 // g
        return ck[:, :, k0:k0 + 1], cv[:, :, k0:k0 + 1], h1 - h0
    idx = torch.arange(h0, h1, device=ck.device) // g
    return ck.index_select(2, idx), cv.index_select(2, idx), 1


def decode_attention(p: dict, x: Tensor, cache_k: Tensor, cache_v: Tensor,
                     pos: int, cfg: ModelConfig, *, use_rope: bool = True,
                     kv_override: Optional[tuple[Tensor, Tensor]] = None,
                     seq_axes: tuple = ()):
    """Single-token decode.  x: (B, 1, d); cache_{k,v}: (B, span, hkv,
    hd); pos: the current position, a host int.  Returns (out (B, 1, d),
    cache_k, cache_v).

    Self attention applies rope at ``pos`` to q and k and writes the new
    k / v IN PLACE at ``pos % span`` for a windowed arch (a ring: once it
    is full every slot is live, and rope went on before the write, so the
    ring's order does not matter), else at ``pos``; it attends over the
    slots up to the one written.  A position past a full cache raises
    ``ValueError`` (the reference's scatter drops that write and attends
    over the stale cache).  Cross attention (``kv_override``: (B, S_kv,
    hkv, hd) k / v) reads the override, leaves the cache untouched and
    masks nothing; it returns (out, None, None), as the reference does.

    The q-head groups contract against the shared kv heads (q as (B, 1,
    hkv, g, hd)): the repeated kv copy never forms; with hkv == hq this
    is the plain form.  The logits are fp32 products of the model-dtype
    operands, as in :func:`attention`.

    On a model mesh x and the cache are this rank's rows and shard (the
    module docstring).  ``seq_axes`` (:func:`cache_seq_axes`) are the mesh
    axes the cache's sequence lies over: the rank holds slots [j s, (j +
    1) s) of the span, j its index over them; only the rank that holds
    slot ``pos`` writes it; each rank attends over its slots, the fp32 max
    of the logits is all-reduced over ``seq_axes``, then the sum of the
    exponentials under it, and the probabilities (cast to the model dtype,
    as one device casts them) weight v into fp32 partials that are
    all-reduced and cast once.  A rank whose slots all lie past ``pos``
    has only ``NEG_INF`` logits and adds exact zeros.
    """
    b = x.shape[0]
    hq, _ = resolved_heads(cfg)
    hd = cfg.head_dim
    mesh = common.model_mesh()
    axes = common.get_mesh_axes()
    if mesh is not None and not heads_split(cfg):
        raise ValueError(f"decode on a model mesh of {axes.model_par} ranks "
                         f"with {cfg.num_heads} q heads: the reference "
                         "replicates such attention; the port's decode "
                         "splits heads only")
    split_kv = mesh is not None and axes.shard_kv
    seq_axes = tuple(seq_axes) if mesh is not None else ()
    q0, q1 = common.model_block(hq)
    q = common.column_parallel(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, 1, q1 - q0, hd)
    live = None                      # the last live local slot, None: all
    if kv_override is not None:
        ck, cv = kv_override
    else:
        s_loc = cache_k.shape[1]
        j = mesh.index(seq_axes) if seq_axes else 0
        span = s_loc * (mesh.size(seq_axes) if seq_axes else 1)
        if not cfg.sliding_window and pos >= span:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"span {span}")
        proj = common.column_parallel if split_kv else torch.matmul
        k, v = proj(x, p["wk"]), proj(x, p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(b, 1, k.shape[-1] // hd, hd)
        v = v.reshape(b, 1, v.shape[-1] // hd, hd)
        if use_rope:
            positions = torch.full((1, 1), pos, device=x.device)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        slot = (pos % span if cfg.sliding_window else pos) - j * s_loc
        if 0 <= slot < s_loc:        # this rank holds the slot
            cache_k[:, slot].copy_(k[:, 0])
            cache_v[:, slot].copy_(v[:, 0])
        ck, cv = cache_k, cache_v
        if pos < span:               # else a full ring: every slot is live
            live = slot

    # Where the model axis splits the sequence, every q head meets this
    # rank's slots: all of them, this rank's kept after the combine.
    gather_q = mesh is not None and axes.model in seq_axes
    h0, h1 = (0, hq) if gather_q else (q0, q1)
    if gather_q:
        q = common.all_gather_model(q.reshape(b, 1, (q1 - q0) * hd)
                                    ).reshape(b, 1, hq, hd)
    ck, cv, g = _group_kv(ck, cv, h0, h1, hq, split_kv)
    qg = q.reshape(b, 1, ck.shape[-2], g, hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          ck.float()) * hd ** -0.5
    if live is not None:
        logits[..., max(live + 1, 0):] = NEG_INF
    if not seq_axes:
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv)
    else:
        top = logits.amax(dim=-1, keepdim=True)
        mesh.all_reduce(top, seq_axes, "max", record=False)
        e = torch.exp(logits - top)
        tot = e.sum(dim=-1, keepdim=True)
        mesh.all_reduce(tot, seq_axes, record=False)
        probs = (e / tot).to(x.dtype)
        part = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), cv.float())
        out = mesh.all_reduce(part.contiguous(), seq_axes,
                              record=False).to(x.dtype)
    out = out.reshape(b, 1, h1 - h0, hd)
    if gather_q:
        out = out[:, :, q0:q1]
    out = common.row_parallel(out.reshape(b, 1, (q1 - q0) * hd), p["wo"],
                              x.dtype)
    if kv_override is not None:
        return out, None, None
    return out, cache_k, cache_v
