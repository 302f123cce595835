"""GQA attention, full-sequence (training) form.

Counterpart of ``repro.models.attention.attention``: plain einsum
attention with a causal mask (or none: whisper's encoder), optional QKV
biases (qwen2 / codeqwen), an optional sliding window under the causal
mask (mixtral), rope unless ``use_rope=False`` (whisper), cross attention
over external k / v (``kv_override``: no mask, no rope), and the kv heads
repeated to the q-head count.  The reference computes this outside any
Pallas kernel, so plain torch ops are its port.  Cached decode arrives
with ``ServeEngine`` (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

import torch

from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDesc, apply_rope

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_params(cfg: ModelConfig, layers: int) -> dict:
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    d, hd = cfg.d_model, cfg.head_dim
    L = (layers,) if layers else ()
    p = {
        "wq": ParamDesc(L + (d, hq * hd), cfg.dtype),
        "wk": ParamDesc(L + (d, hkv * hd), cfg.dtype),
        "wv": ParamDesc(L + (d, hkv * hd), cfg.dtype),
        "wo": ParamDesc(L + (hq * hd, d), cfg.dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamDesc(L + (hq * hd,), cfg.dtype, "zeros")
        p["bk"] = ParamDesc(L + (hkv * hd,), cfg.dtype, "zeros")
        p["bv"] = ParamDesc(L + (hkv * hd,), cfg.dtype, "zeros")
    return p


def _repeat_kv(k: Tensor, hq: int) -> Tensor:
    hkv = k.shape[-2]
    if hkv == hq:
        return k
    return torch.repeat_interleave(k, hq // hkv, dim=-2)


def attention(p: dict, x: Tensor, cfg: ModelConfig, *, causal: bool = True,
              use_rope: bool = True,
              kv_override: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """Full-sequence attention.  x: (B, S, d) -> (B, S, d).

    ``kv_override`` supplies external (k, v) head tensors (B, S_kv, hkv,
    hd) for cross attention (whisper's decoder); no mask and no rope then
    apply, and the layer's own ``wk`` / ``wv`` are not read."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cross = kv_override is not None
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, hq, hd)
    if cross:
        k, v = kv_override
    else:
        k, v = x @ p["wk"], x @ p["wv"]
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k, v = k.reshape(b, s, hkv, hd), v.reshape(b, s, hkv, hd)
        if use_rope:
            positions = torch.arange(s, device=x.device)[None, :]
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    k = _repeat_kv(k, hq)
    v = _repeat_kv(v, hq)

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
    return out.reshape(b, s, hq * hd) @ p["wo"]
