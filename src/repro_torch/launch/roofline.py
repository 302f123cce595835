"""Roofline arithmetic (counterpart of ``repro.launch.roofline``'s
``RooflineTerms``, ``model_flops``, ``total_params`` and ``active_params``),
with the H100's peaks, and the bytes and operations one cached decode step
must move (:func:`decode_step_terms`).

compute    = flops            / peak_flops
memory     = hbm_bytes        / hbm_bw
collective = collective_bytes / ici_bw

The reference fills these from XLA's ``cost_analysis`` and parses
collective bytes out of optimized HLO text (``shape_bytes`` /
``collective_bytes``); torch has no HLO, so those two are not carried
over.  Peaks: one H100 SXM at its full 700 W (NVIDIA's data sheet, dense
rates): 3.35 TB/s HBM, 989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the
tensor cores.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, pad_to
from repro_torch.models import attention, build_model, ssm
from repro_torch.models.common import ParamDesc
from repro_torch.tree import tree_leaves, tree_paths

H100_HBM_BW = 3.35e12
H100_PEAK_BF16 = 989e12
H100_PEAK_FP32 = 67e12


@dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    peak_flops: float
    hbm_bw: float
    ici_bw: float

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(cfg: ModelConfig, n_tokens: int) -> float:
    """Analytic MODEL_FLOPS = 6 * N_active * tokens (decode: tokens=batch)."""
    return 6.0 * active_params(cfg) * n_tokens


def _descs(cfg: ModelConfig) -> list[tuple[str, ParamDesc]]:
    descs = build_model(cfg).param_descs()
    return list(zip(tree_paths(descs), tree_leaves(descs)))


def _numel(d: ParamDesc) -> int:
    n = 1
    for s in d.shape:
        n *= s
    return n


def total_params(cfg: ModelConfig) -> float:
    return float(sum(_numel(d) for _, d in _descs(cfg)))


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: top-k of E experts)."""
    tot = total_params(cfg)
    if cfg.num_experts:
        expert = 3.0 * cfg.num_experts * cfg.d_model * cfg.d_ff * cfg.num_layers
        active_frac = cfg.experts_per_token / cfg.num_experts
        return tot - expert * (1.0 - active_frac)
    return tot


_EXPERT_LEAVES = ("['blocks']['moe']['wi']", "['blocks']['moe']['wg']",
                  "['blocks']['moe']['wo']")


def _step_weights(cfg: ModelConfig, batch: int, experts_read: Optional[float]
                  ) -> tuple[float, float]:
    """(bytes, params) of the weights one decode step reads, each once: the
    embedding's ``batch`` rows (the whole table when it is also the head),
    no VLM projector (decode embeds text only), no encoder and no cross
    ``wk`` / ``wv`` (the cross k / v come from the cache), and of the
    expert tables ``experts_read`` (layer, expert) pairs (default: all)."""
    nbytes = params = 0.0
    for path, d in _descs(cfg):
        n = float(_numel(d))
        if path == "['embed']" and not cfg.tie_embeddings:
            n = float(batch * d.shape[-1])
        elif path.startswith(("['projector']", "['encoder']", "['enc_norm']")):
            n = 0.0
        elif path.startswith("['decoder']['cross_attn']") and \
                path.endswith(("['wk']", "['wv']", "['bk']", "['bv']")):
            n = 0.0
        elif path in _EXPERT_LEAVES and experts_read is not None:
            n *= experts_read / (cfg.num_layers * cfg.num_experts)
        nbytes += n * d.dtype.itemsize
        params += n
    return nbytes, params


def decode_step_terms(cfg: ModelConfig, batch: int, max_seq: int, pos: int,
                      experts_read: Optional[float] = None) -> RooflineTerms:
    """The least work of one cached decode step at position ``pos`` on one
    H100: every weight it needs read once (:func:`_step_weights`), the
    cache entries it needs read (slots up to ``pos``; an RWKV or Mamba2
    state, conv window and shifts whole; the cross k / v whole) and the
    ones it writes, and the fp32 logits written.  Operations: 2 per
    multiply-add of the weights read, per row, plus the attention's
    q.k and p.v over the live slots, against the bf16 (or fp32) peak."""
    el = cfg.dtype.itemsize
    wbytes, wparams = _step_weights(cfg, batch, experts_read)
    if not cfg.tie_embeddings:
        wparams -= batch * cfg.d_model     # a gather, not a product
    kv_layers = {"ssm": 0, "hybrid": cfg.num_layers // max(cfg.attn_every, 1)
                 }.get(cfg.family, cfg.num_layers)
    span = attention.cache_span(cfg, max_seq)
    live = min(pos + 1, span)
    entry = batch * attention.hkv_of(cfg) * cfg.head_dim * 2 * el   # k and v
    cache = kv_layers * entry * (live + 1)
    flops = 2.0 * wparams * batch + \
        kv_layers * 4.0 * batch * cfg.num_heads * cfg.head_dim * live
    if cfg.family == "encdec":
        cache += cfg.num_layers * entry * cfg.encoder_seq
        flops += cfg.num_layers * 4.0 * batch * cfg.num_heads * \
            cfg.head_dim * cfg.encoder_seq
    if cfg.family == "ssm":
        h, hd = cfg.ssm_heads, cfg.ssm_head_dim
        cache += 2 * 4 * cfg.num_layers * batch * (h * hd * hd + 2 * cfg.d_model)
    if cfg.family == "hybrid":
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        conv = (ssm.CONV_K - 1) * (h * p + 2 * n)
        cache += 2 * 4 * cfg.num_layers * batch * (h * n * p + conv)
    logits = batch * pad_to(cfg.vocab_size, 128) * 4
    peak = H100_PEAK_FP32 if cfg.dtype == torch.float32 else H100_PEAK_BF16
    return RooflineTerms(flops=flops, hbm_bytes=wbytes + cache + logits,
                         coll_bytes=0.0, peak_flops=peak, hbm_bw=H100_HBM_BW,
                         ici_bw=float("inf"))
