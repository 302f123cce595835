"""RWKV6 ("Finch") block: attention-free time mix with data-dependent
per-channel decay, plus the RWKV channel mix.

Counterpart of ``repro.models.rwkv``'s training path (arXiv:2404.05892,
with the reference's simplifications: static per-channel lerp
coefficients and one low-rank data-dependent decay projection).  The
recurrence, diag(w_t) state decay with the u-bonus on the current token,
is :func:`repro_torch.models.linear_scan.gla_chunked`; the cached decode
(:func:`time_mix_decode`, :func:`channel_mix_decode`) steps it one token
at a time with :func:`repro_torch.models.linear_scan.gla_decode_step`,
carrying the fp32 state and the two token shifts
(:func:`rwkv_cache_desc`).  Under a ``MeshAxes`` scope the heads pad to
the model axis (:func:`_dims`, the reference's) and the descs carry the
reference's axes; the padded model runs whole on one device.

On a model mesh (``common.model_mesh``) the time mix splits by heads:
``wr`` / ``wk`` / ``wv`` / ``wg`` and the decay's ``wd2`` are
column-parallel (``xw @ wd1`` is replicated and enters ``wd2`` through
the column-parallel product, which all-reduces its input gradient),
``decay_bias`` and ``ln_g`` are the rank's block, the replicated ``u``
gives its heads' rows (``common.replicated_rows``), the scan runs on the
local heads, ``ln_g``'s norm is taken over the whole padded width
(``common.split_rms_norm``) and ``wo`` is row-parallel.  The channel mix
splits ``ck`` (column-parallel) and ``cv`` (row-parallel, summed before
the replicated ``sigmoid(xr @ cr)`` gate multiplies it).  Decode on a
model mesh splits the same way, step by step: the fp32 state holds the
rank's heads (:func:`rwkv_cache_desc`), the token shifts are replicated
and every rank writes the same values.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, linear_scan
from repro_torch.models.common import ParamDesc

Tensor = torch.Tensor
DECAY_LORA = 64


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(heads, head dim, inner): the heads padded to a multiple of the
    active scope's model_par."""
    ctx = common.get_mesh_axes()
    par = ctx.model_par if ctx else 1
    h, hd = cfg.ssm_heads, cfg.ssm_head_dim
    if par > 1 and h % par:
        h = -(-h // par) * par
    return h, hd, h * hd


def rwkv_params(cfg: ModelConfig, layers: int) -> dict:
    d = cfg.d_model
    h, hd, inner = _dims(cfg)
    L = (layers,) if layers else ()
    lora = min(DECAY_LORA, d)
    lax = ("layers",) if layers else ()

    def desc(shape, axes, dtype=cfg.dtype, init="normal", scale=1.0):
        return ParamDesc(L + shape, dtype, init, scale, axes=lax + axes)

    return {
        # time-mix lerp coefficients for the r / k / v / w / g streams
        "mix": desc((5, d), (None, "embed"), init="ones", scale=0.5),
        "wr": desc((d, inner), ("embed", "heads")),
        "wk": desc((d, inner), ("embed", "heads")),
        "wv": desc((d, inner), ("embed", "heads")),
        "wg": desc((d, inner), ("embed", "heads")),
        # data-dependent decay: low-rank projection + bias
        "wd1": desc((d, lora), ("embed", None)),
        "wd2": desc((lora, inner), (None, "heads")),
        "decay_bias": desc((inner,), ("heads",), torch.float32, "ones", -1.0),
        "u": desc((h, hd), (None, None), torch.float32, "ones", 0.5),
        "ln_g": desc((inner,), ("heads",), init="ones"),
        "wo": desc((inner, d), ("heads", "embed")),
        # channel mix
        "cmix": desc((2, d), (None, "embed"), init="ones", scale=0.5),
        "ck": desc((d, cfg.d_ff), ("embed", "ff")),
        "cv": desc((cfg.d_ff, d), ("ff", "embed")),
        "cr": desc((d, d), ("embed", "embed")),
    }


def _token_shift(x: Tensor, prev: Optional[Tensor] = None) -> Tensor:
    """The x_{t-1} stream (zeros before the first token); ``prev`` (B, d)
    supplies decode's carry."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, : x.shape[1]]
    return prev[:, None]


def _streams(p: dict, x: Tensor, shifted: Tensor):
    mix = p["mix"]
    return tuple(x + (shifted - x) * mix[i] for i in range(5))  # r k v w g


def _log_decay(p: dict, xw: Tensor) -> Tensor:
    dd = common.column_parallel(torch.tanh(xw @ p["wd1"]), p["wd2"])
    raw = p["decay_bias"] + dd.float()
    # w_t = exp(-exp(raw)); the per-step log decay clamped for the scan.
    return -torch.clamp(torch.exp(raw), 1e-6, linear_scan.MAX_STEP_DECAY)


def time_mix(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """x: (B, S, d) -> (B, S, d); on a model mesh the rank's heads."""
    b, s, _ = x.shape
    h, hd, inner = _dims(cfg)
    h0, h1 = common.model_block(h)
    hl = h1 - h0
    xr, xk, xv, xw, xg = _streams(p, x, _token_shift(x))
    r = common.column_parallel(xr, p["wr"]).reshape(b, s, hl, hd)
    k = common.column_parallel(xk, p["wk"]).reshape(b, s, hl, hd)
    v = common.column_parallel(xv, p["wv"]).reshape(b, s, hl, hd)
    g = F.silu(common.column_parallel(xg, p["wg"]))
    w = _log_decay(p, xw).reshape(b, s, hl, hd)

    u = common.replicated_rows(p["u"], h0, h1)
    y, _ = linear_scan.gla_chunked(r, k, v, w, chunk=cfg.ssm_chunk, u=u)
    y = y.reshape(b, s, hl * hd).to(x.dtype)
    y = common.constrain(y, "batch", None, "heads", full=(b, s, inner))
    y = common.split_rms_norm(y, p["ln_g"], cfg.norm_eps) * g
    return common.row_parallel(y, p["wo"], x.dtype)


def channel_mix(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    shifted = _token_shift(x)
    cm = p["cmix"]
    xk = x + (shifted - x) * cm[0]
    xr = x + (shifted - x) * cm[1]
    k = torch.square(F.relu(common.column_parallel(xk, p["ck"])))
    out = common.row_parallel(k, p["cv"], x.dtype)
    return out * torch.sigmoid(xr @ p["cr"])


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

def rwkv_cache_desc(cfg: ModelConfig, layers: int, batch: int) -> dict:
    """``state`` (L, B, H, hd, hd), ``tshift`` and ``cshift`` (L, B, d),
    all fp32 zeros: the batch over the data axes, the state's heads over
    the model axis, the shifts replicated."""
    h, hd, _ = _dims(cfg)
    d = cfg.d_model
    baxis = "batch" if batch > 1 else None
    return {
        "state": ParamDesc((layers, batch, h, hd, hd), torch.float32, "zeros",
                           axes=("layers", baxis, "heads", None, None)),
        "tshift": ParamDesc((layers, batch, d), torch.float32, "zeros",
                            axes=("layers", baxis, "embed")),
        "cshift": ParamDesc((layers, batch, d), torch.float32, "zeros",
                            axes=("layers", baxis, "embed")),
    }


def time_mix_decode(p: dict, x: Tensor, state: Tensor, tshift: Tensor,
                    cfg: ModelConfig):
    """x: (B, 1, d); state: (B, H, hd, hd), on a model mesh the rank's
    heads; tshift: (B, d).  Returns (out (B, 1, d), new state, the new
    shift ``x[:, 0]`` in fp32)."""
    b = x.shape[0]
    h, hd, _ = _dims(cfg)
    h0, h1 = common.model_block(h)
    hl = h1 - h0
    xr, xk, xv, xw, xg = _streams(p, x, _token_shift(x, tshift.to(x.dtype)))
    r = common.column_parallel(xr, p["wr"]).reshape(b, hl, hd)
    k = common.column_parallel(xk, p["wk"]).reshape(b, hl, hd)
    v = common.column_parallel(xv, p["wv"]).reshape(b, hl, hd)
    g = F.silu(common.column_parallel(xg, p["wg"]))[:, 0]
    w = _log_decay(p, xw).reshape(b, hl, hd)

    u = common.replicated_rows(p["u"], h0, h1)
    y, new_state = linear_scan.gla_decode_step(state, r, k, v, w, u=u)
    y = y.reshape(b, hl * hd).to(x.dtype)
    y = common.split_rms_norm(y, p["ln_g"], cfg.norm_eps) * g
    return (common.row_parallel(y, p["wo"], x.dtype)[:, None], new_state,
            x[:, 0].float())


def channel_mix_decode(p: dict, x: Tensor, cshift: Tensor, cfg: ModelConfig):
    """x: (B, 1, d); cshift: (B, d).  Returns (out (B, 1, d), the new
    shift ``x[:, 0]`` in fp32)."""
    shifted = _token_shift(x, cshift.to(x.dtype))
    cm = p["cmix"]
    xk = x + (shifted - x) * cm[0]
    xr = x + (shifted - x) * cm[1]
    k = torch.square(F.relu(common.column_parallel(xk, p["ck"])))
    out = common.row_parallel(k, p["cv"], x.dtype)
    return out * torch.sigmoid(xr @ p["cr"]), x[:, 0].float()
