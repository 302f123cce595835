"""Mamba2 (SSD) block, the recurrent backbone of zamba2.

Counterpart of ``repro.models.ssm``'s training path, with the reference's
simplifications: one B / C group, a causal depthwise short conv (kernel
CONV_K = 4) over the concatenated (x, B, C) stream written as shifted
adds in the reference's order, and the chunked scan of
:mod:`repro_torch.models.linear_scan` with a per-head scalar decay.
d_inner = expand * d_model = H * P, state size N.  The cached decode
(:func:`ssm_decode_step`) carries the fp32 (H, N, P) state and the conv's
last CONV_K - 1 inputs (:func:`ssm_cache_desc`), and steps the scan with
:func:`repro_torch.models.linear_scan.gla_decode_step`.  Under a
``MeshAxes`` scope the heads pad to the model axis (:func:`_dims`, the
reference's) and the descs carry the reference's axes; the padded model
runs whole on one device.  Its forward split over a model mesh waits
(ROADMAP queue 1, item 20; ``lm.check_model_mesh`` raises).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, linear_scan
from repro_torch.models.common import ParamDesc, rms_norm

Tensor = torch.Tensor
CONV_K = 4


def _dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(heads, head dim, state, d_inner): the heads padded to a multiple
    of the active scope's model_par."""
    ctx = common.get_mesh_axes()
    par = ctx.model_par if ctx else 1
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    if par > 1 and h % par:
        h = -(-h // par) * par
    return h, p, n, h * p


def ssm_params(cfg: ModelConfig, layers: int) -> dict:
    d = cfg.d_model
    h, p, n, d_inner = _dims(cfg)
    L = (layers,) if layers else ()
    conv_dim = d_inner + 2 * n
    lax = ("layers",) if layers else ()

    def desc(shape, axes, dtype=cfg.dtype, init="normal", scale=1.0):
        return ParamDesc(L + shape, dtype, init, scale, axes=lax + axes)

    return {
        # projections: z (gate), x, B, C, dt
        "in_proj": desc((d, 2 * d_inner + 2 * n + h), ("embed", "ff")),
        "conv_w": desc((CONV_K, conv_dim), (None, "ff"), scale=0.5),
        "conv_b": desc((conv_dim,), ("ff",), init="zeros"),
        "a_log": desc((h,), (None,), torch.float32, "zeros"),
        "dt_bias": desc((h,), (None,), torch.float32, "zeros"),
        "d_skip": desc((h,), (None,), torch.float32, "ones"),
        "norm_g": desc((d_inner,), ("ff",), init="ones"),
        "out_proj": desc((d_inner, d), ("ff", "embed")),
    }


def _short_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv, kernel CONV_K, via shifted adds.  x: (B, S, C)."""
    out = x * w[CONV_K - 1]
    for i in range(1, CONV_K):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[CONV_K - 1 - i]
    return out + b


def _project(p: dict, x: Tensor, cfg: ModelConfig):
    """z, x, B, C, dt from one input projection (split by sizes)."""
    h, _, n, d_inner = _dims(cfg)
    return torch.split(x @ p["in_proj"], [d_inner, d_inner, n, n, h], dim=-1)


def _decays(p: dict, dt: Tensor) -> tuple[Tensor, Tensor]:
    """Returns (per-head log decay <= 0, per-head dt > 0)."""
    z = dt.float() + p["dt_bias"]
    dtv = torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))
    a = torch.exp(p["a_log"])                    # > 0
    # Clamp so chunk * max-step-decay stays inside linear_scan.CLIP.
    log_decay = -torch.clamp(dtv * a, 0.0, linear_scan.MAX_STEP_DECAY)
    return log_decay, dtv


def ssm_block(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    h, pp, n, d_inner = _dims(cfg)
    z, xin, bmat, cmat, dt = _project(p, x, cfg)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = F.silu(_short_conv(conv_in, p["conv_w"], p["conv_b"]))
    xin, bmat, cmat = torch.split(conv_out, [d_inner, n, n], dim=-1)

    log_decay, dtv = _decays(p, dt)              # (B, S, H), (B, S, H)
    v = (xin.reshape(b, s, h, pp) * dtv[..., None]).float()
    # B and C broadcast across heads (their gradient sums over heads).
    k = bmat[:, :, None, :].expand(b, s, h, n)
    q = cmat[:, :, None, :].expand(b, s, h, n)
    w = log_decay[..., None].expand(b, s, h, n)

    y, _ = linear_scan.gla_chunked(q, k, v, w, chunk=cfg.ssm_chunk)
    y = y + p["d_skip"][None, None, :, None] * xin.reshape(b, s, h, pp)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"]


# ---------------------------------------------------------------------------
# Decode (stateful single token).
# ---------------------------------------------------------------------------

def ssm_cache_desc(cfg: ModelConfig, layers: int, batch: int) -> dict:
    """``state`` (L, B, H, N, P) and ``conv`` (L, B, CONV_K - 1,
    conv_dim), both fp32 zeros."""
    h, pp, n, d_inner = _dims(cfg)
    baxis = "batch" if batch > 1 else None
    return {
        "state": ParamDesc((layers, batch, h, n, pp), torch.float32, "zeros",
                           axes=("layers", baxis, "ff", None, None)),
        "conv": ParamDesc((layers, batch, CONV_K - 1, d_inner + 2 * n),
                          torch.float32, "zeros",
                          axes=("layers", baxis, None, "ff")),
    }


def ssm_decode_step(p: dict, x: Tensor, state: Tensor, conv_state: Tensor,
                    cfg: ModelConfig):
    """x: (B, 1, d); state: (B, H, N, P); conv_state: (B, CONV_K - 1,
    conv_dim).  Returns (out (B, 1, d), new state, new conv state).

    The conv window is the fp32 carry joined with this token's input
    (``torch.cat`` promotes to fp32, as the reference's concatenate
    does), reduced as ``(window * conv_w).sum(1) + conv_b``."""
    b = x.shape[0]
    h, pp, n, d_inner = _dims(cfg)
    z, xin, bmat, cmat, dt = _project(p, x, cfg)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)[:, 0]        # (B, C)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)
    conv_out = F.silu((window * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
    new_conv_state = window[:, 1:]
    xin_c, bmat_c, cmat_c = torch.split(conv_out, [d_inner, n, n], dim=-1)

    log_decay, dtv = _decays(p, dt[:, 0])        # (B, H)
    v = (xin_c.reshape(b, h, pp) * dtv[..., None]).float()
    k = bmat_c[:, None, :].expand(b, h, n)
    q = cmat_c[:, None, :].expand(b, h, n)
    w = log_decay[..., None].expand(b, h, n)

    y, new_state = linear_scan.gla_decode_step(state, q, k, v, w)
    y = y + p["d_skip"][None, :, None] * xin_c.reshape(b, h, pp)
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["out_proj"], new_state, new_conv_state
