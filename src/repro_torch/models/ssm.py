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
runs whole on one device.

On a model mesh (``common.model_mesh``) the mixer splits by heads, its
storage as the reference's specs lay it out: ``in_proj``'s columns (z, x,
B, C, dt side by side) and the conv's channels (x, B, C) are split as
contiguous blocks that cut across those boundaries, so a rank's block
does not hold its heads' streams.  Each rank takes the projection of its
block (column-parallel), all-gathers the blocks over the model axis and
reads its heads' z, x and dt and all of B and C (``common.
all_gather_model``: the gradient is summed over the axis and cut back to
the rank's block), and gathers the small conv weights likewise; the conv
runs on its channels, the scan on its heads.  ``norm_g`` (aligned with
the heads) takes the norm over the whole padded width (``common.
split_rms_norm``), ``out_proj`` is row-parallel, and the replicated
``a_log`` / ``dt_bias`` / ``d_skip`` give their heads' rows
(``common.replicated_rows``).  Gathering the projection's output moves
(B, S, 2 d_inner + 2N + H) activations a layer, about 10.7 MB in bf16 at
zamba2-2.7b's widths over 4 x 128 tokens, where gathering ``in_proj``
would move its 53 MB.

Decode on a model mesh (:func:`ssm_decode_step`) reuses the projection's
gather; the fp32 state holds the rank's heads; the conv window is stored
as :func:`ssm_cache_desc` lays it out, one contiguous block of its
``d_inner + 2N`` channels a rank (across the x / B / C boundaries, as
``conv_w``), so each step all-gathers the window's blocks over the model
axis (3 x 5248 fp32 a row a layer at zamba2-2.7b's widths), joins the
whole window with the gathered projection's x, B and C, runs the conv on
every channel (the conv weights gathered once a step for all layers,
:func:`conv_weights`), reads the rank's x channels and all of B and C,
and keeps the rank's block of the shifted window.  On one device the
gathers are the tensors themselves and the step is the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, linear_scan
from repro_torch.models.common import ParamDesc

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


def _cut(proj: Tensor, cfg: ModelConfig):
    """z, x, B, C, dt of the whole projection: this rank's heads' z, x and
    dt and all of B and C."""
    h, pp, n, d_inner = _dims(cfg)
    h0, h1 = common.model_block(h)
    bc = 2 * d_inner + 2 * n
    return (proj[..., h0 * pp:h1 * pp],
            proj[..., d_inner + h0 * pp:d_inner + h1 * pp],
            proj[..., 2 * d_inner:2 * d_inner + n],
            proj[..., 2 * d_inner + n:bc],
            proj[..., bc + h0:bc + h1])


def _projection(p: dict, x: Tensor) -> Tensor:
    """The whole input projection, from its blocks all-gathered (on one
    device the projection itself)."""
    return common.all_gather_model(common.column_parallel(x, p["in_proj"]))


def _project(p: dict, x: Tensor, cfg: ModelConfig):
    """z, x, B, C, dt of the input projection (:func:`_cut`)."""
    return _cut(_projection(p, x), cfg)


def _conv_params(p: dict, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """The conv's (w, b) over this rank's channels: its heads' x, then all
    of B and C (all of them on one device); w and b gathered as one."""
    h, pp, _, d_inner = _dims(cfg)
    h0, h1 = common.model_block(h)
    wb = common.all_gather_model(torch.cat([p["conv_w"], p["conv_b"][None]]))
    wb = torch.cat([wb[:, h0 * pp:h1 * pp], wb[:, d_inner:]], dim=-1)
    return wb[:-1], wb[-1]


def _head_rows(p: dict, key: str, cfg: ModelConfig) -> Tensor:
    """A replicated per-head leaf's rows of this rank's heads."""
    return common.replicated_rows(p[key], *common.model_block(_dims(cfg)[0]))


def _decays(p: dict, dt: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Returns (per-head log decay <= 0, per-head dt > 0) of this rank's
    heads."""
    z = dt.float() + _head_rows(p, "dt_bias", cfg)
    dtv = torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))
    a = torch.exp(_head_rows(p, "a_log", cfg))   # > 0
    # Clamp so chunk * max-step-decay stays inside linear_scan.CLIP.
    log_decay = -torch.clamp(dtv * a, 0.0, linear_scan.MAX_STEP_DECAY)
    return log_decay, dtv


def ssm_block(p: dict, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence Mamba2 mixer.  x: (B, S, d) -> (B, S, d); on a model
    mesh the rank's heads (module docstring)."""
    b, s, _ = x.shape
    h, pp, n, d_inner = _dims(cfg)
    h0, h1 = common.model_block(h)
    hl = h1 - h0
    z, xin, bmat, cmat, dt = _project(p, x, cfg)

    conv_in = torch.cat([xin, bmat, cmat], dim=-1)
    conv_out = F.silu(_short_conv(conv_in, *_conv_params(p, cfg)))
    xin, bmat, cmat = torch.split(conv_out, [hl * pp, n, n], dim=-1)

    log_decay, dtv = _decays(p, dt, cfg)         # (B, S, H), (B, S, H)
    v = (xin.reshape(b, s, hl, pp) * dtv[..., None]).float()
    # B and C broadcast across heads (their gradient sums over heads).
    k = bmat[:, :, None, :].expand(b, s, hl, n)
    q = cmat[:, :, None, :].expand(b, s, hl, n)
    w = log_decay[..., None].expand(b, s, hl, n)

    y, _ = linear_scan.gla_chunked(q, k, v, w, chunk=cfg.ssm_chunk)
    y = y + _head_rows(p, "d_skip", cfg)[None, None, :, None] * \
        xin.reshape(b, s, hl, pp)
    y = y.reshape(b, s, hl * pp).to(x.dtype)
    y = common.constrain(y, "batch", None, "ff", full=(b, s, d_inner))
    y = common.split_rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return common.row_parallel(y, p["out_proj"], x.dtype)


# ---------------------------------------------------------------------------
# Decode (stateful single token).
# ---------------------------------------------------------------------------

def ssm_cache_desc(cfg: ModelConfig, layers: int, batch: int) -> dict:
    """``state`` (L, B, H, N, P) and ``conv`` (L, B, CONV_K - 1,
    conv_dim), both fp32 zeros: the batch over the data axes, the state's
    heads and the window's channels over ``"ff"`` (the model axis)."""
    h, pp, n, d_inner = _dims(cfg)
    baxis = "batch" if batch > 1 else None
    return {
        "state": ParamDesc((layers, batch, h, n, pp), torch.float32, "zeros",
                           axes=("layers", baxis, "ff", None, None)),
        "conv": ParamDesc((layers, batch, CONV_K - 1, d_inner + 2 * n),
                          torch.float32, "zeros",
                          axes=("layers", baxis, None, "ff")),
    }


def conv_weights(p: dict) -> tuple[Tensor, Tensor]:
    """The conv's whole (w, b) of every layer of a layer-stacked ``ssm``
    params dict, (L, CONV_K, conv_dim) and (L, conv_dim), from the ranks'
    blocks: what :func:`ssm_decode_step` takes, gathered once a step."""
    return (common.all_gather_model(p["conv_w"]),
            common.all_gather_model(p["conv_b"]))


def ssm_decode_step(p: dict, x: Tensor, state: Tensor, conv_state: Tensor,
                    conv: tuple[Tensor, Tensor], cfg: ModelConfig):
    """x: (B, 1, d); state: (B, H, N, P); conv_state: (B, CONV_K - 1,
    conv_dim); conv: this layer's whole (w, b) (:func:`conv_weights`).
    Returns (out (B, 1, d), new state, new conv state); on a model mesh
    the state is the rank's heads and the conv state its block of the
    window's channels (module docstring).

    The conv window is the fp32 carry joined with this token's input
    (``torch.cat`` promotes to fp32, as the reference's concatenate
    does), reduced as ``(window * conv_w).sum(1) + conv_b``."""
    b = x.shape[0]
    h, pp, n, d_inner = _dims(cfg)
    h0, h1 = common.model_block(h)
    hl = h1 - h0
    c0, c1 = common.model_block(d_inner + 2 * n)
    proj = _projection(p, x)
    z, _, _, _, dt = _cut(proj, cfg)

    window = torch.cat([common.all_gather_model(conv_state),
                        proj[:, :, d_inner:2 * d_inner + 2 * n]], dim=1)
    conv_out = F.silu((window * conv[0][None]).sum(dim=1) + conv[1])
    new_conv_state = window[:, 1:, c0:c1]
    xin_c = conv_out[:, h0 * pp:h1 * pp]
    bmat_c = conv_out[:, d_inner:d_inner + n]
    cmat_c = conv_out[:, d_inner + n:]

    log_decay, dtv = _decays(p, dt[:, 0], cfg)   # (B, H)
    v = (xin_c.reshape(b, hl, pp) * dtv[..., None]).float()
    k = bmat_c[:, None, :].expand(b, hl, n)
    q = cmat_c[:, None, :].expand(b, hl, n)
    w = log_decay[..., None].expand(b, hl, n)

    y, new_state = linear_scan.gla_decode_step(state, q, k, v, w)
    y = y + _head_rows(p, "d_skip", cfg)[None, :, None] * \
        xin_c.reshape(b, hl, pp)
    y = y.reshape(b, 1, hl * pp).to(x.dtype)
    y = common.split_rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return (common.row_parallel(y, p["out_proj"], x.dtype), new_state,
            new_conv_state)
