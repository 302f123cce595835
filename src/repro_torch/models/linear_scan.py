"""Chunked (gated) linear-attention scans shared by Mamba2 / SSD and RWKV6.

Counterpart of ``repro.models.linear_scan``.  Both families are diagonal
linear recurrences over a matrix-valued state S in R^{K x V} per head:

    S_t = diag(lambda_t) S_{t-1} + k_t v_t^T          (lambda in (0, 1])
    y_t = q_t^T S_t            (+ RWKV "bonus": q_t^T diag(u) k_t v_t^T)

Mamba2 (SSD) uses a scalar-per-head decay; RWKV6 ("Finch") a
data-dependent per-channel decay.  The chunked form processes the
sequence in chunks of Q tokens: intra-chunk contributions use a masked
(Q, Q) kernel matrix, and the state flows across chunks through a Python
loop (the reference's ``lax.scan``) carrying an fp32 state.  The
reference has no Pallas kernel here, so plain torch ops are its port.

Each pair contribution is evaluated as (q_i e^{c_i}) . (k_j e^{-c_j}),
with every factor's exponent clamped at +-CLIP; models clamp the
per-step log-decay to >= -MAX_STEP_DECAY so that chunk * MAX_STEP_DECAY
stays inside CLIP.  ``torch.cumsum`` sums in another order than
``jnp.cumsum``, so the port agrees with the reference to fp32 rounding
carried through ``exp(cum)``, not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor
CLIP = 80.0
#: models clamp per-step log-decay to >= -MAX_STEP_DECAY so that
#: chunk * MAX_STEP_DECAY < CLIP with margin.
MAX_STEP_DECAY = 1.0


def _chunk(x: Tensor, q: int) -> Tensor:
    b, s = x.shape[:2]
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {q}")
    return x.reshape((b, s // q, q) + tuple(x.shape[2:]))


def gla_chunked(q_in: Tensor, k_in: Tensor, v_in: Tensor, log_decay: Tensor,
                *, chunk: int = 64, u: Optional[Tensor] = None,
                init_state: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Per-channel-decay chunked linear attention (RWKV6 / GLA).

    q_in, k_in: (B, S, H, K); v_in: (B, S, H, V); log_decay: (B, S, H, K),
    <= 0, applied *before* the new kv write at each step; u: optional
    (H, K) bonus on the current token (RWKV6); init_state: optional (B,
    H, K, V).  Returns (y (B, S, H, V) fp32, final_state (B, H, K, V)).
    """
    b, s, h, kdim = q_in.shape
    vdim = v_in.shape[-1]
    qc = _chunk(q_in.float(), chunk)
    kc = _chunk(k_in.float(), chunk)
    vc = _chunk(v_in.float(), chunk)
    wc = _chunk(log_decay.float(), chunk)
    nck = qc.shape[1]

    # Cumulative log-decay within each chunk.  Without u the output taps
    # S_t (inclusive exponent); with u (RWKV6) S_{t-1} + u (.) k v
    # (exclusive exponent).
    cum = torch.cumsum(wc, dim=2)                      # (B, nc, Q, H, K)
    total = cum[:, :, -1]                              # (B, nc, H, K)
    read_cum = (cum - wc) if u is not None else cum

    q_scaled = qc * torch.exp(torch.clamp(read_cum, -CLIP, CLIP))
    k_scaled = kc * torch.exp(torch.clamp(-cum, -CLIP, CLIP))
    k_carry = kc * torch.exp(torch.clamp(total[:, :, None] - cum, -CLIP, CLIP))

    # Intra-chunk kernel: A[i, j] = sum_k q'_i k'_j, strictly causal.
    a = torch.einsum("bnihk,bnjhk->bnhij", q_scaled, k_scaled)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=a.device), diagonal=-1)
    a = torch.where(mask, a, torch.zeros((), dtype=a.dtype, device=a.device))
    y_intra = torch.einsum("bnhij,bnjhv->bnihv", a, vc)

    # Diagonal (current-token) term: the u-weighted bonus for RWKV6, the
    # plain post-update read otherwise.
    if u is not None:
        diag = (qc * u.float() * kc).sum(dim=-1)
    else:
        diag = (qc * kc).sum(dim=-1)
    y_intra = y_intra + diag[..., None] * vc

    state = torch.zeros((b, h, kdim, vdim), dtype=torch.float32,
                        device=qc.device) if init_state is None \
        else init_state.float()
    decay = torch.exp(torch.clamp(total, -CLIP, 0.0))[..., None]
    y_inter = []
    for c in range(nck):
        y_inter.append(torch.einsum("bihk,bhkv->bihv", q_scaled[:, c], state))
        state = state * decay[:, c] + \
            torch.einsum("bihk,bihv->bhkv", k_carry[:, c], vc[:, c])
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, h, vdim), state


def gla_decode_step(state: Tensor, q: Tensor, k: Tensor, v: Tensor,
                    log_decay: Tensor, u: Optional[Tensor] = None
                    ) -> tuple[Tensor, Tensor]:
    """Single-token recurrence.  state: (B, H, K, V); q / k / log_decay:
    (B, H, K); v: (B, H, V).  Returns (y (B, H, V), new_state)."""
    state = state.float()
    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    decay = torch.exp(torch.clamp(log_decay.float(), -CLIP, 0.0))[..., None]
    if u is not None:
        eff = state + u.float()[None, :, :, None] * kv
        y = torch.einsum("bhk,bhkv->bhv", q.float(), eff)
        new = state * decay + kv
    else:
        new = state * decay + kv
        y = torch.einsum("bhk,bhkv->bhv", q.float(), new)
    return y, new


def gla_naive(q_in: Tensor, k_in: Tensor, v_in: Tensor, log_decay: Tensor,
              *, u: Optional[Tensor] = None,
              init_state: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Token-by-token oracle: :func:`gla_decode_step` over time."""
    b, s, h, kdim = q_in.shape
    vdim = v_in.shape[-1]
    state = torch.zeros((b, h, kdim, vdim), dtype=torch.float32,
                        device=q_in.device) if init_state is None \
        else init_state.float()
    ys = []
    for t in range(s):
        y, state = gla_decode_step(state, q_in[:, t], k_in[:, t], v_in[:, t],
                                   log_decay[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), state
