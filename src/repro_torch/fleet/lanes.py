"""The lane-batched federated round: B scenario jobs stepped together
(counterpart of ``repro.fleet.lanes``).

The reference writes ONE lane's fully dynamic round and ``jax.vmap``s it
over a leading lane axis.  The port's kernels cannot run inside
``torch.func.vmap``, so the round is written lane-batched from the start:
state, batch, cohort ids and ops all carry a leading B axis.

* poisoned lanes corrupt their batches before the client pass
  (:func:`repro_torch.fed.poison.poison_batch_lanes`, rate / strength per
  lane, feature noise drawn in the host plan);
* the client pass is a ``torch.func.vmap`` over lanes of the vmapped
  cohort pass (plain torch, so vmap is fine there);
* the attack family of each lane is a host int from the round plan, f /
  eta / beta / local_lr / lr are (B,) device tensors;
* guarded lanes screen the attacked stack on the lane axis
  (:func:`repro_torch.robustness.guard.quarantine_stack_lanes`) and
  return ``quarantined_count``;
* aggregation is :func:`repro_torch.core.robust.batched_robust_aggregate`
  on the explicit lane axis, each hierarchical or bucketing lane with its
  own permutation from the plan (on a CUDA stack every kernel takes all
  lanes in one launch: K6 / K7, K5, and K4, K2's median or K3);
* tapped lanes compute the health taps with each lane's ``f_agg``,
  honest count and guard mask (:func:`repro_torch.obs.health_taps_lanes`)
  as ``taps.<field>`` metrics, (B,) or (B, m) each;
* lanes whose job has finished are frozen by ``torch.where(active, new,
  old)``; ``active`` is never read on the host.

A segment (the reference's ``lax.scan`` over rounds) is a Python loop
over its rounds: the metrics stay on the device and come to the host once,
when the caller stacks them at the segment's end.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import vmap

from repro_torch.core import robust as robust_lib
from repro_torch.core.attacks import apply_attack_batched
from repro_torch.fed.clients import client_updates
from repro_torch.fed.poison import poison_batch_lanes
from repro_torch.fed.server import FedConfig
from repro_torch.obs.taps import health_taps_lanes, tap_metrics
from repro_torch.optim import Optimizer
from repro_torch.robustness.guard import quarantine_stack_lanes
from repro_torch.training.trainer import kappa_hat_masked
from repro_torch.tree import tree_map, tree_structure, tree_unflatten

Tensor = torch.Tensor

#: Per-round, per-lane operands, each (B,) in a round:
#:   attack_id  int32  — DYN_ATTACK_FAMILIES index (also passed as host
#:                       ints: the round picks its attack branches there)
#:   m_byz      int32  — Byzantine rows in the cohort stack
#:   f_agg      int32  — aggregator Byzantine budget (== m_byz)
#:   eta        float32 — attack strength
#:   beta       float32 — client momentum coefficient
#:   local_lr   float32 — client local-SGD step size
#:   lr         float32 — server learning rate this round
#:   active     bool   — False freezes the lane's state this round
#:   poison_rate     float32 — data-poisoning sample rate (0 = clean; the
#:                             poison KIND is bucket-key material)
#:   poison_strength float32 — feature-poisoning noise scale
LANE_OP_FIELDS = ("attack_id", "m_byz", "f_agg", "eta", "beta", "local_lr",
                  "lr", "active", "poison_rate", "poison_strength")


def _lanes_like(mask: Tensor, x: Tensor) -> Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def gather_lane_rows(momentum: list, idx: Tensor) -> list:
    """Each lane's cohort rows of its (B, n_clients, ...) momentum."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return [m[lanes, idx] for m in momentum]


def scatter_lane_rows(momentum: list, idx: Tensor, rows: list) -> list:
    """The (B, n_clients, ...) stacks with each lane's cohort rows
    replaced (new tensors)."""
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    out = []
    for m, r in zip(momentum, rows):
        m = m.clone()
        m[lanes, idx] = r
        out.append(m)
    return out


def build_lane_round(loss_fn: Callable, optimizer: Optimizer,
                     cfg: FedConfig) -> Callable:
    """The B-lane round: ``(state, batch, idx, ops, attack_ids, perms,
    noise, signs) -> (state, metrics)``.

    ``state``: params (B, ...) per leaf, ``opt_state``, ``step`` (B,) and,
    for D-SHB, ``momentum`` (a list of (B, n_clients, ...) fp32 leaves in
    the parameters' leaf order).  ``batch`` leaves (B, m, L, bs, ...),
    ``idx`` (B, m) int64 cohort ids, ``ops`` the LANE_OP_FIELDS as (B,)
    device tensors, ``attack_ids`` the same B attack ids as host ints (the
    round picks the attack branches on the host), ``perms`` (B, m) bucket
    permutations (pre="bucketing", or hier with buckets of more than one)
    or None, ``noise`` the (B, m, L, bs,
    ...) feature-poisoning draws (poison kind "feature") or None,
    ``signs`` one (B, C_i) sketch-sign tensor per leaf (``sketch_dim``)
    or None.
    ``cfg`` contributes only the static skeleton; its f, client beta /
    local_lr and poison rate / strength give way to ``ops``.  Metrics are
    (B,) device tensors (the per-worker taps (B, m))."""
    ccfg, spec = cfg.client, cfg.agg

    def one_lane_clients(params, mom, batch, beta, local_lr):
        return client_updates(loss_fn, params, mom, batch, ccfg,
                              beta=beta, local_lr=local_lr)

    lane_clients = vmap(one_lane_clients)
    lane_update = vmap(optimizer.update)

    def lane_round(state: dict, batch, idx: Tensor, ops: dict, attack_ids,
                   perms: Optional[Tensor] = None,
                   noise: Optional[Tensor] = None,
                   signs: Optional[list] = None):
        params = state["params"]
        skeleton = tree_structure(params)
        has_momentum = "momentum" in state
        cohort_mom = gather_lane_rows(state["momentum"], idx) \
            if has_momentum else []
        if cfg.poison is not None:
            batch = poison_batch_lanes(batch, cfg.poison, ops["m_byz"],
                                       rate=ops["poison_rate"],
                                       strength=ops["poison_strength"],
                                       noise=noise)
        losses, stack, new_cohort_mom = lane_clients(
            params, cohort_mom, batch, ops["beta"], ops["local_lr"])
        b, m = losses.shape
        m_honest = m - ops["m_byz"]

        attacked = apply_attack_batched(attack_ids, stack, ops["m_byz"],
                                        etas=ops["eta"],
                                        lane_ids=ops.get("attack_id"))
        qinfo = None
        if cfg.guard is not None:
            attacked, qinfo = quarantine_stack_lanes(attacked, cfg.guard)
        tap_internals = {} if cfg.taps else None
        robust_dir = robust_lib.batched_robust_aggregate(
            attacked, spec, ops["f_agg"], perms=perms, signs=signs,
            internals=tap_internals)
        direction = tree_unflatten(skeleton, robust_dir)

        lr = ops["lr"]
        new_params, new_opt = lane_update(direction, state["opt_state"],
                                          params, lr)
        new_state = dict(params=new_params, opt_state=new_opt,
                         step=state["step"] + 1)
        if has_momentum:
            new_state["momentum"] = scatter_lane_rows(state["momentum"], idx,
                                                      new_cohort_mom)

        w = (torch.arange(m, device=idx.device)[None]
             < m_honest[:, None]).float()
        metrics = {
            "loss": (losses * w).sum(dim=1) / torch.clamp_min(
                m_honest.float(), 1.0),
            "lr": lr,
            "direction_norm": torch.sqrt(sum(
                (leaf.float() ** 2).reshape(b, -1).sum(dim=1)
                for leaf in robust_dir)),
        }
        if qinfo is not None:
            metrics["quarantined_count"] = qinfo["count"]
        if cfg.track_kappa_hat:
            metrics["kappa_hat"] = kappa_hat_masked(robust_dir, attacked,
                                                    m_honest, tap_internals)
        if cfg.taps:
            metrics.update(tap_metrics(health_taps_lanes(
                attacked, robust_dir, n_honest=m_honest, f=ops["f_agg"],
                rule=spec.rule, pre=spec.pre, internals=tap_internals,
                quarantine=qinfo)))

        # Finished lanes ride along frozen (never read on the host).
        active = ops["active"]
        frozen = tree_map(
            lambda new, old: torch.where(_lanes_like(active, new), new, old),
            new_state, state)
        return frozen, metrics

    return lane_round


#: The reference vmaps a one-lane round into its fleet round; the port's
#: round is lane-batched already, so the two are one.
build_fleet_round = build_lane_round


def build_fleet_scan(loss_fn: Callable, optimizer: Optimizer,
                     cfg: FedConfig, *,
                     on_build: Optional[Callable[[], None]] = None
                     ) -> Callable:
    """One segment of K rounds: ``(state, operands) -> (state, metrics)``
    with ``operands = {"batch": (K, B, m, L, ...), "idx": (K, B, m),
    "ops": {field: (K, B)}, "attack_id": (K, B) host ints, "perm": (K, B,
    m) or absent, "noise": (K, B, m, L, bs, ...) or absent, "signs": a
    list of (K, B, C_i) or absent}`` on the
    state's device, and metrics stacked (K, B) on the device.  A Python
    loop replaces the reference's ``lax.scan``; the per-round math is
    :func:`build_lane_round`'s.  The returned state is new tensors, never
    the input's, so an in-place :func:`build_lane_admit` write cannot
    reach a segment's input.  ``on_build`` fires once, here (the
    reference counts jit traces)."""
    if on_build is not None:
        on_build()
    lane = build_lane_round(loss_fn, optimizer, cfg)

    def fleet_scan(state: dict, operands: dict):
        rounds = operands["idx"].shape[0]
        perms, noise = operands.get("perm"), operands.get("noise")
        signs = operands.get("signs")
        cols: dict = {}
        for r in range(rounds):
            state, metrics = lane(
                state, tree_map(lambda a: a[r], operands["batch"]),
                operands["idx"][r],
                {k: v[r] for k, v in operands["ops"].items()},
                operands["attack_id"][r],
                None if perms is None else perms[r],
                None if noise is None else noise[r],
                None if signs is None else [sg[r] for sg in signs])
            for k, v in metrics.items():
                cols.setdefault(k, []).append(v)
        return state, {k: torch.stack(v) for k, v in cols.items()}

    return fleet_scan


def build_lane_admit() -> Callable:
    """The continuous service's slot writer: ``admit(state, lane_state,
    slot) -> state`` overwrites lane ``slot`` of the stacked state with one
    job's (unstacked) init or restored state, in place (``leaf[slot].copy_
    (one)`` under ``torch.no_grad()``): no bucket reallocation, the
    counterpart of the reference's donated ``dynamic_update_index_in_dim``
    (torch has no buffer donation; the in-place write is its stand-in)."""

    def admit(state: dict, lane_state: dict, slot: int) -> dict:
        k = int(slot)
        with torch.no_grad():
            tree_map(lambda full, one: full[k].copy_(one), state, lane_state)
        return state

    return admit
