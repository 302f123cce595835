"""Federated server: sample -> broadcast -> client pass -> robust aggregate
(counterpart of ``repro.fed.server``).

One round:

  1. HOST: resolve the attack schedule, the Byzantine identity set and
     the cohort: ``m_byz`` Byzantine + ``m - m_byz`` honest clients
     sampled without replacement, Byzantine rows LAST.
  2. DEVICE: gather the cohort's momentum rows, poison the Byzantine
     rows' batches when configured, run the client pass, scatter the new
     momentum back, overwrite the last ``m_byz`` rows with the scheduled
     attack, screen the stack (quarantine guard, when configured),
     robustly aggregate with ``f`` rescaled to the cohort
     (:func:`rescale_f`), apply the server optimizer and, with
     ``FedConfig.taps``, compute the health taps on the screened stack
     (:mod:`repro_torch.obs.taps`, ``taps.<field>`` metrics; the
     history's ``taps``).

Both engines of :func:`run_rounds` run ONE round body: "loop" calls it
round by round (:meth:`FedServer.round_fn`, metrics fetched every round),
"scan" runs it segment by segment through a
:class:`~repro_torch.rounds.RoundEngine` (metrics fetched once a run), so
the two agree bit for bit.  With full participation, ``local_steps=0`` and
the fixed last-f identities a round is a trainer step
(:func:`repro_torch.training.build_train_step`).

Memory layout (the trainer's, not the reference's per-leaf stacks): the
population momentum is ONE flat (n_clients, D) fp32 buffer, columns in
jax's leaf order (``repro_torch.interop.state_from_numpy`` builds it from
the reference's list).  A round gathers its cohort rows into one (m, D)
buffer, folds the client sends into it in place, writes the new momentum
back into the population buffer in place, then attacks, screens and
aggregates that same cohort buffer (the kernel path reads it through a
zero-copy view).  The round therefore OWNS ``state["momentum"]``: it is
updated in place and shared with the returned state (clone it to keep
the old one).  The Byzantine rows keep their honest momentum, as in the
reference: their transmitted values are attacked, not their local state.

Per-round randomness (the feature-poisoning noise, then the bucket
permutation of ``pre="bucketing"`` / ``hier`` and the signs of
``sketch_dim``) is drawn from a CPU ``torch.Generator`` per round, seeded
from :func:`round_seeds` (the reference splits PRNG keys); ``round_fn``
also takes ``perm=`` / ``noise=`` / ``signs=`` explicitly (the
reference's draws, in the parity tests).  The permutation and the signs
are drawn once a round: under ``alie_opt`` / ``foe_opt`` the 12 candidate
aggregates of the eta search (the round's spec, no guard: the guard
screens the attacked stack after it) and the deployed one share them, as
the reference's closure shares its ``agg_key``.
Entry points run on CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import robust as robust_lib
from repro_torch.core.attacks import (
    ETA_ATTACKS, apply_attack_scan, check_static_families,
)
from repro_torch.core.theory import tree_kappa_hat
from repro_torch.core.types import AggregatorSpec
from repro_torch.device import resolve_device
from repro_torch.fed.clients import (
    ClientConfig, autograd_grad_and_value, client_send, client_updates,
)
from repro_torch.fed.metrics import FedHistory
from repro_torch.fed.poison import PoisonConfig, poison_batch
from repro_torch.fed.schedules import AttackSchedule, FixedByzantine
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.obs import runtime as obs_runtime
from repro_torch.obs.taps import health_taps, tap_columns, tap_metrics
from repro_torch.optim import Optimizer, global_norm
from repro_torch.resilience import (
    CarryCheckpointer, SnapshotStore, check_signature, concat_metrics,
    resolve_checkpoint, restore_carry, restored_metrics,
)
from repro_torch.robustness.guard import QuarantineConfig, quarantine_stack
from repro_torch.rounds import (
    RoundEngine, RoundOptions, fetch_metrics, resolve_attack_operands,
    resolve_options, round_generator, round_seeds, schedule_families,
    split_segments, stack_rounds,
)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any
Tensor = torch.Tensor

#: The client pass vmaps over the cohort when the cohort stack (m x D)
#: holds at most this many elements, and loops over the cohort rows (one
#: gradient alive at a time) above.
VMAP_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """Static description of the federated system.  ``taps``: the
    in-round health taps (refused with ``agg.hier``)."""
    n_clients: int
    clients_per_round: int          # m <= n_clients
    f: int = 0                      # Byzantine clients in the POPULATION
    agg: AggregatorSpec = AggregatorSpec()
    client: ClientConfig = ClientConfig()
    track_kappa_hat: bool = True
    taps: bool = False
    #: Data poisoning of the last ``m_byz`` cohort rows' batches.
    poison: Optional[PoisonConfig] = None
    #: In-round quarantine of non-finite / norm-exploded rows.
    guard: Optional[QuarantineConfig] = None

    def __post_init__(self):
        if not 0 < self.clients_per_round <= self.n_clients:
            raise ValueError("need 0 < clients_per_round <= n_clients")
        if self.f >= self.n_clients / 2:
            raise ValueError("population must be majority-honest (f < n/2)")


def cohort_breakdown(m: int) -> int:
    """Largest tolerable f for an m-row aggregation (f < m/2)."""
    return (m - 1) // 2


def rescale_f(f_total: int, n_total: int, m: int) -> int:
    """Byzantine budget of an m-client cohort sampled from (n_total,
    f_total): ceil(f_total * m / n_total), clipped to the cohort's
    breakdown point."""
    if f_total == 0:
        return 0
    return min(math.ceil(f_total * m / n_total), cohort_breakdown(m))


def sample_cohort(rng: np.random.Generator, n_clients: int, m: int,
                  byz_ids: np.ndarray, m_byz: int) -> np.ndarray:
    """Cohort ids, honest rows first, Byzantine rows LAST."""
    byz_ids = np.asarray(byz_ids)
    honest_ids = np.setdiff1d(np.arange(n_clients), byz_ids)
    h = rng.choice(honest_ids, size=m - m_byz, replace=False)
    b = rng.choice(byz_ids, size=m_byz, replace=False) if m_byz else \
        np.empty((0,), np.int64)
    return np.concatenate([np.sort(h), np.sort(b)]).astype(np.int32)


def _emit_quarantine_event(surface: str, total: int, rounds: int) -> None:
    """One ``robustness.quarantine`` event per run, only when a row was
    quarantined (the per-round counts are metrics)."""
    if total:
        obs_runtime.event("robustness.quarantine", surface=surface,
                          total=total, rounds=rounds)


def _on(dev: torch.device, a) -> Tensor:
    """A numpy array or tensor as a tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.as_tensor(np.asarray(a)).to(dev)


class FedServer:
    """Holds the model-side callables and a cache of round bodies.

    ``round_fn`` is cached by ``(attack, m_byz, f_round, use_eta)`` and
    ``scan_engine`` by ``(families, m_byz, f_round, chunk)``, the
    reference's keys; everything else (cohort ids, batch, eta, randomness)
    is an argument.  The client pass vmaps the gradient over the cohort
    (``client_updates``) up to :data:`VMAP_ELEMS` cohort-stack elements
    and calls ``client_send`` on plain autograd row by row above (one
    gradient alive at a time: the trainer's form, for models too wide to
    vmap)."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer,
                 cfg: FedConfig, lr_schedule: Callable,
                 options: Optional[RoundOptions] = None, *,
                 device=None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        #: The backend override applies to ``cfg`` here; engine and chunk
        #: become the defaults ``run_rounds`` falls back to.
        self.options = options if options is not None else RoundOptions()
        self.cfg = self.options.apply_config(cfg)
        if self.cfg.taps:
            robust_lib.validate_taps(self.cfg.agg)
        if self.cfg.client.algorithm not in ("dshb", "dgd"):
            raise ValueError(f"unknown algorithm {self.cfg.client.algorithm!r}")
        self.lr_schedule = lr_schedule
        self._round_cache: dict[tuple, Callable] = {}
        self._scan_cache: dict[tuple, RoundEngine] = {}
        #: Counters of the latest segmented run (None before one):
        #: ``trace_count`` (new builds that run caused, 0 on a cache hit),
        #: ``total_trace_count``, ``chunk_shapes``, ``segments``
        #: (``(start, end, seconds)`` per segment, host clock) and, with
        #: the guard, ``quarantined_count`` per round.
        self.last_scan_report: Optional[dict] = None

    # -- state ------------------------------------------------------------
    def init_state(self, params: PyTree) -> dict:
        """Round-0 state on the server's device: params, opt_state, step
        and, for D-SHB, the flat (n_clients, D) fp32 momentum."""
        params = tree_map(lambda p: p.to(self.device), params)
        state = dict(params=params, opt_state=self.optimizer.init(params),
                     step=0)
        if self.cfg.client.algorithm == "dshb":
            width = sum(p.numel() for p in tree_leaves(params))
            state["momentum"] = torch.zeros(
                (self.cfg.n_clients, width), dtype=torch.float32,
                device=self.device)
        return state

    def _f_round(self) -> int:
        """The cohort's Byzantine budget, also the aggregator's f."""
        cfg = self.cfg
        return rescale_f(cfg.f, cfg.n_clients, cfg.clients_per_round)

    # -- the client pass --------------------------------------------------
    def _client_pass(self, params: PyTree, stack: Tensor, batch: PyTree,
                     layout: kdispatch.StackLayout) -> Tensor:
        """Fold the cohort's sends into ``stack`` (m, D) in place (D-SHB:
        m <- beta m + (1 - beta) g, the trainer's fold; D-GD: the sends);
        returns the (m,) losses."""
        ccfg = self.cfg.client
        m = stack.shape[0]
        beta = float(np.float32(ccfg.beta))
        one_minus_beta = float(np.float32(1.0) - np.float32(ccfg.beta))
        # The sends unblended: the fold below blends them in place.
        ccfg_dgd = dataclasses.replace(ccfg, algorithm="dgd")

        def fold(row_or_rows: Tensor, sends) -> None:
            for (off, size, _), g in zip(layout.segments, sends):
                seg = row_or_rows[..., off:off + size]
                g = g.reshape(seg.shape).float()
                if ccfg.algorithm == "dshb":
                    seg.mul_(beta).add_(g, alpha=one_minus_beta)
                else:
                    seg.copy_(g)

        if m * layout.width <= VMAP_ELEMS:
            losses, sends, _ = client_updates(self.loss_fn, params, [],
                                              batch, ccfg_dgd)
            fold(stack, sends)
            return losses.detach().float()
        losses = []
        for i in range(m):
            loss, sends = client_send(
                self.loss_fn, params, tree_map(lambda b: b[i], batch), ccfg,
                grad_and_value=autograd_grad_and_value)
            fold(stack[i], sends)
            losses.append(loss.detach().float())
            del sends
        return torch.stack(losses)

    # -- the round body ---------------------------------------------------
    def _build_body(self, m_byz: int, f_round: int) -> Callable:
        """``body(state, batch, idx, families, attack_id, eta, generator,
        perm, noise) -> (state, metrics)``: the one round both engines
        run.  ``families[attack_id]`` is the round's attack (host ints;
        ``eta`` reaches alie / foe only, through ``apply_attack_scan``);
        metrics are device tensors, apart from the host ``lr``."""
        cfg = self.cfg
        spec = dataclasses.replace(cfg.agg, f=f_round)

        def body(state, batch, idx, families, attack_id, eta, generator,
                 perm=None, noise=None, signs=None):
            params = state["params"]
            dev = tree_leaves(params)[0].device
            idx = _on(dev, idx).long()
            batch = tree_map(lambda a: _on(dev, a), batch)
            m = idx.shape[0]
            m_honest = m - m_byz
            layout = kdispatch.stack_layout(tree_map(
                lambda p: torch.empty((m,) + tuple(p.shape), device="meta"),
                params))
            if cfg.poison is not None:
                batch = poison_batch(batch, cfg.poison, m_byz,
                                     rate=cfg.poison.rate,
                                     strength=cfg.poison.strength,
                                     generator=generator, noise=noise)
            has_momentum = "momentum" in state
            if has_momentum:
                stack = state["momentum"].index_select(0, idx)
            else:
                stack = torch.empty((m, layout.width), dtype=torch.float32,
                                    device=dev)
            losses = self._client_pass(params, stack, batch, layout)
            if has_momentum:
                # The pre-attack momentum goes back; the cohort buffer is
                # the round's own from here on.
                state["momentum"].index_copy_(0, idx, stack)

            # One draw for every aggregate of the round (after the noise).
            perm, signs = robust_lib.draw_randomness(
                kdispatch.stack_views(stack, layout), spec,
                generator=generator, perm=perm, signs=signs)

            def aggregate(flat, tap_internals=None):
                return robust_lib.robust_aggregate(
                    kdispatch.stack_views(flat, layout), spec, perm=perm,
                    signs=signs, internals=tap_internals)

            apply_attack_scan(families, attack_id, stack, m_byz, eta=eta,
                              segments=[(off, size) for off, size, _
                                        in layout.segments],
                              agg_closure=aggregate if any(
                                  a.endswith("_opt") for a in families)
                              else None)
            attacked = kdispatch.stack_views(stack, layout)
            qinfo = None
            if cfg.guard is not None:
                screened, qinfo = quarantine_stack(attacked, cfg.guard)
                for view, new in zip(tree_leaves(attacked),
                                     tree_leaves(screened)):
                    view.copy_(new)
                del screened

            tap_internals = {} if cfg.taps else None
            direction = aggregate(stack, tap_internals)
            lr = self.lr_schedule(state["step"])
            new_params, new_opt = self.optimizer.update(
                direction, state["opt_state"], params, lr)
            new_state = dict(params=new_params, opt_state=new_opt,
                             step=state["step"] + 1)
            if has_momentum:
                new_state["momentum"] = state["momentum"]

            metrics = {"loss": losses[:m_honest].mean(), "lr": lr,
                       "direction_norm": global_norm(direction)}
            if qinfo is not None:
                metrics["quarantined_count"] = qinfo["count"]
            if cfg.track_kappa_hat:
                metrics["kappa_hat"] = tree_kappa_hat(direction, attacked,
                                                      m_honest, tap_internals)
            if cfg.taps:
                metrics.update(tap_metrics(health_taps(
                    attacked, direction, n_honest=m_honest, f=f_round,
                    rule=spec.rule, pre=spec.pre, internals=tap_internals,
                    quarantine=qinfo)))
            return new_state, metrics

        return body

    def round_fn(self, attack: str, m_byz: int,
                 f_round: Optional[int] = None) -> Callable:
        """One round of one attack family (cached): ``step(state, batch,
        idx, eta=0.0, generator=None, *, perm=None, noise=None, signs=None)
        -> (state, metrics)``.  ``eta`` reaches alie / foe only."""
        if f_round is None:
            f_round = self._f_round()
        check_static_families((attack,))
        use_eta = attack in ETA_ATTACKS
        cache_key = (attack, m_byz, f_round, use_eta)
        if cache_key not in self._round_cache:
            body = self._build_body(m_byz, f_round)
            families = (attack,)

            def step(state, batch, idx, eta=0.0, generator=None, *,
                     perm=None, noise=None, signs=None):
                return body(state, batch, idx, families, 0,
                            float(np.float32(eta)), generator, perm, noise,
                            signs)

            self._round_cache[cache_key] = step
        return self._round_cache[cache_key]

    def _prepare(self, seg: dict) -> dict:
        """A segment's host operands with batch and cohort ids on the
        device (one copy per leaf a segment)."""
        return dict(seg, batch=tree_map(lambda a: _on(self.device, a),
                                        seg["batch"]),
                    idx=_on(self.device, seg["idx"]).long())

    def scan_engine(self, families: tuple, m_byz: int,
                    f_round: Optional[int] = None,
                    chunk: Optional[int] = None) -> RoundEngine:
        """The segmented engine for one run skeleton (cached: a rerun with
        the same families / budgets / chunk builds nothing).  Its operands:
        ``batch``, ``idx``, ``attack_id``, ``eta`` and ``key`` (the
        per-round seeds), each with a leading round axis."""
        if f_round is None:
            f_round = self._f_round()
        check_static_families(families)
        cache_key = (families, m_byz, f_round, chunk)
        if cache_key not in self._scan_cache:
            body = self._build_body(m_byz, f_round)

            def scan_body(state, op):
                return body(state, op["batch"], op["idx"], families,
                            int(op["attack_id"]), float(op["eta"]),
                            round_generator(op["key"]))

            self._scan_cache[cache_key] = RoundEngine(
                scan_body, chunk=chunk, prepare=self._prepare)
        return self._scan_cache[cache_key]


def run_rounds(server: FedServer, state: dict, batch_fn: Callable,
               rounds: int, *,
               schedule: AttackSchedule = AttackSchedule(),
               byz_identity=None, seed: int = 0,
               engine: Optional[str] = None,
               chunk: Optional[int] = None,
               options: Optional[RoundOptions] = None
               ) -> tuple[dict, FedHistory]:
    """Drive ``rounds`` federated rounds; returns (state, history).

    ``batch_fn(cohort_ids, n_flip, rng)`` returns numpy leaves (m,
    max(local_steps, 1), batch, ...); ``n_flip > 0`` asks for flipped
    labels on the LAST n_flip cohort rows (the ``"lf"`` attack).
    ``byz_identity.ids(round)`` gives the Byzantine set (default: the
    fixed last f).  The host plan consumes ``np.random.default_rng(seed)``
    in the reference's order (cohort, then batch, round by round), so
    cohorts and batches equal the reference's.

    ``engine``: "scan" (default) plans the whole run up front and runs it
    segment by segment (``chunk`` rounds at most; None = one segment),
    its metrics fetched once (counters in ``server.last_scan_report``);
    "loop" runs the same body round by round, metrics fetched every
    round.  Both draw the same per-round randomness, so they agree bit
    for bit.

    ``options`` (:class:`~repro_torch.rounds.RoundOptions`): explicit
    ``engine=`` / ``chunk=`` keywords win over it, and it over the
    server's construction-time options; its ``taps`` and ``backend`` must
    agree with the server's config.  ``options.checkpoint`` makes a scan run
    resumable: the state and the metrics so far are snapshotted at
    segment boundaries, and a rerun into the same directory resumes from
    the latest snapshot (``last_scan_report["resumed_from"]``).
    """
    opts = resolve_options(options, engine=engine, chunk=chunk)
    opts = server.options.merged(engine=opts.engine, chunk=opts.chunk,
                                 taps=opts.taps, backend=opts.backend,
                                 checkpoint=opts.checkpoint)
    if opts.apply_config(server.cfg) is not server.cfg:
        raise ValueError(
            "run_rounds cannot override taps/backend per call: they are "
            "the round body's key material; pass options to FedServer(...)")
    engine, chunk = opts.engine or "scan", opts.chunk
    if engine not in ("scan", "loop"):
        raise ValueError(f"engine must be 'scan' or 'loop', got {engine!r}")
    if opts.checkpoint is not None and engine != "scan":
        raise ValueError("options.checkpoint requires engine='scan' "
                         "(the loop path has no chunk boundaries to "
                         "snapshot at)")
    cfg = server.cfg
    check_static_families(schedule_families(schedule))
    if byz_identity is None:
        byz_identity = FixedByzantine(cfg.n_clients, cfg.f)
    m = cfg.clients_per_round
    m_byz = server._f_round()
    rng = np.random.default_rng(seed)
    hist = FedHistory()
    if rounds == 0:
        return state, hist
    seeds = round_seeds(seed, rounds)

    if engine == "loop":
        q_total = 0
        for r in range(rounds):
            attack, eta = schedule.resolve(r)
            cohort = sample_cohort(rng, cfg.n_clients, m,
                                   byz_identity.ids(r), m_byz)
            n_flip = m_byz if attack == "lf" else 0
            batch = batch_fn(cohort, n_flip, rng)
            step = server.round_fn(attack, m_byz)
            state, metrics = step(state, batch, cohort,
                                  0.0 if eta is None else eta,
                                  round_generator(seeds[r]))
            host = {k: v[0] for k, v in fetch_metrics([metrics]).items()}
            if "quarantined_count" in host:
                q_total += int(host["quarantined_count"])
            hist.record(host, cohort=cohort, attack=attack, eta=eta,
                        m_byz=m_byz, f_round=m_byz,
                        taps=tap_columns(host) if cfg.taps else None)
        _emit_quarantine_event("fed.loop", q_total, rounds)
        return state, hist

    # HOST, once: the loop's per-round decisions, in the same rng order.
    families, attack_ops, meta = resolve_attack_operands(schedule, rounds)
    cohorts: list = []
    batches: list = []
    for r in range(rounds):
        attack, _ = meta[r]
        cohort = sample_cohort(rng, cfg.n_clients, m, byz_identity.ids(r),
                               m_byz)
        n_flip = m_byz if attack == "lf" else 0
        batches.append(batch_fn(cohort, n_flip, rng))
        cohorts.append(cohort)
    operands = {"batch": stack_rounds(batches),
                "idx": np.stack(cohorts).astype(np.int32),
                "key": seeds, **attack_ops}

    # Resilience: resume from the last segment-boundary snapshot (if any)
    # and keep snapshotting carry + metrics so far at every boundary.  The
    # host plan above is recomputed in full; only the round cursor is
    # durable.
    ckpt_cfg = resolve_checkpoint(opts.checkpoint)
    checkpointer, start_round, saved_cols = None, 0, {}
    if ckpt_cfg is not None:
        store = SnapshotStore.from_config(ckpt_cfg)
        signature = {"surface": "fed", "rounds": rounds, "chunk": chunk,
                     "seed": seed, "families": list(families),
                     "m_byz": m_byz, **({"taps": True} if cfg.taps else {})}
        snap = store.load_latest() if ckpt_cfg.resume else None
        if snap is not None:
            start_round, arrays, snap_meta = snap
            check_signature(snap_meta["signature"], signature, store.path)
            state = restore_carry(arrays, snap_meta, state)
            saved_cols = restored_metrics(arrays)
        checkpointer = CarryCheckpointer(
            store, signature=signature, total=rounds, every=ckpt_cfg.every,
            base_columns=saved_cols)

    eng = server.scan_engine(families, m_byz, chunk=chunk)
    traces_before = eng.trace_count
    try:
        state, metrics = eng.run(
            state, operands,
            on_segment=checkpointer.on_segment if checkpointer else None,
            start=start_round)
    finally:
        if checkpointer is not None:
            checkpointer.close()
    server.last_scan_report = {
        "trace_count": eng.trace_count - traces_before,
        "total_trace_count": eng.trace_count,
        "chunk_shapes": tuple(sorted({end - start for start, end
                                      in split_segments(rounds, chunk)})),
        "segments": list(eng.segment_log),
    }
    if ckpt_cfg is not None:
        server.last_scan_report.update(
            snapshots=checkpointer.store.snapshots_written,
            resumed_from=start_round)

    cols = dict(saved_cols) if metrics is None \
        else concat_metrics(saved_cols, metrics)
    if "quarantined_count" in cols:
        # Per round too: the history holds it only as a tapped run's
        # quarantined_count tap.
        server.last_scan_report["quarantined_count"] = \
            cols["quarantined_count"].tolist()
        _emit_quarantine_event("fed.scan",
                               int(cols["quarantined_count"].sum()), rounds)
    for r in range(rounds):
        attack, eta = meta[r]
        row = {k: v[r] for k, v in cols.items()}
        hist.record(row, cohort=cohorts[r], attack=attack, eta=eta,
                    m_byz=m_byz, f_round=m_byz,
                    taps=tap_columns(row) if cfg.taps else None)
    return state, hist
