"""Fleet runner: pack scenario jobs into shape buckets, step each bucket's
lanes together, demux per-lane histories; and the continuous service's
fixed-capacity bucket, :class:`ContinuousBucket` (counterpart of
``repro.fleet.runner``; :class:`repro_torch.serving.FleetService` drives
it).  Lanes may be poisoned, guarded, tapped (each lane's health-tap
columns demuxed into its own history) or hierarchical (``agg.hier`` with
an explicit ``bucket_size``; taps are refused with hier).

A :class:`FleetJob` is a fully materialised federated run; a
:class:`ScenarioSpec` names a registry scenario + seed.  Jobs whose
static skeleton matches (:func:`bucket_key`) pack into one bucket, their
states stack along a leading lane axis, and the bucket runs segment by
segment.  The host plans every round up front, exactly as the reference
does (cohort sampling then batch building, lane by lane, round by round,
each lane on its own numpy stream seeded from ``job.seed``), so cohorts
and batches equal the reference's sample for sample.  A lane of a
bucketing, hierarchical (bucket size above 1), feature-poisoning or
sketch bucket also owns a CPU ``torch.Generator`` seeded from
``job.seed`` that draws, round by round, its bucket permutation, then
its feature noise, then its sketch signs
in the plan (:func:`lane_draws`; the reference splits a PRNG key
instead, so those draws differ).  The plan goes to the device once per
segment; the segment's metrics come back once, at its end.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.attacks import dyn_attack_id
from repro_torch.core.bucketing import default_bucket_size
from repro_torch.core.robust import draw_signs, validate_taps
from repro_torch.data import build_heterogeneous, make_classification
from repro_torch.device import resolve_device
from repro_torch.fed.clients import init_client_momentum
from repro_torch.fed.metrics import FedHistory
from repro_torch.fed.poison import static_signature as poison_signature
from repro_torch.fed.scenarios import (
    SCENARIO_OPTIMIZER, Scenario, _mlp_eval, _mlp_init, _mlp_loss,
    cohort_batch_fn, get_scenario,
)
from repro_torch.fed.schedules import AttackSchedule, FixedByzantine
from repro_torch.fed.server import FedConfig, rescale_f, sample_cohort
from repro_torch.fleet.lanes import build_fleet_scan
from repro_torch.obs import runtime as obs_runtime
from repro_torch.obs.taps import tap_columns
from repro_torch.optim import Optimizer
from repro_torch.resilience import (
    CarryCheckpointer, SnapshotStore, check_signature, concat_metrics,
    resolve_checkpoint, restore_carry, restored_metrics,
)
from repro_torch.rounds import (
    RoundOptions, cadence_boundaries, fetch_columns, resolve_options,
    split_segments, stack_rounds,
)
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

#: Attack eta defaults of the static path, used when a phase leaves eta
#: unset.
_ETA_DEFAULTS = {"alie": 1.0, "foe": 2.0}


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A registry scenario + the per-job knobs: one fleet lane."""
    scenario: Union[str, Scenario]
    seed: int = 0
    rounds: Optional[int] = None
    label: Optional[str] = None


@dataclasses.dataclass
class FleetJob:
    """A fully materialised federated run, ready to be packed into a lane.

    Jobs of one bucket share ``loss_fn`` and ``optimizer`` OBJECTS;
    everything that may differ per lane (f, attack schedule, identity
    schedule, seed, rounds, beta, local_lr, server lr) is a per-lane
    operand.  ``params`` is a dict of tensors (any device)."""
    label: str
    cfg: FedConfig
    loss_fn: Callable
    optimizer: Optimizer
    params: PyTree
    batch_fn: Callable
    rounds: int
    seed: int = 0
    schedule: AttackSchedule = dataclasses.field(
        default_factory=AttackSchedule)
    byz_identity: Any = None
    lr_fn: Callable[[int], float] = lambda r: 0.1
    eval_fn: Optional[Callable] = None
    eval_every: int = 0

    def __post_init__(self):
        if self.byz_identity is None:
            self.byz_identity = FixedByzantine(self.cfg.n_clients, self.cfg.f)
        if self.cfg.agg.rule == "mda":
            raise ValueError(
                "mda has no dynamic-f form; fleet lanes cannot run it "
                "(use the single-scenario engine instead)")
        for phase in self.schedule.phases:
            dyn_attack_id(phase.attack)   # raises for _opt / unknown
        if (self.cfg.agg.pre == "bucketing"
                and self.cfg.agg.bucket_size is None):
            raise ValueError(
                "fleet lanes with pre='bucketing' need an explicit "
                "bucket_size (resolve it on the host, e.g. "
                "default_bucket_size(m, f_round))")
        if self.cfg.agg.hier and self.cfg.agg.bucket_size is None:
            raise ValueError(
                "hierarchical fleet lanes need an explicit bucket_size "
                "(lanes run the dynamic-f path, whose floor(n/2f) default "
                "is shape-level); resolve it on the host, e.g. "
                "default_bucket_size(m, f_round)")
        if self.cfg.taps:
            validate_taps(self.cfg.agg)

    @property
    def m_byz(self) -> int:
        cfg = self.cfg
        return rescale_f(cfg.f, cfg.n_clients, cfg.clients_per_round)


def job_from_spec(spec: ScenarioSpec, *, dim: int = 48,
                  n_samples: int = 9000, noise: float = 1.6) -> FleetJob:
    """Materialise a registry scenario into a :class:`FleetJob`: the same
    synthetic task and Dirichlet shards as the reference (numpy), the
    port's own MLP init (a torch generator seeded with ``spec.seed``)."""
    sc = get_scenario(spec.scenario) if isinstance(spec.scenario, str) \
        else spec.scenario
    seed = spec.seed
    x, y = make_classification(n_samples, 10, dim, noise=noise, seed=seed)
    split = (n_samples * 2) // 3
    ds = build_heterogeneous({"x": x[:split], "y": y[:split]}, "y",
                             sc.n_clients, alpha=sc.alpha, seed=seed)
    xt, yt = x[split:], y[split:]

    cfg = sc.fed_config()
    if cfg.agg.pre == "bucketing" and cfg.agg.bucket_size is None:
        m = cfg.clients_per_round
        bs = default_bucket_size(m, rescale_f(cfg.f, cfg.n_clients, m))
        cfg = dataclasses.replace(
            cfg, agg=dataclasses.replace(cfg.agg, bucket_size=bs))
    server_lr = sc.server_lr
    return FleetJob(
        label=spec.label or f"{sc.name}:s{seed}", cfg=cfg,
        loss_fn=_mlp_loss, optimizer=SCENARIO_OPTIMIZER,
        params=_mlp_init(seed, dim),
        batch_fn=cohort_batch_fn(ds, sc.batch_size, sc.local_steps),
        rounds=spec.rounds if spec.rounds is not None else sc.rounds,
        seed=seed, schedule=sc.attack, byz_identity=sc.byz_identity(),
        lr_fn=lambda r: server_lr, eval_fn=_mlp_eval(xt, yt))


def apply_job_options(job: FleetJob, options: RoundOptions) -> FleetJob:
    """``job`` with the options' taps / backend overrides applied; the
    SAME object when nothing changes."""
    cfg = options.apply_config(job.cfg)
    return job if cfg is job.cfg else dataclasses.replace(job, cfg=cfg)


# ---------------------------------------------------------------------------
# Per-lane planning and state.
# ---------------------------------------------------------------------------

def plan_lane_round(job: FleetJob, r: int, rng: np.random.Generator
                    ) -> tuple[Any, np.ndarray, dict, tuple]:
    """HOST: one lane's decisions for its round ``r``, consuming ``rng``
    exactly as the reference does (cohort sample, then batch build).
    Returns ``(batch, cohort, ops, (attack, raw eta, cohort))``."""
    cfg = job.cfg
    m_byz = job.m_byz
    attack, eta = job.schedule.resolve(r)
    cohort = sample_cohort(rng, cfg.n_clients, cfg.clients_per_round,
                           job.byz_identity.ids(r), m_byz)
    n_flip = m_byz if attack == "lf" else 0
    batch = job.batch_fn(cohort, n_flip, rng)
    ops = {"attack_id": dyn_attack_id(attack),
           "m_byz": m_byz, "f_agg": m_byz,
           "eta": eta if eta is not None else _ETA_DEFAULTS.get(attack, 0.0),
           "beta": cfg.client.beta, "local_lr": cfg.client.local_lr,
           "lr": float(job.lr_fn(r)), "active": r < job.rounds,
           # Rate / strength are per-lane data; the poison KIND is the
           # bucket's (bucket_key): rate 0 in a poisoned bucket is clean.
           "poison_rate": cfg.poison.rate if cfg.poison else 0.0,
           "poison_strength": cfg.poison.strength if cfg.poison else 0.0}
    return batch, cohort, ops, (attack, eta, cohort)


def _draws_perm(cfg: FedConfig) -> bool:
    """Whether a lane draws a bucket permutation a round: bucketing, or
    hierarchical buckets of more than one (s = 1 is the identity)."""
    agg = cfg.agg
    return agg.pre == "bucketing" or (
        agg.hier and min(int(agg.bucket_size), cfg.clients_per_round) > 1)


def _draws_noise(cfg: FedConfig) -> bool:
    return cfg.poison is not None and cfg.poison.kind == "feature"


def lane_generator(job: FleetJob) -> Optional[torch.Generator]:
    """The lane's CPU generator (seeded from ``job.seed``) when its bucket
    draws bucket permutations, feature noise or sketch signs, else
    None."""
    if _draws_perm(job.cfg) or _draws_noise(job.cfg) or job.cfg.agg.sketch_dim:
        return torch.Generator().manual_seed(int(job.seed))
    return None


def lane_widths(job: FleetJob) -> list:
    """Per-leaf flat widths of the job's parameters (the sketch signs'
    chunk counts follow them)."""
    return [p.numel() for p in tree_leaves(job.params)]


def lane_draws(cfg: FedConfig, gen: Optional[torch.Generator], batch: dict,
               widths: Sequence[int] = ()) -> tuple:
    """HOST: one lane-round's random operands from the lane's generator,
    in this order: the (m,) bucket permutation (pre="bucketing", or hier
    with a bucket size above 1), then
    the feature-poisoning noise, standard normal of the batch's features'
    shape (poison kind "feature"), then the sketch's signs, one (C_i,)
    tensor per leaf of flat width ``widths[i]`` (``sketch_dim``); None
    for what the bucket does not draw.  The batch runner and the
    continuous bucket both draw through here, so a lane's stream is the
    same in either."""
    perm = torch.randperm(cfg.clients_per_round, generator=gen) \
        if _draws_perm(cfg) else None
    noise = None
    if _draws_noise(cfg):
        shape = tuple(np.shape(batch[cfg.poison.features_key]))
        noise = torch.randn(shape, generator=gen, dtype=torch.float32)
    signs = draw_signs(widths, cfg.agg.sketch_dim, gen) \
        if cfg.agg.sketch_dim else None
    return perm, noise, signs


def filler_draws(cfg: FedConfig, batch: dict, widths: Sequence[int] = ()
                 ) -> tuple:
    """:func:`lane_draws`'s operands for an unoccupied slot (``batch`` its
    filler batch): the identity permutation, zero noise and all-plus
    signs (no generator)."""
    perm = torch.arange(cfg.clients_per_round) if _draws_perm(cfg) else None
    noise = torch.zeros(tuple(np.shape(batch[cfg.poison.features_key])),
                        dtype=torch.float32) if _draws_noise(cfg) else None
    signs = [torch.ones(-(-int(w) // cfg.agg.sketch_dim)) for w in widths] \
        if cfg.agg.sketch_dim else None
    return perm, noise, signs


def _stack_draws(operands: dict, draws: list) -> dict:
    """Add the (R, B, ...) draws of :func:`lane_draws` to a plan: ``draws``
    holds one list of B (perm, noise, signs) triples a round; the signs
    become one (R, B, C_i) tensor per leaf."""
    for k, key in enumerate(("perm", "noise")):
        if draws and draws[0][0][k] is not None:
            operands[key] = torch.stack([torch.stack([d[k] for d in r])
                                         for r in draws])
    if draws and draws[0][0][2] is not None:
        operands["signs"] = [
            torch.stack([torch.stack([d[2][i] for d in r]) for r in draws])
            for i in range(len(draws[0][0][2]))]
    return operands


def init_lane_state(job: FleetJob, device=None) -> dict:
    """One lane's (unstacked) state at round 0 on ``device``."""
    params = tree_map(lambda p: p.detach().to(device).clone(), job.params)
    st = dict(params=params, opt_state=job.optimizer.init(params),
              step=torch.zeros((), dtype=torch.int32, device=device))
    if job.cfg.client.algorithm == "dshb":
        st["momentum"] = init_client_momentum(params, job.cfg.n_clients)
    return st


def lane_filler(job: FleetJob) -> tuple[Any, np.ndarray, dict]:
    """Operands of an unoccupied lane slot shaped like ``job``'s: zeroed
    batch, cohort zeros, attack "none", ``active=False`` (the state is
    frozen, so the values only need the right shapes).  Consumes no rng."""
    m = job.cfg.clients_per_round
    probe = job.batch_fn(np.arange(m, dtype=np.int32), 0,
                         np.random.default_rng(0))
    batch = tree_map(lambda a: np.zeros_like(np.asarray(a)), probe)
    idx = np.zeros((m,), np.int32)
    ops = {"attack_id": dyn_attack_id("none"), "m_byz": 0, "f_agg": 0,
           "eta": 0.0, "beta": 0.0, "local_lr": 0.0, "lr": 0.0,
           "active": False, "poison_rate": 0.0, "poison_strength": 0.0}
    return batch, idx, ops


#: Lane-operand dtypes: the packing contract with LANE_OP_FIELDS.
_OP_DTYPES = {"attack_id": np.int32, "m_byz": np.int32, "f_agg": np.int32,
              "eta": np.float32, "beta": np.float32, "local_lr": np.float32,
              "lr": np.float32, "active": bool,
              "poison_rate": np.float32, "poison_strength": np.float32}


def _pack_round(batches: list, cohorts: list, ops: dict) -> dict:
    """Stack one round's per-lane plans into (B, ...) host arrays."""
    return {
        "batch": tree_map(lambda *xs: np.stack(xs), *batches),
        "idx": np.stack(cohorts).astype(np.int32),
        "ops": {f: np.asarray(ops[f], dt) for f, dt in _OP_DTYPES.items()},
    }


def _to_device(operands: dict, device) -> dict:
    """A segment's host plan on the device (one copy per array); the
    attack ids also stay on the host, where the round picks its
    branches."""
    ops = {k: torch.as_tensor(v, device=device)
           for k, v in operands["ops"].items()}
    out = {"batch": tree_map(lambda a: torch.as_tensor(a, device=device),
                             operands["batch"]),
           "idx": torch.as_tensor(operands["idx"], device=device).long(),
           "ops": ops,
           "attack_id": operands["ops"]["attack_id"].tolist()}
    for k in ("perm", "noise"):
        if k in operands:
            out[k] = operands[k].to(device)
    if "signs" in operands:
        out["signs"] = [sg.to(device) for sg in operands["signs"]]
    return out


# ---------------------------------------------------------------------------
# Shape buckets.
# ---------------------------------------------------------------------------

def _tree_sig(tree: PyTree) -> tuple:
    """Hashable shape + dtype signature of a pytree of arrays / tensors."""
    return tuple((tuple(np.shape(leaf)), str(getattr(leaf, "dtype", None)))
                 for leaf in tree_leaves(tree))


def _mesh_sig() -> tuple:
    """Hashable fingerprint of the mesh the aggregation would shard over
    (``launch.mesh.mesh_signature``): a bucket's round routes its
    aggregation by it, so two meshes (or world sizes) never share a
    bucket."""
    from repro_torch.launch.mesh import mesh_signature
    return mesh_signature()


def bucket_key(job: FleetJob, *, chunk: Optional[int] = None) -> tuple:
    """The static skeleton a lane-batched round is built for; everything
    else (f, attack family, eta, beta, local_lr, lr, seed, rounds) is a
    per-lane operand."""
    c = job.cfg
    probe = job.batch_fn(
        np.arange(c.clients_per_round, dtype=np.int32), 0,
        np.random.default_rng(0))
    return (c.n_clients, c.clients_per_round,
            c.client.local_steps, c.client.algorithm,
            c.agg.rule, c.agg.pre, c.agg.bucket_size, c.agg.hier,
            c.agg.gm_iters, c.agg.gm_eps,
            c.agg.autogm_lamb, c.agg.autogm_iters,
            c.agg.transport_dtype, c.agg.sketch_dim, c.agg.backend,
            _mesh_sig(), c.track_kappa_hat, c.taps,
            poison_signature(c.poison), c.guard,
            job.loss_fn, job.optimizer,
            _tree_sig(job.params), _tree_sig(probe), chunk)


@dataclasses.dataclass
class LaneBucket:
    key: tuple
    jobs: list
    indices: list              # positions in the submitted job list


@dataclasses.dataclass
class FleetResult:
    """One lane's demuxed outcome."""
    label: str
    job: FleetJob
    state: dict                 # final (unstacked) lane state, on the device
    history: FedHistory
    evals: list = dataclasses.field(default_factory=list)
    best_eval: Optional[float] = None


class FleetRunner:
    """Packs jobs into shape buckets and runs each bucket's lanes together.

    Each bucket runs B lanes x R rounds of one lane-batched round program
    (:func:`repro_torch.fleet.lanes.build_fleet_scan`), segment by segment
    (``chunk`` bounds a segment; segments are also cut at eval rounds).
    ``trace_count`` counts the round programs built, one per (bucket,
    lane count), the counterpart of the reference's compile count.
    ``segment_log`` holds (bucket index, lanes, rounds, seconds) per
    segment, the seconds by the host clock around work that ends in the
    segment's metric transfer (which waits for the device).

    ``options.checkpoint`` makes each bucket resumable: its carry, metric
    columns and eval points are snapshotted at segment boundaries into
    ``<dir>/bucket-NNN``, and a rerun resumes each bucket from its latest
    snapshot."""

    def __init__(self, jobs: Sequence[Union[FleetJob, ScenarioSpec]], *,
                 max_lanes: Optional[int] = None,
                 chunk: Optional[int] = None,
                 options: Optional[RoundOptions] = None,
                 device=None):
        opts = resolve_options(options, chunk=chunk)
        if opts.engine not in (None, "scan"):
            raise ValueError(f"the fleet runs segments of rounds only "
                             f"(engine 'scan'), got {opts.engine!r}")
        self.options = opts
        self.device = resolve_device(device)
        self.jobs = [apply_job_options(
                         job_from_spec(j) if isinstance(j, ScenarioSpec)
                         else j, opts)
                     for j in jobs]
        if not self.jobs:
            raise ValueError("empty fleet")
        self.max_lanes = max_lanes
        self.chunk = opts.chunk
        self._built: dict = {}
        self.trace_count = 0
        self.segment_log: list = []
        self._buckets = self._pack()

    # -- packing ----------------------------------------------------------
    def _pack(self) -> list:
        groups: dict = {}
        for i, job in enumerate(self.jobs):
            key = bucket_key(job, chunk=self.chunk)
            if key not in groups:
                groups[key] = LaneBucket(key, [], [])
            groups[key].jobs.append(job)
            groups[key].indices.append(i)
        buckets = []
        for g in groups.values():
            cap = self.max_lanes or len(g.jobs)
            for s in range(0, len(g.jobs), cap):
                buckets.append(LaneBucket(g.key, g.jobs[s:s + cap],
                                          g.indices[s:s + cap]))
        return buckets

    @property
    def n_buckets(self) -> int:
        """Distinct shape buckets (not max_lanes chunks)."""
        return len({b.key for b in self._buckets})

    @property
    def buckets(self) -> list:
        """The packed buckets, in run order."""
        return list(self._buckets)

    def _round_fn(self, bucket: LaneBucket) -> Callable:
        cache_key = (bucket.key, len(bucket.jobs))
        if cache_key not in self._built:
            job0 = bucket.jobs[0]
            lanes = len(bucket.jobs)

            def bump():
                self.trace_count += 1
                obs_runtime.event("fleet.trace", lanes=lanes,
                                  trace_count=self.trace_count)

            self._built[cache_key] = build_fleet_scan(
                job0.loss_fn, job0.optimizer, job0.cfg, on_build=bump)
        return self._built[cache_key]

    # -- execution --------------------------------------------------------
    def run(self) -> list:
        """Run every job to completion; results in submission order."""
        results: list = [None] * len(self.jobs)
        for bi, bucket in enumerate(self._buckets):
            for idx, res in zip(bucket.indices,
                                self._run_bucket(bucket, bucket_index=bi)):
                results[idx] = res
        return results

    def _plan_bucket(self, bucket: LaneBucket) -> tuple[dict, list]:
        """HOST, once per bucket: every round's per-lane plan stacked into
        (R, B, ...) arrays (in the reference's rng order), plus the
        bucket permutations (R, B, m), feature noise (R, B, m, L, bs,
        ...) and sketch signs ((R, B, C_i) per leaf) where the bucket
        draws them (:func:`lane_draws`), and the per-round (attacks, raw
        etas, cohorts) the histories record."""
        jobs = bucket.jobs
        rngs = [np.random.default_rng(job.seed) for job in jobs]
        gens = [lane_generator(job) for job in jobs]
        widths = lane_widths(jobs[0])
        max_rounds = max(job.rounds for job in jobs)
        per_round, round_meta, draws = [], [], []
        for r in range(max_rounds):
            attacks, etas_raw, cohorts, batches, rdraws = [], [], [], [], []
            ops: dict = {k: [] for k in _OP_DTYPES}
            for k, job in enumerate(jobs):
                batch, cohort, lane_ops, (attack, eta, _) = \
                    plan_lane_round(job, r, rngs[k])
                rdraws.append(lane_draws(job.cfg, gens[k], batch, widths))
                batches.append(batch)
                attacks.append(attack)
                etas_raw.append(eta)
                cohorts.append(cohort)
                for f in _OP_DTYPES:
                    ops[f].append(lane_ops[f])
            per_round.append(_pack_round(batches, cohorts, ops))
            round_meta.append((attacks, etas_raw, cohorts))
            draws.append(rdraws)
        operands = _stack_draws(stack_rounds(per_round), draws)
        return operands, round_meta

    def _run_bucket(self, bucket: LaneBucket, *,
                    bucket_index: int = 0) -> list:
        jobs = bucket.jobs
        dev = self.device
        fleet_scan = self._round_fn(bucket)
        state = tree_map(lambda *xs: torch.stack(xs),
                         *[init_lane_state(job, dev) for job in jobs])
        m_byzs = [job.m_byz for job in jobs]
        hists = [FedHistory() for _ in jobs]
        evals: list = [[] for _ in jobs]
        max_rounds = max(job.rounds for job in jobs)
        if max_rounds == 0:
            return [FleetResult(label=job.label, job=job,
                                state=tree_map(lambda l, kk=k: l[kk], state),
                                history=hists[k])
                    for k, job in enumerate(jobs)]
        operands, round_meta = self._plan_bucket(bucket)

        # Resilience: a snapshot subdirectory per bucket; the host plan above
        # is recomputed in full, so only the stacked carry, the metric
        # columns and the eval points need restoring.
        ckpt_cfg = resolve_checkpoint(self.options.checkpoint)
        checkpointer, start_round, saved_cols = None, 0, {}
        if ckpt_cfg is not None:
            store = SnapshotStore.from_config(
                ckpt_cfg, subdir=f"bucket-{bucket_index:03d}")
            signature = {"surface": "fleet",
                         "labels": [j.label for j in jobs],
                         "rounds": [j.rounds for j in jobs],
                         "seeds": [j.seed for j in jobs],
                         "chunk": self.chunk,
                         **({"taps": True} if jobs[0].cfg.taps else {})}
            snap = store.load_latest() if ckpt_cfg.resume else None
            if snap is not None:
                start_round, arrays, snap_meta = snap
                check_signature(snap_meta["signature"], signature, store.path)
                state = restore_carry(arrays, snap_meta, state)
                saved_cols = restored_metrics(arrays)
                for k, lane in enumerate(
                        snap_meta.get("payload", {}).get("evals", [])):
                    evals[k] = [(int(r), float(v)) for r, v in lane]
            checkpointer = CarryCheckpointer(
                store, signature=signature, total=max_rounds,
                every=ckpt_cfg.every, base_columns=saved_cols,
                payload_fn=lambda end: {
                    "evals": [[(int(r), float(torch.as_tensor(v)))
                               for r, v in lane] for lane in evals]})

        boundaries = cadence_boundaries(
            max_rounds, *(job.eval_every for job in jobs
                          if job.eval_fn is not None and job.eval_every))
        cols: dict = {}
        try:
            for start, end in split_segments(max_rounds, self.chunk,
                                             boundaries):
                if end <= start_round:   # already run before the resume
                    continue
                t0 = time.perf_counter()
                with obs_runtime.span("fleet.segment", start=start, end=end,
                                      lanes=len(jobs)):
                    seg = _to_device(tree_map(lambda a: a[start:end],
                                              operands), dev)
                    state, metrics = fleet_scan(state, seg)
                    # The segment's one transfer (it waits for the device).
                    obs_runtime.inc("fleet.transfers")
                    metrics = fetch_columns(metrics)
                    for k, v in metrics.items():
                        cols.setdefault(k, []).append(v)
                self.segment_log.append((bucket_index, len(jobs),
                                         end - start,
                                         time.perf_counter() - t0))
                for k, job in enumerate(jobs):
                    if (job.eval_fn is not None and job.eval_every
                            and end <= job.rounds
                            and end % job.eval_every == 0):
                        lane_params = tree_map(lambda leaf, kk=k: leaf[kk],
                                               state["params"])
                        evals[k].append((end, job.eval_fn(lane_params)))
                if checkpointer is not None:
                    checkpointer.on_segment(start, end, state, metrics)
        finally:
            if checkpointer is not None:
                checkpointer.close()

        cols = concat_metrics(saved_cols, {
            k: np.concatenate(v, axis=0) for k, v in cols.items()}) \
            if cols else dict(saved_cols)
        if "quarantined_count" in cols:
            _quarantine_event("fleet", cols["quarantined_count"], max_rounds)
        evals = host_evals(evals)
        for r, (attacks, etas_raw, cohorts) in enumerate(round_meta):
            for k, job in enumerate(jobs):
                if r < job.rounds:
                    _record_lane_round(hists[k], cols, r, k, attacks[k],
                                       etas_raw[k], cohorts[k], m_byzs[k])

        out = []
        for k, job in enumerate(jobs):
            lane_state = tree_map(lambda leaf, kk=k: leaf[kk], state)
            best = max((a for _, a in evals[k]), default=None)
            out.append(FleetResult(label=job.label, job=job, state=lane_state,
                                   history=hists[k], evals=evals[k],
                                   best_eval=best))
        return out


def _record_lane_round(hist: FedHistory, cols: dict, i: int, k: int,
                       attack: str, eta: Any, cohort: np.ndarray,
                       m_byz: int) -> None:
    """Record lane ``k``'s round from row ``i`` of fetched (R, B, ...)
    metric columns, its health taps among them: the batch runner and the
    continuous bucket both record through here."""
    lane_metrics = {name: cols[name][i][k] for name in
                    ("loss", "lr", "direction_norm", "kappa_hat")
                    if name in cols}
    taps = {f: v[i][k] for f, v in tap_columns(cols).items()}
    hist.record(lane_metrics, cohort=cohort, attack=attack, eta=eta,
                m_byz=m_byz, f_round=m_byz, taps=taps or None)


def _quarantine_event(surface: str, counts, rounds: int) -> None:
    """One ``robustness.quarantine`` event when a lane quarantined a row
    (the per-round, per-lane counts are metrics)."""
    total = int(np.asarray(counts).sum())
    if total:
        obs_runtime.event("robustness.quarantine", surface=surface,
                          total=total, rounds=rounds)


def host_evals(lanes: list) -> list:
    """Each lane's eval points with their device values brought to the
    host as Python floats in ONE transfer (values already on the host
    pass through)."""
    fresh = [v for lane in lanes for _, v in lane
             if isinstance(v, torch.Tensor)]
    it = iter(torch.stack([v.reshape(()) for v in fresh]).cpu().tolist()
              if fresh else [])
    return [[(int(r), next(it) if isinstance(v, torch.Tensor) else float(v))
             for r, v in lane] for lane in lanes]


# ---------------------------------------------------------------------------
# Continuous batching: a fixed-capacity bucket stepped one segment at a
# time, with admission / eviction / backfill at segment boundaries.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LaneSlot:
    """Host record of one OCCUPIED slot of a continuous bucket.

    ``local`` is the lane's own round clock (0 at admission): its plans
    (schedule, cohorts, eval cadence) run on lane-local rounds, and its
    numpy ``rng`` and torch ``gen`` (:func:`lane_generator`) are its own
    streams, so a job admitted mid-run computes what it computes in a
    fresh bucket.  ``evals`` holds (round, value) with the values left on
    the device until the lane is finalised or snapshotted."""
    job: FleetJob
    token: Any                          # the caller's opaque handle
    rng: np.random.Generator
    gen: Optional[torch.Generator] = None
    local: int = 0
    hist: FedHistory = dataclasses.field(default_factory=FedHistory)
    evals: list = dataclasses.field(default_factory=list)


class ContinuousBucket:
    """One shape bucket run as a service: ``capacity`` lane slots stepped
    one segment at a time, jobs entering and leaving at boundaries.

    The round program is the batch runner's (``build_fleet_scan`` of the
    same bucket key): occupancy is operand data.  Empty or finished slots
    take :func:`lane_filler` operands (``active=False`` freezes their
    state), the identity permutation and zero noise, and consume no
    generator, so admitting, evicting or backfilling a lane never changes
    the program or another lane's streams.  Admission writes the lane's
    state into its slot in place (:func:`repro_torch.fleet.lanes.
    build_lane_admit`).  Each segment brings its metrics to the host in
    one transfer; ``last_segment`` is its (lanes, rounds, seconds), the
    seconds by the host clock around the work that ends in that transfer,
    as ``FleetRunner.segment_log`` times a segment."""

    def __init__(self, key: tuple, template: FleetJob, capacity: int, *,
                 chunk: Optional[int], fleet_scan: Callable,
                 admit_fn: Callable, device=None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.key = key
        self.capacity = capacity
        self.chunk = chunk
        self.device = resolve_device(device)
        self._scan = fleet_scan
        self._admit = admit_fn
        self._filler = lane_filler(template)
        self._widths = lane_widths(template)
        self._filler_draws = filler_draws(template.cfg, self._filler[0],
                                          self._widths)
        filler_state = init_lane_state(template, self.device)
        self.state = tree_map(lambda x: torch.stack([x] * capacity),
                              filler_state)
        self.slots: list = [None] * capacity
        #: Rounds scanned over every lane generation this bucket hosted.
        self.rounds_executed = 0
        self.last_segment: Optional[tuple] = None

    # -- occupancy --------------------------------------------------------
    @property
    def occupied(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def free_slot(self) -> Optional[int]:
        for k, s in enumerate(self.slots):
            if s is None:
                return k
        return None

    def slot_of(self, token: Any) -> Optional[int]:
        for k, s in enumerate(self.slots):
            if s is not None and s.token is token:
                return k
        return None

    # -- admission / eviction ---------------------------------------------
    def admit(self, job: FleetJob, token: Any = None, *,
              lane_state: Optional[dict] = None, local: int = 0,
              rng: Optional[np.random.Generator] = None,
              gen: Optional[torch.Generator] = None,
              hist: Optional[FedHistory] = None,
              evals: Optional[list] = None,
              slot: Optional[int] = None) -> int:
        """Occupy a free slot with ``job``, effective at the next segment
        (call between :meth:`step` calls).  The keywords re-admit a
        surviving lane from a service snapshot: its state, local clock,
        numpy rng, torch generator, history and evals."""
        if slot is not None:
            if self.slots[slot] is not None:
                raise RuntimeError(f"slot {slot} is occupied")
            k = slot
        else:
            k = self.free_slot()
        if k is None:
            raise RuntimeError("bucket is full")
        self.state = self._admit(
            self.state, lane_state if lane_state is not None
            else init_lane_state(job, self.device), k)
        self.slots[k] = LaneSlot(
            job=job, token=token,
            rng=rng if rng is not None else np.random.default_rng(job.seed),
            gen=gen if gen is not None else lane_generator(job),
            local=local, hist=hist if hist is not None else FedHistory(),
            evals=list(evals) if evals else [])
        obs_runtime.event("fleet.admit", slot=k, label=job.label,
                          at=self.rounds_executed)
        return k

    def cancel(self, k: int) -> FleetResult:
        """Evict a running lane; returns its PARTIAL result (history and
        evals up to the last boundary).  The slot is free at once; the
        lane's stale state stays, frozen by filler operands."""
        s = self.slots[k]
        if s is None:
            raise KeyError(f"slot {k} is empty")
        s.evals = host_evals([s.evals])[0]
        return self._finalize(k, s)

    def _finalize(self, k: int, s: LaneSlot) -> FleetResult:
        """Free slot ``k``; ``s.evals`` must already be on the host."""
        self.slots[k] = None
        obs_runtime.event("fleet.evict", slot=k, label=s.job.label,
                          at=self.rounds_executed, rounds=s.local)
        best = max((a for _, a in s.evals), default=None)
        return FleetResult(label=s.job.label, job=s.job,
                           state=self.lane_state(k), history=s.hist,
                           evals=list(s.evals), best_eval=best)

    def lane_state(self, k: int) -> dict:
        """A copy of lane ``k``'s state (a later admission into the slot
        writes the stacked state in place)."""
        return tree_map(lambda leaf: leaf[k].clone(), self.state)

    # -- stepping ---------------------------------------------------------
    def next_seg_len(self, *, hold_for_pending: bool = False) -> int:
        """Rounds the next segment scans: ``min(max remaining, chunk,
        every lane's distance to its next eval round)``, which for jobs
        admitted together is the batch runner's ``split_segments`` cut.
        ``hold_for_pending`` (a job waits for this bucket) takes ``min
        remaining`` instead, so a slot frees at the earliest boundary."""
        remaining = [s.job.rounds - s.local
                     for s in self.slots if s is not None]
        if not remaining:
            return 0
        length = min(remaining) if hold_for_pending else max(remaining)
        if self.chunk is not None:
            length = min(length, self.chunk)
        for s in self.slots:
            if (s is not None and s.job.eval_fn is not None
                    and s.job.eval_every):
                length = min(length,
                             s.job.eval_every - s.local % s.job.eval_every)
        return max(int(length), 1)

    def _plan(self, seg: int) -> tuple[dict, dict]:
        """HOST: the next ``seg`` rounds of every slot, lane-local."""
        fill_batch, fill_idx, fill_ops = self._filler
        per_round, draws = [], []
        metas: dict = {k: [] for k, s in enumerate(self.slots)
                       if s is not None}
        for i in range(seg):
            batches, cohorts, rdraws = [], [], []
            ops: dict = {f: [] for f in _OP_DTYPES}
            for k in range(self.capacity):
                s = self.slots[k]
                if s is None or s.local + i >= s.job.rounds:
                    batch, cohort, lane_ops = fill_batch, fill_idx, fill_ops
                    rdraws.append(self._filler_draws)
                else:
                    batch, cohort, lane_ops, meta = plan_lane_round(
                        s.job, s.local + i, s.rng)
                    rdraws.append(lane_draws(s.job.cfg, s.gen, batch,
                                             self._widths))
                    metas[k].append((s.local + i,) + meta)
                batches.append(batch)
                cohorts.append(cohort)
                for f in _OP_DTYPES:
                    ops[f].append(lane_ops[f])
            per_round.append(_pack_round(batches, cohorts, ops))
            draws.append(rdraws)
        return _stack_draws(stack_rounds(per_round), draws), metas

    def step(self, *, hold_for_pending: bool = False) -> list:
        """Run ONE segment; returns ``(token, result)`` for every lane that
        finished at this boundary (their slots are already free)."""
        lanes = [(k, s) for k, s in enumerate(self.slots) if s is not None]
        if not lanes:
            return []
        seg = self.next_seg_len(hold_for_pending=hold_for_pending)
        operands, metas = self._plan(seg)

        start = self.rounds_executed
        t0 = time.perf_counter()
        with obs_runtime.span("fleet.segment", start=start, end=start + seg,
                              lanes=len(lanes)):
            self.state, metrics = self._scan(
                self.state, _to_device(operands, self.device))
            # The segment's one transfer (it waits for the device).
            obs_runtime.inc("fleet.transfers")
            fetched = fetch_columns(metrics)
        self.last_segment = (len(lanes), seg, time.perf_counter() - t0)
        self.rounds_executed += seg
        if "quarantined_count" in fetched:
            _quarantine_event("fleet.service", fetched["quarantined_count"],
                              seg)

        done = []
        for k, s in lanes:
            for (local_r, attack, eta_raw, cohort) in metas[k]:
                _record_lane_round(s.hist, fetched, local_r - s.local, k,
                                   attack, eta_raw, cohort, s.job.m_byz)
            new_local = min(s.local + seg, s.job.rounds)
            if (s.job.eval_fn is not None and s.job.eval_every
                    and new_local != s.local
                    and new_local % s.job.eval_every == 0):
                # Left on the device: it reaches the host with the lane.
                params = tree_map(lambda leaf, kk=k: leaf[kk],
                                  self.state["params"])
                s.evals.append((new_local, s.job.eval_fn(params)))
            s.local = new_local
            if s.local >= s.job.rounds:
                done.append((k, s))
        for (k, s), evals in zip(done, host_evals([s.evals
                                                    for _, s in done])):
            s.evals = evals
        return [(s.token, self._finalize(k, s)) for k, s in done]


def run_fleet(jobs: Sequence[Union[FleetJob, ScenarioSpec]], *,
              max_lanes: Optional[int] = None, chunk: Optional[int] = None,
              options: Optional[RoundOptions] = None,
              device=None) -> list:
    """One-shot convenience: pack, run, return per-lane results."""
    return FleetRunner(jobs, max_lanes=max_lanes, chunk=chunk,
                       options=options, device=device).run()
