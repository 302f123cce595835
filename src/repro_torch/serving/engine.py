"""Batched serving (counterpart of ``repro.serving.engine``): the decode
engine and the continuous fleet service.

:class:`ServeEngine` is static-batch prefill + greedy decode over the
model zoo's cache API (``init_cache`` / ``decode_step``, every family).
Its prefill is the per-token ``decode_step`` loop the reference scans:
torch has no scan to compile, so :meth:`ServeEngine.prefill` and the
oracle :meth:`ServeEngine.prefill_loop` run the same steps, and
``prefill`` adds the reference's ``serve.prefill`` span.  The reference's
``serve.prefill_trace`` event marks a JAX trace and has no torch meaning,
so it is not emitted.  Decode writes the cache in place.  On a model
mesh (a ``MeshAxes`` scope whose model axis the active mesh holds) the
engine holds this rank's shards: its cache is the rank's shard, each
data rank decodes its rows of the whole prompts, the greedy argmax reads
the logits gathered over the model axis, and the tokens are all-gathered
over the data axes once at the end, so every rank returns the same
array.

:class:`FleetService` streams federated scenario jobs over the
lane-batched fleet.  ``submit()`` returns a :class:`JobHandle`; each
:meth:`FleetService.step` runs every occupied shape bucket
(:class:`repro_torch.fleet.ContinuousBucket`) forward by one segment,
and at the boundaries jobs are admitted into free lane slots (deadline
order), finished or cancelled lanes are evicted and their slots
backfilled.  ``options.taps`` and
``options.backend`` apply to every submitted job's config.  With
``options.checkpoint`` every boundary is snapshotted and
:meth:`FleetService.restore` rebuilds the service after a kill.

Entry points run on CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint.npz import decode_leaf
from repro_torch.device import resolve_device
from repro_torch.fed.metrics import FedHistory
from repro_torch.fleet import (
    ContinuousBucket, FleetJob, FleetResult, ScenarioSpec, apply_job_options,
    bucket_key, build_fleet_scan, build_lane_admit, init_lane_state,
    job_from_spec,
)
from repro_torch.fleet.runner import host_evals
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.models import common
from repro_torch.obs import runtime as obs_runtime
from repro_torch.resilience import (
    CheckpointError, SnapshotStore, check_signature, resolve_checkpoint,
)
from repro_torch.rounds import RoundOptions, resolve_options
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

PyTree = Any


@dataclasses.dataclass
class ServeEngine:
    """Static-batch greedy serving of one model's params: ``batch_size``
    rows of up to ``max_seq`` positions.  Runs where the params live; on
    a model mesh with this rank's shards (the module docstring)."""
    model: Any
    params: PyTree
    batch_size: int
    max_seq: int

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.params)[0].device

    def init_cache(self) -> PyTree:
        """A zero cache (an encoder-decoder's cross k / v zeros too: the
        engine never sees frames; serve those from the model's
        ``prefill_cache`` through ``generate(cache=...)``); on a model
        mesh this rank's shard."""
        return self.model.init_cache(self.batch_size, self.max_seq,
                                     self.device)

    def _step(self, cache: PyTree, tokens: torch.Tensor, pos: int):
        return self.model.decode_step(self.params, cache, tokens, pos,
                                      batch=self.batch_size,
                                      max_seq=self.max_seq)

    def prefill_loop(self, cache: PyTree, prompts
                     ) -> tuple[PyTree, Optional[torch.Tensor], int]:
        """Teacher-forced prefill, one ``decode_step`` per prompt token.
        prompts: (B, P), the whole batch (on a model mesh this data rank
        feeds its rows).  Returns (cache, the last step's (B, 1, V)
        logits, P), the logits of this rank's rows; the cache is updated
        in place."""
        lo, hi = common.batch_block(self.batch_size)
        toks = torch.as_tensor(prompts, device=self.device).long()[lo:hi]
        logits = None
        for t in range(toks.shape[1]):
            logits, cache = self._step(cache, toks[:, t:t + 1], t)
        return cache, logits, toks.shape[1]

    def prefill(self, cache: PyTree, prompts
                ) -> tuple[PyTree, Optional[torch.Tensor], int]:
        """:meth:`prefill_loop` inside the ``serve.prefill`` span (a host
        span: it ends when the steps are queued, not run)."""
        p = int(prompts.shape[1])
        if p == 0:
            return cache, None, 0
        with obs_runtime.span("serve.prefill", batch=int(prompts.shape[0]),
                              prompt=p):
            return self.prefill_loop(cache, prompts)

    def generate(self, prompts, max_new: int = 32,
                 cache: Optional[PyTree] = None) -> np.ndarray:
        """Greedy decode: the argmax of the prefill's last logits, then
        ``max_new - 1`` more steps, each feeding its argmax back (the first
        maximum, as ``jnp.argmax``; ids from the padded vocab's columns are
        kept, as the reference keeps them).  ``cache`` defaults to
        :meth:`init_cache`.  Returns the tokens as an int32 (B, max_new)
        array, moved to the host once at the end (on a model mesh
        all-gathered over the data axes first).  Always greedy: the
        reference's ``greedy``, ``key`` and ``eos_id`` are unused there and
        not taken here."""
        with torch.inference_mode():
            cache = self.init_cache() if cache is None else cache
            cache, logits, p = self.prefill(cache, prompts)
            cur = torch.argmax(logits[:, -1:], dim=-1)
            toks = [cur]
            for i in range(max_new - 1):
                logits, cache = self._step(cache, cur, p + i)
                cur = torch.argmax(logits[:, -1:], dim=-1)
                toks.append(cur)
            out = common.gather_batch(torch.cat(toks, dim=1), self.batch_size)
            return out.to(torch.int32).cpu().numpy()


def greedy_decode(model, params, prompts, max_new: int = 32,
                  max_seq: Optional[int] = None) -> np.ndarray:
    """One-shot greedy decode of (B, P) prompts; ``max_seq`` defaults to
    P + max_new.  On a model mesh with this rank's shards, as
    :class:`ServeEngine`."""
    b, p = int(prompts.shape[0]), int(prompts.shape[1])
    eng = ServeEngine(model, params, batch_size=b,
                      max_seq=max_seq or (p + max_new))
    return eng.generate(prompts, max_new=max_new)


#: What a service snapshot is checked against on restore.  ``package``
#: keeps the reference's snapshots (another state layout) out.
SIGNATURE = {"surface": "fleet-service", "package": "repro_torch"}


class JobHandle:
    """What :meth:`FleetService.submit` returns: one job's lifecycle.

    :meth:`status` is "queued", "running", "done" or "cancelled";
    :meth:`result` steps the service until the job is done and returns
    its :class:`repro_torch.fleet.FleetResult` (``RuntimeError`` if it was
    cancelled); :meth:`cancel` dequeues a queued job or evicts a running
    lane at the current boundary (the partial result stays on the
    handle).  Handles compare and convert as their int job id, the key of
    :meth:`FleetService.handle_of` and of ``restore(jobs=...)``."""

    def __init__(self, service: "FleetService", job_id: int, job: Any, *,
                 deadline: Optional[float] = None):
        self._service = service
        self.job_id = job_id
        self.job = job
        #: Admission priority: ascending (deadline, job_id), None last.
        self.deadline = deadline
        self._status = "queued"
        self._result = None
        self.key: Optional[tuple] = None        # bucket key (service fills)
        # Latency: registry-epoch seconds (obs_runtime.now()) and service
        # boundary counts.
        self.submit_ts = obs_runtime.now()
        self.admit_ts: Optional[float] = None
        self.first_ts: Optional[float] = None
        self.done_ts: Optional[float] = None
        self.submit_step = service.steps
        self.admit_step: Optional[int] = None
        #: The ScenarioSpec (as a dict) when the job was submitted by
        #: registry name: what restore() rebuilds the job from.  None for
        #: raw FleetJobs, whose callables need restore(jobs=...).
        self.spec: Optional[dict] = None
        # A finished result stays in the snapshots until result() hands
        # it out: a restart between finish and delivery keeps it.
        self._consumed = False

    def status(self) -> str:
        return self._status

    def result(self) -> Any:
        """The finished result; steps the service until the job is done."""
        if self._status in ("queued", "running"):
            self._service._run_until_done(self)
        if self._status == "cancelled":
            raise RuntimeError(
                f"job {self.job_id} ({self.job.label}) was cancelled; "
                "partial history is on handle.partial_result")
        self._consumed = True
        return self._result

    def cancel(self) -> bool:
        """Cancel unless finished; returns whether anything was cancelled."""
        return self._service._cancel(self)

    @property
    def partial_result(self) -> Any:
        """A cancelled job's result up to its last boundary (None if it
        was cancelled while queued)."""
        return self._result

    def __int__(self) -> int:
        return self.job_id

    def __index__(self) -> int:
        return self.job_id

    def __eq__(self, other: Any):
        if isinstance(other, JobHandle):
            return other is self
        if isinstance(other, int):
            return self.job_id == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.job_id)

    def __repr__(self) -> str:
        return f"JobHandle({self.job_id}, {self.job.label!r}, {self._status})"


class FleetService:
    """Continuous batching over the fleet's lane-batched round.

    Each :meth:`step` runs every occupied bucket forward by one segment
    (``chunk`` rounds at most, cut at the lanes' eval rounds); between
    segments pending jobs are admitted into free slots, earliest deadline
    first, finished and cancelled lanes are evicted and their slots
    backfilled at once, so a job submitted mid-run starts within one
    boundary whenever its bucket has or frees a slot.

    * one round program per (bucket key, capacity) (``trace_count``):
      occupancy is operand data;
    * jobs all submitted before the first step give the batch runner's
      results bit for bit (same lane order, streams and segment cuts);
    * admission writes the lane's state into its slot in place.

    ``step_log`` holds (bucket key, lanes occupied, rounds, seconds) per
    segment, the counterpart of ``FleetRunner.segment_log``.  The caller
    drives the device: ``step()``, ``run_until_idle()`` and
    ``JobHandle.result()``.  ``device`` as ``resolve_device`` takes it
    (CUDA unless "cpu")."""

    def __init__(self, *, max_lanes: Optional[int] = None,
                 chunk: Optional[int] = None,
                 options: Optional[RoundOptions] = None, device=None):
        self.options = resolve_options(options, chunk=chunk)
        if self.options.engine not in (None, "scan"):
            raise ValueError(f"the fleet runs segments of rounds only "
                             f"(engine 'scan'), got {self.options.engine!r}")
        self.device = resolve_device(device)
        #: Lanes per bucket (None = the jobs pending for its key when the
        #: bucket is created).
        self.max_lanes = max_lanes
        #: Segment length = admission cadence (None = whole horizon).
        self.chunk = self.options.chunk
        self._handles: dict[int, JobHandle] = {}
        self._pending: list[JobHandle] = []
        self._buckets: dict[tuple, ContinuousBucket] = {}
        # Kept across bucket generations: a later wave of one key reuses
        # its round program.
        self._built: dict = {}
        self._admit_fn = build_lane_admit()
        self._next_id = 0
        #: Boundaries stepped: the clock of admission latency.
        self.steps = 0
        #: Scan rounds run over every bucket.
        self.rounds_executed = 0
        #: Round programs built for this service (one per bucket key and
        #: capacity).
        self.trace_count = 0
        self.step_log: list = []
        #: The dispatch record of the latest step's aggregation (None when
        #: that step opened none): a tenant's "cuda_sharded" /
        #: "cuda_hier" request that degraded without a multi-rank mesh
        #: shows here as a recorded pipeline fallback with mesh_devices 1
        #: (the reference's ``FleetService.last_dispatch``).
        self.last_dispatch = None
        self._ckpt_cfg = resolve_checkpoint(self.options.checkpoint)
        self._store = None
        if self._ckpt_cfg is not None:
            self._store = SnapshotStore.from_config(self._ckpt_cfg,
                                                    subdir="service")

    # -- submission -------------------------------------------------------
    def submit(self, job: Union[ScenarioSpec, FleetJob], *,
               deadline: Optional[float] = None) -> JobHandle:
        """Enqueue a job; returns its :class:`JobHandle` at once.
        ``deadline`` (any comparable float) orders admission when jobs
        compete for slots: earliest first, ties by submission; None after
        every explicit deadline."""
        spec_dict = None
        if isinstance(job, ScenarioSpec):
            if isinstance(job.scenario, str):
                spec_dict = {"scenario": job.scenario, "seed": job.seed,
                             "rounds": job.rounds, "label": job.label}
            job = job_from_spec(job)
        elif not isinstance(job, FleetJob):
            raise TypeError(f"submit wants ScenarioSpec | FleetJob, "
                            f"got {type(job).__name__}")
        job = apply_job_options(job, self.options)
        handle = JobHandle(self, self._next_id, job, deadline=deadline)
        handle.spec = spec_dict
        self._next_id += 1
        self._handles[handle.job_id] = handle
        handle.key = bucket_key(job, chunk=self.chunk)
        obs_runtime.event("fleet.submit", job_id=handle.job_id,
                          label=job.label, deadline=deadline)
        if job.rounds == 0:
            # Done at submission, as the batch runner; never takes a lane.
            handle._result = FleetResult(
                label=job.label, job=job,
                state=init_lane_state(job, self.device),
                history=FedHistory(), evals=[])
            handle._status = "done"
            now = obs_runtime.now()
            handle.admit_ts = handle.first_ts = handle.done_ts = now
            handle.admit_step = self.steps
        else:
            self._pending.append(handle)
        return handle

    @property
    def pending(self) -> int:
        """Jobs not yet finished (queued + running)."""
        return sum(1 for h in self._handles.values()
                   if h._status in ("queued", "running"))

    # -- admission and stepping ---------------------------------------------
    def _sorted_pending(self) -> list[JobHandle]:
        return sorted(self._pending,
                      key=lambda h: (h.deadline if h.deadline is not None
                                     else float("inf"), h.job_id))

    def _make_bucket(self, key: tuple, template: FleetJob,
                     capacity: int) -> ContinuousBucket:
        cache_key = (key, capacity)
        if cache_key not in self._built:
            def bump(lanes=capacity):
                self.trace_count += 1
                obs_runtime.event("fleet.trace", lanes=lanes,
                                  trace_count=self.trace_count)
            self._built[cache_key] = build_fleet_scan(
                template.loss_fn, template.optimizer, template.cfg,
                on_build=bump)
        return ContinuousBucket(key, template, capacity, chunk=self.chunk,
                                fleet_scan=self._built[cache_key],
                                admit_fn=self._admit_fn, device=self.device)

    def _admit_pending(self) -> None:
        """Admit queued jobs into free slots, earliest deadline first; a
        key with no bucket gets one sized to ``max_lanes`` or to the jobs
        pending for it."""
        admitted = []
        for handle in self._sorted_pending():
            bucket = self._buckets.get(handle.key)
            if bucket is None:
                cap = self.max_lanes or sum(
                    1 for p in self._pending if p.key == handle.key)
                bucket = self._make_bucket(handle.key, handle.job, cap)
                self._buckets[handle.key] = bucket
            if bucket.free_slot() is None:
                continue
            bucket.admit(handle.job, token=handle)
            handle._status = "running"
            handle.admit_ts = obs_runtime.now()
            handle.admit_step = self.steps
            admitted.append(handle)
        for handle in admitted:
            self._pending.remove(handle)

    def step(self) -> bool:
        """Advance by ONE boundary: admit pending jobs, run one segment of
        every occupied bucket, finalise and evict finished lanes, backfill
        the freed slots, snapshot (with a checkpoint).  Returns True while
        work remains."""
        self._admit_pending()
        before_disp = kdispatch.dispatch_count()
        for key, bucket in list(self._buckets.items()):
            if bucket.occupied == 0:
                continue
            # A job waiting for a FULL bucket cuts the segment at the
            # soonest lane finish, freeing its slot at once.
            hold = any(h.key == key for h in self._pending)
            before = bucket.rounds_executed
            for token, res in bucket.step(hold_for_pending=hold):
                self._finish(token, res)
            lanes, rounds, sec = bucket.last_segment
            self.step_log.append((key, lanes, rounds, sec))
            self.rounds_executed += bucket.rounds_executed - before
            now = obs_runtime.now()
            for slot in bucket.slots:
                if (slot is not None and slot.local > 0
                        and slot.token is not None
                        and slot.token.first_ts is None):
                    slot.token.first_ts = now
        self.steps += 1
        self.last_dispatch = kdispatch.last_dispatch() \
            if kdispatch.dispatch_count() > before_disp else None
        # Backfill now: an evicted lane's slot is reusable at this
        # boundary.
        self._admit_pending()
        # Retire idle buckets nothing waits for, so the key's next wave
        # sizes its bucket to its own demand (programs stay built).
        for key in [k for k, b in self._buckets.items() if b.occupied == 0]:
            if not any(h.key == key for h in self._pending):
                del self._buckets[key]
        if self._store is not None:
            self._snapshot()
        return bool(self._pending) or any(
            b.occupied for b in self._buckets.values())

    # -- restart recovery ---------------------------------------------------
    def _snapshot(self) -> None:
        """Persist the service at this boundary: the queue, each bucket's
        stacked state (``SnapshotStore.save`` clones it on the caller's
        stream before it returns, so a later in-place admission cannot
        reach the write), each slot's clock, numpy rng and torch generator
        state, history and evals, and the undelivered results."""
        arrays: dict[str, Any] = {}
        buckets = list(self._buckets.values())
        # The slots' device evals reach the host here, in one transfer.
        slots = [s for b in buckets for s in b.slots if s is not None]
        for s, evals in zip(slots, host_evals([s.evals for s in slots])):
            s.evals = evals
        buckets_meta = []
        for bi, bucket in enumerate(buckets):
            for li, leaf in enumerate(tree_leaves(bucket.state)):
                arrays[f"bucket/{bi}/state/{li:03d}"] = leaf
            slots_meta: list = []
            for k, s in enumerate(bucket.slots):
                if s is None:
                    slots_meta.append(None)
                    continue
                h_arrays, h_meta = s.hist.pack()
                for col, arr in h_arrays.items():
                    arrays[f"bucket/{bi}/slot/{k}/hist/{col}"] = arr
                if s.gen is not None:
                    arrays[f"bucket/{bi}/slot/{k}/gen"] = \
                        s.gen.get_state().numpy()
                slots_meta.append({
                    "job_id": (s.token.job_id if s.token is not None
                               else None),
                    "local": int(s.local),
                    "rng": s.rng.bit_generator.state,
                    "gen": s.gen is not None,
                    "hist": h_meta,
                    "evals": [[int(r), float(v)] for r, v in s.evals],
                })
            buckets_meta.append({"capacity": bucket.capacity,
                                 "rounds_executed": bucket.rounds_executed,
                                 "slots": slots_meta})
        handles_meta = []
        for h in sorted(self._handles.values(), key=lambda h: h.job_id):
            if h._status not in ("queued", "running") and not (
                    h._status == "done" and not h._consumed):
                continue
            hm = {"job_id": h.job_id, "label": h.job.label,
                  "status": h._status, "deadline": h.deadline,
                  "spec": h.spec, "submit_step": h.submit_step,
                  "admit_step": h.admit_step}
            if h._status == "done":
                res = h._result
                for li, leaf in enumerate(tree_leaves(res.state)):
                    arrays[f"result/{h.job_id}/state/{li:03d}"] = leaf
                r_arrays, r_meta = res.history.pack()
                for col, arr in r_arrays.items():
                    arrays[f"result/{h.job_id}/hist/{col}"] = arr
                hm["hist"] = r_meta
                hm["evals"] = [[int(r), float(v)] for r, v in res.evals]
                hm["best_eval"] = (None if res.best_eval is None
                                   else float(res.best_eval))
            handles_meta.append(hm)
        meta = {
            "signature": dict(SIGNATURE),
            "payload": {
                "service": {"steps": self.steps,
                            "rounds_executed": self.rounds_executed,
                            "next_id": self._next_id,
                            "max_lanes": self.max_lanes,
                            "chunk": self.chunk,
                            "taps": self.options.taps,
                            "backend": self.options.backend},
                "buckets": buckets_meta,
                "handles": handles_meta,
            },
        }
        self._store.save(self.steps, arrays, meta)

    @classmethod
    def restore(cls, checkpoint: Any, *, jobs: Optional[dict] = None,
                device=None) -> "FleetService":
        """Rebuild a service from its latest boundary snapshot.

        Surviving lanes go back into the SAME slots with their state,
        local clocks, numpy rng and torch generator states and histories;
        queued jobs are re-queued (admission sorts them by deadline), so
        every pre-kill :class:`JobHandle` (``handles()`` / ``handle_of``)
        resolves as the uninterrupted run's.  Jobs submitted by registry
        name are rebuilt from their spec; raw :class:`FleetJob`
        submissions need ``jobs={job_id: FleetJob}``.  Results delivered
        before the kill are not restored."""
        cfg = resolve_checkpoint(checkpoint)
        store = SnapshotStore.from_config(cfg, subdir="service")
        snap = store.load_latest()
        if snap is None:
            raise CheckpointError(
                f"no service snapshot in {store.path!r}",
                hint="the service persists at step boundaries only when "
                     "constructed with options=RoundOptions(checkpoint=...)")
        _, arrays, meta = snap
        check_signature(meta["signature"], SIGNATURE, store.path)
        payload = meta["payload"]
        svc_meta = payload["service"]
        kinds = meta.get("dtypes", {})
        options = RoundOptions(chunk=svc_meta["chunk"],
                               taps=svc_meta.get("taps"),
                               backend=svc_meta["backend"], checkpoint=cfg)
        svc = cls(max_lanes=svc_meta["max_lanes"], options=options,
                  device=device)
        # The seeded store keeps its manifest history, so retention keeps
        # pruning across the restart.
        svc._store = store
        svc.steps = int(svc_meta["steps"])
        svc.rounds_executed = int(svc_meta["rounds_executed"])
        svc._next_id = int(svc_meta["next_id"])

        def decode_state(prefix: str, like: dict, lane=None) -> dict:
            out = []
            for li, leaf in enumerate(tree_leaves(like)):
                name = f"{prefix}{li:03d}"
                try:
                    arr = arrays[name] if lane is None else arrays[name][lane]
                    out.append(decode_leaf(arr, leaf, kinds.get(name)))
                except (KeyError, ValueError) as exc:
                    raise CheckpointError(
                        f"service snapshot entry {name!r} is missing or does "
                        f"not fit the job ({exc!r})",
                        hint="the snapshot was written by an incompatible "
                             "configuration; use a fresh checkpoint dir"
                    ) from exc
            return tree_unflatten(tree_structure(like), out)

        def hist_from(prefix: str, h_meta: dict) -> FedHistory:
            return FedHistory.unpack(
                {n[len(prefix):]: a for n, a in arrays.items()
                 if n.startswith(prefix)}, h_meta)

        missing = []
        id2handle: dict[int, JobHandle] = {}
        for hm in payload["handles"]:
            if hm["spec"] is not None:
                job = job_from_spec(ScenarioSpec(**hm["spec"]))
            elif jobs is not None and hm["job_id"] in jobs:
                job = jobs[hm["job_id"]]
            else:
                missing.append(hm["job_id"])
                continue
            job = apply_job_options(job, svc.options)
            handle = JobHandle(svc, hm["job_id"], job,
                               deadline=hm["deadline"])
            handle.spec = hm["spec"]
            handle._status = hm["status"]
            handle.key = bucket_key(job, chunk=svc.chunk)
            handle.submit_step = hm["submit_step"]
            handle.admit_step = hm["admit_step"]
            svc._handles[handle.job_id] = handle
            id2handle[handle.job_id] = handle
            if hm["status"] == "queued":
                svc._pending.append(handle)
            elif hm["status"] == "done":
                # Finished before the kill, never delivered.
                handle._result = FleetResult(
                    label=job.label, job=job,
                    state=decode_state(f"result/{hm['job_id']}/state/",
                                       init_lane_state(job, svc.device)),
                    history=hist_from(f"result/{hm['job_id']}/hist/",
                                      hm["hist"]),
                    evals=[(int(r), float(v)) for r, v in hm["evals"]],
                    best_eval=hm["best_eval"])
        if missing:
            raise CheckpointError(
                f"cannot rematerialize jobs {missing}: they were submitted "
                "as raw FleetJob objects (their callables do not serialize)",
                hint="pass jobs={job_id: FleetJob} to restore() with the "
                     "original job objects for these ids")

        for bi, bm in enumerate(payload["buckets"]):
            occupied = [(k, sm) for k, sm in enumerate(bm["slots"])
                        if sm is not None]
            if not occupied:
                continue
            template = id2handle[occupied[0][1]["job_id"]]
            bucket = svc._make_bucket(template.key, template.job,
                                      int(bm["capacity"]))
            bucket.rounds_executed = int(bm["rounds_executed"])
            for k, sm in occupied:
                handle = id2handle[sm["job_id"]]
                lane_state = decode_state(
                    f"bucket/{bi}/state/",
                    init_lane_state(handle.job, svc.device), lane=k)
                rng = np.random.default_rng(handle.job.seed)
                rng.bit_generator.state = sm["rng"]
                gen = None
                if sm["gen"]:
                    gen = torch.Generator()
                    gen.set_state(torch.from_numpy(np.array(
                        arrays[f"bucket/{bi}/slot/{k}/gen"], np.uint8)))
                bucket.admit(handle.job, token=handle, lane_state=lane_state,
                             local=int(sm["local"]), rng=rng, gen=gen,
                             hist=hist_from(f"bucket/{bi}/slot/{k}/hist/",
                                            sm["hist"]),
                             evals=[(int(r), float(v))
                                    for r, v in sm["evals"]],
                             slot=k)
            svc._buckets[template.key] = bucket
        obs_runtime.event("resilience.service_restore",
                          step=svc.steps, handles=len(id2handle),
                          buckets=len(svc._buckets))
        return svc

    def handles(self) -> list[JobHandle]:
        """Every handle this service knows, in job-id order (after
        ``restore()``: the surviving pre-kill handles)."""
        return [self._handles[i] for i in sorted(self._handles)]

    def handle_of(self, job_id: int) -> JobHandle:
        return self._handles[int(job_id)]

    def run_until_idle(self) -> None:
        """Step until every submitted job has finished."""
        while self.step():
            pass

    def _run_until_done(self, handle: JobHandle) -> None:
        while handle._status in ("queued", "running"):
            remaining = self.step()
            if handle._status in ("done", "cancelled"):
                return
            if not remaining:       # pragma: no cover - defensive
                raise RuntimeError(
                    f"service went idle with job {handle.job_id} "
                    f"({handle._status}) unfinished")

    def _finish(self, handle: JobHandle, result: Any) -> None:
        handle._result = result
        handle._status = "done"
        handle.done_ts = obs_runtime.now()
        if handle.first_ts is None:
            handle.first_ts = handle.done_ts
        obs_runtime.span_at(
            "fleet.job", handle.submit_ts, handle.done_ts,
            job_id=handle.job_id, label=handle.job.label,
            rounds=result.history.rounds,
            wait_steps=(handle.admit_step - handle.submit_step
                        if handle.admit_step is not None else None))

    def _cancel(self, handle: JobHandle) -> bool:
        if handle._status == "queued":
            self._pending.remove(handle)
            handle._status = "cancelled"
            handle.done_ts = obs_runtime.now()
            obs_runtime.event("fleet.cancel", job_id=handle.job_id,
                              label=handle.job.label, queued=True)
            return True
        if handle._status == "running":
            for bucket in self._buckets.values():
                k = bucket.slot_of(handle)
                if k is not None:
                    handle._result = bucket.cancel(k)       # partial
                    handle._status = "cancelled"
                    handle.done_ts = obs_runtime.now()
                    obs_runtime.event(
                        "fleet.cancel", job_id=handle.job_id,
                        label=handle.job.label, queued=False,
                        rounds=handle._result.history.rounds)
                    return True
        return False
