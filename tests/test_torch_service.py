"""The port's continuous fleet service (repro_torch.serving.FleetService)
against its own batch runner and against the reference's service: the
counterparts of tests/test_service.py and of tests/test_resilience.py's
service cases.

Both packages take the same jobs: a quadratic loss towards per-client
centres drawn with numpy, zero initial params, cohorts from the same
numpy streams.  Contracts and tolerances:

* jobs all submitted up front give the port's ``FleetRunner`` results
  bit for bit (histories, evals, state), bucketing lanes included (their
  permutations come from the same per-lane generator streams);
* against the reference's ``FleetRunner`` and ``FleetService`` up front,
  per-round loss and direction_norm within rtol 1e-5, final params
  within 1e-5, cohorts equal;
* a lane admitted late, or beside a cancelled one, equals bit for bit
  its job alone in a bucket of the same capacity (the neighbours' churn
  is invisible), and is held to its 1-lane solo run within rtol 1e-5
  only: a bucket of another size is another shape, and the reference's
  own bitwise claim there fails in the last bit (tests/test_service.py::
  test_cancel_evicts_and_backfills_slot, ROADMAP queue 3);
* a killed and restored service resolves every surviving handle bit for
  bit equal to the uninterrupted run, the torch generators of a
  bucketing bucket included.
"""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import constant_attack as j_constant
from repro.fleet import FleetJob as JJob
from repro.fleet import FleetRunner as JRunner
from repro.optim import sgd as j_sgd
from repro.resilience import CheckpointConfig as JCkpt
from repro.rounds import RoundOptions as JOptions
from repro.serving import FleetService as JService
from repro_torch.core import AggregatorSpec
from repro_torch.fed import ClientConfig, FedConfig, constant_attack
from repro_torch.fleet import FleetJob, FleetRunner, ScenarioSpec
from repro_torch.obs import runtime as obs_runtime
from repro_torch.optim import sgd
from repro_torch.resilience import (
    CheckpointConfig, CheckpointError, FaultPlan, SimulatedPreemption,
    SnapshotStore,
)
from repro_torch.rounds import RoundOptions
from repro_torch.serving import FleetService, JobHandle
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
_N, _M, _D = 10, 6, 5
_CENTERS = np.random.default_rng(0).normal(size=(_N, _D)).astype(np.float32)
_T_CENTERS = torch.as_tensor(_CENTERS)
_J_CENTERS = jnp.asarray(_CENTERS)
_OPT, _J_OPT = sgd(clip=1.0), j_sgd(clip=1.0)


def _loss(params, batch):
    c = _T_CENTERS[batch["idx"].long()][0]
    return 0.5 * torch.sum((params["theta"].float() - c) ** 2), {}


def _j_loss(params, batch):
    c = _J_CENTERS[batch["idx"][0]]
    return 0.5 * jnp.sum((params["theta"] - c) ** 2), {}


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def _spec(f, pre, ref=False):
    return (JSpec if ref else AggregatorSpec)(
        rule="cwtm", f=f, pre=pre,
        bucket_size=2 if pre == "bucketing" else None)


def _job(label, *, f=2, schedule=None, seed=0, rounds=5, eval_every=0,
         pre="nnm", theta=0.0):
    cfg = FedConfig(n_clients=_N, clients_per_round=_M, f=f,
                    agg=_spec(f, pre),
                    client=ClientConfig(local_lr=0.05, algorithm="dshb",
                                        beta=0.9))
    eval_fn = (lambda p: -torch.sum(p["theta"] ** 2)) if eval_every else None
    return FleetJob(label=label, cfg=cfg, loss_fn=_loss, optimizer=_OPT,
                    params={"theta": torch.full((_D,), theta)},
                    batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                    schedule=schedule or constant_attack("alie", 2.0),
                    eval_fn=eval_fn, eval_every=eval_every,
                    lr_fn=lambda r: 0.1)


def _j_job(label, *, f=2, schedule=None, seed=0, rounds=5, eval_every=0):
    cfg = JFed(n_clients=_N, clients_per_round=_M, f=f,
               agg=_spec(f, "nnm", ref=True),
               client=JClient(local_lr=0.05, algorithm="dshb", beta=0.9))
    eval_fn = (lambda p: -jnp.sum(p["theta"] ** 2)) if eval_every else None
    return JJob(label=label, cfg=cfg, loss_fn=_j_loss, optimizer=_J_OPT,
                params={"theta": jnp.zeros((_D,), jnp.float32)},
                batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                schedule=schedule or j_constant("alie", 2.0),
                eval_fn=eval_fn, eval_every=eval_every, lr_fn=lambda r: 0.1)


def _svc(**kw):
    return FleetService(device="cpu", **kw)


def _solo(job, chunk=2):
    return FleetRunner([job], chunk=chunk, device="cpu").run()[0]


def _alone(job, lanes, chunk=2):
    """``job`` alone in a service bucket of ``lanes`` slots."""
    return _svc(max_lanes=lanes, chunk=chunk).submit(job).result()


def _assert_same_result(a, b):
    """Bit for bit: history, cohorts, evals, state."""
    assert a.history.rounds == b.history.rounds
    assert a.history.loss == b.history.loss
    assert a.history.direction_norm == b.history.direction_norm
    assert a.history.attack == b.history.attack
    for ca, cb in zip(a.history.cohorts, b.history.cohorts):
        np.testing.assert_array_equal(ca, cb)
    assert a.evals == b.evals and a.best_eval == b.best_eval
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_close_result(a, b, rtol=1e-5):
    """Within rtol: per-round loss and direction_norm, final params;
    cohorts and attacks equal.  ``b`` may be the reference's."""
    assert a.history.rounds == b.history.rounds
    np.testing.assert_allclose(a.history.loss, b.history.loss, rtol=rtol)
    np.testing.assert_allclose(a.history.direction_norm,
                               b.history.direction_norm, rtol=rtol)
    assert a.history.attack == b.history.attack
    for ca, cb in zip(a.history.cohorts, b.history.cohorts):
        np.testing.assert_array_equal(ca, cb)
    want = np.asarray(b.state["params"]["theta"])
    np.testing.assert_allclose(a.state["params"]["theta"].numpy(), want,
                               rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


def _three(pre="nnm"):
    return [_job("a", seed=0, rounds=6, eval_every=2, pre=pre),
            _job("b", seed=1, rounds=4, eval_every=2, pre=pre),
            _job("c", seed=2, rounds=6, f=3, schedule=constant_attack("sf"),
                 pre=pre)]


# ---------------------------------------------------------------------------
# Parity: up-front submissions.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre", ["nnm", "bucketing"])
def test_upfront_submit_bitwise_equals_batch_runner(pre):
    batch = FleetRunner(_three(pre), chunk=2, device="cpu").run()
    svc = _svc(chunk=2)
    handles = [svc.submit(j) for j in _three(pre)]
    svc.run_until_idle()
    for h, ref in zip(handles, batch):
        assert h.status() == "done"
        _assert_same_result(h.result(), ref)
    # One metric transfer per segment and bucket: cuts at 2, 4, 6.
    assert [(lanes, n) for _, lanes, n, _ in svc.step_log] == \
        [(3, 2), (3, 2), (2, 2)]


def test_upfront_parity_whole_run_chunk():
    jobs = [_job("a", seed=3, rounds=4), _job("b", seed=4, rounds=4)]
    batch = FleetRunner(jobs, device="cpu").run()
    svc = _svc()
    handles = [svc.submit(j) for j in jobs]
    svc.run_until_idle()
    assert svc.trace_count == 1                 # one program, whole run
    for h, ref in zip(handles, batch):
        _assert_same_result(h.result(), ref)


def test_service_tracks_reference_runner_and_service():
    """The port's service up front against the reference's batch runner
    and its service, same jobs and numpy streams, within rtol 1e-5."""
    def j_jobs():
        return [_j_job("a", seed=0, rounds=6, eval_every=2),
                _j_job("b", seed=1, rounds=4, eval_every=2),
                _j_job("c", seed=2, rounds=6, f=3,
                       schedule=j_constant("sf"))]

    j_batch = JRunner(j_jobs(), chunk=2).run()
    j_svc = JService(chunk=2)
    j_handles = [j_svc.submit(j) for j in j_jobs()]
    j_svc.run_until_idle()
    svc = _svc(chunk=2)
    handles = [svc.submit(j) for j in _three()]
    svc.run_until_idle()
    assert svc.trace_count == j_svc.trace_count == 1
    for h, jr, jh in zip(handles, j_batch, j_handles):
        got = h.result()
        for want in (jr, jh.result()):
            _assert_close_result(got, want)
            assert [r for r, _ in got.evals] == [r for r, _ in want.evals]
            np.testing.assert_allclose([v for _, v in got.evals],
                                       [v for _, v in want.evals], rtol=1e-5)


# ---------------------------------------------------------------------------
# Continuous behaviour: late admission, cancel / backfill, deadlines.
# ---------------------------------------------------------------------------

def test_late_submit_admitted_within_one_boundary():
    svc = _svc(chunk=2, max_lanes=3)
    a = svc.submit(_job("a", seed=0, rounds=6))
    b = svc.submit(_job("b", seed=1, rounds=6))
    svc.step()
    assert a.status() == b.status() == "running"
    late = svc.submit(_job("late", seed=7, rounds=4))
    assert late.status() == "queued"
    svc.step()                                  # next boundary: admitted
    assert late.status() == "running"
    assert late.admit_step - late.submit_step <= 1
    svc.run_until_idle()
    _assert_close_result(late.result(), _solo(_job("late", seed=7, rounds=4)))
    _assert_close_result(a.result(), _solo(_job("a", seed=0, rounds=6)))
    # At a fixed bucket shape the neighbours' churn is invisible, bit for
    # bit (the port's contract; the solo run above is another shape).
    _assert_same_result(late.result(), _alone(_job("late", seed=7, rounds=4), 3))
    _assert_same_result(a.result(), _alone(_job("a", seed=0, rounds=6), 3))


def test_cancel_evicts_and_backfills_slot():
    svc = _svc(chunk=2, max_lanes=2)
    a = svc.submit(_job("a", seed=0, rounds=8))
    b = svc.submit(_job("b", seed=1, rounds=8))
    svc.step()
    waiting = svc.submit(_job("c", seed=2, rounds=4))
    assert waiting.status() == "queued"         # bucket full
    assert a.cancel() is True
    assert a.status() == "cancelled"
    assert a.partial_result.history.rounds == 2     # one segment completed
    svc.step()
    assert waiting.status() == "running"        # backfilled a's slot
    assert waiting.admit_step - waiting.submit_step <= 1
    svc.run_until_idle()
    with pytest.raises(RuntimeError):
        a.result()
    assert a.cancel() is False                  # already cancelled
    _assert_close_result(b.result(), _solo(_job("b", seed=1, rounds=8)))
    _assert_close_result(waiting.result(), _solo(_job("c", seed=2, rounds=4)))
    _assert_same_result(b.result(), _alone(_job("b", seed=1, rounds=8), 2))
    _assert_same_result(waiting.result(),
                        _alone(_job("c", seed=2, rounds=4), 2))
    # The cancelled lane's partial state is a copy: the backfill wrote the
    # slot in place without touching it.
    part = a.partial_result
    _assert_close_result(part, _solo(_job("a", seed=0, rounds=2)))


def test_cancel_queued_job_never_runs():
    svc = _svc(chunk=2, max_lanes=1)
    a = svc.submit(_job("a", seed=0, rounds=2))
    queued = svc.submit(_job("q", seed=1, rounds=2))
    assert queued.cancel() is True
    assert queued.status() == "cancelled" and queued.partial_result is None
    svc.run_until_idle()
    assert a.status() == "done" and svc.pending == 0


def test_deadline_orders_admission():
    svc = _svc(chunk=2, max_lanes=1)
    first = svc.submit(_job("first", seed=0, rounds=2))
    loose = svc.submit(_job("loose", seed=1, rounds=2))
    mid = svc.submit(_job("mid", seed=2, rounds=2), deadline=5.0)
    tight = svc.submit(_job("tight", seed=3, rounds=2), deadline=1.0)
    svc.run_until_idle()
    assert all(h.status() == "done" for h in (first, loose, mid, tight))
    assert tight.admit_step < mid.admit_step < first.admit_step \
        < loose.admit_step


def test_one_program_per_shape_under_churn():
    """Admission, eviction and backfill are operand data: 5 jobs through
    2 lanes build one round program; one metric transfer a segment."""
    obs_runtime.reset()
    svc = _svc(chunk=2, max_lanes=2)
    handles = [svc.submit(_job("a", seed=0, rounds=4)),
               svc.submit(_job("b", seed=1, rounds=4))]
    svc.step()
    handles.append(svc.submit(_job("c", seed=2, rounds=4)))
    svc.step()
    handles.append(svc.submit(_job("d", seed=3, rounds=4)))
    handles.append(svc.submit(_job("e", seed=4, rounds=2)))
    svc.run_until_idle()
    assert all(h.status() == "done" for h in handles)
    assert svc.trace_count == 1
    for h in handles:
        assert h.result().history.rounds == h.job.rounds
    assert obs_runtime.counters()["fleet.transfers"] == len(svc.step_log)
    spans = obs_runtime.history(name="fleet.job")
    assert sorted(e["args"]["job_id"] for e in spans) == [0, 1, 2, 3, 4]
    assert all(e["dur"] >= 0 for e in spans)


# ---------------------------------------------------------------------------
# The JobHandle API.
# ---------------------------------------------------------------------------

def test_jobhandle_api_and_int_compat():
    svc = _svc(chunk=2)
    h = svc.submit(_job("x", seed=0, rounds=2))
    assert isinstance(h, JobHandle)
    assert int(h) == h.job_id and h == h.job_id and h != h.job_id + 1
    assert h.status() == "queued"
    res = h.result()                            # drives the service
    assert h.status() == "done" and res.history.rounds == 2
    assert res is h.result()                    # idempotent
    assert h.submit_ts <= h.admit_ts <= h.first_ts <= h.done_ts
    zero = svc.submit(_job("zero", seed=1, rounds=0))
    assert zero.status() == "done" and zero.result().history.rounds == 0


def test_handle_of_takes_int_ids_and_submit_refuses_non_jobs():
    svc = _svc(chunk=2)
    a = svc.submit(_job("a", seed=0, rounds=2))
    b = svc.submit(_job("b", seed=1, rounds=3))
    assert svc.handle_of(int(b)) is b and svc.handle_of(a) is a
    assert svc.handles() == [a, b] and svc.pending == 2
    svc.run_until_idle()
    assert svc.pending == 0
    assert svc.handle_of(b.job_id).result().history.rounds == 3
    with pytest.raises(KeyError):
        svc.handle_of(999)
    with pytest.raises(TypeError):
        svc.submit("not a job")


def test_service_accepts_options_and_resolves_its_device(monkeypatch):
    assert FleetService(chunk=1, options=RoundOptions(chunk=3),
                        device="cpu").chunk == 1
    svc = _svc(options=RoundOptions(chunk=2, backend="torch"))
    h = svc.submit(_job("x", seed=5, rounds=2))
    assert h.job.cfg.agg.backend == "torch"     # applied at submit
    assert h.result().history.rounds == 2
    with pytest.raises(ValueError, match="segments of rounds only"):
        _svc(options=RoundOptions(engine="loop"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        FleetService()


def test_registry_jobs_with_poison_and_guard_run_as_lanes():
    """Registry specs by name, poisoned and guarded ones included, in the
    service: up front they equal the batch runner bit for bit (the
    feature noise comes from the same per-lane streams) and the guard's
    quarantine event fires."""
    specs = [ScenarioSpec(n, seed=s, rounds=3) for n in
             ("poison_feature", "poison_labelflip", "faulty_nan_quarantine")
             for s in (0, 1)]
    batch = FleetRunner(specs, chunk=2, device="cpu").run()
    obs_runtime.reset()
    svc = _svc(chunk=2)
    handles = [svc.submit(s) for s in specs]
    svc.run_until_idle()
    assert svc.trace_count == 3
    for h, ref in zip(handles, batch):
        assert h.spec["scenario"] == h.job.label.split(":")[0]
        _assert_same_result(h.result(), ref)
        assert np.all(np.isfinite(h.result().history.loss))
    q = [e["args"] for e in obs_runtime.history(name="robustness.quarantine")]
    assert q and all(e["surface"] == "fleet.service" for e in q)
    assert sum(e["total"] for e in q) == 2 * 3 * 4      # f rows, every round


# ---------------------------------------------------------------------------
# Restart recovery.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre", ["nnm", "bucketing"])
def test_service_restart_resolves_handles_identically(tmp_path, pre):
    """Kill the service mid-run, restore, and every surviving handle
    resolves bit for bit as in the uninterrupted run; in the bucketing
    bucket the lanes' torch generators pick up where they stopped."""
    def jobs():
        return [_job("a", seed=0, rounds=6, eval_every=2, pre=pre),
                _job("b", seed=1, rounds=4, eval_every=2, pre=pre),
                _job("q1", seed=2, rounds=4, pre=pre),
                _job("q2", seed=3, rounds=4, pre=pre)]

    svc = _svc(chunk=2, max_lanes=2)
    ref_handles = [svc.submit(j) for j in jobs()]
    svc.run_until_idle()
    ref = {h.job_id: h.result() for h in ref_handles}

    svc2 = _svc(max_lanes=2, options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(
            dir=str(tmp_path), fault_plan=FaultPlan(kill_at=1))))
    kh = [svc2.submit(j) for j in jobs()]
    pre_kill_done = {}
    with pytest.raises(SimulatedPreemption):
        while svc2.step():
            for h in kh:
                if h.status() == "done" and h.job_id not in pre_kill_done:
                    pre_kill_done[h.job_id] = h.result()
    svc3 = FleetService.restore(
        CheckpointConfig(dir=str(tmp_path)), device="cpu",
        jobs={h.job_id: j for h, j in zip(kh, jobs())})
    restored = svc3.handles()
    assert not ({h.job_id for h in restored} & set(pre_kill_done))
    assert {h.job_id for h in restored} | set(pre_kill_done) \
        == {h.job_id for h in kh}
    if pre == "bucketing":
        gens = [s.gen for b in svc3._buckets.values() for s in b.slots
                if s is not None]
        assert gens and all(g is not None for g in gens)
    svc3.run_until_idle()
    for h in restored:
        assert h.status() == "done"
        _assert_same_result(h.result(), ref[h.job_id])
    for jid, res in pre_kill_done.items():
        _assert_same_result(res, ref[jid])


def test_service_restart_with_registry_specs_needs_no_jobs_mapping(tmp_path):
    """Spec-named jobs (a feature-poisoned bucket: its noise streams
    survive) come back from the directory alone."""
    specs = [ScenarioSpec("poison_feature", seed=s, rounds=4) for s in (0, 1)]
    svc = _svc(chunk=2)
    ref = [svc.submit(s) for s in specs]
    svc.run_until_idle()
    killed = _svc(options=RoundOptions(chunk=2, checkpoint=CheckpointConfig(
        dir=str(tmp_path), sync=True, fault_plan=FaultPlan(kill_at=0))))
    for s in specs:
        killed.submit(s)
    with pytest.raises(SimulatedPreemption):
        killed.run_until_idle()
    back = FleetService.restore(str(tmp_path), device="cpu")
    back.run_until_idle()
    for h, r in zip(back.handles(), ref):
        _assert_same_result(h.result(), r.result())


def test_service_queued_jobs_survive_restart(tmp_path):
    svc = _svc(max_lanes=1, options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(
            dir=str(tmp_path), sync=True, fault_plan=FaultPlan(kill_at=0))))
    nodl = svc.submit(_job("nodl", seed=0, rounds=4))
    dl = svc.submit(_job("dl", seed=1, rounds=4), deadline=1.0)
    with pytest.raises(SimulatedPreemption):
        svc.step()
    assert dl.status() == "running" and nodl.status() == "queued"
    svc2 = FleetService.restore(
        CheckpointConfig(dir=str(tmp_path), sync=True), device="cpu",
        jobs={nodl.job_id: _job("nodl", seed=0, rounds=4),
              dl.job_id: _job("dl", seed=1, rounds=4)})
    h_dl = svc2.handle_of(dl.job_id)
    h_nodl = svc2.handle_of(nodl.job_id)
    assert h_dl.status() == "running" and h_nodl.status() == "queued"
    assert h_dl.deadline == 1.0
    svc2.run_until_idle()
    _assert_same_result(h_nodl.result(), _solo(_job("nodl", seed=0, rounds=4)))
    _assert_same_result(h_dl.result(), _solo(_job("dl", seed=1, rounds=4)))


def test_service_undelivered_done_result_survives_restart(tmp_path):
    ref = _solo(_job("x", seed=0, rounds=2, eval_every=2))
    svc = _svc(options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(
            dir=str(tmp_path), sync=True, fault_plan=FaultPlan(kill_at=0))))
    h = svc.submit(_job("x", seed=0, rounds=2, eval_every=2))
    with pytest.raises(SimulatedPreemption):
        svc.step()
    assert h.status() == "done"           # finished, never delivered
    svc2 = FleetService.restore(
        CheckpointConfig(dir=str(tmp_path), sync=True), device="cpu",
        jobs={h.job_id: _job("x", seed=0, rounds=2, eval_every=2)})
    h2 = svc2.handle_of(h.job_id)
    assert h2.status() == "done"
    _assert_same_result(h2.result(), ref)


def test_service_restore_without_jobs_mapping_refuses(tmp_path):
    svc = _svc(options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(
            dir=str(tmp_path), sync=True, fault_plan=FaultPlan(kill_at=0))))
    h = svc.submit(_job("x", seed=0, rounds=4))
    with pytest.raises(SimulatedPreemption):
        svc.step()
    with pytest.raises(CheckpointError, match="raw FleetJob") as ei:
        FleetService.restore(CheckpointConfig(dir=str(tmp_path), sync=True),
                             device="cpu")
    assert str(h.job_id) in str(ei.value)
    assert "jobs=" in ei.value.hint


def test_service_restore_empty_dir_refuses_with_hint(tmp_path):
    with pytest.raises(CheckpointError, match="no service snapshot") as ei:
        FleetService.restore(CheckpointConfig(dir=str(tmp_path)),
                             device="cpu")
    assert "checkpoint" in ei.value.hint


def test_service_snapshot_meta_is_json_clean(tmp_path):
    svc = _svc(max_lanes=2, options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(dir=str(tmp_path), sync=True)))
    svc.submit(_job("a", seed=0, rounds=4, eval_every=2, pre="bucketing"))
    svc.run_until_idle()
    manifest = json.loads(
        (tmp_path / "service" / "MANIFEST.json").read_text())
    assert manifest["latest"]["meta"]["signature"] == {
        "surface": "fleet-service", "package": "repro_torch"}


def test_reference_service_snapshot_is_refused(tmp_path):
    """Snapshots do not cross packages: the reference's service snapshot
    is a clean refusal, not a misread state."""
    svc = JService(options=JOptions(chunk=2, checkpoint=JCkpt(
        dir=str(tmp_path), sync=True)))
    svc.submit(_j_job("a", seed=0, rounds=4))
    svc.step()
    with pytest.raises(CheckpointError, match="different experiment plan"):
        FleetService.restore(str(tmp_path), device="cpu",
                             jobs={0: _job("a", seed=0, rounds=4)})


def test_admission_after_snapshot_does_not_reach_the_write(tmp_path):
    """The in-place trap: the writer is held back while the next step
    admits a job into the snapshotted bucket's free slot in place; the
    snapshot still holds the slot's state of its own boundary."""
    gate, entered = threading.Event(), threading.Event()

    class GatedStore(SnapshotStore):
        def _write(self, *args, **kwargs):
            entered.set()
            assert gate.wait(timeout=60), "writer gate never opened"
            return super()._write(*args, **kwargs)

    svc = _svc(max_lanes=2, options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(dir=str(tmp_path))))
    svc._store = GatedStore(str(tmp_path / "service"), keep=5)
    svc.submit(_job("a", seed=0, rounds=4))
    svc.step()                                  # snapshot of step 1, gated
    assert entered.wait(timeout=60)
    late = svc.submit(_job("late", seed=1, rounds=2, theta=3.0))
    svc.step()                                  # admits `late` in place
    assert late.status() in ("running", "done")
    gate.set()
    svc._store.close()
    with np.load(tmp_path / "service" / "snapshot-00000001.npz") as data:
        names = sorted(k for k in data.files if k.startswith("bucket/0/state/"))
        theta = [data[k] for k in names if data[k].shape == (2, _D)]
    # Slot 1 held the filler (the template's zero params) at step 1.
    assert theta and all((t[1] == 0.0).all() for t in theta)
