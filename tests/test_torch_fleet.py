"""The port's lane-batched fleet against the reference's ``FleetRunner``.

Both packages run the paper's grid cells (n = 17, f = 4, Dirichlet 0.1,
D-SHB beta = 0.9) for 5 rounds: rules cwtm | None, cwtm | nnm and
gm | nnm, each against alie (eta 8), sf and mimic, three buckets of three
lanes.  They start from the same parameters (the reference's MLP init,
carried across with ``repro_torch.interop``) and take the same numpy data:
the port replays the reference's numpy calls, so cohorts and batches are
identical sample for sample.

Tolerances: per-lane, per-round loss and direction_norm within rtol 1e-4
and atol 1e-6, the reference's own tolerance for fleet against engine
(tests/test_fleet.py); final parameters within 1e-4 of the largest
magnitude (five rounds of fp32 forward / backward passes summed in
another order compound); cohorts and bucket packing EQUAL; test accuracy
within 2 of the 3000 test samples (an fp32 difference can flip the
argmax of a sample on the decision boundary).  A lane inside a 3-lane
bucket is held to the same job run alone within rtol 1e-5 (fp32 sums in
another batch shape; bitwise is not required).

Bucketing lanes draw their permutations from a per-lane torch generator
where the reference splits a PRNG key, so their trajectories differ; they
are held here only to identical cohorts and finite metrics (the
bucketing aggregate itself is held to the reference, with the
reference's permutation, in tests/test_torch_fleet_aggregation.py).

Poisoned (label flip) and guarded lanes use no randomness: held to the
reference's lanes within rtol 1e-5.  Feature-poisoned lanes draw their
noise from the same per-lane generators, so they are held to the port's
own ``FedServer`` rounds fed the same noise (``noise=``), within rtol
1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.bucketing import default_bucket_size as j_bucket_size
from repro.core.types import AggregatorSpec as JSpec
from repro.data import build_heterogeneous as j_hetero
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import constant_attack as j_constant
from repro.fed.scenarios import _mlp_eval as j_eval
from repro.fed.scenarios import _mlp_init as j_init
from repro.fed.scenarios import _mlp_loss as j_loss
from repro.fed.scenarios import cohort_batch_fn as j_batch_fn
from repro.fleet import FleetJob as JJob
from repro.fleet import FleetRunner as JRunner
from repro.fleet import SCENARIO_OPTIMIZER as J_OPT
from repro.fleet import init_lane_state as j_init_lane
from repro.fleet import lane_filler as j_filler
from repro.fleet import plan_lane_round as j_plan
from repro_torch.fleet import FleetRunner as TRunner
from repro_torch.fleet import lane_filler as t_filler
from repro_torch.fleet import plan_lane_round as t_plan
from repro_torch.interop import (
    lane_state_from_numpy, lane_state_to_numpy, mlp_params_from_numpy,
    params_to_numpy,
)
from repro_torch.launch import grid as tgrid
from repro_torch.rounds import RoundOptions

torch.set_num_threads(2)

STEPS = 5
CELLS = [(rule, pre, attack)
         for rule, pre in (("cwtm", None), ("cwtm", "nnm"), ("gm", "nnm"))
         for attack in ("alie", "sf", "mimic")]
N, F, SEED = 17, 4, 1


def _ref_init():
    return jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(SEED), 48))


def _ref_jobs(cells, steps=STEPS):
    """The reference's grid cells (benchmarks/bench_accuracy_grid.py's
    _grid_jobs, written out: the tests do not import benchmarks/)."""
    (x, y), (xt, yt) = tgrid._make_task()
    ds = j_hetero({"x": x, "y": y}, "y", N, alpha=0.1, seed=SEED)
    batch_fn = j_batch_fn(ds, 25, 0)
    every = max(steps // 3, 1)
    acc = j_eval(xt, yt)
    params = j_init(jax.random.PRNGKey(SEED), x.shape[1])
    jobs = []
    for rule, pre, attack in cells:
        f = 0 if attack == "none" else F
        spec = JSpec(rule=rule, f=f, pre=pre, backend="xla",
                     bucket_size=j_bucket_size(N, f)
                     if pre == "bucketing" else None)
        cfg = JFed(n_clients=N, clients_per_round=N, f=f, agg=spec,
                   client=JClient(algorithm="dshb", beta=0.9))
        eta = 8.0 if attack in ("alie", "foe") else None
        jobs.append(JJob(
            label=f"{rule}|{pre}|{attack}", cfg=cfg, loss_fn=j_loss,
            optimizer=J_OPT, params=params, batch_fn=batch_fn, rounds=steps,
            seed=SEED, schedule=j_constant(attack, eta),
            lr_fn=lambda r: 0.5 / (1.0 + r // every), eval_fn=acc,
            eval_every=max(steps // 8, 1)))
    return jobs


def _port_jobs(cells, steps=STEPS, backend="torch"):
    train, test = tgrid._make_task()
    cell = tgrid._grid_jobs(train, test, alpha=0.1, steps=steps, seed=SEED,
                            params=mlp_params_from_numpy(_ref_init()),
                            backend=backend)
    return [cell(f"{r}|{p}|{a}", r, p, a, 0 if a == "none" else F)
            for r, p, a in cells]


@pytest.fixture(scope="module")
def runs():
    jr = JRunner(_ref_jobs(CELLS))
    tr = TRunner(_port_jobs(CELLS), device="cpu")
    return jr, jr.run(), tr, tr.run()


def test_bucket_packing_equals_reference(runs):
    jr, _, tr, _ = runs
    assert tr.n_buckets == jr.n_buckets == 3
    assert [b.indices for b in tr.buckets] == [b.indices for b in jr._buckets]
    assert tr.trace_count == 3


def test_fleet_tracks_reference_per_lane(runs):
    _, jres, _, tres = runs
    for j, t in zip(jres, tres):
        assert t.label == j.label
        assert t.history.rounds == j.history.rounds == STEPS
        for jc, tc in zip(j.history.cohorts, t.history.cohorts):
            np.testing.assert_array_equal(tc, jc)
        assert t.history.attack == j.history.attack
        for col in ("loss", "direction_norm", "lr"):
            np.testing.assert_allclose(getattr(t.history, col),
                                       getattr(j.history, col),
                                       rtol=1e-4, atol=1e-6, err_msg=t.label)
        assert np.all(np.isfinite(t.history.kappa_hat))
        assert [r for r, _ in t.evals] == [r for r, _ in j.evals]
        for (_, a), (_, b) in zip(t.evals, j.evals):
            assert abs(a - b) <= 2 / 3000 + 1e-9, t.label
        jp = jax.tree_util.tree_map(np.asarray, j.state["params"])
        tp = params_to_numpy(t.state["params"])
        scale = max(float(np.abs(v).max()) for v in jp.values())
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=k)


def test_lane_in_bucket_equals_the_job_run_alone(runs):
    _, _, _, tres = runs
    label = "cwtm|nnm|mimic"
    solo = TRunner([j for j in _port_jobs(CELLS) if j.label == label],
                   device="cpu").run()[0]
    lane = next(r for r in tres if r.label == label)
    for col in ("loss", "direction_norm", "kappa_hat"):
        np.testing.assert_allclose(getattr(lane.history, col),
                                   getattr(solo.history, col),
                                   rtol=1e-5, atol=1e-7)


def test_kernel_backend_equals_torch_backend_on_the_cpu(runs):
    """backend "cuda" on the CPU (each kernel's plain version: K5, K4,
    K3 per lane) against the leaf-streamed "torch" backend."""
    _, _, _, tres = runs
    cells = [c for c in CELLS if c[2] == "alie"]
    kres = TRunner(_port_jobs(cells, backend="cuda"), device="cpu").run()
    want = {r.label: r for r in tres}
    for k in kres:
        for col in ("loss", "direction_norm"):
            np.testing.assert_allclose(getattr(k.history, col),
                                       getattr(want[k.label].history, col),
                                       rtol=1e-4, atol=1e-6)


def test_max_lanes_chunk_and_options_match_the_unsplit_run(runs):
    """max_lanes splits a bucket (3 lanes -> 2 + 1), chunk cuts every
    segment to at most 2 rounds, and options overlays the backend: each
    lane equals the unsplit run within rtol 1e-5 (fp32 sums in another
    batch shape, as for a lane run alone).  The runtime ring records one
    fleet.segment span and one fleet.transfers count per segment, and a
    fleet.trace event per round program built (one per lane count)."""
    from repro_torch.obs import runtime as obs_runtime
    _, _, _, tres = runs
    want = {r.label: r for r in tres}
    runner = TRunner(_port_jobs(CELLS[:3], backend="cuda"), max_lanes=2,
                     chunk=2, options=RoundOptions(backend="torch"),
                     device="cpu")
    assert all(j.cfg.agg.backend == "torch" for j in runner.jobs)
    assert [len(b.jobs) for b in runner.buckets] == [2, 1]
    assert runner.n_buckets == 1
    obs_runtime.reset()
    res = runner.run()
    for r in res:
        for col in ("loss", "direction_norm", "kappa_hat"):
            np.testing.assert_allclose(getattr(r.history, col),
                                       getattr(want[r.label].history, col),
                                       rtol=1e-5, atol=1e-7, err_msg=r.label)
    segs = [(b, lanes, n) for b, lanes, n, _ in runner.segment_log]
    assert all(n <= 2 for _, _, n in segs)
    assert sum(n for b, _, n in segs if b == 0) == STEPS
    spans = obs_runtime.history(name="fleet.segment", kind="span")
    assert len(spans) == len(segs)
    assert [(e["args"]["lanes"], e["args"]["end"] - e["args"]["start"])
            for e in spans] == [(lanes, n) for _, lanes, n in segs]
    assert all(e["dur"] >= 0 for e in spans)
    assert obs_runtime.counters()["fleet.transfers"] == len(segs)
    assert [e["args"]["lanes"] for e in obs_runtime.history(
        name="fleet.trace")] == [2, 1]
    assert runner.trace_count == 2


def test_bucketing_lanes_keep_the_reference_cohorts():
    cells = [("cwtm", "bucketing", a) for a in ("alie", "sf")]
    jres = JRunner(_ref_jobs(cells, steps=3)).run()
    tres = TRunner(_port_jobs(cells, steps=3), device="cpu").run()
    for j, t in zip(jres, tres):
        for jc, tc in zip(j.history.cohorts, t.history.cohorts):
            np.testing.assert_array_equal(tc, jc)
        assert np.all(np.isfinite(t.history.loss))
        assert np.all(np.isfinite(t.history.direction_norm))


def test_round_plans_and_filler_equal_reference():
    """The host plan of a lane (cohort, batch, ops) and an empty slot's
    operands, numpy for numpy."""
    jjob, tjob = _ref_jobs(CELLS[2:3])[0], _port_jobs(CELLS[2:3])[0]
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for r in range(3):
        jb, jc, jo, jm = j_plan(jjob, r, jrng)
        tb, tc, to, tm = t_plan(tjob, r, trng)
        np.testing.assert_array_equal(tc, jc)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
        assert to == jo and tm[:2] == jm[:2]
    (jb, jc, jo), (tb, tc, to) = j_filler(jjob), t_filler(tjob)
    np.testing.assert_array_equal(tc, jc)
    assert to == jo and all(np.array_equal(tb[k], jb[k]) for k in jb)


def test_lane_state_round_trips_through_interop():
    """The reference's stacked init lane state -> the port -> numpy."""
    jobs = _ref_jobs(CELLS[:3])
    st = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[j_init_lane(j) for j in jobs])
    st["momentum"][0][1, 3] = 0.5          # make it non-trivial
    port = lane_state_from_numpy(st)
    assert "key" not in port and port["step"].dtype == torch.int32
    back = lane_state_to_numpy(port)
    for k in st["params"]:
        np.testing.assert_array_equal(back["params"][k], st["params"][k])
    for a, b in zip(back["momentum"], st["momentum"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["step"], st["step"])
    assert back["opt_state"] == st["opt_state"] == ()


def test_grid_launcher_runs_on_the_cpu(capsys):
    out = tgrid.main(["--device", "cpu", "--rounds", "2"])
    assert out["runner"].n_buckets == 7
    assert len(out["results"]) == 1 + 2 * 3 * 3
    printed = capsys.readouterr().out
    assert "baseline D-SHB (f=0)" in printed and "worst" in printed


def test_fleet_refuses_what_it_does_not_run():
    """Poisoned, guarded and tapped lanes build (tapped lanes were refused
    before the taps were ported: tests/test_torch_taps.py holds them to
    the reference); lane-static attacks and the loop engine are
    refused."""
    from repro_torch.fleet import ScenarioSpec, job_from_spec
    from repro_torch.fleet.lanes import build_lane_round
    for name in ("poison_labelflip", "poison_feature",
                 "faulty_nan_quarantine"):
        assert job_from_spec(ScenarioSpec(name)).cfg is not None
    job = _port_jobs(CELLS[:1])[0]
    tapped = dataclasses.replace(job.cfg, taps=True)
    assert dataclasses.replace(job, cfg=tapped).cfg.taps
    assert callable(build_lane_round(job.loss_fn, job.optimizer, tapped))
    from repro_torch.fed.schedules import constant_attack
    with pytest.raises(ValueError, match="not lane-dynamic"):
        dataclasses.replace(job, schedule=constant_attack("alie_opt"))
    with pytest.raises(ValueError, match="segments of rounds only"):
        TRunner([job], options=RoundOptions(engine="loop"), device="cpu")


def test_schedules_identities_and_cohorts_equal_reference():
    """The host-side pieces the plan is built from, numpy for numpy."""
    from repro.fed import schedules as js
    from repro.fed import server as jsrv
    from repro_torch.fed import schedules as ts
    from repro_torch.fed import server as tsrv
    pairs = [(js.switch_attack((0, "alie", 8.0), (3, "foe", 20.0), (5, "mimic")),
              ts.switch_attack((0, "alie", 8.0), (3, "foe", 20.0), (5, "mimic"))),
             (js.ramp_eta("foe", 0.5, 20.0, 4), ts.ramp_eta("foe", 0.5, 20.0, 4)),
             (js.constant_attack("sf"), ts.constant_attack("sf"))]
    for jsch, tsch in pairs:
        assert [tsch.resolve(r) for r in range(8)] == \
            [jsch.resolve(r) for r in range(8)]
    jrot, trot = js.RotatingByzantine(20, 4, period=2), \
        ts.RotatingByzantine(20, 4, period=2)
    for r in range(12):
        np.testing.assert_array_equal(trot.ids(r), jrot.ids(r))
    for f, n, m in ((4, 17, 17), (4, 20, 12), (3, 20, 10), (0, 17, 5)):
        assert tsrv.rescale_f(f, n, m) == jsrv.rescale_f(f, n, m)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for r in range(5):
        np.testing.assert_array_equal(
            tsrv.sample_cohort(tr, 20, 12, trot.ids(r), 3),
            jsrv.sample_cohort(jr, 20, 12, jrot.ids(r), 3))


@pytest.mark.parametrize("local_steps", [0, 2])
def test_client_updates_match_reference(local_steps):
    """The vmapped cohort pass (gradient mode and local SGD), D-SHB, on
    the same params, momentum rows and batch: losses and sends within
    1e-5 relative of their largest magnitude (fp32 forward / backward sums
    in another order)."""
    from repro.fed import ClientConfig as JCfg
    from repro.fed.clients import client_updates as j_updates
    from repro_torch.fed import ClientConfig as TCfg
    from repro_torch.fed.clients import client_updates as t_updates
    from repro_torch.fed.scenarios import _mlp_loss as t_loss
    rng = np.random.default_rng(local_steps)
    params = _ref_init()
    m, L = 6, max(local_steps, 1)
    batch = {"x": rng.normal(size=(m, L, 8, 48)).astype(np.float32),
             "y": rng.integers(0, 10, size=(m, L, 8)).astype(np.int32)}
    mom = [rng.normal(size=(m,) + np.shape(params[k])).astype(np.float32)
           for k in sorted(params)]
    kw = dict(local_steps=local_steps, local_lr=0.1, beta=0.9)
    jl, js_, jm = j_updates(j_loss, jax.tree_util.tree_map(jax.numpy.asarray,
                                                           params),
                            [jax.numpy.asarray(x) for x in mom],
                            jax.tree_util.tree_map(jax.numpy.asarray, batch),
                            JCfg(**kw))
    tl, ts_, tm = t_updates(t_loss, mlp_params_from_numpy(params),
                            [torch.from_numpy(x) for x in mom],
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            TCfg(**kw))
    for got, want in [(tl, jl)] + list(zip(ts_, js_)) + list(zip(tm, jm)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_kappa_hat_masked_per_lane_matches_reference():
    from repro.training.trainer import kappa_hat_masked as j_kappa
    from repro_torch.training import kappa_hat_masked as t_kappa
    rng = np.random.default_rng(8)
    stack = {"a": rng.normal(size=(3, 9, 4, 2)).astype(np.float32),
             "b": rng.normal(size=(3, 9, 5)).astype(np.float32)}
    agg = {k: v[:, :5].mean(1) + 0.1 for k, v in stack.items()}
    nh = np.array([9, 5, 6], np.int32)
    got = t_kappa({k: torch.from_numpy(v) for k, v in agg.items()},
                  {k: torch.from_numpy(v) for k, v in stack.items()},
                  torch.from_numpy(nh)).numpy()
    for lane in range(3):
        want = float(j_kappa({k: jax.numpy.asarray(v[lane]) for k, v in agg.items()},
                             {k: jax.numpy.asarray(v[lane])
                              for k, v in stack.items()},
                             jax.numpy.asarray(nh[lane])))
        assert got[lane] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("name", ["labelskew_alie_partial", "mimic_rotating",
                                  "dirichlet_localsgd", "foe_ramp"])
def test_registry_jobs_plan_like_the_reference_and_run(name):
    """A registry scenario materialised by both packages plans the same
    rounds (partial participation, rotating identities, local SGD, eta
    ramps); the port's job then runs two rounds on the CPU.  (Its MLP init
    is the port's own, so only the plan is compared.)"""
    from repro.fleet import ScenarioSpec as JSpec_, job_from_spec as j_from
    from repro_torch.fleet import ScenarioSpec as TSpec_, job_from_spec as t_from
    jjob, tjob = j_from(JSpec_(name, seed=2)), t_from(TSpec_(name, seed=2))
    assert tjob.m_byz == jjob.m_byz and tjob.label == jjob.label
    jrng, trng = np.random.default_rng(2), np.random.default_rng(2)
    for r in (0, 1, 5, 6):
        jb, jc, jo, _ = j_plan(jjob, r, jrng)
        tb, tc, to, _ = t_plan(tjob, r, trng)
        np.testing.assert_array_equal(tc, jc)
        assert to == jo
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    res = TRunner([TSpec_(name, seed=2, rounds=2)], device="cpu").run()[0]
    assert res.history.rounds == 2 and np.all(np.isfinite(res.history.loss))


# ---------------------------------------------------------------------------
# Poisoned and guarded lanes.
# ---------------------------------------------------------------------------

GUARD_CELLS = [("cwtm", "nnm", a) for a in ("alie", "sf", "none")]


def _with(jobs, **cfg_kw):
    return [dataclasses.replace(j, cfg=dataclasses.replace(j.cfg, **cfg_kw))
            for j in jobs]


def _nan_first(jobs, constant):
    return [dataclasses.replace(j, schedule=constant("nan")) if i == 0 else j
            for i, j in enumerate(jobs)]


@pytest.mark.parametrize("kind", ["labelflip", "guard"])
def test_poisoned_and_guarded_lanes_track_reference(kind):
    """Label-flip poisoning at rate 0.6 and the quarantine guard (lane 0
    sends NaN rows), 4 rounds, one bucket of three lanes, from the same
    params and numpy streams: within rtol 1e-5 of the reference's lanes;
    the guard quarantines lane 0's f rows every round."""
    from repro.fed import PoisonConfig as JPoison
    from repro.fed import constant_attack as j_const
    from repro.robustness import QuarantineConfig as JGuard
    from repro_torch.fed import PoisonConfig as TPoison
    from repro_torch.fed import constant_attack as t_const
    from repro_torch.obs import runtime as obs_runtime
    from repro_torch.robustness import QuarantineConfig as TGuard
    jj, tj = _ref_jobs(GUARD_CELLS, steps=4), _port_jobs(GUARD_CELLS, steps=4)
    if kind == "labelflip":
        jj = _with(jj, poison=JPoison(kind="labelflip", rate=0.6))
        tj = _with(tj, poison=TPoison(kind="labelflip", rate=0.6))
    else:
        jj = _nan_first(_with(jj, guard=JGuard()), j_const)
        tj = _nan_first(_with(tj, guard=TGuard()), t_const)
    jrun = JRunner(jj)
    jres = jrun.run()
    obs_runtime.reset()
    trun = TRunner(tj, device="cpu")
    tres = trun.run()
    assert trun.n_buckets == jrun.n_buckets == 1
    for t, j in zip(tres, jres):
        for tc, jc in zip(t.history.cohorts, j.history.cohorts):
            np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(t.history.loss, j.history.loss, rtol=1e-5)
        np.testing.assert_allclose(t.history.direction_norm,
                                   j.history.direction_norm, rtol=1e-5)
        tp, jp = params_to_numpy(t.state["params"]), \
            jax.tree_util.tree_map(np.asarray, j.state["params"])
        for k in jp:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                       atol=1e-5 * np.abs(jp[k]).max())
    q = obs_runtime.history(name="robustness.quarantine")
    if kind == "guard":
        assert [e["args"]["total"] for e in q] == [4 * F]
        assert q[0]["args"]["surface"] == "fleet"
    else:
        assert not q


def test_feature_poisoned_lane_equals_fed_server_rounds_fed_its_noise():
    """A poison_feature lane (NNM + AutoGM, rate 0.5, strength 2) against
    the port's FedServer round driven with the lane's own plan: the same
    cohort, batch and feature noise (``noise=``), 3 rounds, within rtol
    1e-5; the noise comes from the lane's generator in its draw order."""
    from repro_torch.fed import FedServer
    from repro_torch.fed.scenarios import get_scenario
    from repro_torch.fleet import (ScenarioSpec, job_from_spec, lane_draws,
                                   lane_generator)
    from repro_torch.optim.schedules import constant
    job = job_from_spec(ScenarioSpec("poison_feature", seed=3, rounds=3))
    res = TRunner([job], device="cpu").run()[0]
    sc = get_scenario("poison_feature")
    server = FedServer(job.loss_fn, job.optimizer, job.cfg,
                       constant(sc.server_lr), device="cpu")
    state = server.init_state(job.params)
    rng, gen = np.random.default_rng(job.seed), lane_generator(job)
    losses, norms = [], []
    for r in range(job.rounds):
        batch, cohort, _, (attack, eta, _) = t_plan(job, r, rng)
        perm, noise, signs = lane_draws(job.cfg, gen, batch)
        assert perm is None and signs is None
        assert noise.shape == batch["x"].shape
        state, metrics = server.round_fn(attack, job.m_byz)(
            state, batch, cohort, 0.0 if eta is None else eta, noise=noise)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["direction_norm"]))
    np.testing.assert_allclose(res.history.loss, losses, rtol=1e-5)
    np.testing.assert_allclose(res.history.direction_norm, norms, rtol=1e-5)
    # The noise entered: a strength-0 run of the same job differs.
    clean = dataclasses.replace(job, cfg=dataclasses.replace(
        job.cfg, poison=dataclasses.replace(job.cfg.poison, strength=0.0)))
    assert TRunner([clean], device="cpu").run()[0].history.loss[1:] \
        != res.history.loss[1:]


def test_service_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import service
    out = service.main(["--device", "cpu", "--seeds", "1", "--rounds", "2",
                        "--scenario", "poison_feature", "--scenario",
                        "faulty_nan_quarantine", "--scenario", "foe_ramp"])
    assert len(out["results"]) == 3 and out["service"].trace_count == 3
    assert all(np.all(np.isfinite(r.history.loss))
               for r in out["results"].values())
    printed = capsys.readouterr().out
    assert "submitted 3 jobs" in printed and "poison_feature:s0" in printed
    drill = service.main(["--device", "cpu", "--seeds", "1", "--rounds", "4",
                          "--chunk", "2", "--kill-at", "1"])
    assert len(drill["survivors"]) == 4        # 5 jobs, one cancelled
    assert drill["snapshots"] and drill["restore_s"] > 0
    assert "bit-for-bit equal" in capsys.readouterr().out
