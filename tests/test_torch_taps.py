"""The port's in-round health taps (``repro_torch.obs.taps``) against the
reference's (``repro.obs.taps``), on the same numpy inputs.

* Static taps: the reference's oracle stack (tests/test_obs.py, a
  two-leaf 9 x 7 stack, f = 2) for six (rule, pre) pairs; both packages'
  taps take the reference's aggregate, rtol = atol = 2e-5 (the
  reference's oracle tolerance) and ``neighbor_count`` / ``trim_frac``
  EQUAL.  The port's taps from its own aggregation's ``internals`` (both
  backends; the kernel backend's trim taps recompute the mix and the
  sort chunk by chunk) equal its standalone taps to the same tolerance.
* Lane taps: three lanes with f = 0, 1, 2 against the reference's
  ``dyn=True`` taps lane by lane, rtol 1e-6.
* Non-finite rows: NaN positions equal, the finite values to the static
  tolerance.
* Chunking: a forced small :data:`~repro_torch.obs.taps.TAP_CHUNK` gives
  bit for bit what one chunk gives.
* Hier: the port refuses taps with ``hier``; the reference's own taps
  fail there with a TypeError (pinned).
* Trainer, fed server, fleet, service: tapped runs equal untapped ones
  bit for bit, with equal metric transfers; scan equals loop; the port
  is held to the reference's LOOP engine at rtol 1e-5 (its scan-vs-loop
  taps test fails, ROADMAP queue 3) and to its fleet taps at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import AggregatorSpec as JSpec
from repro.core.robust import batched_robust_aggregate as j_batched
from repro.core.robust import robust_aggregate as j_aggregate
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import FedServer as JServer
from repro.fed import constant_attack as j_constant
from repro.fed import run_rounds as j_run_rounds
from repro.fed.schedules import AttackPhase as JPhase
from repro.fed.schedules import AttackSchedule as JSchedule
from repro.fleet import FleetJob as JJob
from repro.fleet import FleetRunner as JRunner
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_lr
from repro.robustness.guard import QuarantineConfig as JQuarantine
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JTrainer
from repro.training import train_loop as j_train_loop
from repro_torch.core.robust import (
    batched_robust_aggregate, robust_aggregate, robust_aggregate_dyn,
)
from repro_torch.core.theory import tree_kappa_hat
from repro_torch.core.types import AggregatorSpec
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, constant_attack, run_rounds,
)
from repro_torch.fed.schedules import AttackPhase, AttackSchedule
from repro_torch.fleet import FleetJob, FleetRunner
from repro_torch.obs import taps as taplib
from repro_torch.obs.taps import (
    TAP_FIELDS, health_taps, health_taps_lanes,
)
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.resilience import (
    CheckpointConfig, CheckpointError, FaultPlan, SimulatedPreemption,
)
from repro_torch.robustness.guard import QuarantineConfig
from repro_torch.rounds import RoundOptions
from repro_torch.training import (
    ByzantineConfig, TrainerConfig, build_train_step, kappa_hat_masked,
    train_loop,
)

torch.set_num_threads(2)

STATIC_TOL = 2e-5           # the reference's oracle-test tolerance
RUN_RTOL = 1e-5             # a run against the reference's loop engine


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _oracle_stack(seed=3, n=9, d=7):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return {"w": x[:, :4], "b": x[:, 4:]}


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_taps(got: dict, want: dict, tol=STATIC_TOL, exact=(
        "neighbor_count", "trim_frac")):
    assert set(got) == set(want)
    for k in want:
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)


def _dict(taps):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in taps.to_dict().items()}


STATIC_CASES = [("cwtm", "nnm"), ("cwtm", None), ("gm", "nnm"),
                ("cwmed", None), ("cwtm", "bucketing"), ("krum", "nnm")]


@pytest.mark.parametrize("rule,pre", STATIC_CASES)
def test_static_taps_match_reference(rule, pre):
    n, f = 9, 2
    x = _oracle_stack()
    jspec = JSpec(rule=rule, f=f, pre=pre, backend="xla",
                  bucket_size=2 if pre == "bucketing" else None)
    agg = jax.tree_util.tree_map(np.asarray, j_aggregate(
        _j(x), jspec, key=jax.random.PRNGKey(0)))
    want = _np(jobs.health_taps(_j(x), _j(agg), n_honest=n - f, f=f,
                                rule=rule, pre=pre).to_dict())
    got = _dict(health_taps(_t(x), _t(agg), n_honest=n - f, f=f, rule=rule,
                            pre=pre))
    _assert_taps(got, want)
    assert got["dist_honest"].shape == () and got["cos_honest"].dtype == np.float32


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("rule,pre", STATIC_CASES)
def test_taps_from_internals_equal_standalone(rule, pre, backend):
    """The aggregation's and kappa-hat's stash on each backend (on a CPU
    stack the kernel backend runs the kernels' plain versions, and K2
    stashes no mixed / sorted stack) gives the standalone taps."""
    n, f = 9, 2
    x = _t(_oracle_stack())
    spec = AggregatorSpec(rule=rule, f=f, pre=pre, backend=backend,
                          bucket_size=2 if pre == "bucketing" else None)
    internals = {}
    agg = robust_aggregate(x, spec, internals=internals,
                           generator=torch.Generator().manual_seed(0))
    if pre == "nnm":
        assert internals["mix_matrix"].shape == (n, n)
    stashed = {"mixed", "sorted_leaves"} & set(internals)
    want_stash = {"mixed", "sorted_leaves"} if (
        backend == "torch" and rule == "cwtm" and pre == "nnm") else set()
    if backend == "torch" and rule == "cwtm" and pre is None:
        want_stash = {"sorted_leaves"}
    if backend == "torch" and rule == "cwtm" and pre == "bucketing":
        want_stash = {"sorted_leaves"}      # the bucket means' sort
    assert stashed == want_stash
    tree_kappa_hat(agg, x, n - f, internals)
    got = _dict(health_taps(x, agg, n_honest=n - f, f=f, rule=rule, pre=pre,
                            internals=internals))
    want = _dict(health_taps(x, agg, n_honest=n - f, f=f, rule=rule,
                             pre=pre))
    _assert_taps(got, want)


def test_tap_structure_gates():
    x = {"x": torch.ones((6, 3))}
    agg = {"x": torch.ones(3)}
    t = health_taps(x, agg, n_honest=5, f=1, rule="gm", pre=None)
    assert t.neighbor_count is None and t.trim_frac is None
    assert set(t.to_dict()) == {"dist_honest", "cos_honest"}
    assert health_taps(x, agg, n_honest=5, f=1, rule="cwtm",
                       pre="bucketing").trim_frac is None
    assert TAP_FIELDS == jobs.TAP_FIELDS


@pytest.mark.parametrize("rule,pre", [("cwtm", "nnm"), ("cwtm", None),
                                      ("gm", "nnm")])
def test_lane_taps_match_reference_dyn(rule, pre):
    """Three lanes, f = 0, 1, 2: the lane form against the reference's
    dyn taps lane by lane; standalone and from the lane internals."""
    b, n, d = 3, 8, 5
    rng = np.random.default_rng(1)
    x = {"x": rng.normal(size=(b, n, d)).astype(np.float32),
         "y": rng.normal(size=(b, n, 2, 2)).astype(np.float32)}
    fs = np.asarray([0, 1, 2], np.int32)
    jspec = JSpec(rule=rule, f=0, pre=pre, backend="xla")
    agg = jax.tree_util.tree_map(np.asarray,
                                 j_batched(_j(x), jspec, jnp.asarray(fs)))
    spec = AggregatorSpec(rule=rule, f=0, pre=pre, backend="torch")
    internals = {}
    t_agg = batched_robust_aggregate(_t(x), spec, torch.as_tensor(fs),
                                     internals=internals)
    kappa_hat_masked(t_agg, _t(x), torch.as_tensor(n - fs), internals)
    kw = dict(n_honest=torch.as_tensor(n - fs), f=torch.as_tensor(fs),
              rule=rule, pre=pre)
    lanes = _dict(health_taps_lanes(_t(x), _t(agg), **kw))
    from_int = _dict(health_taps_lanes(_t(x), t_agg, internals=internals,
                                       **kw))
    own = _dict(health_taps_lanes(_t(x), t_agg, **kw))
    _assert_taps(from_int, own, tol=1e-6)
    for k in range(b):
        want = _np(jobs.health_taps(
            {n_: jnp.asarray(v[k]) for n_, v in x.items()},
            {n_: jnp.asarray(v[k]) for n_, v in agg.items()},
            n_honest=jnp.int32(n - fs[k]), f=jnp.int32(fs[k]), rule=rule,
            pre=pre, dyn=True).to_dict())
        _assert_taps({f_: v[k] for f_, v in lanes.items()}, want, tol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_dyn_internals_are_the_one_lane_stash(backend):
    """``robust_aggregate_dyn`` stashes its one lane's entries, those of
    ``batched_robust_aggregate`` on a lane axis of one."""
    n, f = 9, 2
    x = _t(_oracle_stack())
    spec = AggregatorSpec(rule="cwtm", f=0, pre="nnm", backend=backend)
    one, lanes = {}, {}
    robust_aggregate_dyn(x, spec, torch.tensor(f), internals=one)
    batched_robust_aggregate({k: v[None] for k, v in x.items()}, spec,
                             torch.tensor([f]), internals=lanes)
    assert sorted(one) == sorted(lanes)
    assert {"mixed", "sorted_leaves"} <= set(one) or backend == "cuda"
    for k, v in one.items():
        if isinstance(v, list):
            for a, b in zip(v, lanes[k]):
                assert torch.equal(a, b[0])
        else:
            assert torch.equal(v, lanes[k][0]) and v.shape == (n, n)


@pytest.mark.parametrize("rule,pre", [("cwtm", "nnm"), ("cwtm", None),
                                      ("gm", "nnm")])
def test_taps_on_non_finite_rows(rule, pre):
    """A NaN and an inf Byzantine row: the taps' NaN positions equal the
    reference's (its standalone masked mean spreads them)."""
    n, f = 9, 2
    x = _oracle_stack()
    x["w"][-1, 1] = np.nan
    x["b"][-2, 0] = np.inf
    agg = jax.tree_util.tree_map(np.asarray, j_aggregate(
        _j(x), JSpec(rule=rule, f=f, pre=pre, backend="xla"),
        key=jax.random.PRNGKey(0)))
    want = _np(jobs.health_taps(_j(x), _j(agg), n_honest=n - f, f=f,
                                rule=rule, pre=pre).to_dict())
    got = _dict(health_taps(_t(x), _t(agg), n_honest=n - f, f=f, rule=rule,
                            pre=pre))
    _assert_taps(got, want)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forced_small_chunk_is_bitwise(monkeypatch, backend):
    n, f = 9, 2
    rng = np.random.default_rng(5)
    x = _t({"a": rng.normal(size=(n, 37)).astype(np.float32),
            "b": rng.normal(size=(n, 3, 4)).astype(np.float32)})
    spec = AggregatorSpec(rule="cwtm", f=f, pre="nnm", backend=backend)

    def run():
        internals = {}
        agg = robust_aggregate(x, spec, internals=internals)
        tree_kappa_hat(agg, x, n - f, internals)
        return [_dict(health_taps(x, agg, n_honest=n - f, f=f, rule="cwtm",
                                  pre="nnm", internals=i)) for i in
                (internals, None)]

    whole = run()
    monkeypatch.setattr(taplib, "TAP_CHUNK", 5)
    small = run()
    for a, b in zip(whole, small):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_hier_taps_refused_and_reference_fault_pinned():
    n, f = 16, 3
    x = np.random.default_rng(0).normal(size=(n, 10)).astype(np.float32)
    # The reference: its taps break under hier (bucket means, 8 rows,
    # against the 16 workers' honest mask).
    jspec = JSpec(rule="cwtm", f=f, pre="nnm", hier=True, bucket_size=2,
                  backend="xla")
    internals = {}
    agg = j_aggregate({"x": jnp.asarray(x)}, jspec,
                      key=jax.random.PRNGKey(0), internals=internals)
    with pytest.raises(TypeError, match="broadcast"):
        jobs.health_taps({"x": jnp.asarray(x)}, agg, n_honest=n - f, f=f,
                         rule="cwtm", pre="nnm", internals=internals)
    # The port refuses it, saying why.
    spec = AggregatorSpec(rule="cwtm", f=f, pre="nnm", hier=True,
                          bucket_size=2)
    with pytest.raises(ValueError, match="hier=True"):
        robust_aggregate({"x": torch.as_tensor(x)}, spec, internals={},
                         generator=torch.Generator().manual_seed(0))
    cfg = TrainerConfig(agg=spec, byz=ByzantineConfig(f=f, attack="alie"),
                        taps=True)
    with pytest.raises(ValueError, match="bucket means"):
        build_train_step(lambda p, b: (None, {}), sgd(), cfg, constant(0.1))
    with pytest.raises(ValueError, match="hier=True"):
        FedServer(lambda p, b: (None, {}), sgd(),
                  FedConfig(n_clients=n, clients_per_round=n, f=f, agg=spec,
                            taps=True), constant(0.1), device="cpu")


# ---------------------------------------------------------------------------
# The trainer (tests/test_obs.py:155's setup: 10 workers, f = 3, ALIE 3,
# NNM + CWTM, 8 steps).
# ---------------------------------------------------------------------------

_N, _D = 10, 6
_CENTERS = np.random.default_rng(0).normal(size=(_N, _D)).astype(np.float32)


def _j_quad(centers=_CENTERS):
    c_all = jnp.asarray(centers)

    def loss_fn(params, batch):
        return 0.5 * jnp.sum((params["theta"] - c_all[batch["idx"][0]]) ** 2), {}
    return loss_fn


def _t_quad(centers=_CENTERS):
    c_all = torch.as_tensor(centers)

    def loss_fn(params, batch):
        c = c_all[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"].float() - c) ** 2), {}
    return loss_fn


def _t_train(taps, engine, attack="alie", eta=3.0, steps=8, **kw):
    cfg = TrainerConfig(algorithm="dshb",
                        agg=AggregatorSpec(rule="cwtm", f=3, pre="nnm"),
                        byz=ByzantineConfig(f=3, attack=attack, eta=eta),
                        taps=taps)
    return train_loop(_t_quad(), {"theta": torch.zeros(_D)},
                      {"idx": np.arange(_N)[:, None]}, sgd(clip=1.0), cfg,
                      constant(0.1), steps, engine=engine, **kw)


def _same_run(a, b, keys=("loss", "direction_norm", "kappa_hat")):
    assert torch.equal(a[0]["theta"], b[0]["theta"])
    for k in keys:
        assert a[1]["history"][k] == b[1]["history"][k], k


@pytest.mark.parametrize("attack,eta", [("alie", 3.0), ("alie_opt", None)])
def test_trainer_tapped_equals_untapped_and_scan_equals_loop(attack, eta):
    on = _t_train(True, "scan", attack, eta)
    off = _t_train(False, "scan", attack, eta)
    _same_run(on, off)
    assert on[1]["scan_report"]["transfers"] == \
        off[1]["scan_report"]["transfers"] == 1
    assert "taps" not in off[1]["history"]
    cols = on[1]["history"]["taps"]
    assert cols["dist_honest"].shape == (8,)
    assert cols["neighbor_count"].shape == cols["trim_frac"].shape == (8, _N)
    tf = cols["trim_frac"]
    assert (tf >= 0).all() and (tf <= 1).all()
    assert (tf.sum(axis=1) <= 6.0 + 1e-5).all()
    np.testing.assert_allclose(cols["byz_mix_mass"] + cols["honest_mix_mass"],
                               1.0, rtol=1e-6)
    loop_on = _t_train(True, "loop", attack, eta)
    _same_run(on, loop_on)
    _same_run(loop_on, _t_train(False, "loop", attack, eta))
    for k, v in cols.items():
        np.testing.assert_array_equal(v, loop_on[1]["history"]["taps"][k])


def test_trainer_taps_match_reference_loop():
    jcfg = JTrainer(algorithm="dshb",
                    agg=JSpec(rule="cwtm", f=3, pre="nnm"),
                    byz=JByz(f=3, attack="alie", eta=3.0), taps=True)
    _, j_out = j_train_loop(_j_quad(), {"theta": jnp.zeros((_D,))},
                            {"idx": np.arange(_N)[:, None]}, j_sgd(clip=1.0),
                            jcfg, j_lr(0.1), 8, engine="loop")
    _, out = _t_train(True, "scan")
    want, got = j_out["history"]["taps"], out["history"]["taps"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RUN_RTOL,
                                   atol=1e-6, err_msg=k)


def test_trainer_options_taps_and_resume_keep_tap_columns(tmp_path):
    """options.taps switches the taps on; a killed tapped run resumes
    with its tap columns bit for bit (tests/test_resilience.py:226-244);
    an untapped snapshot is refused for a tapped run."""
    kw = dict(seed=3, chunk=2, eval_every=4,
              eval_fn=lambda p: -torch.sum(p["theta"] ** 2))
    ref = _t_train(False, "scan", options=RoundOptions(taps=True), **kw)
    assert "taps" in ref[1]["history"]
    ckpt = str(tmp_path / "t")
    with pytest.raises(SimulatedPreemption):
        _t_train(True, "scan", options=RoundOptions(checkpoint=CheckpointConfig(
            dir=ckpt, sync=True, fault_plan=FaultPlan(kill_at=1))), **kw)
    out = _t_train(True, "scan", options=RoundOptions(
        checkpoint=CheckpointConfig(dir=ckpt, sync=True)), **kw)
    assert out[1]["scan_report"]["resumed_from"] == 4
    _same_run(out, ref)
    for k, v in ref[1]["history"]["taps"].items():
        np.testing.assert_array_equal(out[1]["history"]["taps"][k], v)
    plain = str(tmp_path / "p")
    _t_train(False, "scan", options=RoundOptions(checkpoint=CheckpointConfig(
        dir=plain, sync=True)), **kw)
    with pytest.raises(CheckpointError, match="taps"):
        _t_train(True, "scan", options=RoundOptions(checkpoint=CheckpointConfig(
            dir=plain, sync=True)), **kw)


# ---------------------------------------------------------------------------
# The fed server (tests/test_obs.py's fed setup; the guard's taps,
# tests/test_robustness.py:339-399).
# ---------------------------------------------------------------------------

def _t_fed(taps, engine, rounds=8, guard=None, attack="alie", eta=3.0,
           n_clients=_N + 2, m=8, f=2, centers=None, options=None):
    if centers is None:
        centers = np.random.default_rng(0).normal(
            size=(n_clients, _D)).astype(np.float32)
    cfg = FedConfig(n_clients=n_clients, clients_per_round=m, f=f,
                    agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                    client=ClientConfig(algorithm="dshb", beta=0.9),
                    taps=taps, guard=guard)
    server = FedServer(_t_quad(centers), sgd(clip=1.0), cfg, constant(0.1),
                       device="cpu")
    state = server.init_state({"theta": torch.zeros(centers.shape[1])})
    state, hist = run_rounds(server, state, _idx_batch_fn, rounds,
                             schedule=constant_attack(attack, eta), seed=0,
                             engine=engine, options=options)
    return state, hist, server


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def test_fed_tapped_equals_untapped_and_reference_loop():
    centers = np.random.default_rng(0).normal(size=(_N + 2, _D)).astype(
        np.float32)
    s_on, h_on, _ = _t_fed(True, "scan", centers=centers)
    s_off, h_off, _ = _t_fed(False, "scan", centers=centers)
    assert torch.equal(s_on["params"]["theta"], s_off["params"]["theta"])
    assert h_on.loss == h_off.loss and h_on.kappa_hat == h_off.kappa_hat
    assert all(t is None for t in h_off.taps) and h_off.tap_columns() == {}
    cols = h_on.tap_columns()
    assert cols["trim_frac"].shape == (8, 8)
    _, h_loop, _ = _t_fed(True, "loop", centers=centers)
    for k, v in cols.items():
        np.testing.assert_array_equal(v, h_loop.tap_columns()[k])
    jcfg = JFed(n_clients=_N + 2, clients_per_round=8, f=2,
                agg=JSpec(rule="cwtm", f=2, pre="nnm"),
                client=JClient(algorithm="dshb", beta=0.9), taps=True)
    jserver = JServer(_j_quad(centers), j_sgd(clip=1.0), jcfg, j_lr(0.1))
    _, j_hist = j_run_rounds(jserver, jserver.init_state(
        {"theta": jnp.zeros((_D,))}), _idx_batch_fn, 8,
        schedule=j_constant("alie", 3.0), seed=0, engine="loop")
    want = j_hist.tap_columns()
    assert set(cols) == set(want)
    for k in want:
        np.testing.assert_allclose(cols[k], want[k], rtol=RUN_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_guard_taps_split_the_quarantine(engine):
    """NaN workers under the guard: the count taps read m_byz, all on the
    Byzantine mask; a guard that never fires reads 0; no guard, no
    quarantine taps."""
    centers = np.random.default_rng(0).normal(size=(10, 12)).astype(np.float32)
    kw = dict(n_clients=10, m=10, f=2, centers=centers)
    _, hist, _ = _t_fed(True, engine, 5, guard=QuarantineConfig(),
                        attack="nan", eta=None, **kw)
    assert all(np.isfinite(hist.loss))
    for t in hist.taps:
        assert int(t["quarantined_count"]) == 2
        assert float(np.sum(t["quarantine_mask_byz"])) == 2.0
        assert float(np.sum(t["quarantine_mask_honest"])) == 0.0
    _, hist, _ = _t_fed(True, engine, 2, guard=QuarantineConfig(),
                        attack="none", eta=None, **kw)
    assert all(int(t["quarantined_count"]) == 0 for t in hist.taps)
    _, hist, _ = _t_fed(True, engine, 2, attack="none", eta=None, **kw)
    assert all("quarantined_count" not in t for t in hist.taps)


def test_guard_taps_match_reference():
    centers = np.random.default_rng(0).normal(size=(10, 12)).astype(np.float32)
    _, hist, _ = _t_fed(True, "scan", 5, guard=QuarantineConfig(),
                        attack="nan", eta=None, n_clients=10, m=10, f=2,
                        centers=centers)
    jcfg = JFed(n_clients=10, clients_per_round=10, f=2,
                agg=JSpec(rule="cwtm", f=2, pre="nnm"),
                client=JClient(algorithm="dshb", beta=0.9),
                guard=JQuarantine(), taps=True)
    jserver = JServer(_j_quad(centers), j_sgd(clip=1.0), jcfg, j_lr(0.1))
    _, j_hist = j_run_rounds(jserver, jserver.init_state(
        {"theta": jnp.zeros((12,))}), _idx_batch_fn, 5,
        schedule=j_constant("nan"), seed=0, engine="loop")
    want, got = j_hist.tap_columns(), hist.tap_columns()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RUN_RTOL, atol=1e-6,
                                   err_msg=k)


def test_run_rounds_refuses_per_call_taps_flip_and_options_merge():
    base = RoundOptions(engine="loop", chunk=4, taps=True)
    assert base.merged(chunk=2) == RoundOptions(engine="loop", chunk=2,
                                                taps=True)
    assert base.merged(taps=False).taps is False
    with pytest.raises(ValueError, match="taps/backend"):
        _t_fed(False, "scan", 2, options=RoundOptions(taps=True))
    _, hist, server = _t_fed(False, None, 2,
                             options=RoundOptions(taps=False))
    assert all(t is None for t in hist.taps)
    cfg = FedConfig(n_clients=12, clients_per_round=8, f=2,
                    agg=AggregatorSpec(rule="cwtm", f=2, pre="nnm"))
    server = FedServer(_t_quad(), sgd(), cfg, constant(0.1), device="cpu",
                       options=RoundOptions(taps=True, backend="torch"))
    assert server.cfg.taps is True and server.cfg.agg.backend == "torch"


# ---------------------------------------------------------------------------
# The fleet (tests/test_obs.py's fleet jobs) and the service.
# ---------------------------------------------------------------------------

_FLEET_OPT = sgd(clip=1.0)
_J_FLEET_OPT = j_sgd(clip=1.0)
_FC = np.random.default_rng(0).normal(size=(_N + 2, _D)).astype(np.float32)
_T_LOSS, _J_LOSS = _t_quad(_FC), _j_quad(_FC)


def _fleet_job(taps, f, seed, rounds=6, rule="cwtm"):
    cfg = FedConfig(n_clients=_N + 2, clients_per_round=8, f=f,
                    agg=AggregatorSpec(rule=rule, f=f, pre="nnm"),
                    client=ClientConfig(algorithm="dshb", beta=0.9),
                    taps=taps)
    return FleetJob(label=f"{rule}f{f}s{seed}", cfg=cfg, loss_fn=_T_LOSS,
                    optimizer=_FLEET_OPT, params={"theta": torch.zeros(_D)},
                    batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                    schedule=AttackSchedule((AttackPhase("sf", 0),)))


def _j_fleet_job(f, seed, rounds=6, rule="cwtm"):
    cfg = JFed(n_clients=_N + 2, clients_per_round=8, f=f,
               agg=JSpec(rule=rule, f=f, pre="nnm"),
               client=JClient(algorithm="dshb", beta=0.9), taps=True)
    return JJob(label=f"{rule}f{f}s{seed}", cfg=cfg, loss_fn=_J_LOSS,
                optimizer=_J_FLEET_OPT, params={"theta": jnp.zeros((_D,))},
                batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                schedule=JSchedule((JPhase("sf", 0),)))


#: Per-rule tolerance of a lane's taps against the reference's fleet:
#: cwtm lanes rtol 1e-5; GM lanes the fleet's own 1e-4
#: (tests/test_torch_fleet.py), since the lanes' GM aggregate (8 fp32
#: Weiszfeld iterations) already differs from the reference's by ~1e-5
#: on this setup (kappa_hat 1.08e-05, cos_honest 1.26e-05 relative).
FLEET_RTOL = {"cwtm": RUN_RTOL, "gm": 1e-4}


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
def test_fleet_taps_parity_demux_and_reference(rule):
    jobs_on = [_fleet_job(True, 2, 0, rule=rule), _fleet_job(True, 1, 1, rule=rule)]
    jobs_off = [_fleet_job(False, 2, 0, rule=rule),
                _fleet_job(False, 1, 1, rule=rule)]
    run_on = FleetRunner(jobs_on, device="cpu")
    run_off = FleetRunner(jobs_off, device="cpu")
    res_on, res_off = run_on.run(), run_off.run()
    assert run_on.trace_count == run_off.trace_count == 1
    for a, b in zip(res_on, res_off):
        assert torch.equal(a.state["params"]["theta"],
                           b.state["params"]["theta"])
        assert a.history.loss == b.history.loss
        assert a.history.kappa_hat == b.history.kappa_hat
        assert b.history.tap_columns() == {}
    c0, c1 = (r.history.tap_columns() for r in res_on)
    assert c0["dist_honest"].shape == (6,) and c0["mix_mass"].shape == (6, 8)
    if rule == "cwtm":
        assert (c0["trim_frac"].sum(axis=1) <= 4.0 + 1e-5).all()
        assert (c1["trim_frac"].sum(axis=1) <= 2.0 + 1e-5).all()
        assert not np.array_equal(c0["trim_frac"], c1["trim_frac"])
    else:
        assert "trim_frac" not in c0
    assert not np.array_equal(c0["neighbor_count"], c1["neighbor_count"])
    j_res = JRunner([_j_fleet_job(2, 0, rule=rule),
                     _j_fleet_job(1, 1, rule=rule)]).run()
    for got, jr in zip((c0, c1), j_res):
        want = jr.history.tap_columns()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=FLEET_RTOL[rule],
                                       atol=1e-6, err_msg=k)


def test_fleet_tapped_and_untapped_jobs_split_buckets():
    runner = FleetRunner([_fleet_job(True, 2, 0), _fleet_job(False, 2, 1)],
                         device="cpu")
    assert runner.n_buckets == 2
    runner = FleetRunner([_fleet_job(False, 2, 0), _fleet_job(False, 2, 1)],
                         options=RoundOptions(taps=True), device="cpu")
    assert runner.n_buckets == 1 and all(j.cfg.taps for j in runner.jobs)


def test_service_tapped_restore_is_bitwise(tmp_path):
    from repro_torch.serving import FleetService

    def jobs():
        return [_fleet_job(False, 2, 0, rounds=6), _fleet_job(False, 1, 1,
                                                              rounds=4)]

    ref = FleetService(chunk=2, options=RoundOptions(taps=True),
                       device="cpu")
    handles = [ref.submit(j) for j in jobs()]
    ref.run_until_idle()
    want = [h.result().history.tap_columns() for h in handles]
    assert all(w and "trim_frac" in w for w in want)
    runner = FleetRunner(jobs(), chunk=2, options=RoundOptions(taps=True),
                         device="cpu").run()
    for w, r in zip(want, runner):
        for k, v in r.history.tap_columns().items():
            np.testing.assert_array_equal(w[k], v)
    opts = RoundOptions(taps=True, checkpoint=CheckpointConfig(
        dir=str(tmp_path), sync=True))
    svc = FleetService(chunk=2, options=opts, device="cpu")
    ids = [svc.submit(j).job_id for j in jobs()]
    svc.step()
    restored = FleetService.restore(opts.checkpoint, jobs=dict(zip(ids, jobs())),
                                    device="cpu")
    assert restored.options.taps is True
    restored.run_until_idle()
    for w, i in zip(want, ids):
        got = restored.handle_of(i).result().history.tap_columns()
        assert set(got) == set(w)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])


def test_health_taps_fields_and_metric_columns():
    """The taps keep the reference's field order; they ride the metrics
    as ``taps.<field>`` columns, and ``metric_columns`` expands a
    ``HealthTaps`` value the same way (tests/test_resilience.py's
    metric-column case)."""
    from repro_torch.resilience.experiment import metric_columns
    t = taplib.HealthTaps(dist_honest=torch.tensor(1.0),
                          cos_honest=torch.tensor(0.5))
    assert list(t.to_dict()) == ["dist_honest", "cos_honest"]
    flat = taplib.tap_metrics(t)
    assert flat == {"taps.dist_honest": t.dist_honest,
                    "taps.cos_honest": t.cos_honest}
    assert taplib.tap_columns(dict(flat, loss=1.0)) == t.to_dict()
    cols = metric_columns([{"loss": torch.tensor(2.0), "taps": t}] * 3)
    assert sorted(cols) == ["loss", "taps.cos_honest", "taps.dist_honest"]
    assert cols["taps.cos_honest"].shape == (3,)
    assert sorted(metric_columns({"taps": t})) == ["taps.cos_honest",
                                                   "taps.dist_honest"]
