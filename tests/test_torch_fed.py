"""The port's federated server and scenario registry against the
reference (``repro.fed``).

* One ``FedServer`` round from the same state, batch, cohort and eta
  equals the reference's round: the MLP task, 8 of 12 clients, m_byz = 2,
  a non-zero momentum; attacks none / alie / sf / mimic / lf, rules
  cwtm | nnm, gm | nnm, autogm | nnm (5e-4: AutoGM is ill-conditioned in
  fp32, ROADMAP queue 3) and cwtm | None, local_steps 0 and 2, D-SHB and
  D-GD, both client passes; pre="bucketing" and feature poisoning with
  the reference's own draws fed in (``perm=``, ``noise=``).
* A full-participation round with local_steps = 0 equals the port's
  trainer step within 1e-6 (the reference's tests/test_fed.py contract at
  fp32 tolerance).
* ``run_scenario`` for every registered built-in at 3 rounds, from the
  reference's init: equal cohorts, metrics within tolerance, test
  accuracy within 2 of the 3000 samples.  ``poison_feature`` draws its
  noise from the port's generator (the reference from threefry), so its
  run is held to equal cohorts and finite metrics only; its round math is
  held above with the reference's noise.
* The registry equals the reference's field for field.

Tolerances, unless stated: rtol 1e-4, atol 1e-6 on loss, direction_norm
and kappa_hat; parameters and momentum within 1e-4 of their largest
magnitude (tests/test_torch_fleet.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import FedServer as JServer
from repro.fed import PoisonConfig as JPoison
from repro.fed import SCENARIOS as J_SCENARIOS
from repro.fed import run_scenario as j_run_scenario
from repro.fed.scenarios import _mlp_init as j_init
from repro.fed.scenarios import _mlp_loss as j_loss
from repro.fed.scenarios import build_scenario as j_build
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_lr
from repro_torch.core.types import AggregatorSpec
from repro_torch.data import build_heterogeneous, make_classification
from repro_torch.fed import (
    SCENARIOS, ClientConfig, FedConfig, FedServer, PoisonConfig,
    build_scenario, cohort_batch_fn, list_scenarios, run_scenario,
    sample_cohort,
)
from repro_torch.fed import server as fed_server
from repro_torch.fed.scenarios import _mlp_loss
from repro_torch.interop import (
    mlp_params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy,
)
from repro_torch.launch import scenarios as launch_scenarios
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.training import ByzantineConfig, TrainerConfig
from repro_torch.training import build_train_step, init_state

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-6
N_CLIENTS, M, F = 12, 8, 3          # m_byz = ceil(3 * 8 / 12) = 2


def _task(local_steps, seed=0):
    x, y = make_classification(1200, 10, 48, noise=1.6, seed=seed)
    ds = build_heterogeneous({"x": x, "y": y}, "y", N_CLIENTS, alpha=0.3,
                             seed=seed)
    return cohort_batch_fn(ds, 16, local_steps)


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=ATOL, err_msg=what)


def _tree_close(got, want, tol=1e-4):
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-30)


def _start_state(algorithm, seed=1):
    """The reference's MLP init and a non-zero momentum, as numpy."""
    params = jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(seed), 48))
    rng = np.random.default_rng(seed)
    state = {"params": params, "opt_state": (), "step": np.int32(3)}
    if algorithm == "dshb":
        state["momentum"] = [
            (0.05 * rng.normal(size=(N_CLIENTS,) + p.shape)).astype(np.float32)
            for p in jax.tree_util.tree_leaves(params)]
    return state


_ROUND_CASES = [
    # (attack, eta, rule, pre, local_steps, algorithm, client pass, rtol)
    ("alie", 8.0, "cwtm", "nnm", 0, "dshb", "vmap", RTOL),
    ("alie", 8.0, "cwtm", "nnm", 0, "dshb", "loop", RTOL),
    ("none", None, "cwtm", "nnm", 0, "dshb", "vmap", RTOL),
    ("sf", None, "gm", "nnm", 0, "dshb", "vmap", RTOL),
    ("mimic", None, "cwtm", "nnm", 2, "dshb", "loop", RTOL),
    ("mimic", None, "gm", "nnm", 2, "dshb", "vmap", RTOL),
    ("lf", None, "cwtm", None, 0, "dgd", "vmap", RTOL),
    ("alie", 3.0, "autogm", "nnm", 0, "dshb", "vmap", 5e-4),
    ("sf", None, "cwtm", None, 2, "dgd", "loop", RTOL),
    ("alie", 4.0, "cwtm", "bucketing", 0, "dshb", "vmap", RTOL),
    ("foe", 4.0, "gm", "bucketing", 2, "dshb", "vmap", RTOL),
]


@pytest.mark.parametrize("case", _ROUND_CASES, ids=[
    "-".join(str(v) for v in c[:7]) for c in _ROUND_CASES])
def test_single_round_equals_reference(case, monkeypatch):
    attack, eta, rule, pre, local_steps, algorithm, client_pass, rtol = case
    if client_pass == "loop":
        monkeypatch.setattr(fed_server, "VMAP_ELEMS", 0)
    bucket = {"bucket_size": 2} if pre == "bucketing" else {}
    jcfg = JFed(n_clients=N_CLIENTS, clients_per_round=M, f=F,
                agg=JSpec(rule=rule, f=F, pre=pre, **bucket),
                client=JClient(local_steps=local_steps, local_lr=0.05,
                               algorithm=algorithm))
    tcfg = FedConfig(n_clients=N_CLIENTS, clients_per_round=M, f=F,
                     agg=AggregatorSpec(rule=rule, f=F, pre=pre, **bucket),
                     client=ClientConfig(local_steps=local_steps,
                                         local_lr=0.05, algorithm=algorithm))
    jserver = JServer(j_loss, j_sgd(clip=2.0), jcfg, j_lr(0.2))
    tserver = FedServer(_mlp_loss, sgd(clip=2.0), tcfg, constant(0.2),
                        device="cpu")
    m_byz = 2
    rng = np.random.default_rng(4)
    cohort = sample_cohort(rng, N_CLIENTS, M,
                           np.arange(N_CLIENTS - F, N_CLIENTS), m_byz)
    batch = _task(local_steps)(cohort, m_byz if attack == "lf" else 0, rng)
    start = _start_state(algorithm)
    key = jax.random.PRNGKey(11)
    j_state, j_m = jserver.round_fn(attack, m_byz)(
        jax.tree_util.tree_map(jnp.asarray, start), batch,
        jnp.asarray(cohort), jnp.float32(0.0 if eta is None else eta), key)
    perm = torch.from_numpy(np.array(jax.random.permutation(
        jax.random.split(key)[0], M)))
    t_state, t_m = tserver.round_fn(attack, m_byz)(
        state_from_numpy(start), batch, cohort,
        0.0 if eta is None else eta, perm=perm)
    for k in ("loss", "direction_norm", "kappa_hat"):
        _close(float(t_m[k]), float(j_m[k]), k, rtol)
    assert t_m["lr"] == float(j_m["lr"])
    got = state_to_numpy(t_state)
    _tree_close(got["params"], j_state["params"], max(rtol, 1e-4))
    if algorithm == "dshb":
        _tree_close(got["momentum"], j_state["momentum"])
    assert int(got["step"]) == int(j_state["step"]) == 4


def test_feature_poisoned_round_with_reference_noise_equals_reference():
    pz = dict(kind="feature", rate=0.5, strength=2.0)
    spec = dict(rule="autogm", f=F, pre="nnm")
    jserver = JServer(j_loss, j_sgd(clip=2.0),
                      JFed(n_clients=N_CLIENTS, clients_per_round=M, f=F,
                           agg=JSpec(**spec), poison=JPoison(**pz)),
                      j_lr(0.2))
    tserver = FedServer(_mlp_loss, sgd(clip=2.0),
                        FedConfig(n_clients=N_CLIENTS, clients_per_round=M,
                                  f=F, agg=AggregatorSpec(**spec),
                                  poison=PoisonConfig(**pz)),
                        constant(0.2), device="cpu")
    rng = np.random.default_rng(5)
    cohort = sample_cohort(rng, N_CLIENTS, M,
                           np.arange(N_CLIENTS - F, N_CLIENTS), 2)
    batch = _task(0)(cohort, 0, rng)
    start = _start_state("dshb")
    key = jax.random.PRNGKey(12)
    j_state, j_m = jserver.round_fn("none", 2)(
        jax.tree_util.tree_map(jnp.asarray, start), batch,
        jnp.asarray(cohort), jnp.float32(0.0), key)
    # server.py's round_fn: the noise key is fold_in(agg_key, 7).
    noise = np.array(jax.random.normal(
        jax.random.fold_in(jax.random.split(key)[0], 7), batch["x"].shape,
        jnp.float32))
    t_state, t_m = tserver.round_fn("none", 2)(
        state_from_numpy(start), batch, cohort,
        noise=torch.from_numpy(noise))
    for k in ("loss", "direction_norm", "kappa_hat"):
        _close(float(t_m[k]), float(j_m[k]), k, 5e-4)
    _tree_close(state_to_numpy(t_state)["params"], j_state["params"], 5e-4)


@pytest.mark.parametrize("attack,eta", [("alie", 3.0), ("sf", None),
                                        ("none", None)])
@pytest.mark.parametrize("client_pass", ["loop", "vmap"])
def test_full_participation_round_matches_trainer_step(attack, eta,
                                                        client_pass,
                                                        monkeypatch):
    if client_pass == "loop":
        monkeypatch.setattr(fed_server, "VMAP_ELEMS", 0)
    n, f, d, rounds = 8, 2, 6, 3
    centers = torch.as_tensor(np.random.default_rng(0).normal(
        size=(n, d)).astype(np.float32))

    def loss_fn(params, batch):
        c = centers[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"] - c) ** 2), {}

    agg = AggregatorSpec(rule="cwtm", f=f, pre="nnm")
    tcfg = TrainerConfig(algorithm="dshb", beta=0.9, agg=agg,
                         byz=ByzantineConfig(f=f, attack=attack, eta=eta))
    trainer_step = build_train_step(loss_fn, sgd(clip=1.0), tcfg,
                                    constant(0.1))
    server = FedServer(loss_fn, sgd(clip=1.0),
                       FedConfig(n_clients=n, clients_per_round=n, f=f,
                                 agg=agg, client=ClientConfig(beta=0.9)),
                       constant(0.1), device="cpu")
    fed_round = server.round_fn(attack, f)
    params = {"theta": torch.zeros(d)}
    t_state = init_state(params, sgd(clip=1.0), n, tcfg)
    f_state = server.init_state(params)
    idx = np.arange(n, dtype=np.int32)
    t_batch = {"idx": torch.as_tensor(idx[:, None])}
    f_batch = {"idx": idx[:, None, None]}
    for _ in range(rounds):
        t_state, t_m = trainer_step(t_state, t_batch)
        f_state, f_m = fed_round(f_state, f_batch, idx,
                                 0.0 if eta is None else eta)
        for a, b in ((f_state["params"]["theta"], t_state["params"]["theta"]),
                     (f_state["momentum"], t_state["momentum"])):
            assert torch.allclose(a, b, rtol=0, atol=1e-6)
        for k in ("loss", "direction_norm", "kappa_hat"):
            assert abs(float(f_m[k]) - float(t_m[k])) <= 1e-6 * max(
                1.0, abs(float(t_m[k]))), k
    assert f_state["step"] == t_state["step"] == rounds


# ---------------------------------------------------------------------------
# The registry and run_scenario.
# ---------------------------------------------------------------------------

def _fields(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_fields(v) for v in obj]
    return obj


def test_registry_equals_reference_field_for_field():
    assert list_scenarios() == sorted(J_SCENARIOS)
    for name, sc in SCENARIOS.items():
        assert _fields(sc) == _fields(J_SCENARIOS[name]), name
        assert _fields(sc.fed_config()) == \
            _fields(J_SCENARIOS[name].fed_config()), name


@pytest.mark.parametrize("name", sorted(J_SCENARIOS))
def test_run_scenario_equals_reference(name):
    rounds = 3
    j_out = j_run_scenario(name, rounds=rounds, seed=0)
    init = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(0),
                                                      48))
    t_out = run_scenario(name, rounds=rounds, seed=0, device="cpu",
                         params=mlp_params_from_numpy(init))
    jh, th = j_out["history"], t_out["history"]
    assert th.rounds == jh.rounds == rounds
    for a, b in zip(th.cohorts, jh.cohorts):
        np.testing.assert_array_equal(a, b)
    assert th.attack == jh.attack and th.eta == jh.eta
    assert th.m_byz == jh.m_byz and th.f_round == jh.f_round
    assert th.lr == jh.lr
    if name == "poison_feature":
        assert np.isfinite(th.loss).all() and np.isfinite(
            th.direction_norm).all() and np.isfinite(th.kappa_hat).all()
        return
    _close(th.loss, jh.loss, "loss")
    _close(th.direction_norm, jh.direction_norm, "direction_norm")
    _close(th.kappa_hat, jh.kappa_hat, "kappa_hat")
    _tree_close(params_to_numpy(t_out["state"]["params"]),
                j_out["state"]["params"])
    assert abs(t_out["accuracy"] - j_out["accuracy"]) <= 2 / 3000 + 1e-9


def test_quarantine_counts_equal_reference():
    """faulty_nan_quarantine, round by round: the same rows quarantined."""
    sc = SCENARIOS["faulty_nan_quarantine"]
    jserver, jstate, jbatch_fn, _ = j_build(J_SCENARIOS[sc.name], seed=0)
    tserver, tstate, tbatch_fn, _ = build_scenario(
        sc, seed=0, device="cpu",
        params=mlp_params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jstate["params"])))
    m_byz = 4
    j_round, t_round = jserver.round_fn("nan", m_byz), \
        tserver.round_fn("nan", m_byz)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    for r in range(3):
        cohort = sample_cohort(rng, sc.n_clients, sc.clients_per_round,
                               sc.byz_identity().ids(r), m_byz)
        batch = jbatch_fn(cohort, 0, rng)
        key, sub = jax.random.split(key)
        jstate, jm = j_round(jstate, batch, jnp.asarray(cohort),
                             jnp.float32(0.0), sub)
        tstate, tm = t_round(tstate, batch, cohort)
        assert int(tm["quarantined_count"]) == \
            int(jm["quarantined_count"]) == m_byz
        _close(float(tm["loss"]), float(jm["loss"]), "loss")
        _close(float(tm["direction_norm"]), float(jm["direction_norm"]),
               "direction_norm")


def test_launch_scenarios_runs_demo_and_ceiling(capsys):
    outs = launch_scenarios.main(["--device", "cpu", "--rounds", "2"])
    assert list(outs) == ["iid_baseline", "labelskew_alie_partial",
                          "mimic_rotating", "dirichlet_localsgd"]
    for name, out in outs.items():
        assert out["history"].rounds == 2
        assert np.isfinite(out["history"].loss).all(), name
    text = capsys.readouterr().out
    assert text.startswith("ceiling:\niid_baseline ")
    assert "baseline=" in text and "worst-scenario gap=" in text
    assert launch_scenarios.main(["--list"]) == {}
    assert "poison_feature" in capsys.readouterr().out
