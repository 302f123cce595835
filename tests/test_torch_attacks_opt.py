"""The port's attacks against the reference's (``repro.core.attacks``):
the dense family functions and ``apply_attack``, and the optimized
ALIE / FOE eta searches (``alie_opt`` / ``foe_opt``) on every surface.

* Dense families (alie, foe, sf, mimic, nan, inf) and ``apply_attack``
  within 1e-6 of the largest magnitude, NaN / inf positions equal; the
  dense ``aggregate`` with ``pre="bucketing"`` (the reference's
  permutation fed in) within 1e-5.
* ``alie_opt`` / ``foe_opt`` on the dense API and ``apply_attack_tree``
  under NNM + CWTM, NNM + GM, bucketing + CWTM and hier + NNM + CWTM,
  the reference's permutation fed in as ``perm``: the chosen eta (read
  back from the Byzantine rows, snapped to the grid) is EQUAL, the
  attacked stack within 1e-5 of its largest magnitude.
* ``attack_flat_`` in place equals ``apply_attack_tree`` bit for bit, and
  records the eta it wrote.
* Tie rules: a constant closure (every damage equal) picks index 0, a NaN
  damage the first NaN, as ``jnp.argmax`` does on the same damages.
* A missing closure raises ``ValueError`` with the reference's wording.
* The trainer step (quickstart MLP, 3 steps) against the reference's
  ``build_train_step`` at ``tests/test_torch_trainer.py``'s tolerances;
  ``FedServer.round_fn("foe_opt")`` against the reference's round at
  ``tests/test_torch_fed.py``'s; ``run_rounds`` with an ``alie_opt``
  schedule, scan and loop (equal bit for bit), against the reference's
  LOOP engine at ``tests/test_torch_rounds.py``'s (the reference's own
  scan-vs-loop claim fails on an ``_opt`` schedule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatt
from repro.core.robust import robust_aggregate as j_agg
from repro.core.types import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import FedServer as JServer
from repro.fed import RotatingByzantine as JRot
from repro.fed import constant_attack as j_constant_attack
from repro.fed import run_rounds as j_run_rounds
from repro.fed.scenarios import _mlp_init as j_mlp_init
from repro.fed.scenarios import _mlp_loss as j_mlp_loss
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_lr
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro_torch.core import attacks as tatt
from repro_torch.core.robust import robust_aggregate as t_agg
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.data import build_heterogeneous, make_classification
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, RotatingByzantine, cohort_batch_fn,
    constant_attack, run_rounds, sample_cohort,
)
from repro_torch.fed.scenarios import _mlp_loss as t_mlp_loss
from repro_torch.interop import (
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy,
)
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.training import ByzantineConfig, TrainerConfig
from repro_torch.training import build_train_step, init_state
from repro_torch.training.trainer import to_device

torch.set_num_threads(2)

N, F = 12, 3
GRID = np.asarray(tatt._ETA_GRID, np.float32)
SPECS = {
    "nnm+cwtm": dict(rule="cwtm", pre="nnm"),
    "nnm+gm": dict(rule="gm", pre="nnm"),
    "bucketing+cwtm": dict(rule="cwtm", pre="bucketing"),
    "hier+nnm+cwtm": dict(rule="cwtm", pre="nnm", hier=True, bucket_size=2),
}


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    shift = rng.normal(size=(n, 1, 1)).astype(np.float32)
    return {"w": (rng.normal(size=(n, 4, 5)) + shift).astype(np.float32),
            "b": (rng.normal(size=(n, 7)) * 0.3).astype(np.float32)}


def _flat_np(tree):
    return np.concatenate([np.asarray(tree[k], np.float32).reshape(
        tree["b"].shape[0], -1) for k in sorted(tree)], axis=1)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.nanmax(np.abs(np.where(np.isfinite(want), want,
                                                0)))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _eta_of(base, stack, f):
    """The grid eta a stack's Byzantine rows were built with (alie: byz =
    mean + eta std; foe: byz = (1 - eta) mean), snapped to the grid."""
    h, byz = stack[:-f].astype(np.float64), stack[-1].astype(np.float64)
    mean, std = h.mean(0), h.std(0)
    if base == "alie":
        ok = std > 1e-3
        est = np.median((byz[ok] - mean[ok]) / std[ok])
    else:
        ok = np.abs(mean) > 1e-3
        est = np.median(1.0 - byz[ok] / mean[ok])
    return float(GRID[np.argmin(np.abs(GRID - est))])


def _perm(key, n=N):
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


# ---------------------------------------------------------------------------
# The dense families.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("alie", {}), ("alie", {"eta": 3.0}), ("foe", {}), ("foe", {"eta": 0.5}),
    ("sf", {}), ("mimic", {}), ("mimic", {"target": 2}), ("nan", {}),
    ("inf", {}), ("none", {}), ("lf", {})])
def test_dense_family_and_apply_attack_equal_reference(name, kw):
    honest = _flat_np(_tree(1))[:N - F]
    want = np.asarray(jatt.apply_attack(name, jnp.asarray(honest), F, **kw))
    got = tatt.apply_attack(name, torch.from_numpy(honest), F, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    _close(np.where(fin, got.numpy(), 0), np.where(fin, want, 0), 1e-6)
    if name in tatt.ATTACKS:
        direct = tatt.ATTACKS[name](torch.from_numpy(honest), F, **kw)
        np.testing.assert_array_equal(direct.numpy(), got.numpy()[N - F:])


@pytest.mark.parametrize("rule", ["cwtm", "gm", "krum"])
def test_dense_aggregate_with_bucketing_equals_reference(rule):
    """The dense pipeline's randomized baseline, on the attacked stack,
    with the reference's permutation fed in."""
    from repro.core.aggregators import aggregate as j_aggregate
    from repro_torch.core.aggregators import aggregate as t_aggregate
    honest = _flat_np(_tree(2))[:N - F]
    x = np.asarray(jatt.apply_attack("alie", jnp.asarray(honest), F))
    key = jax.random.PRNGKey(4)
    want = np.asarray(j_aggregate(jnp.asarray(x), JSpec(rule=rule, f=F,
                                                        pre="bucketing"),
                                  key=key))
    got = t_aggregate(torch.from_numpy(x), TSpec(rule=rule, f=F,
                                                 pre="bucketing"),
                      perm=_perm(key))
    _close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="Generator or a perm"):
        t_aggregate(torch.from_numpy(x), TSpec(rule=rule, f=F,
                                               pre="bucketing"))


def test_dense_unknown_attack_raises_as_reference():
    h = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="unknown attack"):
        tatt.apply_attack("wat", h, 1)
    assert tatt.apply_attack("alie", h, 0) is h


# ---------------------------------------------------------------------------
# alie_opt / foe_opt: dense API and apply_attack_tree.
# ---------------------------------------------------------------------------

def _closures(spec_kw, seed, backend="torch"):
    key = jax.random.PRNGKey(seed)
    jspec = JSpec(f=F, **spec_kw)
    tspec = TSpec(f=F, backend=backend, **spec_kw)
    perm = _perm(key)
    return (lambda s: j_agg(s, jspec, key=key)), \
        (lambda s: t_agg(s, tspec, perm=perm))


@pytest.mark.parametrize("case", sorted(SPECS))
@pytest.mark.parametrize("name", ["alie_opt", "foe_opt"])
def test_opt_dense_equals_reference(case, name):
    honest = _flat_np(_tree(3))[:N - F]
    j_close, t_close = _closures(SPECS[case], 5)
    want = np.asarray(jatt.apply_attack(name, jnp.asarray(honest), F,
                                        agg_closure=j_close))
    got = tatt.apply_attack(name, torch.from_numpy(honest), F,
                            agg_closure=t_close).numpy()
    base = name.removesuffix("_opt")
    assert _eta_of(base, got, F) == _eta_of(base, want, F)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("case", sorted(SPECS))
@pytest.mark.parametrize("name", ["alie_opt", "foe_opt"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_opt_tree_equals_reference_and_flat_bitwise(case, name, backend):
    tree = _tree(7)
    j_close, t_close = _closures(SPECS[case], 9, backend=backend)
    want = jatt.apply_attack_tree(
        name, {k: jnp.asarray(v) for k, v in tree.items()}, F,
        agg_closure=j_close)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = tatt.apply_attack_tree(name, ttree, F, agg_closure=t_close)
    base = name.removesuffix("_opt")
    want_flat = _flat_np({k: np.asarray(v) for k, v in want.items()})
    got_flat = _flat_np({k: v.numpy() for k, v in got.items()})
    assert _eta_of(base, got_flat, F) == _eta_of(base, want_flat, F)
    _close(got_flat, want_flat, 1e-5)
    # The in-place flat form: the same stack bit for bit, one buffer.
    flat, layout = kdispatch.flatten_worker_stack(ttree)
    flat = flat.clone()
    segs = [(off, size) for off, size, _ in layout.segments]
    internals = {}
    out = tatt.attack_flat_(
        name, flat, F, segments=segs, internals=internals,
        agg_closure=lambda fl: t_close(kdispatch.stack_views(fl, layout)))
    assert out is flat
    assert torch.equal(flat, torch.from_numpy(got_flat))
    assert internals["eta"].shape == () and internals["damages"].shape == (12,)
    assert float(internals["eta"]) == _eta_of(base, got_flat, F)


def test_opt_tie_rules_match_jnp_argmax():
    tree = {k: torch.from_numpy(v) for k, v in _tree(11).items()}
    flat, layout = kdispatch.flatten_worker_stack(tree)
    segs = [(off, size) for off, size, _ in layout.segments]
    # A constant closure: every damage equal -> the first eta.
    internals = {}
    tatt.attack_flat_("alie_opt", flat.clone(), F, segments=segs,
                      agg_closure=lambda fl: kdispatch.unflatten_aggregate(
                          torch.zeros(fl.shape[1]), layout),
                      internals=internals)
    d = internals["damages"].numpy()
    assert np.all(d == d[0])
    assert float(internals["eta"]) == GRID[0] == GRID[int(jnp.argmax(d))]
    # NaN damages count as the largest: the first NaN wins.
    calls = []

    def spiky(fl):
        calls.append(1)
        bad = len(calls) in (4, 7)
        return kdispatch.unflatten_aggregate(torch.full(
            (fl.shape[1],), float("nan") if bad else 0.0), layout)

    internals = {}
    tatt.attack_flat_("foe_opt", flat.clone(), F, segments=segs,
                      agg_closure=spiky, internals=internals)
    d = internals["damages"].numpy()
    assert np.isnan(d[3]) and np.isnan(d[6])
    assert int(jnp.argmax(jnp.asarray(d))) == 3 == int(np.argmax(
        np.where(np.isnan(d), np.inf, d)))
    assert float(internals["eta"]) == GRID[3]


def test_missing_closure_raises_reference_wording():
    h = np.ones((4, 3), np.float32)
    for name in ("alie_opt", "foe_opt"):
        with pytest.raises(ValueError) as j_err:
            jatt.apply_attack(name, jnp.asarray(h), 1)
        for call in (
                lambda: tatt.apply_attack(name, torch.from_numpy(h), 1),
                lambda: tatt.apply_attack_tree(name, {"a": torch.ones(4, 3)},
                                               1),
                lambda: tatt.attack_flat_(name, torch.ones(4, 3), 1),
                lambda: tatt.apply_attack_scan((name,), 0,
                                               {"a": torch.ones(4, 3)}, 1)):
            with pytest.raises(ValueError) as t_err:
                call()
            assert str(t_err.value) == str(j_err.value)


# ---------------------------------------------------------------------------
# The trainer step.
# ---------------------------------------------------------------------------

def _mlp_task(n_workers=8, steps=3):
    x, y = make_classification(6000, 10, 32, seed=0)
    from repro.data import build_heterogeneous as j_hetero
    from repro.data import worker_batches as j_batches
    ds = j_hetero({"x": x[:4000], "y": y[:4000]}, "y", n_workers, alpha=0.1)
    it = j_batches(ds, 32, seed=1)
    batches = [next(it) for _ in range(steps)]
    params = jax.tree_util.tree_map(np.asarray,
                                    j_mlp_init(jax.random.PRNGKey(0), 32))
    return params, batches


@pytest.mark.parametrize("rule,pre,attack", [
    ("cwtm", "nnm", "alie_opt"), ("gm", "nnm", "foe_opt"),
    ("cwtm", "bucketing", "alie_opt")])
def test_trainer_step_opt_equals_reference(rule, pre, attack):
    params_np, batches = _mlp_task()
    f, n = 2, 8
    jcfg = JCfg(algorithm="dshb", beta=0.9, agg=JSpec(rule=rule, f=f, pre=pre),
                byz=JByz(f=f, attack=attack))
    tcfg = TrainerConfig(algorithm="dshb", beta=0.9,
                         agg=TSpec(rule=rule, f=f, pre=pre),
                         byz=ByzantineConfig(f=f, attack=attack))
    jopt, topt = j_sgd(clip=2.0), sgd(clip=2.0)
    jstep = jax.jit(j_build_step(j_mlp_loss, jopt, jcfg, j_lr(0.3)))
    tstep = build_train_step(t_mlp_loss, topt, tcfg, constant(0.3))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, params_np),
                          jopt, n, jcfg)
    cpu = torch.device("cpu")
    tstate = init_state(params_from_numpy(params_np, cpu), topt, n, tcfg)
    key = jax.random.PRNGKey(0)
    for b in batches:
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, b, sub)
        perm = _perm(jax.random.split(sub)[0], n)
        internals = {}
        tstate, tm = tstep(tstate, to_device(b, cpu), internals, perm=perm)
        assert internals["eta"].shape == ()
        base = attack.removesuffix("_opt")
        assert float(internals["eta"]) == _eta_of(
            base, internals["attacked"].numpy(), f)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["direction_norm"]) == pytest.approx(
            float(jm["direction_norm"]), rel=1e-4)
        assert float(tm["kappa_hat"]) == pytest.approx(
            float(jm["kappa_hat"]), rel=1e-4, abs=1e-4)
    jp = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, jstate["params"]))
    tp = jax.tree_util.tree_leaves(params_to_numpy(tstate["params"]))
    scale = max(float(np.abs(b).max()) for b in jp)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def test_trainer_opt_consumes_the_generator_as_its_base_attack():
    """One permutation draw a step, shared by the 13 aggregates: the
    generator ends where an alie step leaves it."""
    params_np, batches = _mlp_task(steps=1)
    cpu = torch.device("cpu")
    states = []
    for attack in ("alie", "alie_opt"):
        cfg = TrainerConfig(agg=TSpec(rule="cwtm", f=2, pre="nnm", hier=True,
                                      bucket_size=2),
                            byz=ByzantineConfig(f=2, attack=attack))
        step = build_train_step(t_mlp_loss, sgd(clip=2.0), cfg, constant(0.3))
        gen = torch.Generator().manual_seed(3)
        step(init_state(params_from_numpy(params_np, cpu), sgd(clip=2.0), 8,
                        cfg), to_device(batches[0], cpu), generator=gen)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])


# ---------------------------------------------------------------------------
# The fed server: one round, and run_rounds.
# ---------------------------------------------------------------------------

def test_fed_round_foe_opt_equals_reference():
    n_clients, m, f, m_byz = 12, 8, 3, 2
    spec = dict(rule="cwtm", f=f, pre="nnm")
    jserver = JServer(j_mlp_loss, j_sgd(clip=2.0),
                      JFed(n_clients=n_clients, clients_per_round=m, f=f,
                           agg=JSpec(**spec)), j_lr(0.2))
    tserver = FedServer(t_mlp_loss, sgd(clip=2.0),
                        FedConfig(n_clients=n_clients, clients_per_round=m,
                                  f=f, agg=TSpec(**spec)),
                        constant(0.2), device="cpu")
    x, y = make_classification(1200, 10, 48, noise=1.6, seed=0)
    ds = build_heterogeneous({"x": x, "y": y}, "y", n_clients, alpha=0.3,
                             seed=0)
    rng = np.random.default_rng(4)
    cohort = sample_cohort(rng, n_clients, m,
                           np.arange(n_clients - f, n_clients), m_byz)
    batch = cohort_batch_fn(ds, 16, 0)(cohort, 0, rng)
    params = jax.tree_util.tree_map(np.asarray,
                                    j_mlp_init(jax.random.PRNGKey(1), 48))
    mom_rng = np.random.default_rng(1)
    start = {"params": params, "opt_state": (), "step": np.int32(3),
             "momentum": [(0.05 * mom_rng.normal(size=(n_clients,) + p.shape)
                           ).astype(np.float32)
                          for p in jax.tree_util.tree_leaves(params)]}
    key = jax.random.PRNGKey(11)
    j_state, j_m = jserver.round_fn("foe_opt", m_byz)(
        jax.tree_util.tree_map(jnp.asarray, start), batch,
        jnp.asarray(cohort), jnp.float32(0.0), key)
    t_state, t_m = tserver.round_fn("foe_opt", m_byz)(
        state_from_numpy(start), batch, cohort, 0.0,
        perm=_perm(jax.random.split(key)[0], m))
    for k in ("loss", "direction_norm", "kappa_hat"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = state_to_numpy(t_state)
    for name in ("params", "momentum"):
        for a, b in zip(jax.tree_util.tree_leaves(got[name]),
                        jax.tree_util.tree_leaves(j_state[name])):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert np.max(np.abs(a - b)) <= 1e-4 * max(np.max(np.abs(b)),
                                                       1e-30)


def _quad(centers, lib):
    if lib == "jax":
        c_all = jnp.asarray(centers)
        return lambda p, b: (0.5 * jnp.sum((p["theta"] - c_all[b["idx"][0]])
                                           ** 2), {})
    c_all = torch.as_tensor(centers)
    return lambda p, b: (0.5 * torch.sum(
        (p["theta"] - c_all[b["idx"].long()][0]) ** 2), {})


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def test_run_rounds_alie_opt_scan_and_loop_against_reference_loop():
    n_clients, m, f, d, rounds = 10, 6, 2, 5, 8
    centers = np.random.default_rng(0).normal(size=(n_clients, d)).astype(
        np.float32)
    jcfg = JFed(n_clients=n_clients, clients_per_round=m, f=f,
                agg=JSpec(rule="cwtm", f=f, pre="nnm"),
                client=JClient(local_steps=0, algorithm="dshb"))
    jserver = JServer(_quad(centers, "jax"), j_sgd(clip=1.0), jcfg, j_lr(0.1))
    j_state, j_h = j_run_rounds(
        jserver, jserver.init_state({"theta": jnp.zeros((d,), jnp.float32)}),
        _idx_batch_fn, rounds, schedule=j_constant_attack("alie_opt"),
        byz_identity=JRot(n_clients, f, period=3), seed=7, engine="loop")
    out = {}
    for engine in ("scan", "loop"):
        cfg = FedConfig(n_clients=n_clients, clients_per_round=m, f=f,
                        agg=TSpec(rule="cwtm", f=f, pre="nnm"),
                        client=ClientConfig(local_steps=0, algorithm="dshb"))
        server = FedServer(_quad(centers, "torch"), sgd(clip=1.0), cfg,
                           constant(0.1), device="cpu")
        out[engine] = run_rounds(
            server, server.init_state({"theta": torch.zeros(d)}),
            _idx_batch_fn, rounds, schedule=constant_attack("alie_opt"),
            byz_identity=RotatingByzantine(n_clients, f, period=3), seed=7,
            engine=engine, chunk=3)
    (s_s, h_s), (s_l, h_l) = out["scan"], out["loop"]
    assert torch.equal(s_s["params"]["theta"], s_l["params"]["theta"])
    assert h_s.loss == h_l.loss and h_s.direction_norm == h_l.direction_norm
    assert h_s.attack == j_h.attack
    for a, b in zip(h_s.cohorts, j_h.cohorts):
        np.testing.assert_array_equal(a, b)
    for k in ("loss", "direction_norm", "kappa_hat"):
        np.testing.assert_allclose(getattr(h_s, k), getattr(j_h, k),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want = np.asarray(j_state["params"]["theta"])
    assert np.max(np.abs(s_s["params"]["theta"].numpy() - want)) <= \
        1e-4 * np.max(np.abs(want))
