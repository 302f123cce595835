"""The port's scheduled attack, data poisoning and quarantine guard against
the reference (``repro.core.attacks.apply_attack_scan``,
``repro.fed.poison``, ``repro.robustness.guard``).

Inputs are drawn once with numpy and fed to both packages.  Tolerances:
the attacked stacks within 1e-6 of the largest finite magnitude (fp32
moments summed in another order), NaN / inf positions equal; label
flipping, the quarantine mask, count and replaced rows EQUAL (selections,
no arithmetic); feature noise, given the reference's own draw, within
1e-6.  Within the port: the scheduled attack equals ``apply_attack_tree``
bit for bit, its flat in-place form too; a clean stack passes the guard
bit for bit; a rate-0 poisoning run equals the clean run and a rate-1
label-flip run equals the ``"lf"`` attack bit for bit (the reference's
own contracts, tests/test_robustness.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attacks import apply_attack_scan as j_attack_scan
from repro.fed import PoisonConfig as JPoison
from repro.fed import poison_batch as j_poison
from repro.robustness import QuarantineConfig as JGuard
from repro.robustness import quarantine_stack as j_quarantine
from repro_torch.core.attacks import apply_attack_scan, apply_attack_tree
from repro_torch.core.types import AggregatorSpec
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, PoisonConfig, constant_attack,
    poison_batch, run_rounds,
)
from repro_torch.fed.poison import static_signature
from repro_torch.fed.scenarios import build_scenario, get_scenario
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.robustness import QuarantineConfig, quarantine_stack

torch.set_num_threads(2)

FAMILIES = ("none", "lf", "alie", "foe", "sf", "mimic", "nan", "inf")


def _np_tree(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(n, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32)}


def _t(tree):
    return {k: torch.as_tensor(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _assert_close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = max(float(np.max(np.abs(want[fin]), initial=0.0)), 1.0)
    assert np.max(np.abs(got[fin] - want[fin]), initial=0.0) <= tol * scale


# ---------------------------------------------------------------------------
# The scheduled attack.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack_id", range(len(FAMILIES)),
                         ids=list(FAMILIES))
def test_apply_attack_scan_equals_tree_and_reference(attack_id):
    name, f, eta = FAMILIES[attack_id], 3, 2.5
    tree = _np_tree()
    got = apply_attack_scan(FAMILIES, attack_id, _t(tree), f, eta=eta)
    want = apply_attack_tree(name, _t(tree), f,
                             eta=eta if name in ("alie", "foe") else None)
    for k in tree:
        assert torch.equal(got[k], want[k]) or (
            torch.isnan(got[k]).any() and torch.equal(
                torch.nan_to_num(got[k]), torch.nan_to_num(want[k])))
    # The flat in-place form on the same stack, leaf by leaf.
    flat = torch.cat([torch.as_tensor(tree[k]).reshape(8, -1)
                      for k in ("a", "b")], dim=1)
    apply_attack_scan(FAMILIES, attack_id, flat, f, eta=eta,
                      segments=[(0, 12), (12, 5)])
    np.testing.assert_array_equal(flat[:, :12].reshape(8, 3, 4).numpy(),
                                  got["a"].numpy())
    np.testing.assert_array_equal(flat[:, 12:].numpy(), got["b"].numpy())
    ref = j_attack_scan(FAMILIES, jnp.int32(attack_id), _j(tree), f,
                        eta=jnp.float32(eta))
    for k in tree:
        _assert_close(got[k].numpy(), np.asarray(ref[k]))


def test_apply_attack_scan_refuses_unported_families():
    """An ``_opt`` family (ported) without its ``agg_closure`` raises as in
    the reference, whichever branch the round takes; unknown names raise."""
    tree = _t(_np_tree())
    with pytest.raises(ValueError, match="requires agg_closure"):
        apply_attack_scan(("none", "alie_opt"), 0, tree, 2)
    with pytest.raises(ValueError, match="unknown attack"):
        apply_attack_scan(("none", "wat"), 0, tree, 2)
    assert apply_attack_scan(("alie",), 0, tree, 0) is tree


# ---------------------------------------------------------------------------
# Data poisoning.
# ---------------------------------------------------------------------------

def _batch(m=5, b=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"y": rng.integers(0, 10, size=(m, 2, b)).astype(np.int32),
            "x": rng.normal(size=(m, 2, b, 3)).astype(np.float32)}


def test_poison_config_validation_and_signature():
    with pytest.raises(ValueError):
        PoisonConfig(kind="wat")
    with pytest.raises(ValueError):
        PoisonConfig(rate=1.5)
    assert PoisonConfig().static_signature() == \
        JPoison().static_signature() == ("labelflip", "y", "x", 10)
    assert static_signature(None) is None


@pytest.mark.parametrize("rate,m_byz", [(0.6, 2), (1.0, 3), (0.5, 1),
                                        (0.0, 2), (0.3, 0)])
def test_poison_labelflip_equals_reference(rate, m_byz):
    batch = _batch()
    cfg = PoisonConfig(kind="labelflip", rate=rate)
    got = poison_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                       cfg, m_byz, rate=rate, strength=1.0)
    want = j_poison({k: jnp.asarray(v) for k, v in batch.items()},
                    JPoison(kind="labelflip", rate=rate), m_byz,
                    rate=jnp.float32(rate), strength=jnp.float32(1.0),
                    key=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    assert got["y"].dtype == torch.int32
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"])


@pytest.mark.parametrize("rate,strength", [(0.5, 2.0), (1.0, 0.7)])
def test_poison_feature_given_reference_noise_equals_reference(rate,
                                                               strength):
    batch = _batch()
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, batch["x"].shape, jnp.float32))
    got = poison_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                       PoisonConfig(kind="feature", rate=rate,
                                    strength=strength),
                       2, rate=rate, strength=strength,
                       noise=torch.as_tensor(noise))
    want = j_poison({k: jnp.asarray(v) for k, v in batch.items()},
                    JPoison(kind="feature", rate=rate, strength=strength), 2,
                    rate=jnp.float32(rate), strength=jnp.float32(strength),
                    key=key)
    _assert_close(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["x"][:3].numpy(), batch["x"][:3])
    np.testing.assert_array_equal(got["y"].numpy(), batch["y"])
    # Drawn from a generator: the same seed gives the same noise.
    draws = [poison_batch({k: torch.as_tensor(v) for k, v in batch.items()},
                          PoisonConfig(kind="feature", rate=rate), 2,
                          rate=rate, strength=strength,
                          generator=torch.Generator().manual_seed(5))["x"]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])


def _run(sc, engine, rounds=3):
    server, state, batch_fn, _ = build_scenario(sc, seed=0, device="cpu")
    return run_rounds(server, state, batch_fn, rounds, schedule=sc.attack,
                      byz_identity=sc.byz_identity(), seed=0, engine=engine)


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_poison_labelflip_rate1_equals_lf_attack(engine):
    lf = dataclasses.replace(get_scenario("labelflip_partial"), rounds=3)
    pz = dataclasses.replace(lf, name="lf_as_poison",
                             attack=constant_attack("none"),
                             poison=PoisonConfig(kind="labelflip", rate=1.0))
    (st_a, h_a), (st_b, h_b) = _run(lf, engine), _run(pz, engine)
    for k in st_a["params"]:
        assert torch.equal(st_a["params"][k], st_b["params"][k]), k
    assert h_a.loss == h_b.loss


@pytest.mark.parametrize("kind", ["labelflip", "feature"])
def test_poison_rate0_is_bitwise_clean(kind):
    base = get_scenario("poison_labelflip")
    clean = dataclasses.replace(base, name="pz_clean", poison=None)
    zero = dataclasses.replace(base, name="pz_zero",
                               poison=PoisonConfig(kind=kind, rate=0.0))
    (st_a, h_a), (st_b, h_b) = _run(clean, "scan"), _run(zero, "scan")
    for k in st_a["params"]:
        assert torch.equal(st_a["params"][k], st_b["params"][k]), k
    assert h_a.loss == h_b.loss


# ---------------------------------------------------------------------------
# Quarantine guard.
# ---------------------------------------------------------------------------

def _faulty(case):
    tree = _np_tree(n=8, seed=1)
    if case in ("nan", "mixed"):
        tree["a"][1, 0, 2] = np.nan
    if case in ("inf", "mixed"):
        tree["b"][3] = np.inf
    if case in ("neginf", "mixed"):
        tree["a"][6] = -np.inf
    if case in ("exploded", "mixed"):
        tree["b"][5] *= 1e4
    if case == "all":
        tree["b"][:] = np.nan
    return tree


@pytest.mark.parametrize("norm_factor", [10.0, 0.0, 3.0])
@pytest.mark.parametrize("case", ["nan", "inf", "neginf", "exploded",
                                  "mixed", "all"])
def test_quarantine_equals_reference(case, norm_factor):
    tree = _faulty(case)
    out, info = quarantine_stack(_t(tree), QuarantineConfig(norm_factor))
    j_out, j_info = j_quarantine(_j(tree), JGuard(norm_factor))
    np.testing.assert_array_equal(info["mask"].numpy(),
                                  np.asarray(j_info["mask"]))
    assert int(info["count"]) == int(j_info["count"])
    assert info["count"].dtype == torch.int32
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]))
        assert torch.isfinite(out[k]).all()
    if case == "exploded":
        assert int(info["count"]) == (1 if norm_factor else 0)


def test_quarantine_clean_stack_is_bitwise_and_validates():
    tree = _t(_np_tree(n=8, seed=2))
    out, info = quarantine_stack(tree, QuarantineConfig())
    assert int(info["count"]) == 0
    for k in tree:
        assert torch.equal(out[k], tree[k])
    bf = {"w": tree["b"].to(torch.bfloat16)}
    out, _ = quarantine_stack(bf, QuarantineConfig())
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], bf["w"])
    with pytest.raises(ValueError):
        QuarantineConfig(norm_factor=-1.0)


def _quad_fed(guard=None, n=10, f=2, d=12):
    centers = torch.as_tensor(
        np.random.default_rng(0).normal(size=(n, d)).astype(np.float32))

    def loss_fn(params, batch):
        c = centers[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"] - c) ** 2), {}

    def batch_fn(cohort, n_flip, rng):
        return {"idx": np.asarray(cohort)[:, None, None]}

    cfg = FedConfig(n_clients=n, clients_per_round=n, f=f,
                    agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                    client=ClientConfig(algorithm="dshb", beta=0.9),
                    guard=guard)
    server = FedServer(loss_fn, sgd(clip=1.0), cfg, constant(0.1),
                       device="cpu")
    return server, server.init_state({"theta": torch.zeros(d)}), batch_fn


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_guarded_round_survives_nan_workers(engine):
    """f workers emit NaN; every round completes finite with m_byz rows
    quarantined."""
    server, state, batch_fn = _quad_fed(guard=QuarantineConfig())
    state, hist = run_rounds(server, state, batch_fn, 5,
                             schedule=constant_attack("nan"), seed=0,
                             engine=engine)
    assert np.isfinite(hist.loss).all() and np.isfinite(
        hist.direction_norm).all()
    assert torch.isfinite(state["params"]["theta"]).all()
    # Without the guard the same run goes non-finite.
    server, st, batch_fn = _quad_fed(guard=None)
    _, bad = run_rounds(server, st, batch_fn, 2,
                        schedule=constant_attack("nan"), seed=0)
    assert not np.isfinite(bad.direction_norm).all()


@pytest.mark.parametrize("engine", ["loop", "scan"])
def test_guard_noop_run_is_bitwise(engine):
    """Guard enabled, no fault firing: the unguarded run bit for bit."""
    sched = constant_attack("alie", 3.0)
    outs = []
    for guard in (None, QuarantineConfig()):
        server, state, bf = _quad_fed(guard=guard)
        outs.append(run_rounds(server, state, bf, 6, schedule=sched, seed=0,
                               engine=engine))
    (st_a, h_a), (st_b, h_b) = outs
    assert torch.equal(st_a["params"]["theta"], st_b["params"]["theta"])
    assert h_a.loss == h_b.loss


def test_guarded_round_counts_quarantine_and_emits_event():
    from repro_torch.fed import run_scenario
    from repro_torch.obs import runtime as obs_runtime
    out = run_scenario("faulty_nan_quarantine", rounds=3, device="cpu")
    sc = out["scenario"]
    assert out["history"].m_byz == [sc.f] * 3
    assert out["server"].last_scan_report["quarantined_count"] == [sc.f] * 3
    ev = obs_runtime.history(name="robustness.quarantine")[-1]
    assert ev["args"] == {"surface": "fed.scan", "total": 3 * sc.f,
                          "rounds": 3}
    assert np.isfinite(out["history"].loss).all()


# ---------------------------------------------------------------------------
# Lane forms (the fleet's): one value a lane, against the reference's
# one-lane functions vmapped over the lanes.
# ---------------------------------------------------------------------------

def _lane_batches(lanes=4, seed=0):
    parts = [_batch(seed=seed + k) for k in range(lanes)]
    return {k: np.stack([p[k] for p in parts]) for k in parts[0]}


def test_poison_lanes_labelflip_equals_reference_vmapped():
    from repro_torch.fed import poison_batch_lanes
    batch = _lane_batches()
    m_byz = np.array([2, 0, 3, 1], np.int32)
    rate = np.array([0.6, 1.0, 0.0, 0.3], np.float32)
    strength = np.ones(4, np.float32)
    got = poison_batch_lanes({k: torch.as_tensor(v) for k, v in batch.items()},
                             PoisonConfig(kind="labelflip"),
                             torch.as_tensor(m_byz), rate=torch.as_tensor(rate),
                             strength=torch.as_tensor(strength))
    want = jax.vmap(lambda b, mb, r, s: j_poison(
        b, JPoison(kind="labelflip"), mb, rate=r, strength=s,
        key=jax.random.PRNGKey(0)))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(m_byz),
        jnp.asarray(rate), jnp.asarray(strength))
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"])
    for k in range(4):          # each lane equals the one-lane form
        one = poison_batch({n: torch.as_tensor(v[k]) for n, v in batch.items()},
                           PoisonConfig(kind="labelflip"), int(m_byz[k]),
                           rate=float(rate[k]), strength=1.0)
        assert torch.equal(one["y"], got["y"][k])


def test_poison_lanes_feature_given_reference_noise_equals_reference():
    from repro_torch.fed import poison_batch_lanes
    batch = _lane_batches(3)
    m_byz = np.array([2, 1, 0], np.int32)
    rate = np.array([0.5, 1.0, 0.7], np.float32)
    strength = np.array([2.0, 0.7, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    noise = np.stack([np.array(jax.random.normal(k, batch["x"].shape[1:],
                                                 jnp.float32)) for k in keys])
    got = poison_batch_lanes({k: torch.as_tensor(v) for k, v in batch.items()},
                             PoisonConfig(kind="feature"),
                             torch.as_tensor(m_byz), rate=torch.as_tensor(rate),
                             strength=torch.as_tensor(strength),
                             noise=torch.as_tensor(noise))
    want = jax.vmap(lambda b, mb, r, s, k: j_poison(
        b, JPoison(kind="feature"), mb, rate=r, strength=s, key=k))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(m_byz),
        jnp.asarray(rate), jnp.asarray(strength), keys)
    _assert_close(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["x"][2].numpy(), batch["x"][2])
    np.testing.assert_array_equal(got["y"].numpy(), batch["y"])
    with pytest.raises(ValueError, match="noise"):
        poison_batch_lanes({k: torch.as_tensor(v) for k, v in batch.items()},
                           PoisonConfig(kind="feature"),
                           torch.as_tensor(m_byz), rate=torch.as_tensor(rate),
                           strength=torch.as_tensor(strength))


@pytest.mark.parametrize("norm_factor", [10.0, 0.0, 3.0])
def test_quarantine_lanes_equal_reference_vmapped(norm_factor):
    from repro_torch.robustness import quarantine_stack_lanes
    cases = ["nan", "inf", "neginf", "exploded", "mixed", "all", "clean"]
    trees = [_faulty(c) if c != "clean" else _np_tree(n=8, seed=1)
             for c in cases]
    lanes = {k: np.stack([t[k] for t in trees]) for k in trees[0]}
    out, info = quarantine_stack_lanes(_t(lanes), QuarantineConfig(norm_factor))
    j_out, j_info = jax.vmap(
        lambda t: j_quarantine(t, JGuard(norm_factor)))(_j(lanes))
    np.testing.assert_array_equal(info["mask"].numpy(),
                                  np.asarray(j_info["mask"]))
    np.testing.assert_array_equal(info["count"].numpy(),
                                  np.asarray(j_info["count"]))
    assert info["count"].dtype == torch.int32
    for k in lanes:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(j_out[k]))
    for i, tree in enumerate(trees):    # each lane equals the one-stack form
        one, one_info = quarantine_stack(_t(tree), QuarantineConfig(norm_factor))
        assert int(one_info["count"]) == int(info["count"][i])
        for k in tree:
            assert torch.equal(one[k], out[k][i])
