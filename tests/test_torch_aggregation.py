"""The port's aggregation pipeline against the JAX reference.

``repro_torch.core.robust.robust_aggregate`` on its leaf-streamed path
(backend "torch") and its flat kernel path (backend "cuda", which on the
CPU runs each kernel's plain version and records it) is held to
``repro.core.robust.robust_aggregate`` (backend "xla") for every rule x
pre in {None, "nnm"} at the paper's n = 17 with f at its maximum, on an
ALIE stack whose 8 Byzantine rows are identical (ties are the normal case
on the main path).  The same numpy arrays go to both packages.

Tolerance: 1e-5 relative to the largest output magnitude (the reference's
fp32 contract; sums run in another order), after the NNM neighbour sets
have been checked EQUAL.  No case needed re-seeding for a near tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram
from repro.core import theory as jtheory
from repro.core.attacks import apply_attack_tree as j_attack
from repro.core.robust import robust_aggregate as j_aggregate
from repro.core.types import AggregatorSpec as JSpec
from repro_torch.core import gram as tgram
from repro_torch.core import theory as ttheory
from repro_torch.core.attacks import apply_attack_tree as t_attack
from repro_torch.core.attacks import attack_flat_
from repro_torch.core.robust import robust_aggregate as t_aggregate
from repro_torch.core.types import ALL_RULES, AggregatorSpec as TSpec
from repro_torch.kernels import dispatch as kdispatch

torch.set_num_threads(2)

N, F = 17, 8
RTOL = 1e-5


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 6, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 9)).astype(np.float32) * 0.3}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _to_np(tree):
    return {k: np.asarray(v, np.float32) if isinstance(v, jax.Array)
            else v.float().numpy() for k, v in tree.items()}


def _assert_close(got, want, rtol=RTOL):
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale, err_msg=k)


@pytest.fixture(scope="module")
def alie_stack():
    """Honest rows plus 8 identical ALIE rows, built by the reference."""
    jt = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    return _to_np(j_attack("alie", jt, F, eta=1.5))


def test_nnm_neighbour_sets_equal_on_alie_ties(alie_stack):
    jg = jgram.gram(jnp.concatenate(
        [jnp.asarray(v).reshape(N, -1) for v in alie_stack.values()], 1))
    tg = torch.from_numpy(np.array(jg))
    jm = np.asarray(jgram.nnm_matrix(jgram.pdist_sq_from_gram(jg), F))
    tm = tgram.nnm_matrix(tgram.pdist_sq_from_gram(tg), F).numpy()
    np.testing.assert_array_equal(tm, jm)
    # The tie is real: the Byzantine rows are at distance 0 of each other.
    d2 = tgram.pdist_sq_from_gram(tg)
    assert float(d2[N - F:, N - F:].max()) == 0.0


@pytest.mark.parametrize("rule", ALL_RULES)
@pytest.mark.parametrize("pre", [None, "nnm"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_robust_aggregate_matches_reference(alie_stack, rule, pre, backend):
    want = j_aggregate(jax.tree_util.tree_map(jnp.asarray, alie_stack),
                       JSpec(rule=rule, f=F, pre=pre, backend="xla"))
    got = t_aggregate(_to_torch(alie_stack),
                      TSpec(rule=rule, f=F, pre=pre, backend=backend))
    _assert_close(_to_np(got), _to_np(want))
    rec = kdispatch.last_dispatch()
    assert rec.backend == backend
    if backend == "cuda":
        # On the CPU the flat path runs the plain versions, recorded.
        assert rec.fallbacks and all(d.used in ("plain", "torch")
                                     for d in rec.fallbacks)


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bf16_transport_matches_reference(alie_stack, rule, backend):
    want = j_aggregate(jax.tree_util.tree_map(jnp.asarray, alie_stack),
                       JSpec(rule=rule, f=F, pre="nnm", backend="xla",
                             transport_dtype="bf16"))
    got = t_aggregate(_to_torch(alie_stack),
                      TSpec(rule=rule, f=F, pre="nnm", backend=backend,
                            transport_dtype="bf16"))
    _assert_close(_to_np(got), _to_np(want))


@pytest.mark.parametrize("attack", ["none", "lf", "alie", "foe", "sf", "nan", "inf"])
def test_attack_parity(attack):
    tree = _tree(1)
    want = _to_np(j_attack(attack, jax.tree_util.tree_map(jnp.asarray, tree),
                           4, eta=None))
    got = _to_np(t_attack(attack, _to_torch(tree), 4))
    for k in tree:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("attack", ["alie", "foe", "sf", "nan", "inf"])
def test_flat_attack_equals_leaf_attack_with_a_nonfinite_honest_row(attack):
    """The trainer's in-place flat form takes the finite-row test per leaf,
    as the reference does: one NaN in an honest row of leaf "w" drops that
    row from "w"'s moments only."""
    tree = _tree(2)
    tree["w"][1, 0, 0] = np.nan
    want = _to_np(j_attack(attack, jax.tree_util.tree_map(jnp.asarray, tree),
                           4, eta=0.7))
    ttree = _to_torch(tree)
    flat, layout = kdispatch.flatten_worker_stack(ttree)
    attack_flat_(attack, flat, 4, eta=0.7, chunk=7,
                 segments=[(o, s) for o, s, _ in layout.segments])
    got = _to_np(kdispatch.stack_views(flat, layout))
    for k in tree:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rule", ["cwtm", "cwmed"])
@pytest.mark.parametrize("attack", ["nan", "inf"])
def test_nonfinite_attacks_are_trimmed_like_the_reference(rule, attack):
    jt = j_attack(attack, jax.tree_util.tree_map(jnp.asarray, _tree(3)), F)
    stack = _to_np(jt)
    want = _to_np(j_aggregate(jt, JSpec(rule=rule, f=F, pre=None,
                                        backend="xla")))
    for backend in ("torch", "cuda"):
        got = _to_np(t_aggregate(_to_torch(stack),
                                 TSpec(rule=rule, f=F, pre=None,
                                       backend=backend)))
        if rule == "cwmed" and backend == "cuda":
            # K2's median ranks NaN last (the sort order of mixtrim_ref);
            # the leaf path's jnp.median returns NaN for a NaN column.
            assert all(np.isfinite(v).all() for v in got.values())
            continue
        for k in want:
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)


def test_gram_space_coefficients_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N, 40)).astype(np.float32)
    x[N - 4:] = x[N - 4]                          # identical rows: ties
    jg = jgram.gram(jnp.asarray(x))
    tg = torch.from_numpy(np.array(jg))
    jd2, td2 = jgram.pdist_sq_from_gram(jg), tgram.pdist_sq_from_gram(tg)
    for f in (0, 4, 8):
        for rule in ("average", "krum", "multikrum", "gm", "autogm", "mda"):
            want = np.asarray(jgram.coeff_for_rule(rule, jg, f))
            got = tgram.coeff_for_rule(rule, tg, f).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{rule} f={f}")
    v = rng.normal(size=(N,)).astype(np.float32)
    np.testing.assert_allclose(tgram.project_simplex(torch.from_numpy(v)).numpy(),
                               np.asarray(jgram.project_simplex(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td2.numpy(), np.asarray(jd2), rtol=1e-6, atol=1e-5)


def test_theory_matches_reference():
    for rule in ("cwtm", "krum", "gm", "cwmed", "autogm", "average"):
        for n, f in ((17, 4), (8, 2), (17, 8)):
            assert ttheory.kappa(rule, n, f) == jtheory.kappa(rule, n, f)
            assert ttheory.composed_kappa(rule, n, f, "nnm") == \
                jtheory.composed_kappa(rule, n, f, "nnm")
            if rule != "average":
                assert ttheory.breakdown_point(rule, n, f) == \
                    jtheory.breakdown_point(rule, n, f)
    stack = _tree(6)
    agg = {k: v.mean(0) + 0.1 for k, v in stack.items()}
    want = float(jtheory.tree_kappa_hat(
        jax.tree_util.tree_map(jnp.asarray, agg),
        jax.tree_util.tree_map(jnp.asarray, stack), N - F))
    got = float(ttheory.tree_kappa_hat(_to_torch(agg), _to_torch(stack), N - F))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("kw", [dict(hier=True), dict(sketch_dim=16),
                                dict(pre="bucketing")])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_aggregate(_to_torch(_tree(0)), TSpec(rule="cwtm", f=2, **kw))
