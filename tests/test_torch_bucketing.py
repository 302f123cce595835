"""The port's bucketing stage and bucket-means kernels against the JAX
reference.

* ``repro_torch.core.bucketing`` and the bucketing closed forms of
  ``repro_torch.core.theory`` against ``repro.core.bucketing`` /
  ``repro.core.theory``.  The reference draws its permutation from a PRNG
  key, which torch cannot replay, so every case feeds the reference's own
  permutation ``np.asarray(jax.random.permutation(key, n))`` to the port as
  ``perm``.
* ``repro_torch.kernels.bucketgram.bucket_means_gram`` (on the CPU: the
  plain version of K6 / K7) against the reference's ``bucket_means_gram``
  in both forms, the Pallas kernel in interpret mode (``use_pallas=True``,
  as its own tests run it) and its jnp oracle (``use_pallas=False``).

Tolerances: the bucket means and the Gram are fp32 sums taken in another
order than XLA's, held to 1e-5 of the largest output magnitude (the
reference's fp32 contract).  Integer quantities (bucket ids, counts,
adjusted f) and closed forms are held exactly.  A bf16 stack's means are
compared after the cast back to bf16 at one bf16 ulp (2^-7 of the value)
on top of that fp32 tolerance: values that land at a rounding boundary
may round either way after fp32 sums in another order.  Non-finite rows must give the same NaN / inf
positions exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import theory as jtheory
from repro.kernels.bucketgram import bucket_means_gram as j_bmg
from repro.kernels.bucketgram import bucket_means_gram_ref as j_bmg_ref
from repro_torch.core import bucketing as tb
from repro_torch.core import theory as ttheory
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.bucketgram import bucket_means_gram as t_bmg

# ``repro.core`` re-exports the function ``bucketing`` under the module's
# name, so the module is fetched by its dotted path.
jb = importlib.import_module("repro.core.bucketing")

torch.set_num_threads(2)

RTOL = 1e-5


def _perm(key, n):
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


def _close(got, want, rtol=RTOL):
    got = np.asarray(torch.as_tensor(got).float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    if fin.any():
        scale = max(float(np.abs(want[fin]).max()), 1e-30)
        np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                                   atol=rtol * scale)


def _close_bf16(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    tol = RTOL * float(np.abs(want[fin]).max())
    assert (np.abs(got[fin] - want[fin])
            <= 2.0 ** -7 * np.abs(want[fin]) + tol).all()


def _stack(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# core/bucketing.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,f", [(17, 4), (16, 3), (8, 0), (10, 5), (3, 1),
                                 (10240, 320)])
def test_bucket_sizes_match_reference(n, f):
    assert tb.default_bucket_size(n, f) == jb.default_bucket_size(n, f)
    for s in (None, 0, 1, 2, 5, n, n + 3):
        cs = tb.clamp_bucket_size(n, s, f)
        assert cs == jb.clamp_bucket_size(n, s, f)
        assert tb.num_buckets(n, cs) == jb.num_buckets(n, cs)
        np.testing.assert_array_equal(tb.bucket_counts(n, cs).numpy(),
                                      np.asarray(jb.bucket_counts(n, cs)))
        nb = tb.num_buckets(n, cs)
        assert tb.adjusted_f(f, nb) == jb.adjusted_f(f, nb)


def test_ragged_tail_n17_s2_has_one_singleton():
    counts = tb.bucket_counts(17, 2).numpy()
    assert counts.shape == (9,) and counts[-1] == 1 and (counts[:-1] == 2).all()


@pytest.mark.parametrize("n,s", [(17, 2), (16, 2), (10, 4), (7, 7), (5, 1)])
def test_assignment_and_matrix_match_reference(n, s):
    key = jax.random.PRNGKey(n * 13 + s)
    perm = _perm(key, n)
    np.testing.assert_array_equal(
        tb.bucket_assignment(n, s, perm=perm).numpy(),
        np.asarray(jb.bucket_assignment(key, n, s)))
    np.testing.assert_array_equal(tb.bucket_matrix(n, s, perm=perm).numpy(),
                                  np.asarray(jb.bucket_matrix(key, n, s)))


def test_generator_and_explicit_perm_give_the_same_grouping():
    n, s = 23, 3
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    perm = torch.randperm(n, generator=g2)
    a = tb.bucket_assignment(n, s, generator=g1)
    np.testing.assert_array_equal(a.numpy(),
                                  tb.bucket_assignment(n, s, perm=perm).numpy())
    # Worker i goes to bucket argsort(perm)[i] // s.
    np.testing.assert_array_equal(a.numpy(),
                                  (np.argsort(perm.numpy()) // s).astype(np.int32))
    with pytest.raises(ValueError, match="Generator"):
        tb.bucket_assignment(n, s)


@pytest.mark.parametrize("n,s,f", [(17, 2, 4), (16, None, 3), (10, 4, 2),
                                   (9, 1, 2), (6, 6, 1)])
def test_gather_form_matches_reference(n, s, f):
    key = jax.random.PRNGKey(n + 100 * (s or 0))
    x = _stack(n, n, 13)
    want, want_f = jb.bucketing(jnp.asarray(x), f, key, bucket_size=s)
    got, got_f = tb.bucketing(torch.from_numpy(x), f, perm=_perm(key, n),
                              bucket_size=s)
    assert got_f == want_f
    _close(got, want)
    _close(tb.bucketing_means(torch.from_numpy(x), f, perm=_perm(key, n),
                              bucket_size=s), want)


def test_gather_form_preserves_bf16():
    n, f, key = 17, 4, jax.random.PRNGKey(1)
    x = _stack(2, n, 11)
    jx = jnp.asarray(x, jnp.bfloat16)
    want, _ = jb.bucketing(jx, f, key, bucket_size=2)
    got, _ = tb.bucketing(torch.from_numpy(np.asarray(jx.astype(jnp.float32)))
                          .to(torch.bfloat16), f, perm=_perm(key, n),
                          bucket_size=2)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    _close_bf16(got, want)


def test_gather_form_contains_an_inf_row_like_the_reference_xla_path():
    """The gather form (the reference's "xla" hierarchical path) leaves
    only the bucket holding the bad row non-finite."""
    n, s, key = 16, 2, jax.random.PRNGKey(4)
    x = _stack(3, n, 9)
    x[5, 2:4] = np.inf
    x[11, 6] = np.nan
    want, _ = jb.bucketing(jnp.asarray(x), 3, key, bucket_size=s)
    got, _ = tb.bucketing(torch.from_numpy(x), 3, perm=_perm(key, n),
                          bucket_size=s)
    _close(got, want)
    assert int(np.isnan(np.asarray(want)).sum()) == 1
    assert int(np.isinf(np.asarray(want)).sum()) == 2


# ---------------------------------------------------------------------------
# core/theory.py: the bucketed population
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,f,s", [(17, 4, None), (16, 3, None), (16, 3, 2),
                                   (10240, 80, 16), (9, 2, 1), (12, 1, 3)])
def test_bucketed_population_and_composed_kappa_match_reference(n, f, s):
    assert ttheory.bucketed_population(n, f, s) == \
        jtheory.bucketed_population(n, f, s)
    for rule in ("cwtm", "gm", "krum", "cwmed"):
        for pre in (None, "nnm"):
            assert ttheory.composed_kappa(rule, n, f, pre, hier=True,
                                          bucket_size=s) == \
                jtheory.composed_kappa(rule, n, f, pre, hier=True,
                                       bucket_size=s)
        assert ttheory.composed_kappa(rule, n, f, "bucketing",
                                      bucket_size=s) == \
            jtheory.composed_kappa(rule, n, f, "bucketing", bucket_size=s)


def test_bucketed_population_raises_when_buckets_cannot_tolerate_f():
    # 3 buckets for f = 3; and the reference's scale case (n = 10240,
    # f = n/32, s = 16) reduces to 640 = 2f buckets.
    for n, f, s in ((10, 3, 4), (10240, 320, 16)):
        for mod in (ttheory, jtheory):
            with pytest.raises(ValueError, match="n_buckets > 2f"):
                mod.bucketed_population(n, f, s)
    with pytest.raises(ValueError, match="twice"):
        ttheory.composed_kappa("cwtm", 17, 4, "bucketing", hier=True)


# ---------------------------------------------------------------------------
# kernels/bucketgram: K6 / K7's plain version against the reference
# ---------------------------------------------------------------------------

_SHAPES = [(16, 2, 1), (17, 2, 200), (10, 4, 129), (40, 3, 7), (5, 5, 300),
           (33, 16, 64)]


@pytest.mark.parametrize("n,s,d", _SHAPES)
@pytest.mark.parametrize("with_gram", [True, False])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_bucket_means_gram_matches_reference(n, s, d, with_gram, use_pallas):
    key = jax.random.PRNGKey(d + n)
    x = _stack(n + d, n, d)
    bmat = jb.bucket_matrix(key, n, s)
    want_y, want_g = j_bmg(jnp.asarray(x), bmat, with_gram=with_gram,
                           use_pallas=use_pallas)
    tbmat = torch.from_numpy(np.array(bmat))
    got_y, got_g = t_bmg(torch.from_numpy(x), tbmat, with_gram=with_gram)
    _close(got_y, want_y)
    assert (got_g is None) == (want_g is None)
    if with_gram:
        _close(got_g, want_g)
    # The assignment form computes the same thing.
    assign = tb.bucket_assignment(n, s, perm=_perm(key, n))
    y2, g2 = t_bmg(torch.from_numpy(x), assignment=assign,
                   n_buckets=tb.num_buckets(n, s), with_gram=with_gram)
    _close(y2, want_y)
    if with_gram:
        _close(g2, want_g)


def test_bucket_means_gram_bf16_matches_reference():
    n, s, d, key = 17, 2, 150, jax.random.PRNGKey(3)
    jx = jnp.asarray(_stack(8, n, d), jnp.bfloat16)
    bmat = jb.bucket_matrix(key, n, s)
    want_y, want_g = j_bmg_ref(jx, bmat)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    got_y, got_g = t_bmg(tx, torch.from_numpy(np.array(bmat)))
    assert got_y.dtype == torch.bfloat16 and got_g.dtype == torch.float32
    _close_bf16(got_y, want_y)
    # The Gram is of the fp32 means, before the cast (ref.py's contract).
    _close(got_g, want_g)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("fill", [np.inf, -np.inf, np.nan])
def test_kernel_path_spreads_nonfinite_rows_like_the_reference(use_pallas,
                                                               fill):
    """The dense contraction B @ X: 0 * inf = NaN, so a non-finite row
    makes every OTHER bucket NaN in its columns (and its own bucket
    non-finite) — in the reference kernel, its oracle and the port."""
    n, s, d, key = 8, 2, 6, jax.random.PRNGKey(0)
    x = _stack(9, n, d)
    x[3, 1] = fill
    bmat = jb.bucket_matrix(key, n, s)
    want_y, want_g = j_bmg(jnp.asarray(x), bmat, use_pallas=use_pallas)
    got_y, got_g = t_bmg(torch.from_numpy(x), torch.from_numpy(np.array(bmat)))
    _close(got_y, want_y)
    _close(got_g, want_g)
    col = np.asarray(want_y)[:, 1]
    assert np.isnan(col).sum() >= tb.num_buckets(n, s) - 1
    assert np.isfinite(np.delete(np.asarray(want_y), 1, axis=1)).all()


def test_bucket_means_gram_rejects_a_matrix_that_is_not_an_assignment():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="one non-zero per column"):
        t_bmg(x, torch.ones(2, 4))
    with pytest.raises(ValueError, match="exactly one"):
        t_bmg(x)


@pytest.mark.parametrize("with_gram", [True, False])
def test_dispatch_records_the_bucketgram_decision(with_gram):
    x = torch.from_numpy(_stack(12, 16, 10))
    assign = tb.bucket_assignment(16, 2, perm=torch.arange(16))
    kdispatch.open_record(requested="cuda", backend="cuda", rule="cwtm",
                          pre="nnm", hier=True)
    y, g = kdispatch.dispatch_bucketgram(x, assign, 8, backend="cuda",
                                         with_gram=with_gram)
    rec = kdispatch.last_dispatch()
    name = "bucketgram" if with_gram else "bucketmeans"
    assert [d.primitive for d in rec.decisions] == [name]
    assert rec.decisions[0].used == "plain" and rec.fallbacks
    assert rec.hier and "hier(s=auto)" in rec.describe()
    assert (g is None) == (not with_gram)
    y2, g2 = kdispatch.dispatch_bucketgram(x, assign, 8, backend="torch",
                                           with_gram=with_gram)
    _close(y, y2)


# ---------------------------------------------------------------------------
# hier + NNM under the nan / inf attacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["cwtm", "cwmed", "krum", "multikrum", "gm",
                                  "mda", "average"])
@pytest.mark.parametrize("attack", ["nan", "inf"])
@pytest.mark.parametrize("backends", [("xla", "torch"), ("pallas", "cuda")])
def test_hier_nnm_nonfinite_attacks_match_reference(rule, attack, backends):
    """hier + NNM, n = 32 in buckets of 2 (16 means), f = 3, the
    reference's permutation.  Each port backend is held to the reference
    path it mirrors (ROADMAP queue 3, facts: kernel path vs gather path on
    non-finite rows).  The gather form ("xla" / "torch") keeps the inf rows
    to their buckets; NNM over the means then meets inf - inf = -NaN
    distances, which ``lax.top_k(-d2)`` ranks nearest, and the aggregate
    is +inf.  The dense bucket matrix of the kernel path ("pallas" /
    "cuda") spreads 0 * inf = NaN to every other bucket, and the aggregate
    is NaN for every rule."""
    from repro.core.attacks import apply_attack_tree as j_attack
    from repro.core.robust import robust_aggregate as j_aggregate
    from repro.core.types import AggregatorSpec as JSpec
    from repro_torch.core.robust import robust_aggregate as t_aggregate
    from repro_torch.core.types import AggregatorSpec as TSpec
    n, f, key = 32, 3, jax.random.PRNGKey(5)
    jback, tback = backends
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(n, 6, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 9)).astype(np.float32) * 0.3}
    jt = j_attack(attack, jax.tree_util.tree_map(jnp.asarray, tree), f)
    kw = dict(rule=rule, f=f, pre="nnm", hier=True, bucket_size=2)
    want = j_aggregate(jt, JSpec(backend=jback, **kw), key=key)
    got = t_aggregate({k: torch.from_numpy(np.array(v)) for k, v in jt.items()},
                      TSpec(backend=tback, **kw), perm=_perm(key, n))
    for k in want:
        g, w = got[k].float().numpy(), np.asarray(want[k], np.float32)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)],
                                      err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
