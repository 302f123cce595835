"""The port's dynamic-f, lane-batched aggregation against the JAX reference.

Held here: the ``*_dyn`` gram forms (``repro_torch.core.gram``),
``adjusted_f_dyn``, the single-lane ``robust_aggregate_dyn`` and the
lane-batched ``batched_robust_aggregate`` (the fleet's aggregation, with a
per-lane f), and the plain versions of K4 and K5 (``mixtrim_dyn_ref``,
``gram_batched_ref``).  The same numpy arrays go to both packages; where
the reference draws a bucket permutation from its PRNG key, the port is
handed that permutation.

The port's "torch" backend is held to the reference's "xla" backend and
its "cuda" backend (on the CPU: each kernel's plain version) to the
reference's "pallas" backend in interpret mode, whose Pallas kernels run
under ``jax.vmap``.

Tolerances: masks, neighbour sets and one-hot selections must be EQUAL
(ties are the normal case: ALIE, FOE, SF and mimic make the f Byzantine
rows identical); aggregates agree within 1e-5 of the largest finite
output magnitude (the reference's fp32 contract, sums in another order),
with NaN and inf positions equal.  A lane with an inf row and a lane with
a NaN row are included: the dynamic trim multiplies by a 0/1 rank mask,
and inf * 0 = NaN, so NaN columns appear even where the row's rank is
trimmed.  No case was re-seeded.

Two facts of the reference shape the comparisons on non-finite input.
Its Pallas sort pads with fp32-max sentinels (which sort below +inf) and
its min/max network spreads NaN, so on inf / NaN columns the Pallas
kernels disagree with their own jnp oracles (``mixtrim_ref``,
``mixtrim_dyn_ref``); the port's kernels follow the oracles (NaN-last
order, as ``torch.sort``).  Non-finite cases are therefore held to the
oracles: the plain K4 to ``mixtrim_dyn_ref``, and the NaN / inf lanes of
cwmed on the kernel path (which the reference routes to the static
kernel) to ``mixtrim_ref`` (with the reference's own NNM matrix).  AutoGM's coefficients are not compared
entry by entry: its weights concentrate on one row, where the gram-space
distance is a difference of near-equal numbers and its fp32 rounding
decides the small weights (the port's static ``autogm_coeff``, already
held to the reference, shows the same ~2e-4).  Its aggregates are held
to AUTOGM_RTOL = 5e-4 of the largest output: on the bucketing lane whose
weights reach 0.99997, a 1e-7 relative change of the (9, 9) Gram (one
fp32 ulp) moves the port's own aggregate by 1.3e-4 of its magnitude
(measured on this test's data), so no fp32 implementation can be held
to 1e-5 there; every other rule is held to 1e-5.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gram as jgram
from repro.core.robust import batched_robust_aggregate as j_batched
from repro.core.robust import robust_aggregate_dyn as j_dyn
from repro.core.types import AggregatorSpec as JSpec
from repro.kernels.gram import gram_batched as j_gram_batched
from repro.kernels.gram.ref import gram_batched_ref as j_gram_batched_ref
from repro.kernels.mixtrim import mixtrim_dyn as j_mixtrim_dyn
from repro.kernels.mixtrim.ref import mixtrim_dyn_ref as j_mixtrim_dyn_ref
from repro.kernels.mixtrim.ref import mixtrim_ref as j_mixtrim_ref
from repro_torch.core import gram as tgram
from repro_torch.core.robust import batched_robust_aggregate as t_batched
from repro_torch.core.robust import robust_aggregate_dyn as t_dyn
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.gram import gram_batched_ref as t_gram_batched_ref
from repro_torch.kernels.mixtrim import mixtrim_dyn as t_mixtrim_dyn
from repro_torch.kernels.mixtrim import mixtrim_dyn_ref as t_mixtrim_dyn_ref

torch.set_num_threads(2)

jbucket = importlib.import_module("repro.core.bucketing")
tbucket = importlib.import_module("repro_torch.core.bucketing")

RTOL = 1e-5
AUTOGM_RTOL = 5e-4      # module docstring: AutoGM's conditioning
N = 17
RULES = ("cwtm", "cwmed", "meamed", "gm", "autogm", "krum", "multikrum",
         "average")
#: Per-lane f of the lane-batched cases (n = 17): 0, small, the paper's
#: 4 and the largest valid f.
LANE_F = np.array([0, 2, 4, 8, 4, 3], np.int32)
INF_LANE, NAN_LANE = 4, 5


def _assert_close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float32)
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


def _tied_rows(rng, n, f, d=7):
    """n rows, the last f identical (the Byzantine copy of one vector)."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    if f:
        x[n - f:] = x[n - 1]
    return x


@pytest.mark.parametrize("n,f", [(n, f) for n in (6, 9, 17)
                                 for f in range((n - 1) // 2 + 1)])
def test_dyn_gram_forms_equal_reference_on_ties(n, f):
    """nnm_matrix_dyn, krum_coeff_dyn and multikrum_coeff_dyn select
    exactly what the reference selects, one lane at a time and as one
    lane-batched call over every f; gm / autogm / average within 1e-5."""
    rng = np.random.default_rng(n * 100 + f)
    x = _tied_rows(rng, n, f)
    jg = jgram.gram(jnp.asarray(x))
    g = np.asarray(jg)
    d2 = np.asarray(jgram.pdist_sq_from_gram(jg))
    td2 = torch.from_numpy(d2)
    ft = torch.tensor(f, dtype=torch.int32)
    jf = jnp.int32(f)
    np.testing.assert_array_equal(
        tgram.nnm_matrix_dyn(td2, ft).numpy(),
        np.asarray(jgram.nnm_matrix_dyn(jnp.asarray(d2), jf)))
    np.testing.assert_array_equal(
        tgram.krum_coeff_dyn(td2, ft).numpy(),
        np.asarray(jgram.krum_coeff_dyn(jnp.asarray(d2), jf)))
    np.testing.assert_array_equal(
        tgram.multikrum_coeff_dyn(td2, ft).numpy(),
        np.asarray(jgram.multikrum_coeff_dyn(jnp.asarray(d2), jf)))
    # The static and the dynamic neighbour selections agree on the ties.
    np.testing.assert_array_equal(
        tgram.nnm_matrix_dyn(td2, ft).numpy(),
        tgram.nnm_matrix(td2, f).numpy())
    for rule in ("gm", "average"):
        _assert_close(tgram.coeff_for_rule_dyn(rule, torch.from_numpy(g), ft),
                      jgram.coeff_for_rule_dyn(rule, jg, jf))
    # AutoGM (module docstring): the lane form equals the port's static
    # solver, which test_torch_aggregation holds to the reference.
    _assert_close(tgram.coeff_for_rule_dyn("autogm", torch.from_numpy(g), ft),
                  tgram.autogm_coeff(torch.from_numpy(g), f))
    # Lane-batched: every f of this n in one call.
    fs = np.arange((n - 1) // 2 + 1, dtype=np.int32)
    lanes = torch.from_numpy(np.broadcast_to(d2, (len(fs), n, n)).copy())
    got = tgram.nnm_matrix_dyn(lanes, torch.from_numpy(fs)).numpy()
    got_k = tgram.krum_coeff_dyn(lanes, torch.from_numpy(fs)).numpy()
    got_mk = tgram.multikrum_coeff_dyn(lanes, torch.from_numpy(fs)).numpy()
    for k, fk in enumerate(fs):
        jd2, jfk = jnp.asarray(d2), jnp.int32(fk)
        np.testing.assert_array_equal(got[k], jgram.nnm_matrix_dyn(jd2, jfk))
        np.testing.assert_array_equal(got_k[k], jgram.krum_coeff_dyn(jd2, jfk))
        np.testing.assert_array_equal(got_mk[k],
                                      jgram.multikrum_coeff_dyn(jd2, jfk))


def test_mda_has_no_dynamic_form():
    with pytest.raises(ValueError, match="mda"):
        tgram.coeff_for_rule_dyn("mda", torch.eye(5), torch.tensor(1))


@pytest.mark.parametrize("nb", [1, 2, 5, 9, 640])
def test_adjusted_f_dyn_matches_reference(nb):
    fs = np.array([0, 1, 3, 4, 7, 400], np.int32)
    got = tbucket.adjusted_f_dyn(torch.from_numpy(fs), nb).numpy()
    want = np.asarray(jbucket.adjusted_f_dyn(jnp.asarray(fs), nb))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def _lane_stack(seed, d=(3, 4), b=len(LANE_F)):
    """(B, n, ...) two-leaf stacks: honest rows plus each lane's f
    identical ALIE-like rows; lane INF_LANE holds a +inf row and lane
    NAN_LANE a NaN row (both Byzantine, f > 0)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, N) + d).astype(np.float32)
    v = (rng.normal(size=(b, N, 5)) * 0.3).astype(np.float32)
    for k, f in enumerate(LANE_F):
        if f:
            w[k, N - f:] = w[k, :N - f].mean(0) + 1.5 * w[k, :N - f].std(0)
            v[k, N - f:] = v[k, :N - f].mean(0) + 1.5 * v[k, :N - f].std(0)
    w[INF_LANE, N - 1] = np.inf
    v[NAN_LANE, N - 2, 1:3] = np.nan
    return {"w": w, "v": v}


def _perms(seed, b, n=N):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    perms = np.stack([np.asarray(jax.random.permutation(k, n)) for k in keys])
    return keys, perms


def _spec(cls, rule, pre, backend):
    return cls(rule=rule, pre=pre, backend=backend,
               bucket_size=(jbucket.default_bucket_size(N, 4)
                            if pre == "bucketing" else None))


@pytest.mark.parametrize("pre", [None, "nnm", "bucketing"])
@pytest.mark.parametrize("rule", RULES)
def test_batched_robust_aggregate_matches_reference(rule, pre):
    """Port "torch" vs reference "xla" and port "cuda" (plain versions on
    the CPU) vs reference "pallas" (interpret), per-lane f, the inf and
    NaN lanes included; then one lane through the single-lane entry."""
    stack = _lane_stack(seed=len(rule) * 7 + (pre or "").__len__())
    keys, perms = _perms(3, len(LANE_F))
    jtree = jax.tree_util.tree_map(jnp.asarray, stack)
    ttree = {k: torch.from_numpy(v.copy()) for k, v in stack.items()}
    kw = dict(keys=keys) if pre == "bucketing" else {}
    tkw = dict(perms=torch.from_numpy(perms)) if pre == "bucketing" else {}
    for jb, tb in (("xla", "torch"), ("pallas", "cuda")):
        want = j_batched(jtree, _spec(JSpec, rule, pre, jb),
                         jnp.asarray(LANE_F), **kw)
        got = t_batched(ttree, _spec(TSpec, rule, pre, tb),
                        torch.from_numpy(LANE_F), **tkw)
        if rule == "cwmed" and jb == "pallas":
            want = _cwmed_oracle_on_nonfinite_lanes(stack, want, pre, keys)
        rtol = AUTOGM_RTOL if rule == "autogm" else RTOL
        for name in stack:
            _assert_close(got[name].numpy(), want[name], rtol)
        rec = kdispatch.last_dispatch()
        assert rec.dyn and rec.lanes == len(LANE_F) and rec.backend == tb
    # One lane (the inf lane: f = 4) through robust_aggregate_dyn.
    lane = INF_LANE
    one_j = jax.tree_util.tree_map(lambda a: a[lane], jtree)
    one_t = {k: v[lane] for k, v in ttree.items()}
    for jb, tb in (("xla", "torch"), ("pallas", "cuda")):
        jk = dict(key=keys[lane]) if pre == "bucketing" else {}
        tk = dict(perm=torch.from_numpy(perms[lane])) if pre == "bucketing" else {}
        want = j_dyn(one_j, _spec(JSpec, rule, pre, jb), jnp.int32(LANE_F[lane]),
                     **jk)
        got = t_dyn(one_t, _spec(TSpec, rule, pre, tb),
                    torch.tensor(LANE_F[lane]), **tk)
        rtol = AUTOGM_RTOL if rule == "autogm" else RTOL
        for name in stack:
            _assert_close(got[name].numpy(), want[name], rtol)


def _cwmed_oracle_on_nonfinite_lanes(stack, want, pre, keys):
    """The reference's kernel-path cwmed on the inf / NaN lanes by its
    oracle ``mixtrim_ref`` (module docstring), per leaf; under bucketing
    on the reference's own bucket means (same key)."""
    out = {k: np.array(v) for k, v in want.items()}
    s = jbucket.default_bucket_size(N, 4)
    for lane in (INF_LANE, NAN_LANE):
        m = None
        if pre == "nnm":
            flat = jnp.concatenate([jnp.asarray(leaf[lane].reshape(N, -1))
                                    for _, leaf in sorted(stack.items())], 1)
            m = jgram.nnm_matrix_dyn(jgram.pdist_sq_from_gram(
                jgram.gram(flat)), jnp.int32(LANE_F[lane]))
        for name, leaf in stack.items():
            x = jnp.asarray(leaf[lane].reshape(N, -1))
            if pre == "bucketing":
                x = jbucket.bucketing(x, 4, keys[lane], bucket_size=s)[0]
            out[name][lane] = np.asarray(j_mixtrim_ref(x, m, 0, "med")
                                         ).reshape(leaf.shape[2:])
    return out


@pytest.mark.parametrize("s", [2, 4, 17])
def test_tree_bucket_dyn_matches_reference(s):
    """One lane's gather-form bucketing with an int-tensor f, the
    reference's permutation fed in as ``perm`` (and the same grouping from
    a generator-drawn permutation)."""
    from repro.core.robust import _tree_bucket_dyn as j_bucket_dyn
    from repro_torch.core.robust import _tree_bucket_dyn as t_bucket_dyn
    stack = {k: v[0] for k, v in _lane_stack(seed=s).items()}
    key = jax.random.PRNGKey(s)
    perm = np.asarray(jax.random.permutation(key, N))
    want, wf = j_bucket_dyn(jax.tree_util.tree_map(jnp.asarray, stack),
                            jnp.int32(4), key, s)
    got, gf = t_bucket_dyn({k: torch.from_numpy(v.copy())
                            for k, v in stack.items()}, torch.tensor(4), s,
                           perm=torch.from_numpy(perm))
    assert int(gf) == int(wf)
    for k in stack:
        _assert_close(got[k].numpy(), want[k])


def test_dyn_path_records_the_kernels_it_would_launch():
    """The cuda backend's record on the CPU: K5, then K4, K3's lane form
    or K2's median lane form, one decision each for all the lanes, each
    as its plain version (recorded), no other decision."""
    ttree = {k: torch.from_numpy(v.copy()) for k, v in _lane_stack(1).items()}
    fs = torch.from_numpy(LANE_F)
    t_batched(ttree, TSpec(rule="cwtm", pre="nnm", backend="cuda"), fs)
    prims = [d.primitive for d in kdispatch.last_dispatch().decisions]
    assert prims == ["gram_batched", "mixtrim_dyn"]
    t_batched(ttree, TSpec(rule="gm", pre="nnm", backend="cuda"), fs)
    rec = kdispatch.last_dispatch()
    assert [d.primitive for d in rec.decisions] == ["gram_batched",
                                                     "combine_lanes"]
    assert rec.lanes == len(LANE_F)
    t_batched(ttree, TSpec(rule="cwmed", pre=None, backend="cuda"), fs)
    rec = kdispatch.last_dispatch()
    assert [(d.primitive, d.used) for d in rec.decisions] == [
        ("mixtrim_lanes", "plain")]
    assert rec.lanes == len(LANE_F)
    one = {k: v[0] for k, v in ttree.items()}
    t_dyn(one, TSpec(rule="cwtm", pre="nnm", backend="cuda"), fs[0])
    prims = [d.primitive for d in kdispatch.last_dispatch().decisions]
    assert prims == ["gram", "mixtrim_dyn"]


def test_dyn_path_rejects_what_it_does_not_run():
    """Hier on the dynamic path needs an explicit bucket_size (the
    reference's ValueError); with one it runs (its bucket means: 3 of
    5 rows, the f budget capped to 1)."""
    one = {"w": torch.zeros(5, 3)}
    with pytest.raises(ValueError, match="bucket_size"):
        t_dyn(one, TSpec(rule="cwtm", pre="bucketing"), 1,
              generator=torch.Generator())
    with pytest.raises(ValueError, match="bucket_size"):
        t_dyn(one, TSpec(rule="cwtm", hier=True), 1,
              generator=torch.Generator())
    got = t_dyn(one, TSpec(rule="cwtm", hier=True, bucket_size=2), 1,
                generator=torch.Generator())
    assert got["w"].shape == (3,) and bool(torch.all(got["w"] == 0))
    rec = kdispatch.last_dispatch()
    assert rec.hier and rec.bucket_size == 2 and rec.dyn
    assert rec.decisions[1].primitive == "bucketgram"


# --- the plain versions of K4 and K5 ---------------------------------------

def _k4_case(n, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 2 * 128 + 5)).astype(np.float32)
    m = rng.random(size=(b, n, n)).astype(np.float32)
    m /= m.sum(-1, keepdims=True)
    return x, m


@pytest.mark.parametrize("n", [16, 17])
@pytest.mark.parametrize("fill", [None, np.inf, np.nan])
def test_mixtrim_dyn_plain_matches_reference(n, fill):
    """K4's plain version against the reference's ``mixtrim_dyn_ref`` and,
    on finite input, its Pallas kernel (interpret) lane by lane, f = 0 ..
    past n/2, with and without the mix, trim and median; a non-finite row
    in lane 1 (its rank trimmed) gives NaN columns on both sides.  The
    wrapper on a CPU tensor is the plain version."""
    fs = np.array([0, 2, (n - 1) // 2, n // 2 + 1, 3], np.int32)
    x, m = _k4_case(n, len(fs), seed=n)
    if fill is not None:
        x[1, n - 1, 3:40] = fill
    for mode in ("trim", "med"):
        for mm in (None, m):
            got = t_mixtrim_dyn_ref(torch.from_numpy(x),
                                    None if mm is None else torch.from_numpy(mm),
                                    torch.from_numpy(fs), mode).numpy()
            wrapped = t_mixtrim_dyn(torch.from_numpy(x),
                                    None if mm is None else torch.from_numpy(mm),
                                    torch.from_numpy(fs), mode).numpy()
            np.testing.assert_array_equal(wrapped, got)
            for k, f in enumerate(fs):
                jm = None if mm is None else jnp.asarray(mm[k])
                want = j_mixtrim_dyn_ref(jnp.asarray(x[k]), jm, jnp.int32(f), mode)
                _assert_close(got[k], want)
                if fill is None:
                    kern = j_mixtrim_dyn(jnp.asarray(x[k]), jm, jnp.int32(f),
                                         mode=mode, block_d=128, interpret=True)
                    _assert_close(got[k], kern)
    if fill is not None:
        trimmed = t_mixtrim_dyn_ref(torch.from_numpy(x), None,
                                    torch.from_numpy(fs), "trim")[1]
        assert bool(torch.isnan(trimmed[3:40]).all())


@pytest.mark.parametrize("b,n,d", [(1, 8, 7), (5, 17, 2842), (3, 16, 100_003)])
def test_gram_batched_plain_matches_reference(b, n, d):
    """K5's plain version (column chunks above 2^16) against the
    reference's ``gram_batched_ref`` and its Pallas kernel (interpret)."""
    rng = np.random.default_rng(b + n + d)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    got = t_gram_batched_ref(torch.from_numpy(x)).numpy()
    _assert_close(got, j_gram_batched_ref(jnp.asarray(x)))
    if d < 10_000:
        _assert_close(got, j_gram_batched(jnp.asarray(x), block_d=128,
                                          interpret=True))
