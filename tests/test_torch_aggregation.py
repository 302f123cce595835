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


def _nonfinite_x86_row():
    """[3, -NaN, 1, +NaN, 0, -0, inf, 1]: -NaN is x86's default NaN
    (0xffc00000, what inf - inf gives there), +NaN the card's."""
    row = np.array([3, 0, 1, 0, 0, -0.0, np.inf, 1], np.float32)
    row.view(np.uint32)[[1, 3]] = [0xFFC00000, 0x7FC00000]
    return row


def test_smallest_k_follows_lax_top_k_total_order():
    """``lax.top_k(-d2)`` orders d2 in IEEE total order, ties to the lower
    index: -NaN first, -0 before +0, +NaN last.  The port's neighbour
    selection must take the same indices and keep each value's bits."""
    row = _nonfinite_x86_row()
    want = np.asarray(jax.lax.top_k(-jnp.asarray(row), 8)[1])
    np.testing.assert_array_equal(want, [1, 5, 4, 2, 7, 0, 6, 3])
    vals, idx = tgram._smallest_k(torch.from_numpy(row), 8)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  row.view(np.uint32)[want])
    for k in (1, 3, 6):
        np.testing.assert_array_equal(
            tgram._smallest_k(torch.from_numpy(row), k)[1].numpy(), want[:k])
    # Krum's argmin over NaN scores picks the reference's index (the first
    # NaN), whatever the NaN's sign.
    for scores in (row, -row, np.array([2, 1, 1, np.nan], np.float32)):
        assert int(torch.argmin(torch.from_numpy(scores))) == \
            int(jnp.argmin(jnp.asarray(scores)))


def _assert_nonfinite_close(got, want):
    """NaN and inf positions equal, values within 1e-6."""
    for k in want:
        g = np.asarray(got[k], np.float32)
        w = np.asarray(want[k], np.float32)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)],
                                      err_msg=k)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)


def _j_flat_kernel_oracle(stack, rule, f):
    """The reference's flat kernel pipeline for a coordinate rule after
    NNM, with K2's jnp oracle (``mixtrim_ref``) in place of its Pallas
    body: G, M from ``lax.top_k``, then the mix and the sort."""
    from repro.kernels.dispatch import flatten_worker_stack, unflatten_aggregate
    from repro.kernels.mixtrim.ref import mixtrim_ref as j_mixtrim_ref
    x, layout = flatten_worker_stack(jax.tree_util.tree_map(jnp.asarray, stack))
    m = jgram.nnm_matrix(jgram.pdist_sq_from_gram(jgram.gram(x)), f)
    mode = "trim" if rule == "cwtm" else "med"
    return _to_np(unflatten_aggregate(
        j_mixtrim_ref(x, m, f if mode == "trim" else 0, mode), layout))


NNM_RULES = ["cwtm", "cwmed", "krum", "multikrum", "gm", "mda", "average"]


@pytest.mark.parametrize("rule", NNM_RULES)
@pytest.mark.parametrize("attack", ["nan", "inf"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_nnm_nonfinite_attacks_match_reference(rule, attack, backend):
    """pre="nnm" under the nan / inf attacks, n = 17, f = 4.  Under inf,
    d2 between an honest row and an inf row is inf - inf, x86's -NaN, which
    ``lax.top_k(-d2)`` ranks nearest: every row mixes in the inf rows and
    the reference's aggregate is +inf.
    The "torch" backend is held to the reference's "xla" path.  The
    "cuda" backend (on the CPU: the kernels' plain versions) mirrors the
    reference's kernel path: for the gram rules that is "pallas" itself;
    for cwtm / cwmed it is that path with K2's jnp oracle, since the
    reference's Pallas sort disagrees with its own oracle on non-finite
    input (ROADMAP queue 3, facts: its min / max network spreads NaN) and
    the port's K2 follows the oracle."""
    f = 4
    jt = j_attack(attack, jax.tree_util.tree_map(jnp.asarray, _tree(3)), f)
    stack = _to_np(jt)
    if backend == "torch":
        want = _to_np(j_aggregate(jt, JSpec(rule=rule, f=f, pre="nnm",
                                            backend="xla")))
    elif rule in ("cwtm", "cwmed"):
        want = _j_flat_kernel_oracle(stack, rule, f)
    else:
        want = _to_np(j_aggregate(jt, JSpec(rule=rule, f=f, pre="nnm",
                                            backend="pallas")))
    got = _to_np(t_aggregate(_to_torch(stack), TSpec(rule=rule, f=f, pre="nnm",
                                                     backend=backend)))
    _assert_nonfinite_close(got, want)


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


@pytest.mark.parametrize("kw", [dict(sketch_dim=16),
                                dict(backend="cuda_sharded"),
                                dict(backend="cuda_hier")])
def test_unported_options_raise(kw):
    """Options the port once refused now run.  ``sketch_dim`` with no
    randomness takes the exact Gram, as the reference does with
    ``key=None`` (tests/test_torch_sketch.py holds the sketch itself).
    The multi-rank backends (the reference's ``pallas_sharded`` /
    ``pallas_hier``) without a mesh degrade as the reference's do, and the
    degrade is recorded: "cuda_sharded" runs the leaf-streamed torch path,
    "cuda_hier" the dense bucketing path (its stage kept), each with a
    ``pipeline`` fallback decision and ``mesh_devices`` 1; the result is
    that path's bit for bit (tests/test_torch_shard.py holds the meshes)."""
    tree = _to_torch(_tree(0))
    if "sketch_dim" in kw:
        got = t_aggregate(tree, TSpec(rule="cwtm", f=2, **kw))
        want = t_aggregate(tree, TSpec(rule="cwtm", f=2))
        for k in want:
            assert torch.equal(got[k], want[k])
        return
    hier = kw["backend"] == "cuda_hier"
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(3))
    extra = dict(bucket_size=2) if hier else {}
    got = t_aggregate(tree, TSpec(rule="cwtm", f=2, **kw, **extra), perm=perm)
    rec = kdispatch.last_dispatch()
    assert rec.requested == kw["backend"] and rec.backend == "torch"
    assert rec.hier == hier and rec.mesh_devices == 1 and rec.mesh_axis is None
    assert [d.primitive for d in rec.fallbacks] == ["pipeline"], rec.describe()
    assert "no multi-rank mesh" in rec.fallbacks[0].reason
    want = t_aggregate(tree, TSpec(rule="cwtm", f=2, backend="torch",
                                   hier=hier, **extra), perm=perm)
    for k in want:
        assert torch.equal(got[k], want[k])


# --- hierarchical aggregation and pre="bucketing" -------------------------
#
# The reference draws the bucket permutation from its PRNG key; the port is
# handed that same permutation as ``perm``, so both group the workers
# identically.  n = 17, f = 4: s = floor(17/8) = 2 gives 9 buckets, one a
# singleton (the ragged tail), and f' = 4.  Same tolerance as above.

N_H, F_H = 17, 4
KEY_H = jax.random.PRNGKey(5)


@pytest.fixture(scope="module")
def alie_stack_h():
    jt = jax.tree_util.tree_map(jnp.asarray, _tree(7, N_H))
    return _to_np(j_attack("alie", jt, F_H, eta=1.5))


def _perm_h(key=KEY_H, n=N_H):
    return torch.from_numpy(np.array(jax.random.permutation(key, n)))


@pytest.mark.parametrize("rule", ["cwtm", "cwmed", "gm", "krum"])
@pytest.mark.parametrize("pre", [None, "nnm"])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("xla", "torch")])
def test_hier_matches_reference(alie_stack_h, rule, pre, backends):
    """The port's "cuda" backend (on the CPU: K6 / K7, K1-K3's plain
    versions) against the reference's "pallas" (interpret-mode kernels),
    and the port's "torch" (gather form) against the reference's "xla"."""
    jback, tback = backends
    want = j_aggregate(jax.tree_util.tree_map(jnp.asarray, alie_stack_h),
                       JSpec(rule=rule, f=F_H, pre=pre, hier=True,
                             backend=jback), key=KEY_H)
    got = t_aggregate(_to_torch(alie_stack_h),
                      TSpec(rule=rule, f=F_H, pre=pre, hier=True,
                            backend=tback), perm=_perm_h())
    _assert_close(_to_np(got), _to_np(want))
    rec = kdispatch.last_dispatch()
    assert rec.hier and rec.backend == tback
    stage = [d for d in rec.decisions
             if d.primitive in ("bucketgram", "bucketmeans")]
    assert len(stage) == 1
    if tback == "cuda":
        # K6 when a Gram consumer follows (its Gram replaces K1's), else K7.
        need_gram = pre == "nnm" or rule in ("gm", "krum")
        assert stage[0].primitive == ("bucketgram" if need_gram
                                      else "bucketmeans")
        # No K1 pass over the stack; with 9 > 8 buckets K6 takes the Gram
        # of its fp32 means by a K1 launch, recorded with that reason.
        assert all("fp32 means" in d.reason for d in rec.decisions
                   if d.primitive == "gram")


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("xla", "torch")])
@pytest.mark.parametrize("bucket_size", [None, 3])
def test_pre_bucketing_matches_reference(alie_stack_h, rule, backends,
                                         bucket_size):
    jback, tback = backends
    want = j_aggregate(jax.tree_util.tree_map(jnp.asarray, alie_stack_h),
                       JSpec(rule=rule, f=F_H, pre="bucketing",
                             bucket_size=bucket_size, backend=jback),
                       key=KEY_H)
    got = t_aggregate(_to_torch(alie_stack_h),
                      TSpec(rule=rule, f=F_H, pre="bucketing",
                            bucket_size=bucket_size, backend=tback),
                      perm=_perm_h())
    _assert_close(_to_np(got), _to_np(want))


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
@pytest.mark.parametrize("backends", [("pallas", "cuda"), ("xla", "torch")])
def test_hier_bf16_transport_matches_reference(alie_stack_h, rule, backends):
    """Each port backend against its reference counterpart: with a bf16
    stack the two reference paths differ (the kernel path takes the Gram of
    the fp32 means, the gather form of the bf16-rounded ones: 4e-4 apart
    for gm here), and the port keeps each semantics on its own path."""
    jback, tback = backends
    want = j_aggregate(jax.tree_util.tree_map(jnp.asarray, alie_stack_h),
                       JSpec(rule=rule, f=F_H, pre="nnm", hier=True,
                             backend=jback, transport_dtype="bf16"),
                       key=KEY_H)
    got = t_aggregate(_to_torch(alie_stack_h),
                      TSpec(rule=rule, f=F_H, pre="nnm", hier=True,
                            backend=tback, transport_dtype="bf16"),
                      perm=_perm_h())
    _assert_close(_to_np(got), _to_np(want))


@pytest.mark.parametrize("kw,match", [
    (dict(hier=True, pre="bucketing"), "bucket twice"),
    (dict(hier=True, sketch_dim=8), "sketch_dim"),
])
def test_hier_validation_errors_match_reference(kw, match):
    tree = _tree(8, N_H)
    with pytest.raises(ValueError, match=match):
        j_aggregate(jax.tree_util.tree_map(jnp.asarray, tree),
                    JSpec(rule="cwtm", f=F_H, backend="xla", **kw), key=KEY_H)
    with pytest.raises(ValueError, match=match):
        t_aggregate(_to_torch(tree), TSpec(rule="cwtm", f=F_H, **kw),
                    perm=_perm_h())


@pytest.mark.parametrize("kw", [dict(hier=True), dict(pre="bucketing"),
                                dict(hier=True, bucket_size=1)])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_bucketing_without_a_permutation_source_raises(kw, backend):
    with pytest.raises(ValueError, match="Generator or a perm"):
        t_aggregate(_to_torch(_tree(8, N_H)),
                    TSpec(rule="cwtm", f=F_H, backend=backend, **kw))


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
@pytest.mark.parametrize("pre", [None, "nnm"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_hier_bucket_size_one_is_bitwise_the_dense_pipeline(
        alie_stack_h, rule, pre, backend):
    """s = 1 skips the stage (recorded) without drawing a permutation."""
    dense = t_aggregate(_to_torch(alie_stack_h),
                        TSpec(rule=rule, f=F_H, pre=pre, backend=backend))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    got = t_aggregate(_to_torch(alie_stack_h),
                      TSpec(rule=rule, f=F_H, pre=pre, backend=backend,
                            hier=True, bucket_size=1), generator=gen)
    for k in dense:
        assert torch.equal(got[k], dense[k]), k
    assert torch.equal(gen.get_state(), state)
    rec = kdispatch.last_dispatch()
    skipped = [d for d in rec.decisions if d.primitive == "bucketgram"]
    assert [d.used for d in skipped] == ["skipped"]
    assert not skipped[0].fell_back


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_generator_draws_the_permutation_it_is_given(alie_stack_h, backend):
    spec = TSpec(rule="cwtm", f=F_H, pre="nnm", hier=True, backend=backend)
    got = t_aggregate(_to_torch(alie_stack_h), spec,
                      generator=torch.Generator().manual_seed(11))
    perm = torch.randperm(N_H, generator=torch.Generator().manual_seed(11))
    want = t_aggregate(_to_torch(alie_stack_h), spec, perm=perm)
    for k in want:
        assert torch.equal(got[k], want[k]), k
