"""The port's sketch Gram (``AggregatorSpec.sketch_dim``) against the
reference's (``repro.core.robust.tree_sketch_gram``).

The reference draws leaf i's signs as ``rademacher(fold_in(key, i),
(C_i,))``; threefry does not carry across, so those same signs are fed to
the port (``signs=``), with the reference's permutation ``perm =
permutation(key, n)`` for bucketing.

* ``tree_sketch_gram`` within 1e-5 of the largest entry, on leaves whose
  widths are not multiples of ``sketch_dim`` (fp32 and bf16); the flat
  per-segment fold (``kernels.dispatch.dispatch_sketch_gram``) equal to
  the tree form bit for bit.
* ``robust_aggregate`` with the sketch (CWTM / GM / Krum + NNM, and
  bucketing + CWTM / GM with ``perm``) within 1e-5 of the largest magnitude,
  on both port backends; the kernel path records ``sketch_gram`` and no
  K1.  Without randomness the exact Gram is taken.
* The reference's two sketch contracts (tests/test_perf_options.py) run
  on the port with the port's own generator.
* hier + sketch raises ``ValueError`` as in the reference.
* ``robust_aggregate_dyn`` with the sketch against the reference's for
  one lane, within 1e-5.
* Fleet sketch lanes: a 2-lane bucket against its 1-lane runs at rtol
  1e-5, the signs drawn from each lane's generator after its
  permutation; a sketch bucket killed and resumed equals the
  uninterrupted run bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.robust import robust_aggregate as j_agg
from repro.core.robust import robust_aggregate_dyn as j_agg_dyn
from repro.core.robust import tree_sketch_gram as j_sketch_gram
from repro.core.types import AggregatorSpec as JSpec
from repro_torch.core import robust as trobust
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.fleet import FleetRunner, ScenarioSpec, job_from_spec
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.resilience import (
    CheckpointConfig, FaultPlan, SimulatedPreemption,
)
from repro_torch.rounds import RoundOptions
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

N, F, S = 12, 3, 16


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    shift = rng.normal(size=(n, 1)).astype(np.float32)
    return {"a": (rng.normal(size=(n, 37)) + shift).astype(np.float32),
            "b": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "c": rng.normal(size=(n,)).astype(np.float32),
            "d": (rng.normal(size=(n, 2, 16)) * 0.5).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _ref_signs(key, tree, s=S):
    """The reference's draws: leaf i's ceil(d_i / s) Rademacher signs."""
    out = []
    for i, leaf in enumerate(jax.tree_util.tree_leaves(tree)):
        d = int(np.prod(leaf.shape[1:]))
        out.append(torch.from_numpy(np.array(jax.random.rademacher(
            jax.random.fold_in(key, i), (-(-d // s),), jnp.float32))))
    return out


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_sketch_gram_equals_reference(dtype):
    tree = _tree(0)
    key = jax.random.PRNGKey(3)
    jt = {k: v.astype(dtype) for k, v in _j(tree).items()}
    want = np.asarray(j_sketch_gram(jt, S, key))
    tt = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in jt.items()}
    signs = _ref_signs(key, tree)
    got = trobust.tree_sketch_gram(tt, S, signs)
    _close(got.numpy(), want)
    # The flat per-segment fold: the tree form, bit for bit.
    flat, layout = kdispatch.flatten_worker_stack(tt)
    segs = [(off, size) for off, size, _ in layout.segments]
    assert any(size % S for _, size in segs)
    kdispatch.open_record(requested="cuda", backend="cuda", rule="cwtm",
                          pre="nnm")
    g = kdispatch.dispatch_sketch_gram(flat, segs, S, signs, backend="cuda")
    assert torch.equal(g, got)
    assert [d.primitive for d in kdispatch.last_dispatch().decisions] == \
        ["sketch_gram"]
    # Folded in small steps, the same sketch within fp32 rounding.
    sk = kdispatch.sketch_fold(flat[None], segs, S, signs, chunk=S)
    _close((sk @ sk.mT)[0].numpy(), got.numpy(), 1e-6)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_sketch_fold_of_column_blocks_sums_to_the_whole(k):
    """``sketch_fold(c0=)`` on k column blocks (a rank's block of a mesh),
    block edges inside leaves and inside sketch chunks: the blocks'
    sketches sum to the whole stack's within fp32 rounding."""
    tree = _t(_tree(0))
    signs = trobust.draw_signs(trobust.leaf_widths(tree), S,
                               torch.Generator().manual_seed(1))
    flat, layout = kdispatch.flatten_worker_stack(tree)
    segs = [(off, size) for off, size, _ in layout.segments]
    d = flat.shape[1]
    whole = kdispatch.sketch_fold(flat[None], segs, S, signs)
    w = -(-d // k)
    assert any((j * w) % S for j in range(1, k))
    parts = sum(kdispatch.sketch_fold(flat[None, :, j * w:(j + 1) * w],
                                      segs, S, signs, c0=j * w)
                for j in range(k))
    _close(parts[0].numpy(), whole[0].numpy(), 1e-6)


def test_draw_signs_shapes_and_values():
    widths = trobust.leaf_widths(_t(_tree(0)))
    assert widths == [37, 15, 1, 32]
    signs = trobust.draw_signs(widths, S, torch.Generator().manual_seed(0))
    assert [s.shape[0] for s in signs] == [3, 1, 1, 2]
    assert all(s.dtype == torch.float32 and set(s.tolist()) <= {-1.0, 1.0}
               for s in signs)


_CASES = [("cwtm", "nnm"), ("gm", "nnm"), ("krum", "nnm"),
          ("cwtm", "bucketing"), ("gm", "bucketing")]


@pytest.mark.parametrize("rule,pre", _CASES)
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_robust_aggregate_sketch_equals_reference(rule, pre, backend):
    tree = _tree(4)
    key = jax.random.PRNGKey(5)
    want = j_agg(_j(tree), JSpec(rule=rule, f=F, pre=pre, sketch_dim=S),
                 key=key)
    perm = torch.from_numpy(np.array(jax.random.permutation(key, N)))
    got = trobust.robust_aggregate(
        _t(tree), TSpec(rule=rule, f=F, pre=pre, sketch_dim=S,
                        backend=backend),
        perm=perm, signs=_ref_signs(key, tree))
    prims = [d.primitive for d in kdispatch.last_dispatch().decisions]
    assert "gram" not in prims
    # bucketing + CWTM has no Gram consumer: the kernel path folds nothing.
    assert ("sketch_gram" in prims) == (backend == "torch" or rule == "gm"
                                        or pre == "nnm")
    for k in tree:
        _close(got[k].numpy(), np.asarray(want[k]))


def test_sketch_needs_randomness_and_draws_after_the_permutation():
    tree = _t(_tree(6))
    spec = TSpec(rule="gm", f=F, pre="bucketing", sketch_dim=S)
    exact = trobust.robust_aggregate(
        tree, dataclasses.replace(spec, sketch_dim=0),
        perm=torch.arange(N))
    no_signs = trobust.robust_aggregate(tree, spec, perm=torch.arange(N))
    for k in exact:
        assert torch.equal(exact[k], no_signs[k])
    # A generator draws the permutation, then the signs: draw_randomness
    # replays it, and leaves the generator where the aggregate leaves it.
    g1, g2 = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    via_gen = trobust.robust_aggregate(tree, spec, generator=g1)
    perm, signs = trobust.draw_randomness(tree, spec, generator=g2)
    via_draw = trobust.robust_aggregate(tree, spec, perm=perm, signs=signs)
    assert torch.equal(g1.get_state(), g2.get_state())
    for k in via_gen:
        assert torch.equal(via_gen[k], via_draw[k])


def _clustered(seed, n=16, f=3, d=4096):
    """tests/test_perf_options.py's clustered stack (honest cluster near 0,
    f outliers near +25), drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(n - f, d)) * 0.1,
                        rng.normal(size=(f, d)) * 0.1 + 25.0]).astype(
        np.float32)
    return {"a": torch.from_numpy(x[:, : d // 2].copy()),
            "b": torch.from_numpy(x[:, d // 2:].reshape(n, -1, 4).copy())}


@pytest.mark.parametrize("rule", ["cwtm", "gm", "krum"])
def test_sketch_matches_exact_on_separated_data(rule):
    tree = _clustered(1)
    base = trobust.robust_aggregate(tree, TSpec(rule=rule, f=3, pre="nnm"))
    fast = trobust.robust_aggregate(
        tree, TSpec(rule=rule, f=3, pre="nnm", sketch_dim=256),
        generator=torch.Generator().manual_seed(1))
    for a, b in zip(tree_leaves(base), tree_leaves(fast)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-2)


def test_sketch_excludes_byzantine_rows():
    out = trobust.robust_aggregate(
        _clustered(2), TSpec(rule="cwtm", f=3, pre="nnm", sketch_dim=128),
        generator=torch.Generator().manual_seed(2))
    for leaf in tree_leaves(out):
        assert float(leaf.abs().max()) < 2.0


def test_hier_with_sketch_raises_as_reference():
    tree = _tree(0)
    with pytest.raises(ValueError, match="sketch_dim") as j_err:
        j_agg(_j(tree), JSpec(rule="cwtm", f=F, hier=True, sketch_dim=S),
              key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="sketch_dim") as t_err:
        trobust.robust_aggregate(_t(tree), TSpec(rule="cwtm", f=F, hier=True,
                                                 sketch_dim=S),
                                 generator=torch.Generator())
    assert "incompatible with sketch_dim" in str(j_err.value)
    assert "incompatible with sketch_dim" in str(t_err.value)


@pytest.mark.parametrize("rule", ["cwtm", "gm"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_robust_aggregate_dyn_sketch_equals_reference(rule, backend):
    tree = _tree(9)
    key = jax.random.PRNGKey(10)
    want = j_agg_dyn(_j(tree), JSpec(rule=rule, pre="nnm", sketch_dim=S),
                     jnp.int32(F), key=key)
    got = trobust.robust_aggregate_dyn(
        _t(tree), TSpec(rule=rule, pre="nnm", sketch_dim=S, backend=backend),
        torch.tensor(F), signs=_ref_signs(key, tree))
    assert "sketch_gram" in [d.primitive for d in
                             kdispatch.last_dispatch().decisions]
    for k in tree:
        _close(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# Fleet sketch lanes.
# ---------------------------------------------------------------------------

def _sketch_job(seed, rounds=3, sketch_dim=64):
    job = job_from_spec(ScenarioSpec("labelskew_alie_partial", seed=seed,
                                     rounds=rounds))
    agg = dataclasses.replace(job.cfg.agg, sketch_dim=sketch_dim)
    return dataclasses.replace(job, cfg=dataclasses.replace(job.cfg, agg=agg),
                               label=f"sketch:s{seed}")


def test_fleet_sketch_lanes_equal_their_solo_runs():
    both = FleetRunner([_sketch_job(0), _sketch_job(1)], device="cpu")
    assert both.n_buckets == 1
    res = both.run()
    assert "sketch_gram" in [d.primitive for d in
                             kdispatch.last_dispatch().decisions]
    for k, seed in enumerate((0, 1)):
        solo = FleetRunner([_sketch_job(seed)], device="cpu").run()[0]
        for name in ("loss", "direction_norm", "kappa_hat"):
            np.testing.assert_allclose(getattr(res[k].history, name),
                                       getattr(solo.history, name),
                                       rtol=1e-5, err_msg=name)
    assert all(np.isfinite(r.history.loss).all() for r in res)


def test_fleet_sketch_bucket_kill_resume_bitwise(tmp_path):
    jobs = lambda: [_sketch_job(0, rounds=4), _sketch_job(1, rounds=4)]
    ref = FleetRunner(jobs(), chunk=1, device="cpu").run()
    with pytest.raises(SimulatedPreemption):
        FleetRunner(jobs(), device="cpu", options=RoundOptions(
            chunk=1, checkpoint=CheckpointConfig(
                dir=str(tmp_path), sync=True,
                fault_plan=FaultPlan(kill_at=1)))).run()
    res = FleetRunner(jobs(), device="cpu", options=RoundOptions(
        chunk=1, checkpoint=CheckpointConfig(dir=str(tmp_path),
                                             sync=True))).run()
    for a, b in zip(res, ref):
        (x, xm), (y, ym) = a.history.pack(), b.history.pack()
        assert xm == ym
        for k in y:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
        for u, v in zip(tree_leaves(a.state), tree_leaves(b.state)):
            assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))
