"""Hierarchical aggregation on the port's dynamic-f path, and hierarchical
fleet lanes, against the JAX reference.

The same numpy arrays go to both packages.  Randomness does not carry
across them: where the reference draws a bucket permutation from its PRNG
key (``jax.random.permutation(key, n)``, what ``bucket_assignment`` and
``_tree_bucket_dyn`` draw), the port is handed that permutation.

Held here:
* ``robust_aggregate_dyn`` with ``hier=True`` (one lane) and
  ``batched_robust_aggregate`` (per-lane f and permutations) on both port
  backends against the reference's "xla" backend; on the CPU the port's
  "cuda" backend runs the flat pipeline through the kernels' plain
  versions (K6 / K7's lane form, K5, K4, K2's median and K3's lane forms);
* bucket size 1: bitwise the dense dynamic pipeline, recorded "skipped";
* the lane plain versions of K6 / K7, K3 and K2's median against their
  single-lane plain versions on each lane, bitwise, ±inf / NaN rows
  included (the dense contraction's 0 * inf = NaN stays in its lane);
* the refusals the reference makes (hier without ``bucket_size``), the
  port's refusal of taps with hier, and ``bucket_key``;
* ``FleetRunner`` of hierarchical jobs from the reference's parameters
  (``interop``), fed the reference's permutations; kill and resume;
  ``FleetService`` up front and restored.

Tolerances: aggregates within RTOL = 1e-5 of the largest output magnitude
(the reference's fp32 contract, sums in another order).  GM is held to
GM_RTOL = 2e-4: on four to nine bucket means Weiszfeld's fixed iterations
end near one of the points, where a 1e-7 relative perturbation of the
input moves the reference's own aggregate by 3.6e-5 of its magnitude
(measured on this file's lane stack, s = 5, lane 2); the port lands
7.7e-5 from the reference there.  Fleet histories: per-round loss and
direction_norm within the reference's fleet tolerance, rtol 1e-4
(tests/test_torch_fleet.py), the first round, which aggregates the same
stack in both, within 1e-5; a lane against its 1-lane solo run within
1e-5 (fp32 sums in another batch shape).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.robust import batched_robust_aggregate as j_batched
from repro.core.robust import robust_aggregate_dyn as j_dyn
from repro.core.types import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import constant_attack as j_constant
from repro.fed.scenarios import _mlp_init as j_init
from repro.fed.scenarios import _mlp_loss as j_loss
from repro.fed.scenarios import cohort_batch_fn as j_batch_fn
from repro.data import build_heterogeneous as j_hetero
from repro.fleet import FleetJob as JJob
from repro.fleet import FleetRunner as JRunner
from repro.fleet import SCENARIO_OPTIMIZER as J_OPT
from repro_torch.core.robust import batched_robust_aggregate as t_batched
from repro_torch.core.robust import robust_aggregate_dyn as t_dyn
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.fed import ClientConfig, FedConfig, constant_attack
from repro_torch.fleet import FleetJob, FleetRunner, bucket_key
from repro_torch.fleet import runner as trunner
from repro_torch.interop import mlp_params_from_numpy
from repro_torch.kernels import (
    bucket_means_gram_lanes_ref, bucket_means_gram_ref, bucketgram_lanes,
    bucketmeans_lanes, combine_lanes, combine_lanes_ref, combine_ref,
    mixtrim_lanes, mixtrim_lanes_ref, mixtrim_ref,
)
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.bucketgram import assignment_matrix
from repro_torch.kernels.gram import gram_batched_ref
from repro_torch.launch import grid as tgrid
from repro_torch.optim import sgd
from repro_torch.resilience import (
    CheckpointConfig, FaultPlan, SimulatedPreemption,
)
from repro_torch.rounds import RoundOptions
from repro_torch.serving import FleetService
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

RTOL = 1e-5
GM_RTOL = 2e-4          # module docstring: GM on a few bucket means
FLEET_RTOL = 1e-4
N = 17
B = 4
LANE_F = np.array([0, 1, 3, 4], np.int32)
RULES = ("cwtm", "cwmed", "gm", "krum", "average")
SIZES = (2, 3, 5)


def _stack(seed, b=B, n=N):
    """A (b, n, ...) two-leaf stack (D = 5 * 61 + 7) with the last rows of
    each lane shifted away from the honest ones, as an attack would."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(b, n, 5, 61)).astype(np.float32)
    v = rng.normal(size=(b, n, 7)).astype(np.float32)
    w[:, n - 3:] += 4.0
    return {"w": w, "v": v}


def _perms(seed, b=B, n=N):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, np.stack([np.asarray(jax.random.permutation(k, n))
                           for k in keys])


def _spec(cls, rule, pre, s, backend):
    return cls(rule=rule, pre=pre, hier=True, bucket_size=s, backend=backend)


def _tol(rule):
    return GM_RTOL if rule == "gm" else RTOL


def _same(a, b) -> bool:
    """Bit for bit, NaN positions included (NaN != NaN to torch.equal)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(na, nb)
            and torch.equal(a[~na], b[~nb]))


def _assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=rtol * scale)


# ---------------------------------------------------------------------------
# One lane: robust_aggregate_dyn with hier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("s", SIZES)
@pytest.mark.parametrize("pre", [None, "nnm"])
@pytest.mark.parametrize("rule", RULES)
def test_single_lane_hier_matches_reference(rule, pre, s, backend):
    stack = {k: v[0] for k, v in _stack(len(rule) + s).items()}
    key = jax.random.PRNGKey(s)
    perm = np.asarray(jax.random.permutation(key, N))
    want = j_dyn(jax.tree_util.tree_map(jnp.asarray, stack),
                 _spec(JSpec, rule, pre, s, "xla"), jnp.int32(4), key=key)
    got = t_dyn({k: torch.from_numpy(v) for k, v in stack.items()},
                _spec(TSpec, rule, pre, s, backend), torch.tensor(4),
                perm=torch.from_numpy(perm))
    for k in stack:
        _assert_close(got[k].numpy(), want[k], _tol(rule))
    rec = kdispatch.last_dispatch()
    assert rec.hier and rec.dyn and rec.bucket_size == s
    used = {d.primitive: d.used for d in rec.decisions}
    if backend == "cuda":
        # One lane: the single-lane K6 / K7, K1 above 8 buckets.
        name = "bucketgram" if (pre == "nnm" or rule != "cwtm"
                                and rule != "cwmed") else "bucketmeans"
        assert used[name] == "plain"
        assert ("gram" in used) == (name == "bucketgram"
                                     and -(-N // s) > 8)
    else:
        assert used["bucketgram"] == "torch"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("rule", ["cwtm", "gm"])
def test_bucket_size_one_is_the_dense_dynamic_pipeline(rule, backend):
    """s = 1: bitwise the dense dynamic pipeline, lanes and one lane, the
    stage recorded as skipped, no permutation drawn or needed."""
    stack = _stack(5)
    ttree = {k: torch.from_numpy(v) for k, v in stack.items()}
    fs = torch.from_numpy(LANE_F)
    hier = TSpec(rule=rule, pre="nnm", hier=True, bucket_size=1,
                 backend=backend)
    dense = TSpec(rule=rule, pre="nnm", backend=backend)
    got = t_batched(ttree, hier, fs)
    rec = kdispatch.last_dispatch()
    assert ("bucketgram", "skipped") in [(d.primitive, d.used)
                                         for d in rec.decisions]
    want = t_batched(ttree, dense, fs)
    for k in stack:
        assert torch.equal(got[k], want[k])
    one = t_dyn({k: v[2] for k, v in ttree.items()}, hier, fs[2])
    ref = t_dyn({k: v[2] for k, v in ttree.items()}, dense, fs[2])
    for k in stack:
        assert torch.equal(one[k], ref[k])


def test_bucket_size_is_clamped_to_n_on_the_dynamic_path():
    """bucket_size above n is one bucket of every worker (the dynamic
    clamp max(1, min(s, n)); the static clamp would cap it by f)."""
    stack = {k: v[0] for k, v in _stack(8).items()}
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, N))
    want = j_dyn(jax.tree_util.tree_map(jnp.asarray, stack),
                 _spec(JSpec, "average", None, 40, "xla"), jnp.int32(4),
                 key=key)
    got = t_dyn({k: torch.from_numpy(v) for k, v in stack.items()},
                _spec(TSpec, "average", None, 40, "cuda"), torch.tensor(4),
                perm=torch.from_numpy(perm))
    for k in stack:
        _assert_close(got[k].numpy(), want[k])
        _assert_close(got[k].numpy(), stack[k].mean(0))


# ---------------------------------------------------------------------------
# Lanes: batched_robust_aggregate with hier.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("s", [2, 3])
@pytest.mark.parametrize("pre", [None, "nnm"])
@pytest.mark.parametrize("rule", RULES)
def test_hier_lanes_match_single_lane_and_reference(rule, pre, s, backend):
    stack = _stack(11 * s + len(rule))
    keys, perms = _perms(s)
    ttree = {k: torch.from_numpy(v) for k, v in stack.items()}
    got = t_batched(ttree, _spec(TSpec, rule, pre, s, backend),
                    torch.from_numpy(LANE_F), perms=torch.from_numpy(perms))
    rec = kdispatch.last_dispatch()
    assert rec.hier and rec.lanes == B
    if backend == "cuda":
        # One decision for all the lanes, the lane forms.
        prims = [d.primitive for d in rec.decisions]
        assert prims[0].endswith("_lanes")
        assert all(p in ("bucketgram_lanes", "bucketmeans_lanes",
                         "gram_batched", "mixtrim_dyn", "mixtrim_lanes",
                         "combine_lanes") for p in prims), prims
    want = j_batched(jax.tree_util.tree_map(jnp.asarray, stack),
                     _spec(JSpec, rule, pre, s, "xla"),
                     jnp.asarray(LANE_F), keys=keys)
    for k in stack:
        _assert_close(got[k].numpy(), want[k], _tol(rule))
    for lane in range(B):
        one = t_dyn({k: v[lane] for k, v in ttree.items()},
                    _spec(TSpec, rule, pre, s, backend),
                    torch.tensor(int(LANE_F[lane])),
                    perm=torch.from_numpy(perms[lane]))
        for k in stack:
            _assert_close(got[k][lane].numpy(), one[k].numpy())


def test_hier_lanes_draw_each_lane_from_its_generator():
    """With generators, lane b's permutation is drawn from generator b
    (the fleet's lane_draws order); the same draws fed as perms agree
    bit for bit."""
    ttree = {k: torch.from_numpy(v) for k, v in _stack(2).items()}
    spec = _spec(TSpec, "cwtm", "nnm", 3, "cuda")
    fs = torch.from_numpy(LANE_F)
    got = t_batched(ttree, spec, fs, generators=[
        torch.Generator().manual_seed(k) for k in range(B)])
    perms = torch.stack([torch.randperm(N, generator=torch.Generator()
                                        .manual_seed(k)) for k in range(B)])
    want = t_batched(ttree, spec, fs, perms=perms)
    for k in ttree:
        assert torch.equal(got[k], want[k])


def test_hier_lanes_on_bf16_transport_match_the_torch_backend():
    """bf16 transport: the kernel path's bf16 bucket means against the
    torch backend's gather form (each mean rounded once to bf16, from
    fp32 sums in another order: one bf16 ulp)."""
    ttree = {k: torch.from_numpy(v) for k, v in _stack(4).items()}
    _, perms = _perms(9)
    fs = torch.from_numpy(LANE_F)
    out = {}
    for backend in ("torch", "cuda"):
        spec = TSpec(rule="cwtm", pre=None, hier=True, bucket_size=3,
                     backend=backend, transport_dtype="bf16")
        out[backend] = t_batched(ttree, spec, fs,
                                 perms=torch.from_numpy(perms))
    for k in ttree:
        want = out["torch"][k].numpy()
        np.testing.assert_allclose(out["cuda"][k].numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


# ---------------------------------------------------------------------------
# The lane plain versions against the single-lane plain versions.
# ---------------------------------------------------------------------------

def _nonfinite_stack(seed, b=3, n=N, d=301):
    x = np.random.default_rng(seed).normal(size=(b, n, d)).astype(np.float32)
    x[1, 4, 10:20] = np.inf
    x[1, 9, 15:25] = -np.inf
    x[2, 7, 30:40] = np.nan
    return torch.from_numpy(x)


def _assignments(perms, s):
    return torch.div(torch.argsort(torch.from_numpy(perms), dim=1), s,
                     rounding_mode="floor")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 3])
def test_bucketgram_lane_plain_is_the_single_lane_plain_per_lane(s, dtype):
    """K6 (n_b = 6 at s = 3, 9 at s = 2) and K7 lane plain versions: each
    lane bit for bit the single-lane plain version on that lane; the
    non-finite rows of lanes 1 and 2 spread NaN to their lane's other
    buckets only."""
    x = _nonfinite_stack(s).to(dtype)
    _, perms = _perms(s, b=3)
    assign = _assignments(perms, s)
    nb = -(-N // s)
    y, g = bucket_means_gram_lanes_ref(x, assign, nb)
    ym = bucketmeans_lanes(x, assign, nb)
    yk, gk = bucketgram_lanes(x, assign, nb)
    assert _same(ym, y) and _same(yk, y) and _same(gk, g)
    assert y.shape == (3, nb, x.shape[2]) and y.dtype == dtype
    for k in range(3):
        y1, g1 = bucket_means_gram_ref(x[k], assignment_matrix(assign[k], nb))
        assert _same(y[k], y1) and _same(g[k], g1)
    assert not bool(torch.isnan(y[0]).any())
    assert not bool(torch.isnan(g[0]).any())
    # Lane 1's inf rows: every bucket but theirs is NaN in those columns.
    bad = int(assign[1, 4])
    others = [b for b in range(nb) if b != bad and b != int(assign[1, 9])]
    assert bool(torch.isnan(y[1][others, 10:25]).all())
    assert bool(torch.isnan(y[2][:, 30:40]).all())
    assert not bool(torch.isnan(y[2][:, :30]).any())
    if dtype == torch.float32:
        assert _same(g, gram_batched_ref(y))


def test_combine_and_median_lane_plain_are_the_single_lane_plain_per_lane():
    x = _nonfinite_stack(7, b=4)
    rng = np.random.default_rng(3)
    c = torch.from_numpy(rng.dirichlet(np.ones(N), size=4).astype(np.float32))
    m = torch.softmax(torch.from_numpy(
        rng.normal(size=(4, N, N)).astype(np.float32)), -1)
    got = combine_lanes(x, c)
    assert _same(got, combine_lanes_ref(x, c))
    for k in range(4):
        assert _same(got[k], combine_ref(x[k], c[k]))
    assert not bool(torch.isnan(got[0]).any())
    for mm in (m, None):
        med = mixtrim_lanes(x, mm)
        assert _same(med, mixtrim_lanes_ref(x, mm))
        for k in range(4):
            want = mixtrim_ref(x[k], None if mm is None else mm[k], 0, "med")
            assert _same(med[k], want)
        assert not bool(torch.isnan(med[0]).any())
        assert not bool(torch.isnan(med[3]).any())
    # bf16: the coefficients round to X's dtype first, per lane.
    xb = x.to(torch.bfloat16)
    gotb = combine_lanes(xb, c)
    for k in range(4):
        assert _same(gotb[k], combine_ref(xb[k], c[k]))


def test_dispatch_records_one_decision_per_lane_form():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, N, 40)).astype(np.float32))
    _, perms = _perms(1, b=3)
    assign = _assignments(perms, 2)
    kdispatch.open_record(requested="cuda", backend="cuda", rule="cwtm",
                          pre="nnm", dyn=True, lanes=3)
    y, g = kdispatch.dispatch_bucketgram(x, assign, 9, backend="cuda")
    kdispatch.dispatch_combine(x, torch.full((3, N), 1.0 / N), backend="cuda")
    kdispatch.dispatch_mixtrim(x, None, torch.zeros(3, dtype=torch.int64),
                               mode="med", backend="cuda", dyn=True)
    rec = kdispatch.last_dispatch()
    assert [(d.primitive, d.used) for d in rec.decisions] == [
        ("bucketgram_lanes", "plain"), ("gram_batched", "plain"),
        ("combine_lanes", "plain"), ("mixtrim_lanes", "plain")]
    assert "K5" in rec.decisions[1].reason
    assert y.shape == (3, 9, 40) and g.shape == (3, 9, 9)
    assert set(kdispatch.KERNELS) >= {"bucketgram_lanes", "bucketmeans_lanes",
                                      "combine_lanes", "mixtrim_lanes"}


# ---------------------------------------------------------------------------
# Refusals.
# ---------------------------------------------------------------------------

_OPT = sgd(clip=1.0)


def _quad_loss(params, batch):
    c = batch["idx"].float().reshape(-1)[0]
    return 0.5 * torch.sum((params["theta"] - c) ** 2), {}


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def _quad_job(label, *, rule="cwtm", pre="nnm", s=3, f=4, seed=0,
              rounds=4, attack="alie", eval_every=0, d=6, n=N):
    """A quadratic job (tests/test_hier.py's ``_hier_job``, widened: n
    clients, all of them every round, client i pulled towards i)."""
    cfg = FedConfig(n_clients=n, clients_per_round=n, f=f,
                    agg=TSpec(rule=rule, f=f, pre=pre, hier=True,
                              bucket_size=s),
                    client=ClientConfig(local_steps=0, local_lr=0.05,
                                        algorithm="dshb", beta=0.9))
    eval_fn = (lambda p: -torch.sum(p["theta"] ** 2)) if eval_every else None
    return FleetJob(label=label, cfg=cfg, loss_fn=_quad_loss,
                    optimizer=_OPT,
                    params={"theta": torch.linspace(-1.0, 1.0, d)},
                    batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                    schedule=constant_attack(attack, 2.0),
                    eval_fn=eval_fn, eval_every=eval_every,
                    lr_fn=lambda r: 0.1)


def test_hier_without_bucket_size_is_refused_as_the_reference_refuses():
    job = _quad_job("h")
    bad = dataclasses.replace(job.cfg.agg, bucket_size=None)
    with pytest.raises(ValueError, match="bucket_size"):
        dataclasses.replace(job, cfg=dataclasses.replace(job.cfg, agg=bad))
    one = {"w": torch.zeros(N, 3)}
    with pytest.raises(ValueError, match="bucket_size"):
        t_dyn(one, TSpec(rule="cwtm", hier=True), 1,
              generator=torch.Generator())
    with pytest.raises(ValueError, match="bucket_size"):
        j_dyn({"w": jnp.zeros((N, 3))}, JSpec(rule="cwtm", hier=True),
              jnp.int32(1), key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="bucket_size"):
        t_batched({"w": torch.zeros(2, N, 3)}, TSpec(rule="cwtm", hier=True),
                  torch.tensor([1, 1]), perms=torch.zeros(2, N))


def test_bucket_key_separates_hier_lanes():
    job = _quad_job("h")
    plain = dataclasses.replace(job, cfg=dataclasses.replace(
        job.cfg, agg=dataclasses.replace(job.cfg.agg, hier=False)))
    assert bucket_key(job) != bucket_key(plain)
    other = _quad_job("h2", s=2)
    assert bucket_key(job) != bucket_key(other)
    assert bucket_key(job) == bucket_key(_quad_job("h3", seed=5))


def test_hier_lanes_refuse_taps_and_the_mesh_backends():
    job = _quad_job("h")
    with pytest.raises(ValueError, match="hier=True"):
        dataclasses.replace(job, cfg=dataclasses.replace(job.cfg, taps=True))
    with pytest.raises(ValueError, match="hier=True"):
        FleetRunner([job], options=RoundOptions(taps=True), device="cpu")
    with pytest.raises(ValueError, match="hier=True"):
        t_batched({"w": torch.zeros(2, N, 3)},
                  TSpec(rule="cwtm", pre="nnm", hier=True, bucket_size=2),
                  torch.tensor([1, 1]), perms=torch.stack(
                      [torch.arange(N)] * 2), internals={})
    # Without a mesh the multi-rank backends degrade, recorded, to the
    # dense bucketing lanes of the torch backend, bit for bit.
    x = torch.arange(2 * N * 3, dtype=torch.float32).reshape(2, N, 3)
    perms = torch.stack([torch.arange(N), torch.arange(N).flip(0)])
    want = t_batched({"w": x}, TSpec(rule="cwtm", hier=True, bucket_size=2,
                                     backend="torch"),
                     torch.tensor([1, 1]), perms=perms)
    for backend in ("cuda_sharded", "cuda_hier"):
        got = t_batched({"w": x},
                        TSpec(rule="cwtm", hier=True, bucket_size=2,
                              backend=backend),
                        torch.tensor([1, 1]), perms=perms)
        rec = kdispatch.last_dispatch()
        assert rec.requested == backend and rec.backend == "torch"
        assert rec.hier and rec.mesh_devices == 1
        assert [d.primitive for d in rec.fallbacks] == ["pipeline"], \
            rec.describe()
        assert torch.equal(got["w"], want["w"])


def test_lane_draws_give_hier_lanes_a_permutation_and_fillers_the_identity():
    job = _quad_job("h", s=3)
    gen = trunner.lane_generator(job)
    assert gen is not None
    batch = job.batch_fn(np.arange(N), 0, np.random.default_rng(0))
    perm, noise, signs = trunner.lane_draws(job.cfg, gen, batch)
    want = torch.randperm(N, generator=torch.Generator().manual_seed(0))
    assert torch.equal(perm, want) and noise is None and signs is None
    perm, _, _ = trunner.filler_draws(job.cfg, batch)
    assert torch.equal(perm, torch.arange(N))
    one = _quad_job("h1", s=1)
    assert trunner.lane_generator(one) is None
    assert trunner.lane_draws(one.cfg, None, batch)[0] is None


# ---------------------------------------------------------------------------
# The fleet: FleetRunner against the reference, kill / resume, the service.
# ---------------------------------------------------------------------------

SEED, F = 1, 4
INTEROP_CELLS = [(rule, attack) for rule in ("cwtm", "cwmed", "gm")
                 for attack in ("alie", "sf")]
INTEROP_S, INTEROP_ROUNDS = 3, 3


def _ref_hier_jobs(steps=INTEROP_ROUNDS, s=INTEROP_S):
    """The grid's cells (n = 17, f = 4, the 48-48-10 MLP), hierarchical
    with bucket size ``s``, NNM before the rule."""
    (x, y), _ = tgrid._make_task()
    ds = j_hetero({"x": x, "y": y}, "y", N, alpha=0.1, seed=SEED)
    batch_fn = j_batch_fn(ds, 25, 0)
    params = j_init(jax.random.PRNGKey(SEED), x.shape[1])
    jobs = []
    for rule, attack in INTEROP_CELLS:
        spec = JSpec(rule=rule, f=F, pre="nnm", hier=True, bucket_size=s,
                     backend="xla")
        cfg = JFed(n_clients=N, clients_per_round=N, f=F, agg=spec,
                   client=JClient(algorithm="dshb", beta=0.9))
        jobs.append(JJob(
            label=f"{rule}|nnm|{attack}", cfg=cfg, loss_fn=j_loss,
            optimizer=J_OPT, params=params, batch_fn=batch_fn, rounds=steps,
            seed=SEED, schedule=j_constant(
                attack, 8.0 if attack == "alie" else None),
            lr_fn=lambda r: 0.5))
    return jobs, jax.tree_util.tree_map(np.asarray, params)


def _port_hier_jobs(params, steps=INTEROP_ROUNDS, s=INTEROP_S,
                    backend="torch"):
    train, test = tgrid._make_task()
    cell = tgrid._grid_jobs(train, test, alpha=0.1, steps=steps, seed=SEED,
                            params=mlp_params_from_numpy(params),
                            backend=backend)
    jobs = []
    for rule, attack in INTEROP_CELLS:
        job = cell(f"{rule}|nnm|{attack}", rule, "nnm", attack, F)
        agg = dataclasses.replace(job.cfg.agg, hier=True, bucket_size=s)
        jobs.append(dataclasses.replace(
            job, cfg=dataclasses.replace(job.cfg, agg=agg),
            lr_fn=lambda r: 0.5, eval_fn=None, eval_every=0))
    return jobs


def _reference_perms(seed, rounds, m=N):
    """The permutations the reference's lane draws: its lane key starts at
    PRNGKey(seed), each round splits off the aggregation key, and
    ``_tree_bucket_dyn`` permutes with it."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, agg_key = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(
            jax.random.permutation(agg_key, m))))
    return torch.stack(out)


@pytest.fixture(scope="module")
def interop_runs():
    jjobs, params = _ref_hier_jobs()
    jres = JRunner(jjobs).run()
    orig = trunner.FleetRunner._plan_bucket

    def with_reference_perms(self, bucket):
        operands, meta = orig(self, bucket)
        rounds = operands["idx"].shape[0]
        operands["perm"] = torch.stack(
            [_reference_perms(j.seed, rounds) for j in bucket.jobs], dim=1)
        return operands, meta

    trunner.FleetRunner._plan_bucket = with_reference_perms
    try:
        out = {b: FleetRunner(_port_hier_jobs(params, backend=b),
                              device="cpu").run() for b in ("torch", "cuda")}
    finally:
        trunner.FleetRunner._plan_bucket = orig
    return jres, out, params


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fleet_hier_lanes_track_the_reference_with_its_permutations(
        interop_runs, backend):
    jres, out, _ = interop_runs
    for j, t in zip(jres, out[backend]):
        assert t.label == j.label
        for jc, tc in zip(j.history.cohorts, t.history.cohorts):
            np.testing.assert_array_equal(tc, jc)
        for col in ("loss", "direction_norm"):
            a = np.asarray(getattr(t.history, col))
            b = np.asarray(getattr(j.history, col))
            np.testing.assert_allclose(a[:1], b[:1], rtol=RTOL,
                                       err_msg=f"{t.label} {col} round 0")
            np.testing.assert_allclose(a, b, rtol=FLEET_RTOL,
                                       err_msg=f"{t.label} {col}")


def test_fleet_hier_backends_agree(interop_runs):
    _, out, _ = interop_runs
    for a, b in zip(out["cuda"], out["torch"]):
        for col in ("loss", "direction_norm"):
            np.testing.assert_allclose(getattr(a.history, col),
                                       getattr(b.history, col),
                                       rtol=FLEET_RTOL, err_msg=a.label)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fleet_hier_lane_equals_its_solo_run(interop_runs, backend):
    """Whole runs, each lane drawing its own permutations from its
    generator: each lane of a 2-lane bucket against its 1-lane solo run."""
    _, _, params = interop_runs
    jobs = _port_hier_jobs(params, backend=backend)
    res = FleetRunner(jobs, device="cpu").run()
    for job, r in zip(jobs, res):
        solo = FleetRunner([job], device="cpu").run()[0]
        for col in ("loss", "direction_norm", "kappa_hat"):
            np.testing.assert_allclose(getattr(r.history, col),
                                       getattr(solo.history, col),
                                       rtol=RTOL, atol=1e-7, err_msg=r.label)


def _assert_same_result(a, b):
    assert a.label == b.label and a.history.rounds == b.history.rounds
    (x, xm), (y, ym) = a.history.pack(), b.history.pack()
    assert xm == ym
    for k in y:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a.evals == b.evals and a.best_eval == b.best_eval
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and torch.equal(u, v)


def _quad_jobs(backend="cuda"):
    def j(label, **kw):
        job = _quad_job(label, **kw)
        agg = dataclasses.replace(job.cfg.agg, backend=backend)
        return dataclasses.replace(job, cfg=dataclasses.replace(job.cfg,
                                                                agg=agg))
    return [j("a", seed=0, rounds=6, eval_every=2),
            j("b", seed=1, rounds=4, eval_every=2, attack="sf"),
            j("c", seed=2, rounds=6, f=3),
            j("g", rule="gm", seed=3, rounds=5),
            j("m", rule="cwmed", s=2, seed=4, rounds=4)]


@pytest.mark.parametrize("kind,fault", [
    ("quad", FaultPlan(kill_at=0)), ("quad", FaultPlan(kill_at=1)),
    ("quad", FaultPlan(torn_at=1)), ("grid", FaultPlan(kill_at=0))],
    ids=["quad-kill@0", "quad-kill@1", "quad-torn@1", "grid-kill@0"])
def test_fleet_hier_kill_resume_bitwise(tmp_path, interop_runs, kind, fault):
    """Killed after a snapshot and resumed, bit for bit: the quadratic
    jobs (three hier buckets), and the interop runner's grid jobs (each
    lane's generator picks up where it stopped)."""
    params = interop_runs[2]

    def jobs():
        return _quad_jobs() if kind == "quad" else _port_hier_jobs(
            params, backend="cuda")

    chunk = 2 if kind == "quad" else 1
    ref = FleetRunner(jobs(), chunk=chunk, device="cpu").run()
    with pytest.raises(SimulatedPreemption):
        FleetRunner(jobs(), device="cpu", options=RoundOptions(
            chunk=chunk, checkpoint=CheckpointConfig(
                dir=str(tmp_path), sync=True, fault_plan=fault))).run()
    res = FleetRunner(jobs(), device="cpu", options=RoundOptions(
        chunk=chunk, checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                 sync=True))).run()
    for a, b in zip(res, ref):
        _assert_same_result(a, b)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fleet_service_upfront_equals_fleet_runner(backend):
    batch = FleetRunner(_quad_jobs(backend), chunk=2, device="cpu").run()
    svc = FleetService(chunk=2, device="cpu")
    handles = [svc.submit(j) for j in _quad_jobs(backend)]
    svc.run_until_idle()
    assert len({h.key for h in handles}) == 3    # a, b and c share one
    for h, r in zip(handles, batch):
        assert h.status() == "done"
        _assert_same_result(h.result(), r)


def test_fleet_service_restore_equals_the_uninterrupted_run(tmp_path):
    svc = FleetService(chunk=2, max_lanes=2, device="cpu")
    ref_handles = [svc.submit(j) for j in _quad_jobs()]
    svc.run_until_idle()
    ref = {h.job_id: h.result() for h in ref_handles}
    killed = FleetService(max_lanes=2, device="cpu", options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(
            dir=str(tmp_path), fault_plan=FaultPlan(kill_at=1))))
    kh = [killed.submit(j) for j in _quad_jobs()]
    done = {}
    with pytest.raises(SimulatedPreemption):
        while killed.step():
            for h in kh:
                if h.status() == "done" and h.job_id not in done:
                    done[h.job_id] = h.result()
    back = FleetService.restore(
        CheckpointConfig(dir=str(tmp_path)), device="cpu",
        jobs={h.job_id: j for h, j in zip(kh, _quad_jobs())})
    restored = back.handles()
    gens = [s.gen for b in back._buckets.values() for s in b.slots
            if s is not None]
    assert gens and all(g is not None for g in gens)
    back.run_until_idle()
    assert {h.job_id for h in restored} | set(done) == set(ref)
    for h in restored:
        _assert_same_result(h.result(), ref[h.job_id])
    for jid, res in done.items():
        _assert_same_result(res, ref[jid])
