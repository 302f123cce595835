"""The multi-rank backends ("cuda_sharded" / "cuda_hier", the reference's
``pallas_sharded`` / ``pallas_hier``) in gloo worlds of CPU processes,
held to the reference's single-device ``robust_aggregate`` on the same
numpy inputs.

One world per size (2 and 4 ranks) runs the whole matrix in one spawn
(``repro_torch.launch.mesh.spawn_world``, under a hard time limit: a rank
that raises or hangs fails the fixture, never the suite's clock) and
returns every rank's aggregates and dispatch records:

* every rule x pre in {None, nnm} (and bucketing, static) x static / dyn
  / batched on the 1-D "shard" mesh, n = 17 (a non-power-of-two worker
  count; D = 53 splits raggedly: 27 + 26, 14 x 3 + 11);
* "cuda_hier" on the 1-D mesh and, with 4 ranks, on the 2-D ("workers",
  "model") mesh: the identity permutation gives tile 0 (workers 0-8) no
  member of buckets 5-8; ragged n (17 over 2 tiles); NaN / inf rows;
* the mesh rules: the axis preferences, the ad-hoc meshes, the record's
  mesh fields, ``bucket_key``'s mesh signature.

On CPU blocks the kernel wrappers run their plain versions, so the
coordinate rules without a Gram-derived mix are per-column math on equal
inputs: bit for bit the port's single-process "cuda" path.  With a Gram
the partials are all-reduced (another summation order): within RTOL of
the largest output, AutoGM 5e-4 and GM on bucket means 2e-4 (the
tolerances of tests/test_torch_fleet_aggregation.py and
test_torch_fleet_hier.py, which say why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.robust import batched_robust_aggregate as j_batched
from repro.core.robust import robust_aggregate as j_aggregate
from repro.core.robust import robust_aggregate_dyn as j_dyn
from repro.core.types import AggregatorSpec as JSpec
from repro_torch.core.robust import batched_robust_aggregate as t_batched
from repro_torch.core.robust import robust_aggregate as t_aggregate
from repro_torch.core.robust import robust_aggregate_dyn as t_dyn
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.launch import mesh as tmesh

N, F, S = 17, 3, 2
RULES = ("average", "krum", "multikrum", "gm", "autogm", "mda", "cwtm",
         "cwmed", "meamed")
RTOL = 1e-5
AUTOGM_RTOL = 5e-4
GM_HIER_RTOL = 2e-4
KEY = jax.random.PRNGKey(5)
LANE_F = (0, 2, 3)
#: Seconds a world may take in all (the suite must never hang).
WORLD_LIMIT = 300


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(N, 37)).astype(np.float32),
            "b": rng.normal(size=(N, 3, 5)).astype(np.float32),
            "s": rng.normal(size=(N,)).astype(np.float32)}


def _bad_tree() -> dict:
    """NaN and inf rows: worker 3 holds a NaN, worker 12 an inf."""
    t = _tree(9)
    t["w"][3, 4] = np.nan
    t["b"][12, 1, 2] = np.inf
    return t


def _perm(kind: str) -> np.ndarray:
    if kind == "identity":
        return np.arange(N)
    return np.array(jax.random.permutation(KEY, N))


def _cases(world: int) -> list:
    """(tag, kind, mesh, spec kwargs, tree seed or "bad", perm kind)."""
    out = []
    for rule in RULES:
        for pre in (None, "nnm", "bucketing"):
            out.append((f"static/{rule}/{pre}", "static", "1d",
                        dict(rule=rule, pre=pre, bucket_size=S,
                             backend="cuda_sharded"), 1, "key"))
        if rule == "mda":
            continue                       # no dynamic form
        for pre in (None, "nnm"):
            out.append((f"dyn/{rule}/{pre}", "dyn", "1d",
                        dict(rule=rule, pre=pre, backend="cuda_sharded"),
                        2, "key"))
            out.append((f"batched/{rule}/{pre}", "batched", "1d",
                        dict(rule=rule, pre=pre, backend="cuda_sharded"),
                        3, "key"))
    meshes = ["1d"] + (["2d"] if world == 4 else [])
    for mesh in meshes:
        for rule in ("cwtm", "cwmed", "gm", "average", "meamed"):
            for pre in (None, "nnm"):
                for perm in ("key", "identity"):
                    out.append((f"hier-{mesh}/{rule}/{pre}/{perm}", "static",
                                mesh, dict(rule=rule, pre=pre, hier=True,
                                           bucket_size=S,
                                           backend="cuda_hier"), 4, perm))
        for rule in ("cwtm", "gm"):
            out.append((f"hier-{mesh}-dyn/{rule}/nnm", "dyn", mesh,
                        dict(rule=rule, pre="nnm", hier=True, bucket_size=S,
                             backend="cuda_hier"), 5, "identity"))
            out.append((f"hier-{mesh}-batched/{rule}/nnm", "batched", mesh,
                        dict(rule=rule, pre="nnm", hier=True, bucket_size=S,
                             backend="cuda_hier"), 6, "identity"))
        for rule in ("cwtm", "cwmed"):
            out.append((f"hier-{mesh}-bad/{rule}/None", "static", mesh,
                        dict(rule=rule, pre=None, hier=True, bucket_size=S,
                             backend="cuda_hier"), "bad", "identity"))
        out.append((f"hier-{mesh}-s1/cwtm/nnm", "static", mesh,
                    dict(rule="cwtm", pre="nnm", hier=True, bucket_size=1,
                         backend="cuda_hier"), 7, "key"))
    return out


def _input(seed, kind: str) -> dict:
    tree = _bad_tree() if seed == "bad" else _tree(seed)
    if kind == "batched":
        return {k: np.stack([v, 2 * v, v + 1]) for k, v in tree.items()}
    return tree


def _lane_perms(kind: str) -> np.ndarray:
    return np.stack([_perm(kind)] * len(LANE_F))


def _run_port(kind: str, tree: dict, spec: TSpec, perm_kind: str) -> dict:
    t = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    p = torch.from_numpy(_perm(perm_kind))
    if kind == "static":
        out = t_aggregate(t, dataclasses.replace(spec, f=F), perm=p)
    elif kind == "dyn":
        out = t_dyn(t, spec, torch.tensor(F), perm=p)
    else:
        out = t_batched(t, spec, torch.tensor(LANE_F),
                        perms=torch.from_numpy(_lane_perms(perm_kind)))
    return {k: v.numpy() for k, v in out.items()}


def _rec_summary(rec) -> dict:
    return {"backend": rec.backend, "hier": rec.hier,
            "mesh_devices": rec.mesh_devices, "mesh_axis": rec.mesh_axis,
            "mesh_worker_axis": rec.mesh_worker_axis,
            "decisions": [(d.primitive, d.requested, d.used, d.reason)
                          for d in rec.decisions]}


def _world_matrix(rank: int, world: int) -> dict:
    """Every case of :func:`_cases` under its mesh on this rank."""
    torch.set_num_threads(1)
    meshes = {"1d": tmesh.make_mesh((world,), ("shard",))}
    if world == 4:
        meshes["2d"] = tmesh.make_hier_mesh(2, 2)
    out = {}
    for tag, kind, mesh, kw, seed, perm in _cases(world):
        with tmesh.use_mesh(meshes[mesh]):
            got = _run_port(kind, _input(seed, kind), TSpec(**kw), perm)
        out[tag] = {"out": got, "rec": _rec_summary(kdispatch.last_dispatch())}
    # The mesh rules of launch.mesh, on this world.
    dbg = tmesh.make_debug_mesh(2, world // 2) if world == 4 else None
    info = {
        "ad_hoc_shard": tmesh.aggregation_mesh()[1],
        "ad_hoc_hier": [a for a in tmesh.hier_aggregation_mesh()[1:]],
        "hier_axes_1d": list(tmesh.hier_aggregation_mesh()[1:])
        if world == 2 else None,
        "debug_axis": None if dbg is None else tmesh.aggregation_axis(dbg),
        "debug_worker_axis": None if dbg is None
        else tmesh.aggregation_worker_axis(dbg, "model"),
        "signature_bare": tmesh.mesh_signature(),
        "auto_cpu": kdispatch.resolve_backend("auto", torch.device("cpu")),
    }
    with tmesh.use_mesh(meshes["1d"]):
        info["signature_1d"] = tmesh.mesh_signature()
        info["auto_hier_cpu"] = kdispatch.resolve_backend(
            "auto", torch.device("cpu"), hier=True)
    from repro_torch.fleet import bucket_key
    from repro_torch.fleet.runner import _mesh_sig
    job = _fleet_job("cuda_sharded")
    info["key_sig"] = _mesh_sig() in bucket_key(job)
    info["key_differs"] = _key_differs(job, meshes["1d"])
    return {"rank": rank, "cases": out, "info": info,
            "collectives": len(tmesh.collective_log())}


def _key_differs(job, mesh) -> bool:
    from repro_torch.fleet import bucket_key
    base = bucket_key(job)
    with tmesh.use_mesh(mesh):
        return bucket_key(job) != base


def _fleet_job(backend: str, hier: bool = False):
    from repro_torch.fed import ClientConfig, FedConfig, constant_attack
    from repro_torch.fleet import FleetJob
    from repro_torch.optim import sgd

    def loss_fn(params, batch):
        return 0.5 * torch.sum(params["theta"] ** 2), {}

    cfg = FedConfig(n_clients=10, clients_per_round=6, f=2,
                    agg=TSpec(rule="cwtm", f=2, pre="nnm", hier=hier,
                              bucket_size=2 if hier else None,
                              backend=backend),
                    client=ClientConfig(local_steps=0, local_lr=0.05,
                                        algorithm="dshb", beta=0.9))
    return FleetJob(label="shard", cfg=cfg, loss_fn=loss_fn,
                    optimizer=sgd(clip=1.0),
                    params={"theta": torch.zeros((5,), dtype=torch.float32)},
                    batch_fn=lambda cohort, n_flip, rng:
                        {"idx": np.asarray(cohort)[:, None, None]},
                    rounds=2, schedule=constant_attack("none"))


@pytest.fixture(scope="module")
def world2():
    return tmesh.spawn_world(_world_matrix, 2, limit=WORLD_LIMIT)


@pytest.fixture(scope="module")
def world4():
    return tmesh.spawn_world(_world_matrix, 4, limit=WORLD_LIMIT)


def _worlds(request, size: int):
    return request.getfixturevalue(f"world{size}")


def _reference(kind: str, tree: dict, kw: dict, perm_kind: str) -> dict:
    jkw = dict(kw, backend="xla")
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    if perm_kind == "identity":
        # The reference draws its permutation from a key; the identity is
        # fed through the tree's rows instead, which its own permutation
        # then shuffles back: the port's identity equals the reference
        # run on rows permuted by argsort(permutation(KEY)).
        raise AssertionError("identity permutations compare to the port")
    if kind == "static":
        out = j_aggregate(jt, JSpec(f=F, **jkw), key=KEY)
    elif kind == "dyn":
        out = j_dyn(jt, JSpec(**jkw), jnp.int32(F), key=KEY)
    else:
        keys = jnp.stack([KEY] * len(LANE_F))
        out = j_batched(jt, JSpec(**jkw), jnp.asarray(LANE_F, jnp.int32),
                        keys=keys if kw.get("hier") or kw.get("pre") ==
                        "bucketing" else None)
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _tol(tag: str, kw: dict) -> float:
    if kw["rule"] == "autogm":
        return AUTOGM_RTOL
    if kw["rule"] == "gm" and (kw.get("hier") or kw.get("pre") ==
                               "bucketing"):
        return GM_HIER_RTOL
    return RTOL


def _assert_close(got: dict, want: dict, rtol: float, what: str) -> None:
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = np.asarray(got[k], np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w),
                                      err_msg=f"{what} {k}: NaN positions")
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin & ~np.isnan(w)],
                                      w[~fin & ~np.isnan(w)])
        scale = max(float(np.abs(w[fin]).max()) if fin.any() else 0.0, 1e-30)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                   atol=rtol * scale, err_msg=f"{what} {k}")


def _same(got: dict, want: dict) -> bool:
    return all(np.array_equal(got[k], want[k], equal_nan=True) for k in want)


def _cpu_fallback_only(rec: dict) -> list:
    """Decisions that fell back for a reason other than the CPU stack (the
    plain versions), meamed's and AutoGM's recorded torch ops."""
    bad = []
    for prim, req, used, why in rec["decisions"]:
        if req not in kdispatch.KERNEL_BACKENDS or used in ("cuda", "skipped"):
            continue
        if used == "plain" or "meamed" in why or prim == "autogm_coeff":
            continue
        bad.append((prim, used, why))
    return bad


@pytest.mark.parametrize("size", [2, 4])
def test_ranks_agree_and_records_carry_the_mesh(request, size):
    ranks = _worlds(request, size)
    assert [r["rank"] for r in ranks] == list(range(size))
    for tag, kind, mesh, kw, _, _ in _cases(size):
        rows = [r["cases"][tag] for r in ranks]
        for r in rows[1:]:
            assert _same(r["out"], rows[0]["out"]), tag
        rec = rows[0]["rec"]
        assert rec["backend"] == kw["backend"], (tag, rec)
        assert rec["mesh_devices"] == size, (tag, rec)
        assert rec["mesh_axis"] == ("model" if mesh == "2d" else "shard")
        assert rec["mesh_worker_axis"] == ("workers" if mesh == "2d"
                                           else None), (tag, rec)
        assert _cpu_fallback_only(rec) == [], (tag, rec)
        assert any(d[0].startswith("collective:") for d in rec["decisions"]) \
            or kw["rule"] in ("cwtm", "cwmed", "meamed") and not kw.get(
                "pre") and not kw.get("hier"), (tag, rec)
    assert ranks[0]["collectives"] > 0


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_matches_reference(request, size):
    """Every case with a keyed permutation against the reference's
    single-device robust_aggregate (its "xla" path) on the same input."""
    got_all = _worlds(request, size)[0]["cases"]
    for tag, kind, mesh, kw, seed, perm in _cases(size):
        if perm != "key":
            continue
        want = _reference(kind, _input(seed, kind), kw, perm)
        _assert_close(got_all[tag]["out"], want, _tol(tag, kw), tag)


@pytest.mark.parametrize("size", [2, 4])
def test_sharded_matches_single_process_port(request, size):
    """Every case against the port's single-process kernel path ("cuda";
    the plain versions on the CPU) with the same permutation: the
    coordinate rules without a Gram (no NNM, no hier Gram) bit for bit,
    the rest within the tolerances above.  The identity-permutation hier
    cases (a tile that misses a bucket, NaN / inf rows) are held here."""
    got_all = _worlds(request, size)[0]["cases"]
    bitwise = 0
    for tag, kind, mesh, kw, seed, perm in _cases(size):
        solo = dict(kw, backend="cuda")
        if kw["backend"] == "cuda_hier":
            solo["hier"] = True
        want = _run_port(kind, _input(seed, kind), TSpec(**solo), perm)
        got = got_all[tag]["out"]
        coord = kw["rule"] in ("cwtm", "cwmed") and kw.get("pre") is None
        if coord and not kw.get("hier"):
            assert _same(got, want), tag
            bitwise += 1
        else:
            _assert_close(got, want, _tol(tag, kw), tag)
    assert bitwise >= 6


def test_two_d_hier_tile_misses_a_bucket():
    """The identity permutation puts workers 0-8 in buckets 0-4 (bucket 4
    spans both tiles) and 9-16 in 4-8: tile 0 holds no member of buckets
    5-8, and K7's global 1/|bucket| weights keep every mean exact."""
    from repro_torch.core import bucketing
    assign = bucketing.bucket_assignment(N, S, perm=torch.arange(N))
    tile0 = set(assign[:9].tolist())
    assert tile0 == {0, 1, 2, 3, 4}
    assert set(assign[9:].tolist()) == {4, 5, 6, 7, 8}


def test_two_d_hier_nan_rows_spread_as_the_dense_path(world4):
    """A NaN / inf row on one worker tile turns every bucket of its
    columns NaN after the sum over the tiles, as the dense B does: the
    2-D aggregate's NaN positions equal the single-process path's, and
    the NaN does not spread to other columns."""
    got = world4[0]["cases"]["hier-2d-bad/cwtm/None"]["out"]
    want = _run_port("static", _bad_tree(),
                     TSpec(rule="cwtm", pre=None, hier=True, bucket_size=S,
                           backend="cuda"), "identity")
    for k in want:
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]))
    assert np.isnan(got["w"]).sum() == 1 and not np.isnan(got["s"]).any()


def test_mesh_rules(world2, world4):
    """The axis preferences and ad-hoc meshes of launch.mesh (the
    reference's), the world size as the device count, "auto" on a CPU
    stack, and bucket_key's mesh signature."""
    i2, i4 = world2[0]["info"], world4[0]["info"]
    assert i2["ad_hoc_shard"] == "shard" and i4["ad_hoc_shard"] == "shard"
    assert i2["hier_axes_1d"] == [None, "shard"]
    assert i4["ad_hoc_hier"] == ["workers", "shard"]
    assert i4["debug_axis"] == "model" and i4["debug_worker_axis"] == "data"
    assert i2["signature_bare"] == (2,) and i4["signature_bare"] == (4,)
    assert i2["signature_1d"] == (2, ("shard",), (2,))
    assert i2["auto_cpu"] == "torch" and i2["auto_hier_cpu"] == "torch"
    assert i2["key_differs"] and i4["key_differs"]
    assert i2["key_sig"] and i4["key_sig"]


def test_single_process_mesh_rules():
    """Without a world: no multi-rank mesh, the bare signature, "auto" by
    device, a one-rank axis never sharded."""
    assert tmesh.world_size() == 1
    assert tmesh.aggregation_mesh() is None
    assert tmesh.hier_aggregation_mesh() is None
    assert tmesh.mesh_signature() == (1,)
    assert kdispatch.resolve_backend("auto", torch.device("cpu")) == "torch"
    with pytest.raises(ValueError, match="unknown backend"):
        kdispatch.resolve_backend("pallas_sharded", torch.device("cpu"))
    from repro_torch.fleet import bucket_key
    from repro_torch.fleet.runner import _mesh_sig
    assert _mesh_sig() == (1,) and _mesh_sig() in bucket_key(
        _fleet_job("cuda_sharded"))


@pytest.mark.parametrize("backend", ["cuda_sharded", "cuda_hier"])
@pytest.mark.parametrize("kind", ["static", "dyn", "batched"])
def test_degrade_without_a_mesh_is_recorded(backend, kind):
    """No world: "cuda_sharded" runs the leaf-streamed torch path and
    "cuda_hier" the dense bucketing path (the stage kept), each with a
    recorded ``pipeline`` fallback naming why and ``mesh_devices`` 1 —
    the reference's degrade (tests/test_hier.py, test_shard_dispatch.py),
    bit for bit the torch backend's result."""
    hier = backend == "cuda_hier"
    kw = dict(rule="cwtm", pre="nnm", bucket_size=S)
    tree = _input(8, kind)
    got = _run_port(kind, tree, TSpec(backend=backend, **kw), "key")
    rec = kdispatch.last_dispatch()
    assert rec.requested == backend and rec.backend == "torch"
    assert rec.hier == hier and rec.mesh_devices == 1
    assert rec.mesh_axis is None and rec.mesh_worker_axis is None
    pipe = [d for d in rec.fallbacks if d.primitive == "pipeline"]
    assert len(pipe) == 1 and "no multi-rank mesh" in pipe[0].reason
    assert (("bucketgram", "torch") in [(d.primitive, d.used)
                                         for d in rec.decisions]) == hier
    want = _run_port(kind, tree, TSpec(backend="torch", hier=hier, **kw),
                     "key")
    assert _same(got, want)


def test_fleet_service_surfaces_a_degrade():
    """A tenant's "cuda_sharded" / "cuda_hier" request on one process shows
    on ``FleetService.last_dispatch``: the pipeline fallback and
    mesh_devices 1 (the reference's ``FleetService.last_dispatch``)."""
    from repro_torch.serving import FleetService
    for backend, hier in (("cuda_sharded", False), ("cuda_hier", True)):
        svc = FleetService(device="cpu")
        svc.submit(_fleet_job(backend, hier=hier))
        svc.run_until_idle()
        rec = svc.last_dispatch
        assert rec is not None
        assert rec.requested == backend and rec.backend == "torch"
        assert rec.mesh_devices == 1 and rec.hier == hier
        assert any(d.primitive == "pipeline" and d.fell_back
                   for d in rec.decisions), rec.describe()


def test_block_api_needs_a_mesh():
    from repro_torch.core.robust import robust_aggregate_block
    with pytest.raises(ValueError, match="multi-rank mesh"):
        robust_aggregate_block(torch.zeros(4, 6), TSpec(
            rule="cwtm", f=1, pre=None, backend="cuda_sharded"), d=6)


def _raise_on_rank_one(rank: int, world: int) -> int:
    if rank == 1:
        raise RuntimeError("rank one fails")
    torch.distributed.barrier()
    return rank


def _sleep(rank: int, world: int) -> int:
    import time
    time.sleep(60)
    return rank


def test_spawn_world_fails_fast():
    """A rank that raises fails the world (the others, blocked in a
    collective, are killed); a world past its limit is killed too."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        tmesh.spawn_world(_raise_on_rank_one, 2, limit=60, group_timeout=30)
    with pytest.raises(TimeoutError):
        tmesh.spawn_world(_sleep, 2, limit=8)
