"""Cached decode of every family split over a model mesh, on gloo worlds
of (1, 2) and (2, 2) CPU processes, held to the reference's decode of the
same padded model on one device.

Each case's parameters are the reference's padded init (a one-device
mesh of ``Auto`` axes under ``mesh_axes_scope``, as in
tests/test_torch_model_mesh_world.py), every constant leaf moved off its
constant (QKV biases, norm gains, rwkv6's u, Mamba2's a_log / dt_bias /
d_skip), carried into each rank's shards with ``interop.params_to_shards``.
The starting cache is seeded numpy of the reference's cache shapes (live
history below the first position, masked slots above it), carried in
with ``interop.cache_to_shards``; whisper's comes from ``prefill_cache``
over seeded frames in both packages.  Each rank of a ``(data, model)``
world steps ``decode_step`` 8 times on its rows of the tokens:

* dense: qwen2 (QKV biases, kv heads split) and smollm with 3 q heads and
  1 kv head (padded to 4 / 1: 2 q heads a rank, one shared kv head,
  replicated);
* moe: mixtral with the ring at max_seq 64 / window 32, from position
  28, so that the ring wraps;
* vlm: internvl2 with 1 kv head (text decode);
* ssm: rwkv6 with 3 heads, padded to 4 (the state by heads);
* hybrid: zamba2 with 3 Mamba2 heads (padded to 4: the conv window's
  contiguous block crosses the x / B / C boundaries) and the shared
  block's KV cache by kv heads;
* whisper with 3 heads (padded to 4, the cross k / v split).

Tolerances: each step's logits within 1e-5 of their largest magnitude,
and every cache leaf after the 8 steps, gathered with
``interop.cache_from_shards``, within 1e-5 of its largest magnitude (fp32
partials all-reduced against one device's sums).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro_torch.interop import (
    cache_from_shards, cache_to_shards, params_to_shards,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.tree import tree_leaves, tree_paths

import test_torch_model_mesh_world as world_cases
from repro.configs import reduced_config as j_reduced
from repro_torch.configs import reduced_config as t_reduced

WORLD_LIMIT = 240
TOL = 1e-5
B = 4
STEPS = 8

#: tag: (arch, config changes, max_seq, first position)
CASES = {
    "dense": ("qwen2-7b", {}, 16, 5),
    "smollm": ("smollm-360m", dict(num_heads=3, num_kv_heads=1), 16, 5),
    "moe": ("mixtral-8x22b", {}, 64, 28),
    "vlm": ("internvl2-2b", dict(num_kv_heads=1), 16, 5),
    "ssm": ("rwkv6-3b", dict(ssm_heads=3), 16, 5),
    "hybrid": ("zamba2-2.7b", dict(ssm_heads=3, num_heads=3,
                                   num_kv_heads=3), 16, 5),
    "whisper": ("whisper-base", dict(num_heads=3, num_kv_heads=3), 16, 0),
}


def cfgs(tag):
    arch, kw, _, _ = CASES[tag]
    return j_reduced(arch).replace(**kw), t_reduced(arch).replace(**kw)


def seeded_cache(tree, seed: int) -> dict:
    """Seeded normal values of each leaf's shape and dtype (a jax tree of
    zeros in, numpy out)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.5 * rng.standard_normal(a.shape)).astype(a.dtype), tree)


def frames(cfg, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def reference(tag: str) -> dict:
    """The reference's padded parameters, starting cache, tokens and each
    step's logits and its cache after the steps."""
    jcfg, _ = cfgs(tag)
    _, _, max_seq, pos0 = CASES[tag]
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    with jmesh.use_mesh(world_cases.j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2)):
        model = j_build(jcfg)
        params = world_cases._unconstant(model.init(jax.random.PRNGKey(0)))
        if jcfg.family == "encdec":
            cache = model.prefill_cache(params, jnp.asarray(frames(jcfg)), B,
                                        max_seq)
            start = None
        else:
            start = seeded_cache(model.init_cache(B, max_seq), 11)
            cache = jax.tree_util.tree_map(jnp.asarray, start)
        step = jax.jit(model.decode_step)
        logits = []
        for t in range(STEPS):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(pos0 + t))
            logits.append(np.asarray(lg))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "start": start, "tokens": tokens,
            "logits": logits, "cache": jax.tree_util.tree_leaves(
                as_np(cache))}


def rank_case(tag: str, ref: dict, mesh) -> dict:
    _, tcfg = cfgs(tag)
    _, _, max_seq, pos0 = CASES[tag]
    axes = tmesh.mesh_axes_for(tcfg, model_par=2)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        cdescs = model.cache_descs(B, max_seq)
        if tcfg.family == "encdec":
            cache = model.prefill_cache(params, torch.from_numpy(
                frames(tcfg)), B, max_seq)
        else:
            cache = cache_to_shards(ref["start"], cdescs, axes, mesh)
        local = [tuple(t.shape) for t in tree_leaves(cache)]
        paths = tree_paths(cache)
        lo, hi = tcommon.batch_block(B)
        tokens = torch.from_numpy(ref["tokens"][lo:hi])
        logits = []
        for t in range(STEPS):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          pos0 + t, batch=B, max_seq=max_seq)
            logits.append(tcommon.gather_batch(lg, B).numpy())
        whole = tree_leaves(cache_from_shards(cache, cdescs, axes, mesh))
    return {"logits": logits, "cache": whole, "local": local,
            "paths": paths, "full": [d.shape for d in tree_leaves(cdescs)]}


def _world(rank: int, world: int, refs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(world // 2, 2)
    return {tag: rank_case(tag, ref, mesh) for tag, ref in refs.items()}


@pytest.fixture(scope="module")
def run():
    refs = {tag: reference(tag) for tag in CASES}
    return refs, {(world // 2, 2): tmesh.spawn_world(
        _world, world, (refs,), limit=WORLD_LIMIT) for world in (2, 4)}


def close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= TOL * max(scale, 1e-30), (what, err, scale)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", tuple(CASES))
def test_split_decode_matches_reference(run, tag, shape):
    refs, worlds = run
    ref = refs[tag]
    for r, got in enumerate(w[tag] for w in worlds[shape]):
        for t, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
            close(a, b, f"{tag} rank {r} step {t} logits")
        assert len(got["cache"]) == len(ref["cache"])
        for i, (a, b) in enumerate(zip(got["cache"], ref["cache"])):
            close(a, b, f"{tag} rank {r} cache leaf {i}")


def test_each_rank_holds_its_cache_shard(run):
    """Every rank holds its part of the cache: on (2, 2) each batch
    dimension halved; the KV caches' kv heads halved where they split
    (qwen2, mixtral, zamba2's shared block, whisper's self and cross
    pairs), whole where they do not (smollm's one kv head, internvl2's);
    the RWKV and Mamba2 states' heads and the conv window's channels
    halved, the token shifts whole."""
    split_kv = {"dense": True, "smollm": False, "moe": True, "vlm": False,
                "hybrid": True, "whisper": True}
    for shape, ranks in run[1].items():
        for tag, got in ranks[0].items():
            for path, loc, full in zip(got["paths"], got["local"],
                                       got["full"]):
                want = list(full)
                if shape[0] == 2:
                    want[1] //= 2                    # the batch over "data"
                if "'state'" in path:                # RWKV / Mamba2 heads
                    want[2] //= 2
                elif "'conv'" in path:               # the window's channels
                    want[3] //= 2
                elif "shift" not in path and split_kv[tag]:
                    want[3] //= 2                    # kv heads
                assert list(loc) == want, (tag, shape, path, loc, full)
