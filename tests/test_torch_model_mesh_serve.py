"""The KV cache's sequence split, ServeEngine and the cache interop on a
model mesh, on gloo worlds of (1, 2) and (2, 2) CPU processes, held to
the reference's padded model on one device (tests/test_torch_model_mesh_
decode.py holds every family's decode step).

* The sequence split.  qwen2 reduced to 2 layers, fp32, ``max_seq`` 16384
  (a span above 8192), its cache seeded in every slot.  The kv heads do
  not split (``MeshAxes(shard_kv=False)``, what a model axis of 16 gives
  qwen2's 4 kv heads) at batch 2: the sequence lies over the model axis
  ("seq_model"); at batch 1 over the data and model axes ("seq_both").
  With split kv heads at batch 1 it lies over the data axis
  ("seq_shard").  Steps at positions 100, 5000, 9000 and 16383 put the
  written slot in each rank's block in turn; at 100 every rank but the
  first holds only masked slots.  Logits and the whole cache within 1e-5
  of their largest magnitude; the reference's rope frequencies are taken
  as its eager path computes them (``eager_rope_freqs``: compiled, they
  round one ulp apart, which long positions magnify).
* ``ServeEngine.generate`` on the mesh: smollm with 3 q heads and 1 kv
  head (padded to 4 / 1) and zamba2 with 3 Mamba2 heads.  Its tokens equal
  the port's one-device tokens of the same padded model (fp32); teacher-
  forced on the reference's greedy tokens its logits lie within 1e-5, and
  its argmax equals the reference's token wherever the reference's top
  two logits are more than twice that apart (tests/test_torch_decode.py's
  near-tie rule).
* ``prefill`` == ``prefill_loop`` on the mesh, bit for bit.
* A cache round trip through ``interop.cache_to_shards`` /
  ``cache_from_shards`` for every layout, bit for bit.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro.serving import ServeEngine as JEngine
from repro_torch.interop import (
    cache_from_shards, cache_to_shards, params_from_numpy, params_to_shards,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves, tree_map

import test_torch_model_mesh_decode as decode_cases
import test_torch_model_mesh_world as world_cases
from repro.configs import reduced_config as j_reduced
from repro_torch.configs import reduced_config as t_reduced

WORLD_LIMIT = 240
TOL = 1e-5
LONG = 16384
POSITIONS = (100, 5000, 9000, LONG - 1)

#: layout: (batch, shard_kv, mesh shapes)
LAYOUTS = {
    "seq_model": (2, False, ((1, 2), (2, 2))),
    "seq_both": (1, False, ((2, 2),)),
    "seq_shard": (1, True, ((2, 2),)),
}

#: generate cases: tag: (arch, config changes, batch, prompt, new)
GEN = {
    "smollm": ("smollm-360m", dict(num_heads=3, num_kv_heads=1), 4, 5, 8),
    "zamba2": ("zamba2-2.7b", dict(ssm_heads=3, num_heads=3,
                                   num_kv_heads=3), 4, 5, 8),
}


def seq_axes(jax_side: bool, shard_kv: bool):
    mod = jcommon if jax_side else tcommon
    return mod.MeshAxes(model_par=2, shard_kv=shard_kv)


@contextlib.contextmanager
def eager_rope_freqs():
    """The reference's rope frequencies evaluated eagerly inside its
    compiled decode.  Compiled, XLA folds ``theta ** exps`` one ulp off
    the eager values at two of head_dim 32's 16 frequencies (5 and 6), and
    at position p that moves those angles by p times the ulp: 1.2e-4 of
    the rotated values' magnitude at 16383, past the 1e-5 bound.  The
    eager values are what the port computes (bit for bit)."""
    orig = jcommon.rope_freqs

    def eager(head_dim, theta=1e4):
        with jax.ensure_compile_time_eval():
            return orig(head_dim, theta)
    jcommon.rope_freqs = eager
    try:
        yield
    finally:
        jcommon.rope_freqs = orig


def seq_reference(layout: str) -> dict:
    """The reference's steps at POSITIONS from a seeded long cache."""
    batch, shard_kv, _ = LAYOUTS[layout]
    jcfg = j_reduced("qwen2-7b")
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (batch, len(POSITIONS))).astype(np.int32)
    with jmesh.use_mesh(world_cases.j_mesh()), jcommon.mesh_axes_scope(
            seq_axes(True, shard_kv)), eager_rope_freqs():
        model = j_build(jcfg)
        params = world_cases._unconstant(model.init(jax.random.PRNGKey(0)))
        start = decode_cases.seeded_cache(model.init_cache(batch, LONG), 13)
        assert jcommon.get_mesh_axes().logical_to_spec(
            model.cache_descs(batch, LONG)["k"].axes)[2] is not None
        cache = jax.tree_util.tree_map(jnp.asarray, start)
        step = jax.jit(model.decode_step)
        logits = []
        for i, pos in enumerate(POSITIONS):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.int32(pos))
            logits.append(np.asarray(lg))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "start": start, "tokens": tokens,
            "logits": logits, "cache": jax.tree_util.tree_leaves(
                as_np(cache))}


def seq_rank(layout: str, ref: dict, mesh) -> dict:
    batch, shard_kv, _ = LAYOUTS[layout]
    tcfg = t_reduced("qwen2-7b")
    axes = seq_axes(False, shard_kv)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        cdescs = model.cache_descs(batch, LONG)
        cache = cache_to_shards(ref["start"], cdescs, axes, mesh)
        span = cache["k"].shape[2]
        lo, hi = tcommon.batch_block(batch)
        tokens = torch.from_numpy(ref["tokens"][lo:hi])
        logits = []
        for i, pos in enumerate(POSITIONS):
            lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                          pos, batch=batch, max_seq=LONG)
            logits.append(tcommon.gather_batch(lg, batch).numpy())
        whole = tree_leaves(cache_from_shards(cache, cdescs, axes, mesh))
        split = tcommon.spec_axes(tcommon.leaf_spec(cdescs["k"])[2])
        try:
            model.decode_step(params, cache, tokens[:, :1], LONG,
                              batch=batch, max_seq=LONG)
            past = "ran"
        except ValueError as e:
            past = str(e)
    return {"logits": logits, "cache": whole, "span": span, "past": past,
            "seq_axes": split}


def gen_setup(tag: str):
    arch, kw, batch, prompt, new = GEN[tag]
    jcfg, tcfg = j_reduced(arch).replace(**kw), t_reduced(arch).replace(**kw)
    prompts = np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    return jcfg, tcfg, prompts, batch, prompt, new


def gen_reference(tag: str) -> dict:
    """The reference's greedy tokens and its teacher-forced logits."""
    jcfg, _, prompts, batch, prompt, new = gen_setup(tag)
    with jmesh.use_mesh(world_cases.j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2)):
        model = j_build(jcfg)
        params = world_cases._unconstant(model.init(jax.random.PRNGKey(0)))
        eng = JEngine(model, params, batch_size=batch, max_seq=prompt + new)
        tokens = eng.generate(jnp.asarray(prompts), max_new=new)
        cache, lg, _ = eng.prefill(eng.init_cache(), jnp.asarray(prompts))
        logits = [np.asarray(lg[:, -1])]
        step = jax.jit(model.decode_step)
        for i in range(new - 1):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.int32(prompt + i))
            logits.append(np.asarray(lg[:, -1]))
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "tokens": np.asarray(tokens), "logits": np.stack(logits, 1)}


def one_device_tokens(tag: str, ref: dict) -> np.ndarray:
    """The port's greedy tokens of the padded model whole on one device."""
    _, tcfg, prompts, batch, prompt, new = gen_setup(tag)
    with tcommon.mesh_axes_scope(tmesh.mesh_axes_for(tcfg, model_par=2)):
        model = t_build(tcfg)
        eng = ServeEngine(model, params_from_numpy(ref["params"]),
                          batch_size=batch, max_seq=prompt + new)
        return eng.generate(prompts, max_new=new)


def gen_rank(tag: str, ref: dict, mesh) -> dict:
    _, tcfg, prompts, batch, prompt, new = gen_setup(tag)
    axes = tmesh.mesh_axes_for(tcfg, model_par=2)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        eng = ServeEngine(model, params, batch_size=batch,
                          max_seq=prompt + new)
        tokens = eng.generate(prompts, max_new=new)
        # Teacher-forced on the reference's tokens.
        cache, lg, _ = eng.prefill(eng.init_cache(), prompts)
        lo, hi = tcommon.batch_block(batch)
        forced = torch.from_numpy(ref["tokens"][lo:hi]).long()
        logits = [lg[:, -1]]
        for i in range(new - 1):
            lg, cache = model.decode_step(params, cache, forced[:, i:i + 1],
                                          prompt + i, batch=batch,
                                          max_seq=prompt + new)
            logits.append(lg[:, -1])
        logits = tcommon.gather_batch(torch.stack(logits, 1), batch)
        # prefill against prefill_loop, each from its own zero cache.
        c_l, lg_l, p_l = eng.prefill_loop(eng.init_cache(), prompts)
        c_s, lg_s, p_s = eng.prefill(eng.init_cache(), prompts)
        same = (p_l == p_s == prompt and torch.equal(lg_l, lg_s)
                and all(torch.equal(a, b) for a, b in
                        zip(tree_leaves(c_l), tree_leaves(c_s))))
    return {"tokens": tokens, "logits": logits.numpy(), "prefill": same}


def round_trip(mesh) -> dict:
    """Seeded caches of every layout (long ones included) through
    cache_to_shards and cache_from_shards: bit for bit?"""
    out = {}
    layouts = [(f"{layout} {arch}", arch, kw, batch, max_seq, shard_kv)
               for layout, (batch, shard_kv, _) in LAYOUTS.items()
               for arch, kw, max_seq in (("qwen2-7b", {}, LONG),)]
    layouts += [(tag, arch, kw, 4, 16, None)
                for tag, (arch, kw, _, _) in decode_cases.CASES.items()]
    for name, arch, kw, batch, max_seq, shard_kv in layouts:
        cfg = t_reduced(arch).replace(**kw)
        axes = tmesh.mesh_axes_for(cfg, model_par=2) if shard_kv is None \
            else seq_axes(False, shard_kv)
        with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
            descs = t_build(cfg).cache_descs(batch, max_seq)
            rng = np.random.default_rng(17)
            tree = tree_map(lambda d: rng.standard_normal(d.shape).astype(
                np.float32), descs)
            back = cache_from_shards(cache_to_shards(tree, descs, axes, mesh),
                                     descs, axes, mesh)
        out[name] = all(np.array_equal(a, b) for a, b in
                        zip(tree_leaves(tree), tree_leaves(back)))
    return out


def _world(rank: int, world: int, seq_refs: dict, gen_refs: dict) -> dict:
    torch.set_num_threads(1)
    shape = (world // 2, 2)
    mesh = tmesh.make_debug_mesh(*shape)
    return {"seq": {layout: seq_rank(layout, ref, mesh)
                    for layout, ref in seq_refs.items()
                    if shape in LAYOUTS[layout][2]},
            "gen": {tag: gen_rank(tag, ref, mesh)
                    for tag, ref in gen_refs.items()},
            "round_trip": round_trip(mesh)}


@pytest.fixture(scope="module")
def run():
    seq_refs = {layout: seq_reference(layout) for layout in LAYOUTS}
    gen_refs = {tag: gen_reference(tag) for tag in GEN}
    single = {tag: one_device_tokens(tag, ref) for tag, ref in gen_refs.items()}
    worlds = {(world // 2, 2): tmesh.spawn_world(
        _world, world, (seq_refs, gen_refs), limit=WORLD_LIMIT)
        for world in (2, 4)}
    return seq_refs, gen_refs, single, worlds


def close(got, want, what: str) -> None:
    decode_cases.close(got, want, what)


@pytest.mark.parametrize("layout,shape", [(lay, shape) for lay, (_, _, shapes)
                                          in LAYOUTS.items()
                                          for shape in shapes], ids=str)
def test_sequence_split_matches_reference(run, layout, shape):
    """Each layout's steps against the reference: the logits at every
    position and the whole cache after them; each rank holds its block of
    the span, and a position past the full span still raises."""
    ref = run[0][layout]
    want_axes = {"seq_model": ("model",), "seq_both": ("data", "model"),
                 "seq_shard": ("data",)}[layout]
    ranks = [w["seq"][layout] for w in run[3][shape]]
    for r, got in enumerate(ranks):
        assert got["seq_axes"] == want_axes
        n = 4 if layout == "seq_both" else 2
        assert got["span"] == LONG // n
        for pos, a, b in zip(POSITIONS, got["logits"], ref["logits"]):
            close(a, b, f"{layout} rank {r} position {pos} logits")
        for i, (a, b) in enumerate(zip(got["cache"], ref["cache"])):
            close(a, b, f"{layout} rank {r} cache leaf {i}")
        assert "position 16384" in got["past"] and "span 16384" in got["past"]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", tuple(GEN))
def test_generate_on_the_mesh(run, tag, shape):
    _, gen_refs, single, worlds = run
    ref = gen_refs[tag]
    tol = TOL * float(np.abs(ref["logits"]).max())
    top2 = np.sort(ref["logits"], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol
    ties = int((~clear).any(axis=0).sum())
    assert ties <= 2, (tag, ties)
    for r, got in enumerate(w["gen"][tag] for w in worlds[shape]):
        assert got["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], single[tag])
        close(got["logits"], ref["logits"], f"{tag} rank {r} forced logits")
        assert (np.argmax(got["logits"], -1) == ref["tokens"])[clear].all()
        if ties == 0:
            np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        assert got["prefill"], (tag, r)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_cache_round_trip_through_shards(run, shape):
    for got in (w["round_trip"] for w in run[3][shape]):
        assert got and all(got.values()), got

