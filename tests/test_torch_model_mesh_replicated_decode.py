"""Decode and ServeEngine with fewer q heads than model ranks, on an
8-rank gloo world of CPU processes, held to the reference's decode of the
same model on one device and to the port's own one-device decode.

With hq < model_par the reference replicates attention
(``common.pad_heads``): the q / o leaves stay split evenly over the model
axis, the kv heads are whole, and every rank forms all the q heads from
the gathered leaves, attends and applies the whole ``wo``.  Reduced
smollm-360m and whisper-base have 4 q heads, below the 8 model ranks of
a (1, 8) mesh:

* ``decode_step`` 8 steps from a seeded cache (whisper's from
  ``prefill_cache`` over seeded frames, its cross attention replicated
  too): each step's logits and every cache leaf after the steps within
  1e-5 of their largest magnitude, against the reference and against the
  port's one-device decode;
* ``ServeEngine.generate`` on the mesh (whisper from ``prefill_cache``):
  its tokens equal the port's one-device tokens; teacher-forced on the
  reference's greedy tokens its logits lie within 1e-5, and its argmax
  equals the reference's token wherever the reference's top two logits
  lie more than twice that apart;
* the KV cache's sequence split of the replicated attention: smollm
  with 3 q heads and 1 kv head (below the model ranks of both meshes) at
  ``max_seq`` 16384, batch 2 on (1, 8) (the sequence over the model axis,
  "seq_model", 2048 slots a rank) and batch 1 on (2, 4) (over the data and
  model axes, "seq_both"), steps at positions 100, 5000, 9000 and 16383:
  logits and the whole cache within 1e-5 (the reference's rope
  frequencies taken eagerly, tests/test_torch_model_mesh_serve.py).

``decode_attention`` handed a rank's q / o shard instead of the whole
leaves raises.  No test here replaces an earlier one: no test asserted
decode's old refusal of this case.
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
    cache_from_numpy, cache_from_shards, cache_to_shards, params_from_numpy,
    params_to_shards,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.models import attention as tattention
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.serving import ServeEngine
from repro_torch.tree import tree_leaves

import test_torch_model_mesh_decode as decode_cases
import test_torch_model_mesh_serve as serve_cases
import test_torch_model_mesh_world as world_cases
from repro.configs import reduced_config as j_reduced
from repro_torch.configs import reduced_config as t_reduced

WORLD, PAR = 8, 8
WORLD_LIMIT = 600
TOL = 1e-5
B, STEPS = 4, 8
PROMPT, NEW = 5, 8
LONG = 16384
POSITIONS = (100, 5000, 9000, LONG - 1)

#: tag: (arch, max_seq, first position of the decode steps)
CASES = {"smollm": ("smollm-360m", 16, 5), "whisper": ("whisper-base", 16, 0)}
#: layout: (batch, mesh shape, the axes the cache's sequence lies over)
LAYOUTS = {"seq_model": (2, (1, 8), ("model",)),
           "seq_both": (1, (2, 4), ("data", "model"))}
#: The sequence split's smollm: 3 q heads and 1 kv head, below the 4
#: model ranks of (2, 4) too.
SEQ_HEADS = dict(num_heads=3, num_kv_heads=1)


def cfgs(tag):
    if tag in CASES:
        arch = CASES[tag][0]
        return j_reduced(arch), t_reduced(arch)
    return (j_reduced("smollm-360m").replace(**SEQ_HEADS),
            t_reduced("smollm-360m").replace(**SEQ_HEADS))


def close(got, want, what: str) -> None:
    decode_cases.close(got, want, what)


def frames(cfg) -> np.ndarray:
    return decode_cases.frames(cfg)


def j_scope(jcfg, par: int = PAR):
    return jmesh.use_mesh(world_cases.j_mesh()), jcommon.mesh_axes_scope(
        jmesh.mesh_axes_for(jcfg, model_par=par))


def t_axes(tcfg, par: int = PAR):
    return tmesh.mesh_axes_for(tcfg, model_par=par)


# ---------------------------------------------------------------------------
# The reference, and the port on one device.
# ---------------------------------------------------------------------------

def reference(tag: str) -> dict:
    """The reference's parameters, starting cache, decode steps and
    greedy run (with each step's logits: its engine's prefill is a scan
    of these steps)."""
    jcfg, _ = cfgs(tag)
    _, max_seq, pos0 = CASES[tag]
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    prompts = rng.integers(0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    mesh_cm, axes_cm = j_scope(jcfg)
    with mesh_cm, axes_cm:
        model = j_build(jcfg)
        assert not jcommon.pad_heads(jcfg.num_heads, jcfg.num_kv_heads,
                                     PAR)[2]
        params = world_cases._unconstant(model.init(jax.random.PRNGKey(0)))
        step = jax.jit(model.decode_step)

        def start(span):
            if jcfg.family == "encdec":
                return model.prefill_cache(params, jnp.asarray(frames(jcfg)),
                                           B, span), None
            seeded = decode_cases.seeded_cache(model.init_cache(B, span), 11)
            return jax.tree_util.tree_map(jnp.asarray, seeded), seeded

        cache, seeded = start(max_seq)
        logits = []
        for t in range(STEPS):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.int32(pos0 + t))
            logits.append(np.asarray(lg))
        # Greedy from a fresh cache (whisper's from its frames).
        gcache = start(PROMPT + NEW)[0] if jcfg.family == "encdec" else \
            model.init_cache(B, PROMPT + NEW)
        for t in range(PROMPT):
            lg, gcache = step(params, gcache, jnp.asarray(prompts[:, t:t + 1]),
                              jnp.int32(t))
        glogits, greedy = [np.asarray(lg[:, -1])], []
        for i in range(NEW):
            cur = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            greedy.append(np.asarray(cur))
            if i < NEW - 1:
                lg, gcache = step(params, gcache, cur, jnp.int32(PROMPT + i))
                glogits.append(np.asarray(lg[:, -1]))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "start": seeded, "tokens": tokens,
            "logits": logits, "cache": jax.tree_util.tree_leaves(
                as_np(cache)), "prompts": prompts,
            "greedy": np.concatenate(greedy, 1),
            "greedy_logits": np.stack(glogits, 1)}


def _start(model, tcfg, params, ref, span: int, cache_np=None):
    """The port's starting cache: whisper's from prefill_cache over the
    same frames, else the reference's seeded numpy cache (``cache_np``) or
    zeros."""
    if tcfg.family == "encdec":
        return model.prefill_cache(params, torch.from_numpy(frames(tcfg)),
                                   B, span)
    if cache_np is None:
        return model.init_cache(B, span, torch.device("cpu"))
    return cache_np()


def one_device(tag: str, ref: dict) -> dict:
    """The port's decode and greedy run of the same model whole on one
    device."""
    _, tcfg = cfgs(tag)
    _, max_seq, pos0 = CASES[tag]
    with tcommon.mesh_axes_scope(t_axes(tcfg)):
        model = t_build(tcfg)
        params = params_from_numpy(ref["params"])
        cache = _start(model, tcfg, params, ref, max_seq,
                       lambda: cache_from_numpy(ref["start"]))
        logits = []
        for t in range(STEPS):
            lg, cache = model.decode_step(
                params, cache, torch.from_numpy(ref["tokens"][:, t:t + 1]),
                pos0 + t)
            logits.append(lg.numpy())
        eng = ServeEngine(model, params, batch_size=B, max_seq=PROMPT + NEW)
        tokens = eng.generate(ref["prompts"], max_new=NEW, cache=_start(
            model, tcfg, params, ref, PROMPT + NEW))
    return {"logits": logits, "cache": [t.numpy() for t in tree_leaves(cache)],
            "tokens": tokens}


def seq_reference(layout: str) -> dict:
    """The reference's smollm steps at POSITIONS from a seeded long
    cache."""
    batch, shape, _ = LAYOUTS[layout]
    jcfg, _ = cfgs("seq")
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (batch, len(POSITIONS))).astype(np.int32)
    mesh_cm, axes_cm = j_scope(jcfg, shape[1])
    with mesh_cm, axes_cm, serve_cases.eager_rope_freqs():
        model = j_build(jcfg)
        params = world_cases._unconstant(model.init(jax.random.PRNGKey(0)))
        start = decode_cases.seeded_cache(model.init_cache(batch, LONG), 13)
        cache = jax.tree_util.tree_map(jnp.asarray, start)
        step = jax.jit(model.decode_step)
        logits = []
        for i, pos in enumerate(POSITIONS):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                             jnp.int32(pos))
            logits.append(np.asarray(lg))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "start": start, "tokens": tokens,
            "logits": logits,
            "cache": jax.tree_util.tree_leaves(as_np(cache))}


# ---------------------------------------------------------------------------
# The world.
# ---------------------------------------------------------------------------

def rank_case(tag: str, ref: dict, mesh) -> dict:
    _, tcfg = cfgs(tag)
    _, max_seq, pos0 = CASES[tag]
    axes = t_axes(tcfg)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        cdescs = model.cache_descs(B, max_seq)
        cache = _start(model, tcfg, params, ref, max_seq,
                       lambda: cache_to_shards(ref["start"], cdescs, axes,
                                               mesh))
        local = [tuple(t.shape) for t in tree_leaves(cache)]
        lo, hi = tcommon.batch_block(B)
        tokens = torch.from_numpy(ref["tokens"][lo:hi])
        logits = []
        for t in range(STEPS):
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          pos0 + t, batch=B, max_seq=max_seq)
            logits.append(tcommon.gather_batch(lg, B).numpy())
        whole = tree_leaves(cache_from_shards(cache, cdescs, axes, mesh))
        # ServeEngine: the world's own greedy run, then teacher-forced on
        # the reference's greedy tokens.
        span = PROMPT + NEW
        eng = ServeEngine(model, params, batch_size=B, max_seq=span)
        greedy = eng.generate(ref["prompts"], max_new=NEW,
                              cache=_start(model, tcfg, params, ref, span))
        c, lg, _ = eng.prefill(_start(model, tcfg, params, ref, span),
                               ref["prompts"])
        forced = torch.from_numpy(ref["greedy"][lo:hi]).long()
        steps = [lg[:, -1]]
        for i in range(NEW - 1):
            lg, c = model.decode_step(params, c, forced[:, i:i + 1],
                                      PROMPT + i, batch=B, max_seq=span)
            steps.append(lg[:, -1])
        forced_logits = tcommon.gather_batch(torch.stack(steps, 1), B)
    return {"logits": logits, "cache": whole, "local": local,
            "full": [d.shape for d in tree_leaves(cdescs)],
            "greedy": greedy, "forced": forced_logits.numpy()}


def seq_rank(layout: str, ref: dict, mesh) -> dict:
    batch, shape, _ = LAYOUTS[layout]
    _, tcfg = cfgs("seq")
    axes = t_axes(tcfg, shape[1])
    assert not axes.shard_kv
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        cdescs = model.cache_descs(batch, LONG)
        cache = cache_to_shards(ref["start"], cdescs, axes, mesh)
        seq_axes = tattention.cache_seq_axes(tcfg, batch, LONG)
        lo, hi = tcommon.batch_block(batch)
        tokens = torch.from_numpy(ref["tokens"][lo:hi])
        logits = []
        for i, pos in enumerate(POSITIONS):
            lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1],
                                          pos, batch=batch, max_seq=LONG)
            logits.append(tcommon.gather_batch(lg, batch).numpy())
        whole = tree_leaves(cache_from_shards(cache, cdescs, axes, mesh))
    return {"logits": logits, "cache": whole, "seq_axes": seq_axes,
            "span": cache["k"].shape[2]}


def shard_refusal(ref: dict, mesh) -> str:
    """``decode_attention`` handed the rank's q / o shards instead of the
    whole leaves (:func:`attention.decode_qo`): the ``ValueError``'s
    message, or "" if it did not raise."""
    _, tcfg = cfgs("smollm")
    axes = t_axes(tcfg)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        params = params_to_shards(ref["params"], model.param_descs(), axes,
                                  mesh)
        p = {k: v[0] for k, v in params["blocks"]["attn"].items()}
        cache = model.init_cache(B, 16, torch.device("cpu"))
        x = torch.zeros(B, 1, tcfg.d_model)
        try:
            tattention.decode_attention(p, x, cache["k"][0], cache["v"][0],
                                        0, tcfg)
        except ValueError as e:
            return str(e)
    return ""


def _world(rank: int, world: int, refs: dict, seq_refs: dict) -> dict:
    torch.set_num_threads(1)
    meshes = {shape: tmesh.make_debug_mesh(*shape)
              for shape in ((1, 8), (2, 4))}
    return {"cases": {tag: rank_case(tag, ref, meshes[(1, 8)])
                      for tag, ref in refs.items()},
            "refusal": shard_refusal(refs["smollm"], meshes[(1, 8)]),
            "seq": {layout: seq_rank(layout, ref,
                                     meshes[LAYOUTS[layout][1]])
                    for layout, ref in seq_refs.items()}}


@pytest.fixture(scope="module")
def run():
    refs = {tag: reference(tag) for tag in CASES}
    single = {tag: one_device(tag, ref) for tag, ref in refs.items()}
    seq_refs = {layout: seq_reference(layout) for layout in LAYOUTS}
    ranks = tmesh.spawn_world(_world, WORLD, (refs, seq_refs),
                              limit=WORLD_LIMIT)
    return refs, single, seq_refs, ranks


@pytest.mark.parametrize("tag", tuple(CASES))
def test_one_device_matches_reference(run, tag):
    """The port's one-device decode of the model the mesh splits, against
    the reference's: each step's logits and the cache."""
    refs, single, _, _ = run
    for t, (a, b) in enumerate(zip(single[tag]["logits"],
                                   refs[tag]["logits"])):
        close(a, b, f"{tag} one device step {t} logits")
    for i, (a, b) in enumerate(zip(single[tag]["cache"], refs[tag]["cache"])):
        close(a, b, f"{tag} one device cache leaf {i}")


@pytest.mark.parametrize("tag", tuple(CASES))
def test_replicated_decode_matches_reference(run, tag):
    """Every rank's logits (its rows gathered) and the gathered cache
    against the reference and against the port on one device."""
    refs, single, _, ranks = run
    for r, got in enumerate(w["cases"][tag] for w in ranks):
        for want, who in ((refs[tag], "reference"),
                          (single[tag], "one device")):
            for t, (a, b) in enumerate(zip(got["logits"], want["logits"])):
                close(a, b, f"{tag} rank {r} step {t} logits vs {who}")
            assert len(got["cache"]) == len(want["cache"])
            for i, (a, b) in enumerate(zip(got["cache"], want["cache"])):
                close(a, b, f"{tag} rank {r} cache leaf {i} vs {who}")


def test_replicated_cache_is_whole_on_every_rank(run):
    """On (1, 8) every rank holds the whole cache: the batch does not
    split (one data rank) and the kv heads are whole (``shard_kv`` is
    False with 4 q heads on 8 model ranks)."""
    for w in run[3]:
        for tag, got in w["cases"].items():
            assert [list(s) for s in got["local"]] == \
                [list(s) for s in got["full"]], tag


def test_decode_attention_refuses_a_shard(run):
    """Replicated attention reads the whole q / o leaves, which the decode
    step gathers: ``decode_attention`` handed a rank's shard raises
    instead of gathering it on its own."""
    for r, w in enumerate(run[3]):
        assert "must be whole" in w["refusal"], (r, w["refusal"])


@pytest.mark.parametrize("tag", tuple(CASES))
def test_serve_engine_on_the_mesh(run, tag):
    refs, single, _, ranks = run
    ref = refs[tag]
    tol = TOL * float(np.abs(ref["greedy_logits"]).max())
    top2 = np.sort(ref["greedy_logits"], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * tol
    for r, got in enumerate(w["cases"][tag] for w in ranks):
        assert got["greedy"].dtype == np.int32
        np.testing.assert_array_equal(got["greedy"], single[tag]["tokens"])
        close(got["forced"], ref["greedy_logits"],
              f"{tag} rank {r} teacher-forced logits")
        assert (np.argmax(got["forced"], -1) == ref["greedy"])[clear].all()
        if clear.all():
            np.testing.assert_array_equal(got["greedy"], ref["greedy"])


@pytest.mark.parametrize("layout", tuple(LAYOUTS))
def test_sequence_split_of_replicated_attention(run, layout):
    _, _, seq_refs, ranks = run
    ref = seq_refs[layout]
    _, shape, want_axes = LAYOUTS[layout]
    for r, got in enumerate(w["seq"][layout] for w in ranks):
        assert got["seq_axes"] == want_axes
        assert got["span"] == LONG // 8
        for pos, a, b in zip(POSITIONS, got["logits"], ref["logits"]):
            close(a, b, f"{layout} {shape} rank {r} position {pos} logits")
        for i, (a, b) in enumerate(zip(got["cache"], ref["cache"])):
            close(a, b, f"{layout} {shape} rank {r} cache leaf {i}")
