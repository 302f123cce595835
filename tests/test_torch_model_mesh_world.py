"""The model-split dense and moe models on gloo worlds of CPU processes,
held to the reference's padded model on one device (the other families
run through this module's helpers in tests/test_torch_model_mesh_families.py).

Each case's parameters are the reference's padded init (a one-device
mesh of ``Auto`` axes, under ``mesh_axes_scope``; see
tests/test_torch_model_mesh.py), carried into every rank's shards with
``interop.params_to_shards``.  Each rank of a ``(data, model)`` world of
(1, 2) and (2, 2) runs the port's forward and loss on its shards
(column- / row-parallel attention and MLP, the split vocabulary, the
split experts) and gathers every gradient back with
``interop.params_from_shards``:

* smollm with 3 heads and 1 kv head (padded to 4; kv replicated), tied;
* qwen2 (QKV biases, random; kv heads split);
* minitron with 1 kv head and ``pad_kv`` (kv padded to 2, split);
* the moe family (mixtral, arctic) in tests/test_torch_model_mesh_moe.py,
  and rwkv6, zamba2, internvl2 and whisper in
  tests/test_torch_model_mesh_families.py, which run this module's
  helpers on their own worlds.

Tolerances: logits within 1e-5 of the largest, the loss within 1e-5
relative, each gradient leaf within 1e-5 of its largest magnitude (fp32
partial sums all-reduced against one device's sums).  The last test
holds the refusals of what still waits on a model mesh (item 19).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.interop import params_from_shards, params_to_shards
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

WORLD_LIMIT = 240
TOL = 1e-5
DENSE = ("smollm", "qwen2", "minitron")

#: tag: (arch, config changes, pad_kv, seq)
CASES = {
    "smollm": ("smollm-360m", dict(num_heads=3, num_kv_heads=1), False, 32),
    "qwen2": ("qwen2-7b", {}, False, 32),
    "minitron": ("minitron-8b", dict(num_kv_heads=1), True, 32),
    "mixtral": ("mixtral-8x22b", {}, False, 64),
    "arctic": ("arctic-480b", {}, False, 32),
    "arctic-ff": ("arctic-480b", dict(num_experts=3), False, 32),
    # 3 SSM (and attention) heads padded to 4 on the model axis of 2.
    "rwkv6": ("rwkv6-3b", dict(ssm_heads=3), False, 32),
    "zamba2": ("zamba2-2.7b", dict(ssm_heads=3, num_heads=3, num_kv_heads=3),
               False, 32),
    "internvl2": ("internvl2-2b", dict(num_kv_heads=1), False, 24),
    "whisper": ("whisper-base", dict(num_heads=3, num_kv_heads=3), False,
                24),
}


def j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _cfgs(tag):
    arch, kw, pad_kv, _ = CASES[tag]
    return j_reduced(arch).replace(**kw), t_reduced(arch).replace(**kw), pad_kv


def _batch(cfg, s: int) -> dict:
    """Seeded tokens and labels; a VLM's seeded patches, an
    encoder-decoder's seeded frames (zeros would hide their paths)."""
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    labels[:, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


#: Cases whose constant-initialised leaves (norm gains, biases, rwkv6's
#: u and decay bias, Mamba2's a_log / dt_bias / d_skip) are moved off
#: their constants first: equal rows would hide a head read from the
#: wrong rank's rows.
UNCONSTANT = ("rwkv6", "zamba2", "internvl2", "whisper")


def _unconstant(params):
    rng = np.random.default_rng(3)

    def move(a):
        v = np.asarray(a)
        if v.size < 2 or not np.all(v == v.reshape(-1)[0]):
            return a
        noise = 0.1 * rng.standard_normal(v.shape)
        return jnp.asarray(v.astype(np.float32) + noise, a.dtype)
    return jax.tree_util.tree_map(move, params)


def _reference(tag: str) -> dict:
    """The reference's padded parameters, forward, loss and gradients."""
    jcfg, _, pad_kv = _cfgs(tag)
    batch = _batch(jcfg, CASES[tag][3])
    with jmesh.use_mesh(j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2, pad_kv=pad_kv)):
        model = j_build(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        if jcfg.qkv_bias:                 # zeros at init would hide them
            rng = np.random.default_rng(2)
            attn = dict(params["blocks"]["attn"])
            for k in ("bq", "bk", "bv"):
                attn[k] = jnp.asarray(0.1 * rng.standard_normal(
                    attn[k].shape), attn[k].dtype)
            params = dict(params, blocks=dict(params["blocks"], attn=attn))
        if tag in UNCONSTANT:
            params = _unconstant(params)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.value_and_grad(
            lambda p: model.loss(p, jb)[0])(params)
        logits = model.forward(params, jb)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"params": as_np(params), "grads": as_np(grads), "batch": batch,
            "loss": float(loss), "logits": np.asarray(logits)}


def _rank_case(tag: str, ref: dict, mesh) -> dict:
    _, tcfg, pad_kv = _cfgs(tag)
    axes = tmesh.mesh_axes_for(tcfg, model_par=2, pad_kv=pad_kv)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(tcfg)
        descs = model.param_descs()
        shards = params_to_shards(ref["params"], descs, axes, mesh)
        batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
        req = [leaf.detach().requires_grad_(True)
               for leaf in tree_leaves(shards)]
        loss, _ = model.loss(tree_unflatten(tree_structure(shards), req),
                             batch)
        grads = torch.autograd.grad(loss, req)
        whole = params_from_shards(
            tree_unflatten(tree_structure(shards), list(grads)), descs, axes,
            mesh)
        logits = model.forward(shards, batch).detach().numpy()
        local = [tuple(t.shape) for t in tree_leaves(shards)]
    return {"loss": float(loss.detach()), "grads": tree_leaves(whole),
            "logits": logits, "local": local,
            "whole": [d.shape for d in tree_leaves(descs)],
            "shard_kv": axes.shard_kv, "shard_expert": axes.shard_expert}


def _world(rank: int, world: int, refs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(world // 2, 2)
    return {tag: _rank_case(tag, ref, mesh) for tag, ref in refs.items()}


def run_worlds(tags) -> tuple:
    """The reference's results for ``tags`` and each world's ranks'."""
    refs = {tag: _reference(tag) for tag in tags}
    return refs, {(world // 2, 2): tmesh.spawn_world(
        _world, world, (refs,), limit=WORLD_LIMIT) for world in (2, 4)}


def check_case(refs: dict, worlds: dict, tag: str, shape: tuple) -> None:
    """One case's forward, loss and gathered gradients on every rank."""
    ref = refs[tag]
    for got in (r[tag] for r in worlds[shape]):
        want = ref["logits"]
        np.testing.assert_allclose(got["logits"], want, rtol=0,
                                   atol=TOL * float(np.abs(want).max()))
        assert got["loss"] == pytest.approx(ref["loss"], rel=TOL)
        wleaves = jax.tree_util.tree_leaves(ref["grads"])
        assert len(got["grads"]) == len(wleaves)
        for g, w in zip(got["grads"], wleaves):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=TOL * max(float(np.abs(w).max()), 1e-30))


def check_shards(worlds: dict) -> None:
    """Each split dimension is halved on every rank, the rest whole."""
    for ranks in worlds.values():
        for tag, got in ranks[0].items():
            split = [a != b for a, b in zip(got["local"], got["whole"])]
            assert any(split) and not all(split), tag
            for loc, whole in zip(got["local"], got["whole"]):
                diff = [i for i, (a, b) in enumerate(zip(loc, whole)) if a != b]
                assert len(diff) <= 1 and all(2 * loc[i] == whole[i]
                                              for i in diff), (tag, loc)


@pytest.fixture(scope="module")
def dense():
    return run_worlds(DENSE)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", DENSE)
def test_sharded_forward_loss_and_gradients(dense, tag, shape):
    check_case(*dense, tag, shape)


def test_each_rank_holds_its_shards(dense):
    """The kv heads split only when shard_kv (qwen2, minitron with
    pad_kv), not smollm's replicated one."""
    worlds = dense[1]
    check_shards(worlds)
    for ranks in worlds.values():
        assert not ranks[0]["smollm"]["shard_kv"]
        assert ranks[0]["qwen2"]["shard_kv"] and ranks[0]["minitron"]["shard_kv"]


def _refusals(rank: int, world: int) -> list:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(1, 2)
    out = []

    def attempt(fn):
        try:
            fn()
            out.append("ran")
        except ValueError as e:
            out.append(str(e))

    cfg = t_reduced("mixtral-8x22b")
    for flag in ("seq_par", "expert_fsdp"):
        axes = tcommon.MeshAxes(model_par=2, **{flag: True})
        with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
            model = t_build(cfg)
            tokens = torch.zeros((1, 8), dtype=torch.long)
            attempt(lambda: model.loss(
                model.init(0, torch.device("cpu")),
                {"tokens": tokens, "labels": tokens}))
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(
            tmesh.mesh_axes_for(cfg, model_par=2)):
        model = t_build(cfg)
        params = model.init(0, torch.device("cpu"))
        cache = model.init_cache(1, 8, torch.device("cpu"))
        attempt(lambda: model.decode_step(
            params, cache, torch.zeros((1, 1), dtype=torch.long), 0))
        attempt(lambda: tcommon.constrain(torch.zeros(2, 8), "batch", "heads",
                                          full=(2, 8)))
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(
            tcommon.MeshAxes(model_par=4)):
        attempt(tcommon.model_mesh)
    attempt(tmesh.make_production_mesh)
    return out


def test_what_waits_on_a_model_mesh_raises():
    """Only item 19 (``seq_par`` / ``expert_fsdp``) still waits on a
    model mesh; decode runs there (tests/test_torch_model_mesh_decode.py)
    once it is told the cache's whole batch and span, which its shard
    cannot show.  The constraint's shape check, a model axis of the wrong
    size and the production mesh's rank count raise too."""
    got = tmesh.spawn_world(_refusals, 2, limit=120)[0]
    assert all("item 19" in m for m in got[0:2]), got[0:2]
    assert "batch=" in got[2] and "max_seq=" in got[2], got[2]
    assert "expected (2, 4)" in got[3]
    assert "model_par=4" in got[4]
    assert "256 ranks" in got[5]
