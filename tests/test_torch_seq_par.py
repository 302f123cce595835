"""Sequence parallelism (``MeshAxes.seq_par``) on a model mesh: gloo
worlds of (1, 2) and (2, 2) CPU processes, each rank holding its shards
of the reference's padded model and, between the sub-blocks, its block
of the sequence (``models.common.seq_parallel``).

* dense (smollm, 3 heads / 1 kv head padded to 4, kv replicated), moe
  (mixtral at seq 64: the window binds, the experts split), vlm
  (internvl2: 8 patches then the text, one sequence), rwkv6 and zamba2
  (3 heads padded to 4): the forward's logits, the loss and every
  gradient leaf, gathered back, against the reference's padded model on
  one device (tests/test_torch_model_mesh_world.py's cases and
  tolerances: 1e-5 of each leaf's largest magnitude, the loss 1e-5
  relative) and against the same world without ``seq_par``;
* one D-SHB step of each: tests/test_torch_seq_par_dshb.py;
* a sequence that does not divide over the model axis raises, naming its
  length; decode ignores ``seq_par`` (the reference has no ``_sp`` there).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config as t_reduced
from repro_torch.interop import params_from_shards, params_to_shards
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.tree import tree_leaves, tree_structure, tree_unflatten

import test_torch_model_mesh_world as world_cases

TAGS = ("smollm", "mixtral", "internvl2", "rwkv6", "zamba2")
LIMIT = 240


def _grads(model, shards, batch):
    req = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(shards)]
    loss, _ = model.loss(tree_unflatten(tree_structure(shards), req), batch)
    return loss, torch.autograd.grad(loss, req)


def _rank_case(tag: str, ref: dict, mesh) -> dict:
    _, tcfg, pad_kv = world_cases._cfgs(tag)
    base = tmesh.mesh_axes_for(tcfg, model_par=2, pad_kv=pad_kv)
    out = {}
    for name, axes in (("seq_par", dataclasses.replace(base, seq_par=True)),
                       ("plain", base)):
        with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
            model = t_build(tcfg)
            descs = model.param_descs()
            shards = params_to_shards(ref["params"], descs, axes, mesh)
            batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
            tmesh.reset_collective_log()
            loss, grads = _grads(model, shards, batch)
            ops = {(c["op"], c["axis"]) for c in tmesh.collective_log()}
            whole = params_from_shards(
                tree_unflatten(tree_structure(shards), list(grads)), descs,
                axes, mesh)
            out[name] = {"loss": float(loss.detach()), "ops": ops,
                         "grads": tree_leaves(whole),
                         "logits": model.forward(shards, batch).numpy()}
    return out


def _refusals(mesh) -> list:
    cfg = t_reduced("smollm-360m")
    axes = dataclasses.replace(tmesh.mesh_axes_for(cfg, model_par=2),
                               seq_par=True)
    out = []
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(cfg)
        params = model.init(0, torch.device("cpu"))
        tokens = torch.zeros((1, 7), dtype=torch.long)
        try:
            model.loss(params, {"tokens": tokens, "labels": tokens})
            out.append("ran")
        except ValueError as e:
            out.append(str(e))
        # Decode steps one token: no sequence to split.
        cache = model.init_cache(1, 8, torch.device("cpu"))
        logits, _ = model.decode_step(params, cache, tokens[:, :1], 0,
                                      batch=1, max_seq=8)
        out.append(tuple(logits.shape))
    return out


def _world(rank: int, world: int, refs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(world // 2, 2)
    out = {tag: _rank_case(tag, ref, mesh) for tag, ref in refs.items()}
    out["refusals"] = _refusals(mesh)
    return out


@pytest.fixture(scope="module")
def forward():
    refs = {tag: world_cases._reference(tag) for tag in TAGS}
    return refs, {(world // 2, 2): tmesh.spawn_world(
        _world, world, (refs,), limit=LIMIT) for world in (2, 4)}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", TAGS)
def test_seq_par_forward_loss_and_gradients(forward, tag, shape):
    refs, worlds = forward
    world_cases.check_case(
        refs, {shape: [{tag: r[tag]["seq_par"]} for r in worlds[shape]]},
        tag, shape)
    for r in worlds[shape]:
        got, plain = r[tag]["seq_par"], r[tag]["plain"]
        # The stream really is split: its exits reduce-scatter.
        assert ("reduce_scatter", "model") in got["ops"]
        assert ("reduce_scatter", "model") not in plain["ops"]
        assert got["loss"] == pytest.approx(plain["loss"], rel=1e-5)
        for g, w in zip(got["grads"], plain["grads"]):
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-5 * max(float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_seq_par_refusal_and_decode(forward, shape):
    for r in forward[1][shape]:
        msg, logits_shape = r["refusals"]
        assert "seq_par" in msg and "7 positions" in msg, msg
        assert logits_shape[:2] == (1, 1)
