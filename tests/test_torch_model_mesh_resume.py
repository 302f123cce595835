"""Selective robustness and resumable runs on a model mesh: the trainer
under ``worker_axes=("data",)`` on a (2, 2) gloo world of CPU processes.

* arctic (4 experts, split 2 per model rank) with its expert tables under
  ``fsdp_keys``: their direction is the workers' mean gradient, summed in
  fp32 on each rank's expert shard over the data axis; one D-SHB step
  (NNM + CWTM, n = 8, f = 2, ALIE) against the reference's
  single-device step on the same padded parameters (a one-device mesh of
  ``Auto`` axes; tests/test_torch_model_mesh.py), at the tolerances of
  tests/test_torch_model_mesh_trainer.py;
* ``options.checkpoint``: ``train_loop`` over 3 steps in segments of 1,
  killed after its first snapshot (``FaultPlan(kill_at=0)``) and rerun
  into the same directory, resumes at step 1 and ends equal bit for bit,
  on every rank, to the uninterrupted run (parameter shards and momentum
  block); every rank writes its own ``rank<r>/`` snapshots and a run on
  another mesh is refused.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.types import AggregatorSpec as JSpec
from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_constant
from repro.training import ByzantineConfig as JByz
from repro.training import TrainerConfig as JCfg
from repro.training import build_train_step as j_build_step
from repro.training import init_state as j_init_state
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import params_from_shards, params_to_shards
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.launch_config import FSDP_KEYS
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.resilience import CheckpointConfig, FaultPlan
from repro_torch.resilience.faults import SimulatedPreemption
from repro_torch.rounds import RoundOptions
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training.trainer import to_device, train_loop
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
N, F, LR = 8, 2, 0.05
SPEC = dict(rule="cwtm", pre="nnm")


def j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _batches(vocab: int) -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        s = rng.integers(0, vocab, (N, 2, 17)).astype(np.int32)
        out.append({"tokens": s[..., :-1], "labels": s[..., 1:]})
    return out


def _reference(arch: str, fsdp: bool) -> dict:
    jcfg = j_reduced(arch)
    cfg = JCfg(algorithm="dshb", beta=0.9,
               agg=JSpec(f=F, backend="xla", **SPEC),
               byz=JByz(f=F, attack="alie", eta=8.0),
               fsdp_keys=FSDP_KEYS if fsdp else ())
    opt = j_sgd(clip=2.0)
    batches = _batches(jcfg.vocab_size)
    with jmesh.use_mesh(j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2)):
        model = j_build(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        state = j_init_state(params, opt, N, cfg)
        if fsdp:
            step = jax.jit(j_build_step(model.loss, opt, cfg,
                                        j_constant(LR)))
            state, m = step(state, batches[0], jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    out = {"init": as_np(params), "params": as_np(state["params"]),
           "batches": batches}
    if fsdp:
        out["loss"] = float(m["loss"])
        out["direction_norm"] = float(m["direction_norm"])
    return out


def _setup(arch: str, fsdp: bool, mesh):
    cfg = t_reduced(arch)
    axes = tmesh.mesh_axes_for(cfg, model_par=2)
    model = t_build(cfg)
    with tcommon.mesh_axes_scope(axes):
        descs = model.param_descs()
        specs = tcommon.leaf_specs(descs)
    tcfg = TCfg(beta=0.9, agg=TSpec(f=F, backend="cuda_sharded", **SPEC),
                byz=TByz(f=F, attack="alie", eta=8.0), worker_axes=("data",),
                param_specs=specs, fsdp_keys=FSDP_KEYS if fsdp else ())
    return model, axes, descs, tcfg


def _fsdp_case(mesh, ref: dict) -> dict:
    model, axes, descs, tcfg = _setup("arctic-480b", True, mesh)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        opt = t_sgd(clip=2.0)
        step = t_build_step(model.loss, opt, tcfg, t_constant(LR))
        state = t_init_state(params_to_shards(ref["init"], descs, axes, mesh),
                             opt, N, tcfg)
        state, m = step(state, to_device(ref["batches"][0], CPU),
                        perm=torch.arange(N))
        whole = params_from_shards(state["params"], descs, axes, mesh)
    return {"loss": float(m["loss"]),
            "direction_norm": float(m["direction_norm"]),
            "params": tree_leaves(whole),
            "momentum_width": state["momentum"].shape[1]}


def _resume_case(mesh, ref: dict, tmp: str) -> dict:
    model, axes, descs, tcfg = _setup("smollm-360m", False, mesh)
    out = {}
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        init = params_to_shards(ref["init"], descs, axes, mesh)

        def run(options):
            params, info = train_loop(
                model.loss, init, iter(ref["batches"]), t_sgd(clip=2.0),
                tcfg, t_constant(LR), 3, seed=3, chunk=1, options=options)
            return [t.numpy() for t in tree_leaves(params)] + \
                [info["state"]["momentum"].numpy()], info

        out["full"], _ = run(None)
        ck = CheckpointConfig(dir=tmp, sync=True,
                              fault_plan=FaultPlan(kill_at=0))
        try:
            run(RoundOptions(checkpoint=ck))
            out["killed"] = False
        except SimulatedPreemption:
            out["killed"] = True
        out["resumed"], info = run(RoundOptions(
            checkpoint=dataclasses.replace(ck, fault_plan=None)))
        out["resumed_from"] = info["scan_report"]["resumed_from"]
    # The same directory under another mesh: the signature differs.
    other = tmesh.make_mesh((mesh.devices,), ("shard",))
    flat = dataclasses.replace(tcfg, worker_axes=("shard",), param_specs=None)
    with tmesh.use_mesh(other):
        try:
            train_loop(model.loss, model.init(0, CPU), iter(ref["batches"]),
                       t_sgd(clip=2.0), flat, t_constant(LR), 3, seed=3,
                       chunk=1, options=RoundOptions(checkpoint=ck))
            out["other_mesh"] = "ran"
        except Exception as e:                         # noqa: BLE001
            out["other_mesh"] = str(e)
    return out


def _world(rank: int, world: int, refs: dict, tmp: str) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(2, 2)
    return {"fsdp": _fsdp_case(mesh, refs["fsdp"]),
            "resume": _resume_case(mesh, refs["resume"], tmp)}


@pytest.fixture(scope="module")
def refs():
    return {"fsdp": _reference("arctic-480b", True),
            "resume": _reference("smollm-360m", False)}


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("model_mesh_ckpt"))
    return tmesh.spawn_world(_world, 4, (refs, tmp), limit=300)


def test_fsdp_keys_on_model_shards(ranks, refs):
    ref = refs["fsdp"]
    want = jax.tree_util.tree_leaves(ref["params"])
    scale = max(float(np.abs(w).max()) for w in want)
    for r in ranks:
        got = r["fsdp"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert got["direction_norm"] == pytest.approx(ref["direction_norm"],
                                                      rel=1e-4)
        for a, b in zip(got["params"], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)
    # The expert tables are out of the stack: arctic's robust columns are
    # a small part of its 1.07 M parameters.
    assert sum(r["fsdp"]["momentum_width"] for r in ranks) < 400_000


def test_checkpoint_kill_and_resume_bit_for_bit(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["killed"] and res["resumed_from"] == 1
        assert len(res["full"]) == len(res["resumed"])
        for a, b in zip(res["full"], res["resumed"]):
            np.testing.assert_array_equal(a, b)
        assert "signature" in res["other_mesh"] or "mesh" in \
            res["other_mesh"], res["other_mesh"]
