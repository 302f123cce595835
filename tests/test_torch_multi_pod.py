"""Training on the multi-pod mesh: the trainer under ``worker_axes=("pod",
"data")`` on an 8-rank gloo world of CPU processes shaped (pod 2, data 2,
model 2), each rank holding its shards of the padded model, held to the
reference's single-device step and to the port's own single-device step
on the same padded parameters (the helpers of
tests/test_torch_model_mesh_trainer.py).

The 8 workers are dealt over the four (pod, data) ranks in the
reference's order (rank index ``pod * 2 + data``), each worker's forward
and backward split over its two model ranks:

* smollm with 3 heads / 1 kv head (padded to 4, kv replicated), n = 8,
  f = 2, ALIE, 2 steps: NNM + CWTM on "cuda_sharded" (the model shard's
  columns split over the four data ranks, the Gram all-reduced over
  every axis) and hier + NNM + CWTM (s = 2) on "cuda_hier" (the worker
  rows tiled over "data", the axis ``aggregation_worker_axis`` picks; the
  pods repeat the aggregate);
* arctic under ``seq_par`` + ``expert_fsdp``: its expert tables split over
  ``("pod", "data")`` as well as the model axis and under ``fsdp_keys``,
  one step.

Bounds: the loss 1e-5 relative, direction_norm and kappa_hat 1e-4, the
parameters within 1e-5 of the tree's largest magnitude, the attacked
stack's Gram (summed over the blocks) within 1e-5 of its largest entry,
and the momentum block each rank holds within 1e-5 of its largest
magnitude against the same columns of the one-device momentum, against
the reference and the port.  Every rank's leaves that no data axis splits
equal those of the other ranks of its model index bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.interop import params_from_numpy, params_from_shards
from repro_torch.interop import params_to_shards
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.shard import column_block
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.launch_config import FSDP_KEYS
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.optim import sgd as t_sgd
from repro_torch.optim.schedules import constant as t_constant
from repro_torch.training import ByzantineConfig as TByz
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import build_train_step as t_build_step
from repro_torch.training import init_state as t_init_state
from repro_torch.training import trainer as ttrainer
from repro_torch.training.trainer import to_device
from repro_torch.tree import tree_leaves

import test_torch_model_mesh_trainer as trainer_cases
from repro_torch.configs import reduced_config as t_reduced

CPU = torch.device("cpu")
N, F, LR = trainer_cases.N, trainer_cases.F, trainer_cases.LR
SHAPE = (2, 2, 2)
DATA = ("pod", "data")
WORLD_LIMIT = 600
TOL = 1e-5

#: tag: (arch tag, spec kwargs, fsdp?, MeshAxes changes, steps)
CASES = {
    "nnm+cwtm": ("smollm", dict(rule="cwtm", pre="nnm",
                                backend="cuda_sharded"), False, {}, 2),
    "hier+nnm+cwtm": ("smollm", dict(rule="cwtm", pre="nnm", hier=True,
                                     bucket_size=2, backend="cuda_hier"),
                      False, {}, 2),
    "arctic seq_par+expert_fsdp": (
        "arctic", dict(rule="cwtm", pre="nnm", backend="cuda_sharded"),
        True, dict(seq_par=True, expert_fsdp=True), 1),
}


def _setup(tag: str):
    arch_tag, spec_kw, fsdp, layout, _ = CASES[tag]
    arch, kw = trainer_cases.ARCHS[arch_tag]
    cfg = t_reduced(arch).replace(**kw)
    axes = dataclasses.replace(
        tmesh.mesh_axes_for(cfg, multi_pod=True, model_par=SHAPE[2]),
        **layout)
    return cfg, axes, spec_kw, fsdp


def _tcfg(spec_kw: dict, fsdp: bool, **kw) -> TCfg:
    return TCfg(beta=0.9, agg=TSpec(f=F, **spec_kw),
                byz=TByz(f=F, attack="alie", eta=8.0),
                fsdp_keys=FSDP_KEYS if fsdp else (), **kw)


def _gram(a: torch.Tensor) -> torch.Tensor:
    a = a.double()
    return a @ a.T


def one_device(tag: str, ref: dict, perms: list) -> dict:
    """The port's steps of the padded model whole on one device: metrics,
    parameters, each step's stack Gram and the final momentum as one
    (n, ...) array per robust leaf."""
    cfg, axes, spec_kw, fsdp = _setup(tag)
    steps = CASES[tag][4]
    tcfg = _tcfg(dict(spec_kw, backend="auto"), fsdp)
    with tcommon.mesh_axes_scope(axes):
        model = t_build(cfg)
        opt = t_sgd(clip=2.0)
        step = t_build_step(model.loss, opt, tcfg, t_constant(LR))
        params = params_from_numpy(ref["init"])
        state = t_init_state(params, opt, N, tcfg)
        rows, grams = [], []
        for t in range(steps):
            internals: dict = {}
            state, m = step(state, to_device(ref["batches"][t], CPU),
                            internals, perm=torch.from_numpy(perms[t]))
            rows.append({k: float(v) for k, v in m.items()})
            grams.append(_gram(internals["attacked"]).numpy())
        robust, _ = ttrainer.split_params(state["params"], tcfg.fsdp_keys)
        mom, off = [], 0
        for leaf in robust:
            mom.append(state["momentum"][:, off:off + leaf.numel()]
                       .reshape((N,) + tuple(leaf.shape)).numpy())
            off += leaf.numel()
    return {"rows": rows, "grams": grams,
            "params": [t.numpy() for t in tree_leaves(state["params"])],
            "momentum": mom}


def _block_of(momentum: list, robust_descs: list, mc, local: tuple, axes,
              mesh) -> np.ndarray:
    """This rank's momentum block cut from a one-device momentum (one
    (n, ...) array per robust leaf): each split leaf's shard, each
    replicated leaf's column block for this model index, side by side,
    then the block's columns ``local`` of them."""
    pieces = []
    for m, d, split in zip(momentum, robust_descs, mc.split):
        m = np.asarray(m).reshape((N,) + tuple(d.shape))
        if split:
            pieces.append(m[(slice(None),) + tcommon.shard_slice(
                d, axes, mesh)].reshape(N, -1))
        else:
            a, b = column_block(m[0].size, mc.k, mc.index)
            pieces.append(m.reshape(N, -1)[:, a:b])
    return np.concatenate(pieces, axis=1)[:, local[0]:local[1]]


def _rank_case(tag: str, ref: dict, single: dict, perms: list, mesh) -> dict:
    cfg, axes, spec_kw, fsdp = _setup(tag)
    steps = CASES[tag][4]
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(cfg)
        descs = model.param_descs()
        specs = tcommon.leaf_specs(descs)
        tcfg = _tcfg(spec_kw, fsdp, worker_axes=DATA, param_specs=specs)
        opt = t_sgd(clip=2.0)
        step = t_build_step(model.loss, opt, tcfg, t_constant(LR))
        params = params_to_shards(ref["init"], descs, axes, mesh)
        state = t_init_state(params, opt, N, tcfg)
        mc = ttrainer.model_columns(tcfg, params)
        sh = ttrainer.trainer_shard(tcfg, CPU, mc)
        local = (sh.span[0] - mc.offset, sh.span[1] - mc.offset)
        rows, grams = [], []
        for t in range(steps):
            internals: dict = {}
            state, m = step(state, to_device(ref["batches"][t], CPU),
                            internals, perm=torch.from_numpy(perms[t]))
            rows.append({k: float(v) for k, v in m.items()})
            hier = spec_kw.get("hier", False)
            grams.append(mesh.all_reduce(_gram(internals["attacked"]),
                                         "model" if hier
                                         else ("model",) + DATA).numpy())
        whole = params_from_shards(state["params"], descs, axes, mesh)
        _, _, is_fsdp = ttrainer._split_info(params, tcfg.fsdp_keys)
        robust_descs = [d for d, f in zip(tree_leaves(descs), is_fsdp)
                        if not f]
        want = {who: _block_of(mom, robust_descs, mc, local, axes, mesh)
                for who, mom in (("reference", ref["momentum"]),
                                 ("one device", single["momentum"]))}
        rec = kdispatch.last_dispatch()
    data_split = [any(a in tcommon.spec_axes(p) for p in spec for a in DATA)
                  for spec in specs]
    return {"rows": rows, "grams": grams, "params": tree_leaves(whole),
            "shards": [t.numpy() for t in tree_leaves(state["params"])],
            "data_split": data_split, "momentum": state["momentum"].numpy(),
            "want_momentum": want, "backend": rec.backend,
            "worker_axis": sh.worker_axis, "axis": sh.axis,
            "model_index": mesh.index("model"),
            "data_index": mesh.index(DATA)}


def _world(rank: int, world: int, refs: dict, single: dict,
           perms: list) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_mesh(SHAPE, ("pod", "data", "model"))
    return {tag: _rank_case(tag, refs[tag], single[tag], perms, mesh)
            for tag in refs}


@pytest.fixture(scope="module")
def run():
    perms = trainer_cases._perms()
    refs = {tag: trainer_cases._reference(arch, spec, fsdp, layout,
                                          steps=steps)
            for tag, (arch, spec, fsdp, layout, steps) in CASES.items()}
    single = {tag: one_device(tag, ref, perms) for tag, ref in refs.items()}
    ranks = tmesh.spawn_world(_world, 8, (refs, single, perms),
                              limit=WORLD_LIMIT)
    return refs, single, ranks


def _close_tree(got: list, want: list, tol: float, what: str) -> None:
    scale = max(float(np.abs(w).max()) for w in want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=tol * scale, err_msg=f"{what} {i}")


@pytest.mark.parametrize("tag", list(CASES))
def test_multi_pod_step_matches_one_device(run, tag):
    """Every rank's metrics, stack Gram, parameters and momentum block
    against the reference's one-device steps and the port's."""
    refs, single, ranks = run
    ref, one = refs[tag], single[tag]
    for r, got in enumerate(w[tag] for w in ranks):
        assert got["backend"] == CASES[tag][1]["backend"]
        for who, want in (("reference", ref), ("one device", one)):
            for g, w in zip(got["rows"], want["rows"]):
                assert g["loss"] == pytest.approx(w["loss"], rel=TOL), who
                assert g["direction_norm"] == pytest.approx(
                    w["direction_norm"], rel=1e-4), who
                assert g["kappa_hat"] == pytest.approx(
                    w["kappa_hat"], rel=1e-4, abs=1e-4), who
            for g, w in zip(got["grams"], want["grams"]):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                    err_msg=f"{tag} rank {r} Gram vs {who}")
            params = want["params"] if who == "one device" else \
                jax.tree_util.tree_leaves(want["params"])
            _close_tree(got["params"], params, TOL,
                        f"{tag} rank {r} parameters vs {who}")
            block = got["want_momentum"][who]
            assert got["momentum"].shape == block.shape
            np.testing.assert_allclose(
                got["momentum"], block, rtol=0,
                atol=TOL * float(np.abs(block).max()),
                err_msg=f"{tag} rank {r} momentum vs {who}")


def test_workers_dealt_pod_major(run):
    """Each rank's data index is ``pod * 2 + data`` (rank r of the (2, 2,
    2) grid: r // 2); "cuda_sharded" splits D over the model and both
    data axes, "cuda_hier" tiles the worker rows over "data"."""
    for r, w in enumerate(run[2]):
        assert w["nnm+cwtm"]["data_index"] == r // 2
        assert w["nnm+cwtm"]["model_index"] == r % 2
        assert w["nnm+cwtm"]["axis"] == ("model", "pod", "data")
        assert w["hier+nnm+cwtm"]["axis"] == "model"
        assert w["hier+nnm+cwtm"]["worker_axis"] == "data"


@pytest.mark.parametrize("tag", list(CASES))
def test_ranks_of_a_model_index_hold_equal_shards(run, tag):
    """The four (pod, data) ranks of each model index hold equal shards of
    every leaf no data axis splits, bit for bit; the expert tables that
    expert FSDP lays over ("pod", "data") differ between them."""
    ranks = run[2]
    for m in range(SHAPE[2]):
        group = [w[tag] for w in ranks if w[tag]["model_index"] == m]
        assert len(group) == 4
        for other in group[1:]:
            for a, b, split in zip(group[0]["shards"], other["shards"],
                                   group[0]["data_split"]):
                if not split:
                    np.testing.assert_array_equal(a, b, err_msg=tag)
        if CASES[tag][3].get("expert_fsdp"):
            assert any(split and not np.array_equal(a, b) for a, b, split
                       in zip(group[0]["shards"], group[1]["shards"],
                              group[0]["data_split"]))
