"""D-SHB on a model mesh: the trainer under ``worker_axes=("data",)`` on
gloo worlds of (1, 2) and (2, 2) CPU processes, each rank holding its
shards of the padded model, held to the reference's single-device step
on the same padded parameters (a one-device mesh of ``Auto`` axes under
``mesh_axes_scope``; see tests/test_torch_model_mesh.py).

Each step deals the 8 workers over the data axis, runs every worker's
forward and backward split over its data index's model ranks, hands each
rank its model shard's columns of the gradient rows, aggregates them
("cuda_sharded": the Gram all-reduced over both axes; "cuda_hier": the
worker rows tiled over the data axis) and updates the rank's shard.

* smollm with 3 heads / 1 kv head (padded to 4, kv replicated), n = 8,
  f = 2, ALIE, 2 steps: NNM + CWTM, NNM + GM and hier + NNM + CWTM
  (s = 2).  Loss 1e-5 relative, direction_norm and kappa_hat 1e-4,
  parameters 1e-5 of the tree's largest magnitude (GM: 1e-4, the fleet's
  GM tolerance), and the attacked stack's Gram, summed over the blocks,
  within 1e-5 of its largest entry against the Gram of the reference's
  attacked momentum: a column counted twice (a replicated leaf on both
  model ranks) would show there, where CWTM would not show it;
* arctic's expert tables under ``fsdp_keys`` and ``options.checkpoint``
  are tests/test_torch_model_mesh_resume.py's; rwkv6, zamba2, internvl2
  and whisper run this module's helpers in
  tests/test_torch_model_mesh_families_dshb.py, the sketch Gram in
  tests/test_torch_model_mesh_sketch.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.core.attacks import apply_attack_tree as j_attack
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
from repro_torch.kernels import dispatch as kdispatch
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
from repro_torch.training.trainer import to_device
from repro_torch.tree import tree_leaves

import test_torch_model_mesh_world as world_cases

CPU = torch.device("cpu")
N, F, STEPS, LR = 8, 2, 2, 0.05
WORLD_LIMIT = 300

#: tag: (arch tag, spec kwargs, fsdp?)
CASES = {
    "nnm+cwtm": ("smollm", dict(rule="cwtm", pre="nnm",
                                backend="cuda_sharded"), False),
    "nnm+gm": ("smollm", dict(rule="gm", pre="nnm", backend="cuda_sharded"),
               False),
    "hier+nnm+cwtm": ("smollm", dict(rule="cwtm", pre="nnm", hier=True,
                                     bucket_size=2, backend="cuda_hier"),
                      False),
}
ARCHS = {"smollm": ("smollm-360m", dict(num_heads=3, num_kv_heads=1))}
#: The other families' cases (tests/test_torch_model_mesh_world.py's),
#: their constant leaves moved off their constants.
FAMILY_ARCHS = ("rwkv6", "zamba2", "internvl2", "whisper")
ARCHS.update({tag: world_cases.CASES[tag][:2] for tag in
              FAMILY_ARCHS + ("mixtral", "arctic", "arctic-ff")})


def j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _batches(cfg) -> list:
    """Three steps' worker batches of 2 x 16 tokens (a VLM's 8 text
    positions, after its patches); seeded patches and frames."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        s = rng.integers(0, cfg.vocab_size, (N, 2, 17)).astype(np.int32)
        b = {"tokens": s[..., :-1], "labels": s[..., 1:]}
        if cfg.family == "vlm":
            b = {k: v[..., :8] for k, v in b.items()}
            b["patches"] = rng.standard_normal(
                (N, 2, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (N, 2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _perms() -> list:
    """The reference step's bucket permutation of each step."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.permutation(jax.random.split(sub)[0],
                                                   N)))
    return out


def ref_signs(key, leaves: list, s: int) -> list:
    """The reference's sketch signs under ``key`` (its aggregate's key):
    leaf i's ceil(d_i / s) Rademacher values, d_i the whole leaf's size."""
    return [np.array(jax.random.rademacher(
        jax.random.fold_in(key, i), (-(-int(np.prod(np.shape(leaf))) // s),),
        jnp.float32)) for i, leaf in enumerate(leaves)]


def _gram(leaves: list) -> np.ndarray:
    flat = np.concatenate([np.asarray(x, np.float64).reshape(N, -1)
                           for x in leaves], axis=1)
    return flat @ flat.T


def _reference(arch_tag: str, spec_kw: dict, fsdp: bool, layout=None,
               steps: int = STEPS) -> dict:
    """The reference's steps (``layout``, the port's ``MeshAxes`` changes,
    changes nothing on one device)."""
    arch, kw = ARCHS[arch_tag]
    jcfg = j_reduced(arch).replace(**kw)
    spec_kw = {k: v for k, v in spec_kw.items() if k != "backend"}
    cfg = JCfg(algorithm="dshb", beta=0.9, agg=JSpec(f=F, backend="xla",
                                                     **spec_kw),
               byz=JByz(f=F, attack="alie", eta=8.0),
               fsdp_keys=FSDP_KEYS if fsdp else ())
    opt = j_sgd(clip=2.0)
    batches = _batches(jcfg)
    with jmesh.use_mesh(j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2)):
        model = j_build(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        if arch_tag in world_cases.UNCONSTANT:
            params = world_cases._unconstant(params)
        step = jax.jit(j_build_step(model.loss, opt, cfg, j_constant(LR)))
        state = j_init_state(params, opt, N, cfg)
        key, rows, grams, signs = jax.random.PRNGKey(0), [], [], []
        for b in batches[:steps]:
            key, sub = jax.random.split(key)
            if spec_kw.get("sketch_dim"):       # the step's aggregate key
                signs.append(ref_signs(jax.random.split(sub)[0],
                                       jax.tree_util.tree_leaves(params),
                                       spec_kw["sketch_dim"]))
            state, m = step(state, b, sub)
            rows.append({k: float(m[k]) for k in ("loss", "kappa_hat",
                                                  "direction_norm")})
            grams.append(_gram(jax.tree_util.tree_leaves(j_attack(
                "alie", state["momentum"], F, eta=8.0))))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"init": as_np(params), "params": as_np(state["params"]),
            "rows": rows, "grams": grams, "batches": batches,
            "signs": signs}


def _tcfg(arch_tag, spec_kw, fsdp, specs):
    return TCfg(beta=0.9, agg=TSpec(f=F, **spec_kw),
                byz=TByz(f=F, attack="alie", eta=8.0), worker_axes=("data",),
                param_specs=specs, fsdp_keys=FSDP_KEYS if fsdp else ())


def _setup(arch_tag: str, mesh, layout=None):
    arch, kw = ARCHS[arch_tag]
    cfg = t_reduced(arch).replace(**kw)
    axes = tmesh.mesh_axes_for(cfg, model_par=2)
    return cfg, dataclasses.replace(axes, **(layout or {}))


def _rank_case(tag: str, ref: dict, perms: list, mesh, cases: dict,
               steps: int = STEPS) -> dict:
    arch_tag, spec_kw, fsdp, *layout = cases[tag]
    cfg, axes = _setup(arch_tag, mesh, *layout)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(cfg)
        descs = model.param_descs()
        tcfg = _tcfg(arch_tag, spec_kw, fsdp, tcommon.leaf_specs(descs))
        opt = t_sgd(clip=2.0)
        step = t_build_step(model.loss, opt, tcfg, t_constant(LR))
        state = t_init_state(params_to_shards(ref["init"], descs, axes, mesh),
                             opt, N, tcfg)
        rows, grams = [], []
        for t, b in enumerate(ref["batches"][:steps]):
            internals: dict = {}
            signs = [torch.from_numpy(x) for x in ref["signs"][t]] \
                if ref["signs"] else None
            state, m = step(state, to_device(b, CPU), internals,
                            perm=torch.from_numpy(perms[t]), signs=signs)
            rows.append({k: float(v) for k, v in m.items()})
            a = internals["attacked"].double()
            g = a @ a.T
            hier = spec_kw.get("hier", False)
            grams.append(mesh.all_reduce(g, "model" if hier
                                         else ("model", "data")).numpy())
        whole = params_from_shards(state["params"], descs, axes, mesh)
        rec = kdispatch.last_dispatch()
    return {"rows": rows, "grams": grams, "params": tree_leaves(whole),
            "shards": [t.numpy() for t in tree_leaves(state["params"])],
            "momentum": state["momentum"].numpy(),
            "backend": rec.backend, "mesh_devices": rec.mesh_devices,
            "decisions": [d.primitive for d in rec.decisions]}


def _world(rank: int, world: int, refs: dict, perms: list,
           cases: dict, steps: int = STEPS) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(world // 2, 2)
    return {tag: _rank_case(tag, refs[tag], perms, mesh, cases, steps)
            for tag in refs}


def run_cases(cases: dict, steps: int = STEPS) -> tuple:
    """The reference's ``steps`` steps for ``cases`` and each world's
    ranks'.  A case is (arch tag, spec kwargs, fsdp) and, optionally, the
    port's ``MeshAxes`` changes (``seq_par``, ``expert_fsdp``)."""
    refs = {tag: _reference(*case, steps=steps)
            for tag, case in cases.items()}
    return refs, {(world // 2, 2): tmesh.spawn_world(
        _world, world, (refs, _perms(), cases, steps), limit=WORLD_LIMIT)
        for world in (2, 4)}


@pytest.fixture(scope="module")
def run():
    return run_cases(CASES)


@pytest.fixture(scope="module")
def refs(run):
    return run[0]


@pytest.fixture(scope="module")
def worlds(run):
    return run[1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
@pytest.mark.parametrize("tag", list(CASES))
def test_dshb_step_matches_reference(worlds, refs, tag, shape):
    check_step(worlds, refs, CASES, tag, shape)


def check_step(worlds: dict, refs: dict, cases: dict, tag: str,
               shape: tuple) -> None:
    """One case's metrics, stack Gram and parameters on every rank of a
    world against the reference's steps."""
    ref, tol = refs[tag], 1e-4 if "gm" in tag.split("+") else 1e-5
    for got in worlds[shape]:
        assert got[tag]["backend"] == cases[tag][1]["backend"]
        assert got[tag]["mesh_devices"] == shape[0] * shape[1]
        for g, w in zip(got[tag]["rows"], ref["rows"]):
            assert g["loss"] == pytest.approx(w["loss"], rel=1e-5)
            assert g["direction_norm"] == pytest.approx(w["direction_norm"],
                                                        rel=1e-4)
            assert g["kappa_hat"] == pytest.approx(w["kappa_hat"], rel=1e-4,
                                                   abs=1e-4)
        for g, w in zip(got[tag]["grams"], ref["grams"]):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()))
        want = jax.tree_util.tree_leaves(ref["params"])
        scale = max(float(np.abs(w).max()) for w in want)
        assert len(got[tag]["params"]) == len(want)
        for a, b in zip(got[tag]["params"], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                       err_msg=tag)


def test_data_ranks_hold_equal_shards(worlds):
    """On (2, 2) the two data ranks of each model index hold equal
    parameter shards bit for bit; the model ranks' shards differ."""
    ranks = worlds[(2, 2)]
    for tag in CASES:
        for r, q in ((0, 2), (1, 3)):
            for a, b in zip(ranks[r][tag]["shards"], ranks[q][tag]["shards"]):
                np.testing.assert_array_equal(a, b, err_msg=tag)
        assert any(a.shape == b.shape and not np.array_equal(a, b)
                   for a, b in zip(ranks[0][tag]["shards"],
                                   ranks[1][tag]["shards"]))
