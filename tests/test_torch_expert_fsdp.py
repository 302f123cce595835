"""Expert FSDP (``MeshAxes.expert_fsdp``) on a model mesh: the MoE expert
tables split over the data axis as well as the model axis (ZeRO-3
style), on a (2, 2) gloo world of CPU processes, held to the
reference's padded model on one device (a one-device mesh of ``Auto``
axes; tests/test_torch_model_mesh.py).

* the specs: every arch's ``leaf_spec`` under ``expert_fsdp`` (and
  ``seq_par``) at full size equals the reference's ``PartitionSpec``,
  model axis 16, one and two pods;
* reduced arctic with 4 experts (``shard_expert``: the experts over the
  model axis, ``ff_inner`` over the data axis) and with 3 experts (the
  experts whole, ``ff_inner`` over the model axis, ``expert_embed`` over
  the data axis): ``params_to_shards`` / ``params_from_shards`` round
  trip bit for bit, each table a quarter a rank;
* one D-SHB step (NNM + CWTM, ALIE, the tables under ``fsdp_keys``) at n
  = 8 and, for 4 experts, n = 7, where one data rank has no worker in
  the last round and joins the tables' collectives with a zero pass:
  loss 1e-5 relative, direction_norm 1e-4, parameters within 1e-5 of the
  tree's largest magnitude.  A table's gradient summed twice over the
  data ranks (the reduce-scatter, then the trainer's all-reduce) would
  double its direction and show in both;
* ``train_loop`` killed after its first snapshot and resumed ends equal
  bit for bit to the uninterrupted run on every rank;
* ``decode_step`` (4 steps, batch 4 over the data axis) against the
  reference's decode, logits within 1e-5 of their largest magnitude;
* the trainer refuses data-split tables outside ``fsdp_keys``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get
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
from repro_torch.configs import get_config as t_get
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
F, LR, B, DECODE_STEPS = 2, 0.05, 4, 4
SPEC = dict(rule="cwtm", pre="nnm")
#: tag: (config changes, workers)
CASES = {"arctic": ({}, 8), "arctic-ff": (dict(num_experts=3), 8),
         "arctic-n7": ({}, 7)}
LIMIT = 300


def j_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _batches(vocab: int, n: int) -> list:
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        s = rng.integers(0, vocab, (n, 2, 17)).astype(np.int32)
        out.append({"tokens": s[..., :-1], "labels": s[..., 1:]})
    return out


def _reference(tag: str) -> dict:
    """The reference's padded init, one D-SHB step under ``fsdp_keys``
    and (n = 8 cases) a few decode steps from a zero cache."""
    kw, n = CASES[tag]
    jcfg = j_reduced("arctic-480b").replace(**kw)
    cfg = JCfg(algorithm="dshb", beta=0.9,
               agg=JSpec(f=F, backend="xla", **SPEC),
               byz=JByz(f=F, attack="alie", eta=8.0), fsdp_keys=FSDP_KEYS)
    opt = j_sgd(clip=2.0)
    batches = _batches(jcfg.vocab_size, n)
    tokens = np.random.default_rng(7).integers(
        0, jcfg.vocab_size, (B, DECODE_STEPS)).astype(np.int32)
    with jmesh.use_mesh(j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2)):
        model = j_build(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        step = jax.jit(j_build_step(model.loss, opt, cfg, j_constant(LR)))
        state, m = step(j_init_state(params, opt, n, cfg), batches[0],
                        jax.random.PRNGKey(0))
        logits, cache = [], model.init_cache(B, 16)
        for t in range(DECODE_STEPS):
            lg, cache = model.decode_step(params, cache,
                                          jnp.asarray(tokens[:, t:t + 1]),
                                          jnp.int32(t))
            logits.append(np.asarray(lg))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"init": as_np(params), "params": as_np(state["params"]),
            "loss": float(m["loss"]),
            "direction_norm": float(m["direction_norm"]),
            "batches": batches, "tokens": tokens, "logits": logits}


def _setup(tag: str):
    kw, n = CASES[tag]
    cfg = t_reduced("arctic-480b").replace(**kw)
    axes = dataclasses.replace(tmesh.mesh_axes_for(cfg, model_par=2),
                               expert_fsdp=True)
    model = t_build(cfg)
    with tcommon.mesh_axes_scope(axes):
        descs = model.param_descs()
        specs = tcommon.leaf_specs(descs)
    tcfg = TCfg(beta=0.9, agg=TSpec(f=F, backend="cuda_sharded", **SPEC),
                byz=TByz(f=F, attack="alie", eta=8.0), worker_axes=("data",),
                param_specs=specs, fsdp_keys=FSDP_KEYS)
    return model, axes, descs, tcfg, n


def _step_case(tag: str, ref: dict, mesh) -> dict:
    model, axes, descs, tcfg, n = _setup(tag)
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        shards = params_to_shards(ref["init"], descs, axes, mesh)
        back = params_from_shards(shards, descs, axes, mesh)
        same = all(np.array_equal(a, np.asarray(b)) for a, b in zip(
            tree_leaves(back), jax.tree_util.tree_leaves(ref["init"])))
        opt = t_sgd(clip=2.0)
        step = t_build_step(model.loss, opt, tcfg, t_constant(LR))
        state = t_init_state(shards, opt, n, tcfg)
        state, m = step(state, to_device(ref["batches"][0], CPU),
                        perm=torch.arange(n))
        whole = params_from_shards(state["params"], descs, axes, mesh)
        moe = shards["blocks"]["moe"]
        out = {"roundtrip": same, "loss": float(m["loss"]),
               "direction_norm": float(m["direction_norm"]),
               "params": tree_leaves(whole),
               "local": {k: tuple(moe[k].shape) for k in ("wi", "wo")}}
        if n == 8:
            lo, hi = tcommon.batch_block(B)
            tokens = torch.from_numpy(ref["tokens"][lo:hi])
            cache = model.init_cache(B, 16, CPU)
            out["logits"] = []
            for t in range(DECODE_STEPS):
                lg, cache = model.decode_step(shards, cache,
                                              tokens[:, t:t + 1], t, batch=B,
                                              max_seq=16)
                out["logits"].append(tcommon.gather_batch(lg, B).numpy())
    return out


def _resume_case(mesh, ref: dict, tmp: str) -> dict:
    model, axes, descs, tcfg, _ = _setup("arctic")
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
        # The tables outside fsdp_keys: refused.
        robust = dataclasses.replace(tcfg, fsdp_keys=())
        try:
            t_build_step(model.loss, t_sgd(), robust, t_constant(LR))(
                t_init_state(init, t_sgd(), 8, robust),
                to_device(ref["batches"][0], CPU))
            out["refused"] = "ran"
        except ValueError as e:
            out["refused"] = str(e)
    return out


def _world(rank: int, world: int, refs: dict, tmp: str) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(2, 2)
    out = {tag: _step_case(tag, refs[tag], mesh) for tag in CASES}
    out["resume"] = _resume_case(mesh, refs["arctic"], tmp)
    return out


@pytest.fixture(scope="module")
def refs():
    return {tag: _reference(tag) for tag in CASES}


@pytest.fixture(scope="module")
def ranks(refs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("expert_fsdp_ckpt"))
    return tmesh.spawn_world(_world, 4, (refs, tmp), limit=LIMIT)


FLAGS = list(itertools.product((False, True), repeat=2))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_under_fsdp_and_seq_par(arch, multi_pod):
    """Full size, model axis 16: every leaf's spec under each of
    expert_fsdp / seq_par on and off equals the reference's."""
    tcfg, jcfg = t_get(arch), j_get(arch)
    for fsdp, sp in FLAGS:
        kw = dict(expert_fsdp=fsdp, seq_par=sp)
        taxes = dataclasses.replace(
            tmesh.mesh_axes_for(tcfg, multi_pod=multi_pod), **kw)
        jaxes = dataclasses.replace(
            jmesh.mesh_axes_for(jcfg, multi_pod=multi_pod), **kw)
        with tcommon.mesh_axes_scope(taxes):
            tspecs = list(tcommon.leaf_specs(t_build(tcfg).param_descs()))
        with jcommon.mesh_axes_scope(jaxes):
            jspecs = jax.tree_util.tree_leaves(
                jcommon.partition_specs(j_build(jcfg).param_descs()),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert tspecs == [tuple(s) for s in jspecs], (arch, kw)


@pytest.mark.parametrize("tag", list(CASES))
def test_roundtrip_and_quarter_shards(ranks, tag):
    kw, _ = CASES[tag]
    e = kw.get("num_experts", 4)
    cfg = t_reduced("arctic-480b")
    d, ff = cfg.d_model, cfg.d_ff
    for r in ranks:
        got = r[tag]
        assert got["roundtrip"]
        if e == 4:      # experts over model, ff_inner over data
            assert got["local"] == {"wi": (2, 2, d, ff // 2),
                                    "wo": (2, 2, ff // 2, d)}
        else:           # ff_inner over model, expert_embed over data
            assert got["local"] == {"wi": (2, e, d // 2, ff // 2),
                                    "wo": (2, e, ff // 2, d // 2)}


@pytest.mark.parametrize("tag", list(CASES))
def test_dshb_step_matches_reference(ranks, refs, tag):
    ref = refs[tag]
    want = jax.tree_util.tree_leaves(ref["params"])
    scale = max(float(np.abs(w).max()) for w in want)
    for r in ranks:
        got = r[tag]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert got["direction_norm"] == pytest.approx(ref["direction_norm"],
                                                      rel=1e-4)
        assert len(got["params"]) == len(want)
        for a, b in zip(got["params"], want):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("tag", ["arctic", "arctic-ff"])
def test_decode_matches_reference(ranks, refs, tag):
    for r in ranks:
        for a, b in zip(r[tag]["logits"], refs[tag]["logits"]):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def test_resume_bit_for_bit_and_refusal(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["killed"] and res["resumed_from"] == 1
        assert len(res["full"]) == len(res["resumed"])
        for a, b in zip(res["full"], res["resumed"]):
            np.testing.assert_array_equal(a, b)
        assert "fsdp_keys" in res["refused"], res["refused"]
