"""The sketch Gram (``AggregatorSpec.sketch_dim``) on a model mesh, on
gloo worlds of (1, 2) and (2, 2) CPU processes.

The reference's sketch cuts each WHOLE padded leaf, flattened, into
chunks of ``sketch_dim`` with one sign a chunk.  A rank holds its model
shard's columns of the stack (``kernels.shard.ModelColumns``: a split
leaf's shard is strided in its whole leaf, runs of its split block
times every later dimension, one in every model rank's), cut further
over the data axis, so it folds each element at its whole-leaf index
(``kernels.dispatch.sketch_fold_model``) and the partial sketches are
all-reduced over both axes.

* The sketch Gram of a seeded stack shaped like the padded smollm (3
  heads / 1 kv head, padded to 4; leaves split on their first, middle and
  last dimension, and replicated norms) against the reference's
  ``tree_sketch_gram`` of the whole stack under the same key, its signs
  fed (``signs=``), within 1e-5 of the largest entry; ``sketch_dim`` 48
  divides none of the runs, 64 divides some.  Folded one run at a time
  (``chunk=1``) it gives the same Gram within fp32 rounding.
* D-SHB with ``sketch_dim`` 48, NNM + CWTM, on those worlds against the
  reference's single-device step fed the same signs, at
  tests/test_torch_model_mesh_trainer.py's tolerances with its Gram
  check; the aggregate records ``sketch_gram`` and no K1.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.robust import tree_sketch_gram as j_sketch_gram
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.types import AggregatorSpec as TSpec
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.training import TrainerConfig as TCfg
from repro_torch.training import trainer as ttrainer
from repro_torch.tree import tree_leaves

import test_torch_model_mesh_trainer as trainer_cases

CPU = torch.device("cpu")
N = 6
SKETCH_DIMS = (48, 64)
WORLD_LIMIT = 240


def _cfg():
    return t_reduced("smollm-360m").replace(num_heads=3, num_kv_heads=1)


def _whole_shapes() -> list:
    cfg = _cfg()
    with tcommon.mesh_axes_scope(tmesh.mesh_axes_for(cfg, model_par=2)):
        return [d.shape for d in tree_leaves(t_build(cfg).param_descs())]


def _stack() -> list:
    """A seeded (N, ...) stack of every whole padded leaf, rows shifted
    apart so their distances differ."""
    rng = np.random.default_rng(4)
    shift = rng.standard_normal((N,)).astype(np.float32)
    return [(rng.standard_normal((N,) + shape).astype(np.float32)
             + shift.reshape((N,) + (1,) * len(shape)))
            for shape in _whole_shapes()]


def _block(stack: list, descs: list, axes, mesh, mc, local) -> torch.Tensor:
    """This rank's block: its model shard's columns of the stack (each
    leaf's shard, or its column block of a replicated leaf), then its
    columns [local) of them."""
    cols = []
    for x, d, (a, b) in zip(stack, descs, mc.pieces):
        shard = x[(slice(None),) + tcommon.shard_slice(d, axes, mesh)]
        cols.append(shard.reshape(N, -1)[:, a:b])
    whole = torch.from_numpy(np.ascontiguousarray(np.concatenate(cols, 1)))
    return whole[:, local[0]:local[1]].contiguous()


def _sketch_rank(rank: int, world: int, stack: list, signs: dict) -> dict:
    torch.set_num_threads(1)
    mesh = tmesh.make_debug_mesh(world // 2, 2)
    cfg = _cfg()
    axes = tmesh.mesh_axes_for(cfg, model_par=2)
    out = {}
    with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
        model = t_build(cfg)
        descs = tree_leaves(model.param_descs())
        params = model.init(0, CPU)
        tcfg = TCfg(agg=TSpec(f=1, rule="cwtm", pre="nnm",
                              backend="cuda_sharded", sketch_dim=48),
                    worker_axes=("data",),
                    param_specs=tcommon.leaf_specs(model.param_descs()))
        mc = ttrainer.model_columns(tcfg, params)
        sh = ttrainer.trainer_shard(tcfg, CPU, mc)
        local = (sh.span[0] - mc.offset, sh.span[1] - mc.offset)
        block = _block(stack, descs, axes, mesh, mc, local)
        out["whole"] = list(mc.whole)
        for s, sg in signs.items():
            sg = [torch.from_numpy(x) for x in sg]
            kdispatch.open_record(requested="cuda_sharded",
                                  backend="cuda_sharded", rule="cwtm",
                                  pre="nnm", mesh_devices=mesh.devices)
            g = kdispatch.dispatch_sketch_gram(block, None, s, sg,
                                               backend="cuda_sharded", sh=sh,
                                               d=mc.total)
            sk = kdispatch.sketch_fold_model(block[None], s, sg, mc=mc,
                                             local=local, chunk=1)
            sk = mesh.all_reduce(sk, sh.axis)
            out[s] = (g.numpy(), (sk @ sk.mT)[0].numpy())
    return out


@pytest.fixture(scope="module")
def sketch_worlds():
    stack = _stack()
    key = jax.random.PRNGKey(5)
    want, signs = {}, {}
    for s in SKETCH_DIMS:
        want[s] = np.asarray(j_sketch_gram(stack, s, key))
        signs[s] = trainer_cases.ref_signs(key, [x[0] for x in stack], s)
    worlds = {(w // 2, 2): tmesh.spawn_world(_sketch_rank, w, (stack, signs),
                                             limit=WORLD_LIMIT)
              for w in (2, 4)}
    return want, worlds, [x[0].size for x in stack]


@pytest.mark.parametrize("s", SKETCH_DIMS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_sketch_gram_of_model_shards_equals_reference(sketch_worlds, shape,
                                                      s):
    want, worlds, sizes = sketch_worlds
    scale = float(np.abs(want[s]).max())
    for got in worlds[shape]:
        assert got["whole"] == sizes
        g, g_runs = got[s]
        np.testing.assert_allclose(g, want[s], rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(g_runs, g, rtol=0, atol=1e-6 * scale)


def test_runs_cover_split_leaves_on_every_axis():
    """The case splits leaves on their first (embedding), middle (wo) and
    last (wq) dimension, and keeps norms replicated: every run kind."""
    cfg = _cfg()
    axes = tmesh.mesh_axes_for(cfg, model_par=2)
    with tcommon.mesh_axes_scope(axes):
        descs = tree_leaves(t_build(cfg).param_descs())
        dims = {tcommon.leaf_spec(d).index("model") - len(d.shape)
                if "model" in tcommon.leaf_spec(d) else None for d in descs}
    assert {-2, -1, None} <= dims and any(
        "model" in tcommon.leaf_spec(d, axes)
        and tcommon.leaf_spec(d, axes).index("model") == 0 for d in descs)


CASES = {"smollm sketch nnm+cwtm": (
    "smollm", dict(rule="cwtm", pre="nnm", backend="cuda_sharded",
                   sketch_dim=48), False)}


@pytest.fixture(scope="module")
def run():
    return trainer_cases.run_cases(CASES)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=str)
def test_dshb_with_sketch_matches_reference(run, shape):
    refs, worlds = run
    tag = next(iter(CASES))
    assert refs[tag]["signs"]
    trainer_cases.check_step(worlds, refs, CASES, tag, shape)
    for got in worlds[shape]:
        assert "sketch_gram" in got[tag]["decisions"]
        assert "gram" not in got[tag]["decisions"]
