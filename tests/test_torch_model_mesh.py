"""The model-parallel mesh's single-process half against the reference, on
the CPU: ``pad_heads`` / ``mesh_axes_for`` for all ten configs,
``MeshAxes.logical_to_spec`` for every logical axis and flag, all ten
archs' full-size descs (meta tensors, no allocation) in shape, dtype and
spec, the cache descs' axes, and every reduced arch's padded forward run
whole on one device.

The reference runs its padded models on a one-device mesh of ``Auto``
axes, ``jax.sharding.Mesh(devices.reshape(1, 1), ("data", "model"))``,
under ``use_mesh`` and ``mesh_axes_scope``: ``jax.make_mesh`` gives
``Explicit`` axes on this jax, under which the reference's own sharding
constraints assert.  The reduced configs are cut to 3 heads (1 kv head
where the arch groups its kv heads, 3 where it does not) and 3 SSM heads,
so that padding to a model axis of 2 changes every padded count.
Tolerance of the forward: 1e-5 of the largest logit (fp32; both sum the
same products in another order).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.launch import mesh as jmesh
from repro.models import build_model as j_build
from repro.models import common as jcommon
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.tree import tree_leaves, tree_paths

torch.set_num_threads(2)
CPU = torch.device("cpu")
PARS = (1, 2, 4, 8, 16)
LOGICAL = ("embed", "heads", "kv", "ff", "vocab", "expert", "ff_inner",
           "expert_embed", "ff_act", "batch", "seq_shard", "seq_model",
           "seq_both", "layers", None)
FLAGS = ("shard_kv", "shard_expert", "expert_fsdp", "workers_on_data")


def j_mesh():
    """The reference's one-device mesh of Auto axes."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def padded(cfg):
    """A reduced config whose head counts pad at a model axis of 2."""
    kv = 1 if cfg.num_kv_heads < cfg.num_heads else 3
    kw = dict(num_heads=3, num_kv_heads=kv)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm_heads"] = 3
    return cfg.replace(**kw)


def _axes_fields(a) -> dict:
    return {k: getattr(a, k) for k in ("data", "model", "model_par",
                                       "shard_kv", "shard_expert",
                                       "expert_fsdp", "seq_par",
                                       "workers_on_data", "pad_kv_to_mesh")}


def test_registry_matches():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_heads_and_mesh_axes_for_equal_reference(arch):
    """Every par x pad_kv: the padded counts, the shard flags and the
    resolved MeshAxes (field by field)."""
    tcfg, jcfg = t_get(arch), j_get(arch)
    for par, pad_kv in itertools.product(PARS, (False, True)):
        got = tcommon.pad_heads(tcfg.num_heads, tcfg.num_kv_heads, par,
                                pad_kv=pad_kv)
        want = jcommon.pad_heads(jcfg.num_heads, jcfg.num_kv_heads, par,
                                 pad_kv=pad_kv)
        assert got == want, (par, pad_kv)
        for multi_pod in (False, True):
            t = tmesh.mesh_axes_for(tcfg, model_par=par, pad_kv=pad_kv,
                                    multi_pod=multi_pod)
            j = jmesh.mesh_axes_for(jcfg, model_par=par, pad_kv=pad_kv,
                                    multi_pod=multi_pod)
            assert _axes_fields(t) == _axes_fields(j), (par, pad_kv)
    assert tmesh.n_workers() == jmesh.n_workers()
    assert tmesh.n_workers(multi_pod=True) == jmesh.n_workers(multi_pod=True)


@pytest.mark.parametrize("data", [("data",), ("pod", "data")])
@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=len(FLAGS))),
                         ids=lambda f: "".join("1" if x else "0" for x in f))
def test_logical_to_spec_equals_reference(flags, data):
    """Every logical axis alone and every pair, under every flag set."""
    kw = dict(zip(FLAGS, flags), data=data, model_par=4)
    t, j = tcommon.MeshAxes(**kw), jcommon.MeshAxes(**kw)
    for axes in list(itertools.product(LOGICAL, repeat=2)) + \
            [(a,) for a in LOGICAL] + [()]:
        assert t.logical_to_spec(axes) == tuple(j.logical_to_spec(axes)), axes


def _j_specs(jmodel):
    descs = jmodel.param_descs()
    specs = jcommon.partition_specs(descs)
    abst = jcommon.abstract(descs)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    return (jax.tree_util.tree_leaves(abst),
            jax.tree_util.tree_leaves(specs, is_leaf=is_spec),
            [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(abst)[0]])


@pytest.mark.parametrize("par", [2, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_descs_equal_reference(arch, par):
    """All ten archs at full size under mesh_axes_for(model_par=par): the
    port's meta tensors and spec tuples against the reference's abstract
    tree and PartitionSpecs, leaf for leaf (the padded shapes included)."""
    tcfg, jcfg = t_get(arch), j_get(arch)
    with tcommon.mesh_axes_scope(tmesh.mesh_axes_for(tcfg, model_par=par)):
        tdescs = t_build(tcfg).param_descs()
        tabs = tree_leaves(tcommon.abstract(tdescs))
        tspecs = list(tcommon.leaf_specs(tdescs))
        tpaths = tree_paths(tdescs)
    with jcommon.mesh_axes_scope(jmesh.mesh_axes_for(jcfg, model_par=par)):
        jabs, jspecs, jpaths = _j_specs(j_build(jcfg))
    assert tpaths == jpaths
    for path, t, j, ts, js in zip(tpaths, tabs, jabs, tspecs, jspecs):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
        assert str(t.dtype).removeprefix("torch.") == np.dtype(j.dtype).name
        assert ts == tuple(js), (path, ts, js)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_descs_equal_reference(arch):
    """The decode caches' shapes and axes at par 16, batch 1 and 4 (the
    layouts decode reads on a model mesh: tests/test_torch_model_mesh_
    decode.py and _serve.py run them)."""
    tcfg, jcfg = t_get(arch), j_get(arch)
    for batch, max_seq in ((1, 32768), (4, 32768), (4, 1024)):
        with tcommon.mesh_axes_scope(tmesh.mesh_axes_for(tcfg, model_par=16)):
            td = t_build(tcfg).cache_descs(batch, max_seq)
            tspecs = tcommon.leaf_specs(td)
            tshapes = [d.shape for d in tree_leaves(td)]
        with jcommon.mesh_axes_scope(jmesh.mesh_axes_for(jcfg, model_par=16)):
            jd = j_build(jcfg).cache_descs(batch, max_seq)
            jl = jax.tree_util.tree_leaves(
                jd, is_leaf=lambda x: isinstance(x, jcommon.ParamDesc))
            jspecs = [tuple(jcommon.MeshAxes.logical_to_spec(
                jcommon.get_mesh_axes(), d.axes)) for d in jl]
        assert tshapes == [d.shape for d in jl], (batch, max_seq)
        assert list(tspecs) == jspecs, (batch, max_seq)


def test_abstract_allocates_nothing():
    """arctic-480b's 477 B parameters as meta tensors."""
    cfg = t_get("arctic-480b")
    with tcommon.mesh_axes_scope(tmesh.mesh_axes_for(cfg, model_par=16)):
        leaves = tree_leaves(tcommon.abstract(t_build(cfg).param_descs()))
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 4e11


def _batch(cfg, s: int = 32) -> dict:
    rng = np.random.default_rng(0)
    text = s - cfg.num_patches if cfg.family == "vlm" else s
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, text))
             .astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (2, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_padded_forward_whole_equals_reference(arch):
    """Every reduced arch with padded heads (model_par 2; minitron with
    pad_kv), run whole on one device from the reference's padded
    parameters: the logits within 1e-5 of the largest."""
    pad_kv = arch == "minitron-8b"
    jcfg, tcfg = padded(j_reduced(arch)), padded(t_reduced(arch))
    batch = _batch(jcfg)
    with jmesh.use_mesh(j_mesh()), jcommon.mesh_axes_scope(
            jmesh.mesh_axes_for(jcfg, model_par=2, pad_kv=pad_kv)):
        jmodel = j_build(jcfg)
        params = jmodel.init(jax.random.PRNGKey(0))
        want = np.asarray(jmodel.forward(
            params, {k: jnp.asarray(v) for k, v in batch.items()}))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    axes = tmesh.mesh_axes_for(tcfg, model_par=2, pad_kv=pad_kv)
    with tcommon.mesh_axes_scope(axes):
        tmodel = t_build(tcfg)
        shapes = [d.shape for d in tree_leaves(tmodel.param_descs())]
        assert shapes == [a.shape for a in jax.tree_util.tree_leaves(
            np_params)]
        got = tmodel.forward(params_from_numpy(np_params, CPU),
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()}).detach().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    # The padding bit: more q heads (or SSM heads) than the config's.
    with tcommon.mesh_axes_scope(axes):
        from repro_torch.models import attention, rwkv, ssm
        if tcfg.family == "ssm":
            assert rwkv._dims(tcfg)[0] == 4
        elif tcfg.family == "hybrid":
            assert ssm._dims(tcfg)[0] == 4
        else:
            assert attention.resolved_heads(tcfg)[0] == 4


def test_shard_slice_and_constrain_without_a_world():
    """No mesh: shard_slice keeps the whole leaf, constrain returns its
    argument, model_mesh is None (the padded model runs whole)."""
    d = tcommon.ParamDesc((4, 8), axes=("embed", "heads"))
    axes = tcommon.MeshAxes(model_par=2)
    assert tcommon.shard_slice(d, axes, None) == (slice(None), slice(None))
    with tcommon.mesh_axes_scope(axes):
        assert tcommon.model_mesh() is None
        x = torch.zeros(2, 3)
        assert tcommon.constrain(x, "batch", "heads", full=(9, 9)) is x
    with pytest.raises(ValueError, match="ranks"):
        tmesh.make_production_mesh()
