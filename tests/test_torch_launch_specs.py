"""``repro_torch.launch.specs`` against ``repro.launch.specs``: every
arch's train / prefill / decode input stand-ins (shapes, dtypes) and
specs (the ``PartitionSpec`` entries) on one and two pods, and
``materialize_batch``'s numpy arrays bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get
from repro.configs import reduced_config as j_reduced
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro_torch.configs import get_config as t_get
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.configs.base import SHAPES, InputShape
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs

#: jnp dtypes by name as torch spells them.
DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def _same(tmeta: dict, tspec: dict, jabs: dict, jspec: dict) -> None:
    assert list(tmeta) == list(jabs) and list(tspec) == list(jspec)
    for k, t in tmeta.items():
        j = jabs[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(j.shape), k
        assert t.dtype == DTYPES[jnp.dtype(j.dtype).name], k
        assert tspec[k] == tuple(jspec[k]), (k, tspec[k], jspec[k])


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_reference(arch, multi_pod):
    tcfg, jcfg = t_get(arch), j_get(arch)
    taxes = tmesh.mesh_axes_for(tcfg, multi_pod=multi_pod)
    jaxes = jmesh.mesh_axes_for(jcfg, multi_pod=multi_pod)
    n = tmesh.n_workers(multi_pod=multi_pod)
    assert n == jmesh.n_workers(multi_pod=multi_pod)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        if shape.kind == "train":
            _same(*tspecs.train_input_specs(tcfg, shape, taxes, n),
                  *jspecs.train_input_specs(jcfg, jshape, jaxes, n))
        _same(*tspecs.prefill_input_specs(tcfg, shape, taxes),
              *jspecs.prefill_input_specs(jcfg, jshape, jaxes))
        _same(*tspecs.decode_input_specs(tcfg, shape, taxes),
              *jspecs.decode_input_specs(jcfg, jshape, jaxes))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_materialize_batch_bit_for_bit(arch):
    """The reduced config's train batch (4 workers of 2 rows of 32
    positions; a VLM's 8 patches within them) from seed 3."""
    from repro.configs.base import InputShape as JShape
    tcfg, jcfg = t_reduced(arch), j_reduced(arch)
    tmeta, _ = tspecs.train_input_specs(
        tcfg, InputShape("tiny", 32, 8, "train"), tmesh.mesh_axes_for(tcfg),
        4)
    jabs, _ = jspecs.train_input_specs(
        jcfg, JShape("tiny", 32, 8, "train"), jmesh.mesh_axes_for(jcfg), 4)
    got = tspecs.materialize_batch(tcfg, tmeta, seed=3)
    want = jspecs.materialize_batch(jcfg, jabs, seed=3)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
