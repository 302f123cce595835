"""``repro_torch.launch.dryrun`` and ``launch.perf``: one rank of a mesh
over torch's fake process group, every tensor fake.

* A fake (2, 2) world's rank 0 against rank 0 of a real 4-process gloo
  world running the same train step (``dryrun.train_target`` on the
  reduced config, 4 workers of 2 x 16 tokens dealt over 2 data ranks):
  the collective log (op, axis, calls, bytes) and the FLOP count are
  equal exactly, for smollm
  and for arctic under ``seq_par`` + ``expert_fsdp`` with its tables
  under ``fsdp_keys``;
* the same on the multi-pod mesh: a fake (2, 2, 2) world's rank 0
  against rank 0 of a real 8-process world, 8 workers dealt over
  ("pod", "data");
* smollm-360m train_4k on the 16 x 16 production mesh (full config, full
  depth) returns ``status: "ok"`` with the keys
  ``benchmarks/bench_roofline.py`` reads, and on the 2 x 16 x 16
  multi-pod mesh with 32 workers; decode_32k of smollm-360m and
  whisper-base (fewer q heads than the 16 model ranks: replicated
  attention) returns ``"ok"``;
* whisper long_500k is skipped with the reference's reason, a
  ``gqa_einsum`` variant with the port's;
* ``perf.PAIRS`` is the reference's.  ``repro.launch.dryrun`` and
  ``repro.launch.perf`` set a 512-device ``XLA_FLAGS`` at import, so the
  reference's ``PAIRS`` is read in a subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import launch_config as j_lc
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, perf
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.launch.launch_config import FSDP_KEYS
from repro_torch.models import build_model as t_build
from repro_torch.models import common as tcommon
from repro_torch.training.trainer import to_device

CPU = torch.device("cpu")
TINY = InputShape("tiny", 16, 8, "train")
N = 4
#: tag: (arch, MeshAxes changes, fsdp_keys)
CASES = {"smollm": ("smollm-360m", {}, ()),
         "arctic": ("arctic-480b", dict(seq_par=True, expert_fsdp=True),
                    FSDP_KEYS)}


#: The multi-pod world: (pod 2, data 2, model 2), 8 workers (two rounds
#: over its four data ranks).
POD_SHAPE, N_POD = (2, 2, 2), 8


def _real(rank: int, world: int, shape: tuple = (2, 2), n: int = N) -> dict:
    torch.set_num_threads(1)
    multi_pod = len(shape) == 3
    mesh = tmesh.make_mesh(shape, ("pod", "data", "model") if multi_pod
                           else ("data", "model"))
    out = {}
    for tag, (arch, layout, keys) in CASES.items():
        cfg = t_reduced(arch)
        axes = dataclasses.replace(
            tmesh.mesh_axes_for(cfg, multi_pod=multi_pod, model_par=2),
            workers_on_data=True, **layout)
        with tmesh.use_mesh(mesh), tcommon.mesh_axes_scope(axes):
            model = t_build(cfg)
            meta, _ = specs.train_input_specs(cfg, TINY, axes, n)
            batch = to_device(specs.materialize_batch(cfg, meta), CPU)
            step, state = dryrun.train_target(
                model, axes, n, dryrun.parse_agg("nnm+cwtm"), keys,
                model.init(0, CPU))
            with dryrun.Counters() as c:
                step(state, batch)
        out[tag] = {"flops": c.flops, "collectives": c.collectives}
    return out


@pytest.fixture(scope="module")
def real():
    return tmesh.spawn_world(_real, 4, limit=240)[0]


@pytest.fixture(scope="module")
def real_pod():
    return tmesh.spawn_world(_real, 8, (POD_SHAPE, N_POD), limit=600)[0]


@pytest.mark.parametrize("tag", list(CASES))
def test_fake_world_equals_real_world(real, tag):
    arch, layout, keys = CASES[tag]
    rec = dryrun.dryrun_one(arch, "train_4k", cfg=t_reduced(arch),
                            shape=TINY, mesh_shape=(2, 2), verbose=False,
                            seq_par=layout.get("seq_par", False),
                            expert_fsdp=layout.get("expert_fsdp", False),
                            fsdp_keys=keys, n_workers=N)
    assert rec["status"] == "ok"
    assert rec["collectives"] == real[tag]["collectives"]
    assert rec["cost"]["flops"] == real[tag]["flops"] > 0
    ops = set(rec["collectives"])
    if layout:
        assert {"reduce_scatter@model", "reduce_scatter@data",
                "all_gather@data"} <= ops, ops


@pytest.mark.parametrize("tag", list(CASES))
def test_fake_pod_world_equals_real_world(real_pod, tag):
    """The multi-pod mesh: a fake (2, 2, 2) world's rank 0 against rank 0
    of a real 8-process world, the workers dealt over ("pod", "data")."""
    arch, layout, keys = CASES[tag]
    rec = dryrun.dryrun_one(arch, "train_4k", cfg=t_reduced(arch),
                            shape=TINY, mesh_shape=POD_SHAPE, verbose=False,
                            seq_par=layout.get("seq_par", False),
                            expert_fsdp=layout.get("expert_fsdp", False),
                            fsdp_keys=keys, n_workers=N_POD)
    assert rec["status"] == "ok" and rec["mesh"] == "2x2x2"
    assert rec["collectives"] == real_pod[tag]["collectives"]
    assert rec["cost"]["flops"] == real_pod[tag]["flops"] > 0
    ops = set(rec["collectives"])
    assert {"all_to_all@pod", "all_to_all@data"} <= ops, ops
    if layout:
        assert {"reduce_scatter@model", "reduce_scatter@pod",
                "reduce_scatter@data", "all_gather@pod",
                "all_gather@data"} <= ops, ops


def test_multi_pod_smollm_train():
    """The reference's multi-pod train target: 32 workers dealt over
    ("pod", "data") of the 2 x 16 x 16 mesh."""
    rec = dryrun.dryrun_one("smollm-360m", "train_4k", multi_pod=True,
                            verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "2x16x16"
    assert rec["n_workers"] == 32
    assert rec["links"] == {"pod": "network", "data": "network",
                            "model": "network"}
    colls = rec["collectives"]
    assert colls["all_to_all@pod"]["calls"] == 1
    assert colls["all_to_all@data"]["calls"] == 1


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-base"])
def test_decode_with_fewer_q_heads_than_model_ranks(arch):
    """decode_32k on the 16 x 16 mesh, where smollm-360m's 15 and
    whisper-base's 8 q heads replicate attention: the q / o leaves are
    gathered over the model axis, no row-parallel all-reduce."""
    rec = dryrun.dryrun_one(arch, "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["collectives"]["all_gather@model"]["calls"] > 0


def test_production_mesh_smollm_train():
    rec = dryrun.dryrun_one("smollm-360m", "train_4k", verbose=False)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_workers"] == 16
    for key in ("compute_s", "memory_s", "collective_s", "dominant"):
        assert key in rec["roofline"]
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["links"] == {"data": "network", "model": "network"}
    assert rec["collectives"]["all_to_all@data"]["calls"] == 1


def test_skips():
    rec = dryrun.dryrun_one("whisper-base", "long_500k")
    assert rec["status"] == "skipped"
    assert rec["reason"] == j_lc.skip_reason("whisper-base", "long_500k")
    rec = dryrun.dryrun_one("minitron-8b", "decode_32k", gqa_einsum=True)
    assert rec["status"] == "skipped" and "gqa_einsum" in rec["reason"]


def test_pairs_equal_reference():
    code = ("import json; from repro.launch.perf import PAIRS; "
            "print(json.dumps(PAIRS))")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    want = json.loads(out.strip().splitlines()[-1])
    assert json.loads(json.dumps(perf.PAIRS)) == want
