"""Import hygiene of the port: ``repro_torch`` imports neither ``jax`` nor
the reference package, and its entry points never fall back to the CPU
without being asked."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import sys
import torch
torch.set_num_threads(1)
import repro_torch
import repro_torch.core.bucketing
import repro_torch.kernels.bucketgram
import repro_torch.fed, repro_torch.fleet, repro_torch.obs, repro_torch.rounds
import repro_torch.fed.server, repro_torch.fed.poison, repro_torch.rounds.engine
import repro_torch.robustness.guard
import repro_torch.checkpoint, repro_torch.checkpoint.npz
import repro_torch.resilience, repro_torch.resilience.store
import repro_torch.resilience.experiment, repro_torch.resilience.faults
import repro_torch.serving, repro_torch.serving.engine
import repro_torch.robustness.breakdown
import repro_torch.models.moe, repro_torch.launch.launch_config
import repro_torch.models.encdec, repro_torch.models.linear_scan
import repro_torch.models.rwkv, repro_torch.models.ssm
import repro_torch.models.attention, repro_torch.models.lm
import repro_torch.launch.roofline, repro_torch.launch.serve
import repro_torch.launch.mesh, repro_torch.kernels.shard
from repro_torch.core import apply_attack, nnm_direct, theory
from repro_torch.launch import breakdown, grid, scenarios, serve, service, train
out = train.main(["--device", "cpu", "--steps", "1", "--workers", "4",
                  "--byz", "1", "--seq", "8", "--batch", "1"])
assert out["history"]["loss"], out
out = train.main(["--device", "cpu", "--steps", "1", "--workers", "4",
                  "--byz", "1", "--seq", "8", "--batch", "1",
                  "--attack", "foe_opt", "--sketch-dim", "64"])
assert out["history"]["loss"], out
assert "sketch_gram" in [d.primitive for d in out["dispatch"].decisions]
for arch in ("mixtral-8x22b", "internvl2-2b", "rwkv6-3b", "zamba2-2.7b",
             "whisper-base"):
    out = train.main(["--device", "cpu", "--steps", "1", "--workers", "4",
                      "--byz", "1", "--seq", "16", "--batch", "1",
                      "--arch", arch])
    assert out["history"]["loss"], out
for arch in ("qwen2-7b", "rwkv6-3b", "zamba2-2.7b", "whisper-base"):
    out = serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                      "--prompt", "3", "--max-new", "3"])
    assert out["tokens"].shape == (2, 3), out
out = breakdown.main(["--device", "cpu", "--n", "4", "--rounds", "1"])
assert out["n_buckets"] == 10, out
out = train.main(["--device", "cpu", "--steps", "1", "--workers", "4",
                  "--byz", "1", "--seq", "8", "--batch", "1",
                  "--agg", "bucketing+cwtm"])
assert out["history"]["loss"], out
out = grid.main(["--device", "cpu", "--rounds", "1"])
assert out["runner"].n_buckets == 7, out
outs = scenarios.main(["--device", "cpu", "--rounds", "1",
                       "--scenario", "faulty_nan_quarantine"])
assert outs["faulty_nan_quarantine"]["history"].rounds == 1, outs
out = service.main(["--device", "cpu", "--seeds", "1", "--rounds", "1",
                    "--scenario", "poison_labelflip"])
assert len(out["results"]) == 1, out
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
print("CLEAN")
"""


def test_port_runs_a_cpu_step_without_importing_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "CLEAN" in res.stdout


def test_no_source_file_names_jax_or_repro():
    """Every module of the port (the bucketing, bucketgram and fleet
    modules included) and chip_smoke.py; nor ``benchmarks``."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)",
                     re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PKG / "core" / "bucketing.py" in files
    assert PKG / "kernels" / "bucketgram" / "ops.py" in files
    for mod in ("fleet/lanes.py", "fleet/runner.py", "fed/clients.py",
                "fed/scenarios.py", "rounds/plan.py", "obs/runtime.py",
                "launch/grid.py", "fed/server.py", "fed/poison.py",
                "robustness/guard.py", "rounds/engine.py",
                "launch/scenarios.py", "checkpoint/npz.py",
                "resilience/store.py", "resilience/experiment.py",
                "resilience/faults.py", "training/trainer.py",
                "serving/__init__.py", "serving/engine.py",
                "launch/service.py", "robustness/breakdown.py",
                "launch/breakdown.py", "core/theory.py", "core/nnm.py",
                "models/moe.py", "launch/launch_config.py",
                "models/attention.py", "models/lm.py", "models/rwkv.py",
                "models/ssm.py", "models/encdec.py", "launch/serve.py",
                "launch/roofline.py", "launch/mesh.py", "kernels/shard.py"):
        assert PKG / mod in files, mod
    offenders = [str(p.relative_to(ROOT)) for p in files
                 if pat.search(p.read_text())]
    assert not offenders, offenders


def test_entry_point_without_cpu_request_raises_without_gpu(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.fleet import FleetRunner, ScenarioSpec
    from repro_torch.launch import grid, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no GPU"):
        grid.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no GPU"):
        FleetRunner([ScenarioSpec("iid_baseline", rounds=1)])
    from repro_torch.fed import (
        FedConfig, FedServer, build_scenario, get_scenario, run_scenario,
    )
    from repro_torch.fed.scenarios import _mlp_loss
    from repro_torch.launch import scenarios
    from repro_torch.optim import sgd
    from repro_torch.optim.schedules import constant
    with pytest.raises(RuntimeError, match="no GPU"):
        FedServer(_mlp_loss, sgd(), FedConfig(n_clients=4,
                                              clients_per_round=4),
                  constant(0.1))
    with pytest.raises(RuntimeError, match="no GPU"):
        build_scenario(get_scenario("iid_baseline"))
    with pytest.raises(RuntimeError, match="no GPU"):
        run_scenario("iid_baseline", rounds=1)
    with pytest.raises(RuntimeError, match="no GPU"):
        scenarios.main(["--rounds", "1"])
    from repro_torch.launch import service
    from repro_torch.serving import FleetService
    with pytest.raises(RuntimeError, match="no GPU"):
        FleetService()
    with pytest.raises(RuntimeError, match="no GPU"):
        service.main(["--rounds", "1"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no GPU"):
        serve.main(["--max-new", "2"])
    from repro_torch.launch import breakdown
    from repro_torch.robustness import run_breakdown
    with pytest.raises(RuntimeError, match="no GPU"):
        breakdown.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="no GPU"):
        run_breakdown(n_clients=4, rounds=1)
    assert resolve_device("cpu").type == "cpu"


def test_checkpoint_flag_names_its_roadmap_item(tmp_path):
    """``--checkpoint PATH`` (ROADMAP queue 1, item 11, now ported) saves
    the final params; ``load_checkpoint`` reads them back bit for bit, with
    the step."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map
    path = str(tmp_path / "params.npz")
    out = train.main(["--device", "cpu", "--steps", "2", "--workers", "4",
                      "--byz", "1", "--seq", "8", "--batch", "1",
                      "--checkpoint", path])
    params = out["state"]["params"]
    like = tree_map(torch.zeros_like, params)
    loaded, step = load_checkpoint(path, like)
    assert step == 2
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
