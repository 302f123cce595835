"""The NCCL world with one card a rank, as far as a host without a card
can show it (``launch.mesh``; ``chip_smoke.py --nccl`` runs it on four
cards):

* ``rank_device`` under each backend: a rank's own card under nccl, the
  shared card or the CPU under gloo, the CPU under the dry run's fake
  world;
* ``spawn_world(backend="nccl")`` (and ``chip_smoke.KeptWorld``) with more
  ranks than cards raises before anything is spawned, naming both counts,
  and never falls back to gloo;
* ``Transport("nccl")`` refuses a host operand, naming the op and the
  axis, before any ``torch.distributed`` call;
* the resume check (``trainer._check_same_start``) makes its tensor on
  the mesh's device, and in a gloo CPU world of 2 passes equal starts and
  refuses unequal ones; a mesh over another backend than the world's;
* the plain trimmed mean in column blocks equals it whole bit for bit
  (the dry run reckons a rank's peak with it);
* the dry run's peak for each of ``chip_smoke.py``'s four-card cases at
  the depth and batch the script uses, on a fake (2, 2) world: the cases
  it runs stay under its CARD_GB a rank.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.kernels.mixtrim import ops as mixops
from repro_torch.launch import mesh as tmesh
from repro_torch.resilience.faults import CheckpointError
from repro_torch.training import trainer

ROOT = Path(__file__).resolve().parents[1]
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rank", [0, 3])
def test_rank_device_per_backend(rank, monkeypatch):
    assert tmesh.rank_device(rank, "nccl") == torch.device("cuda", rank)
    assert tmesh.rank_device(rank, "fake") == torch.device("cpu")
    # Ranks sharing the host: the CPU without a card, card 0 with one.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.rank_device(rank, "gloo") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tmesh.rank_device(rank, "gloo") == torch.device("cuda", 0)


def test_rank_device_refuses_unknown_backends():
    with pytest.raises(ValueError, match="unknown process-group backend"):
        tmesh.rank_device(0, "mpi")


def _no_spawn(*a, **k):
    raise AssertionError("a process was started")


@pytest.mark.parametrize("cards", [0, 1, 3])
def test_spawn_world_nccl_needs_a_card_a_rank(cards, monkeypatch):
    import torch.multiprocessing as mp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mp, "get_context", _no_spawn)
    monkeypatch.setattr(dist, "init_process_group", _no_spawn)
    world = cards + 1
    with pytest.raises(ValueError) as e:
        tmesh.spawn_world(_no_spawn, world, backend="nccl")
    msg = str(e.value)
    assert f"a world of {world} nccl ranks needs {world} cards" in msg
    assert f"this host has {cards}" in msg
    assert not dist.is_initialized()


def test_kept_world_nccl_needs_a_card_a_rank(monkeypatch):
    import torch.multiprocessing as mp
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mp, "get_context", _no_spawn)
    with pytest.raises(ValueError, match="world of 4 nccl ranks .* has 2"):
        cs.KeptWorld(4, "nccl")
    with pytest.raises(ValueError, match="unknown process-group backend"):
        tmesh.spawn_world(_no_spawn, 2, backend="mpi")


@pytest.mark.parametrize("op", OPS)
def test_nccl_transport_refuses_a_host_operand(op, monkeypatch):
    for name in ("all_reduce", "all_gather_into_tensor",
                 "reduce_scatter_tensor", "all_to_all_single"):
        monkeypatch.setattr(dist, name, _no_spawn)
    tr = tmesh.Transport("nccl")
    t = torch.ones((4, 3))
    call = {"all_reduce": lambda: tr.all_reduce(t, None, "data"),
            "all_gather": lambda: tr.all_gather(t, None, "data", 2),
            "reduce_scatter": lambda: tr.reduce_scatter(t, None, "data", 2),
            "all_to_all": lambda: tr.all_to_all(t, None, "data", 4)}[op]
    with pytest.raises(ValueError) as e:
        call()
    assert str(e.value).startswith(f"{op} over axis 'data'")
    assert "cpu" in str(e.value)


def test_gloo_transport_takes_a_host_operand(monkeypatch):
    seen = []
    monkeypatch.setattr(dist, "all_reduce",
                        lambda t, op=None, group=None: seen.append(t.device))
    tmesh.Transport("gloo").all_reduce(torch.ones(3), None, "data",
                                       record=False)
    assert seen == [torch.device("cpu")]


class _Stop(Exception):
    pass


def test_check_same_start_uses_the_mesh_device():
    seen = []

    class Stub:
        device = torch.device("meta")

        def all_reduce_world(self, t, op):
            seen.append((t.device, t.dtype, op))
            raise _Stop

    with pytest.raises(_Stop):
        trainer._check_same_start(Stub(), 4, "d")
    assert seen == [(torch.device("meta"), torch.float64, "max")]


def _start_rank(rank: int, world: int) -> dict:
    mesh = tmesh.make_mesh((world,), ("data",))
    other = tmesh.make_mesh((world,), ("data",), "gloo")
    out = {"device": mesh.device == tmesh.rank_device(rank, "gloo"),
           "same": other is mesh, "backend": mesh.transport.backend}
    trainer._check_same_start(mesh, 5, "d")
    try:
        trainer._check_same_start(mesh, 5 + rank, "d")
        out["refused"] = False
    except CheckpointError:
        out["refused"] = True
    return out


def test_check_same_start_in_a_gloo_world():
    got = tmesh.spawn_world(_start_rank, 2, limit=120.0)
    assert got == [{"device": True, "same": True, "backend": "gloo",
                    "refused": True}] * 2


@pytest.mark.parametrize("mode", ["trim", "med"])
@pytest.mark.parametrize("mix", [False, True])
def test_plain_mixtrim_in_column_blocks_is_the_whole(mode, mix, monkeypatch):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 1000)).astype(np.float32))
    x[2, 17] = float("nan")
    x[5, 400] = float("inf")
    m = torch.from_numpy(rng.random((9, 9)).astype(np.float32)) if mix \
        else None
    whole = mixops.mixtrim_ref(x, m, 2, mode)
    monkeypatch.setattr(mixops, "PLAIN_COLS", 96)
    blocks = mixops.mixtrim_ref(x, m, 2, mode)
    assert torch.equal(torch.isnan(whole), torch.isnan(blocks))
    assert torch.equal(torch.nan_to_num(whole), torch.nan_to_num(blocks))


def test_dry_run_peaks_of_the_four_card_cases():
    """``chip_smoke.dry_nccl`` (its ``--25b-dry``) at the script's depths
    and batches: minitron-8b's case under CARD_GB a rank (the script runs
    it), and the script's gate runs exactly the cases under it."""
    cs = _chip_smoke()
    reck = cs.dry_nccl()
    assert set(reck) == {run[0] for run in cs.NCCL_RUNS}
    for name, rec in reck.items():
        peak = rec["peak_bytes"]
        assert peak > 0 and rec["collectives"]
        assert cs.fits_card(peak) == (peak / 1e9 < cs.CARD_GB)
    assert cs.fits_card(reck["25b-i"]["peak_bytes"])
    calls = reck["25b-i"]["collectives"]
    assert calls["all_to_all@data"]["calls"] == 4     # n = 8 over 2 data ranks
