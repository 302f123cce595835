"""Preemption-safe resumable runs of the port (repro_torch.resilience):
the reference's tests/test_resilience.py cases on the port.

The contract: a run killed at any segment boundary, or mid-snapshot-write,
and resumed from its checkpoint directory returns bit for bit the
uninterrupted run's results, on every loop owner (``train_loop``,
``fed.run_rounds``, ``FleetRunner``); the resume points (``resumed_from``)
are the reference's.  Corrupt state is a clean refusal with a recovery
hint.  Where the reference round-trips typed PRNG keys, the port
round-trips what numpy cannot hold: bf16 tensors and Python numbers.
The port's carries are updated in place, so a snapshot must be a copy
taken before ``on_segment`` returns (the gated-writer test).
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import AggregatorSpec
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, constant_attack, run_rounds,
)
from repro_torch.fleet import FleetJob, FleetRunner
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.resilience import (
    CarryCheckpointer, CheckpointConfig, CheckpointError, FaultPlan,
    SimulatedPreemption, SnapshotStore, resolve_checkpoint, restore_carry,
)
from repro_torch.rounds import RoundOptions
from repro_torch.training import ByzantineConfig, TrainerConfig, train_loop
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
_N, _M, _D = 10, 6, 5


def _centers(seed, n, d):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32)


def _quad_loss(centers):
    def loss_fn(params, batch):
        c = centers[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"].float() - c) ** 2), {}
    return loss_fn


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


# ---------------------------------------------------------------------------
# Snapshot store: atomicity, retention, fault injection, corrupt refusal.
# ---------------------------------------------------------------------------

def test_store_save_load_roundtrip_including_bf16_and_int_leaves(tmp_path):
    store = SnapshotStore(str(tmp_path), sync=True)
    g = torch.Generator().manual_seed(3)
    bf = torch.randn((4, 3), generator=g).to(torch.bfloat16)
    carry = (torch.arange(3.0), {"w": bf, "step": 7, "lr": 0.1})
    store.save(5, {f"carry/{i:03d}": leaf
                   for i, leaf in enumerate(tree_leaves(carry))}
               | {"metrics/loss": [np.ones(2), torch.zeros(3)]},
               {"signature": {"surface": "t"}, "payload": {"x": 1}})
    store.close()
    assert sorted(os.listdir(tmp_path)) == ["MANIFEST.json",
                                            "snapshot-00000005.npz"]
    round_, arrays, meta = SnapshotStore(str(tmp_path)).load_latest()
    assert round_ == 5
    np.testing.assert_array_equal(arrays["carry/000"], [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(arrays["metrics/loss"], [1, 1, 0, 0, 0])
    assert meta["payload"] == {"x": 1}
    # Leaf order: carry[0], then the dict's sorted keys lr, step, w.
    assert meta["dtypes"] == {"carry/001": "float", "carry/002": "int",
                              "carry/003": "bfloat16"}
    like = (torch.zeros(3), {"w": torch.zeros((4, 3), dtype=torch.bfloat16),
                             "step": 0, "lr": 0.0})
    out = restore_carry(arrays, meta, like)
    _tree_equal(out, carry)
    assert torch.equal(out[1]["w"].view(torch.int16), bf.view(torch.int16))


def test_store_retention_keeps_newest(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=2, sync=True)
    for r in (2, 4, 6, 8):
        store.save(r, {"x": np.asarray([r])}, {"signature": {}})
    store.close()
    snaps = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert snaps == ["snapshot-00000006.npz", "snapshot-00000008.npz"]
    round_, arrays, _ = SnapshotStore(str(tmp_path), keep=2).load_latest()
    assert round_ == 8 and arrays["x"][0] == 8


def test_store_async_double_buffered_writes_all(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=10)       # async path
    for r in range(6):
        store.save(r, {"x": torch.tensor([float(r)])}, {"signature": {}})
    store.close()
    assert store.snapshots_written == 6
    round_, arrays, _ = SnapshotStore(str(tmp_path)).load_latest()
    assert round_ == 5 and arrays["x"][0] == 5.0


def test_snapshot_holds_the_carry_of_its_boundary_not_a_later_one(tmp_path):
    """The in-place trap: the writer is held back until the caller has
    written the next segment into the same momentum tensor; the snapshot
    still holds the values ``on_segment`` saw."""
    gate, entered = threading.Event(), threading.Event()

    class GatedStore(SnapshotStore):
        def _write(self, *args, **kwargs):
            entered.set()
            assert gate.wait(timeout=60), "writer gate never opened"
            return super()._write(*args, **kwargs)

    store = GatedStore(str(tmp_path))                   # async path
    ck = CarryCheckpointer(store, signature={"surface": "t"}, total=4)
    momentum = torch.arange(15.0).reshape(3, 5)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = {"momentum": momentum, "params": params, "step": 2}
    want = (momentum.clone(), params["w"].clone())
    ck.on_segment(0, 2, state, [{"loss": torch.tensor(1.0)},
                                {"loss": torch.tensor(2.0)}])
    assert entered.wait(timeout=60)
    # The next segment: in place, as the trainer's and fed server's fold.
    momentum.mul_(0.5).add_(7.0)
    params["w"].add_(1.0)
    gate.set()
    ck.close()
    round_, arrays, meta = SnapshotStore(str(tmp_path)).load_latest()
    assert round_ == 2
    out = restore_carry(arrays, meta, {"momentum": torch.zeros(3, 5),
                                       "params": {"w": torch.zeros(
                                           4, dtype=torch.bfloat16)},
                                       "step": 0})
    assert torch.equal(out["momentum"], want[0])
    assert torch.equal(out["params"]["w"], want[1])
    assert out["step"] == 2
    np.testing.assert_array_equal(arrays["metrics/loss"], [1.0, 2.0])


def test_async_snapshots_each_hold_their_round_under_thread_switching(
        tmp_path):
    """Stress: 24 async saves, the carry written in place right after each
    one returns, with the interpreter switching threads every microsecond;
    every snapshot file holds the values of its own round."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        store = SnapshotStore(str(tmp_path), keep=100)
        carry = torch.zeros(64, 257)
        for r in range(1, 25):
            carry.fill_(float(r))
            store.save(r, {"carry/000": carry, "step": r},
                       {"signature": {}})
            carry.mul_(-1.0).add_(1000.0)       # the next segment, in place
        store.close()
    finally:
        sys.setswitchinterval(old)
    assert store.snapshots_written == 24
    for r in range(1, 25):
        with np.load(tmp_path / f"snapshot-{r:08d}.npz") as data:
            assert (data["carry/000"] == float(r)).all(), r
            assert int(data["step"]) == r


def test_fault_kill_completes_write_then_raises(tmp_path):
    store = SnapshotStore(str(tmp_path), sync=True,
                          fault_plan=FaultPlan(kill_at=1))
    store.save(3, {"x": np.zeros(1)}, {"signature": {}})
    with pytest.raises(SimulatedPreemption) as ei:
        store.save(6, {"x": np.ones(1)}, {"signature": {}})
    assert ei.value.ordinal == 1 and ei.value.round == 6
    # The kill-ordinal write itself is durable (the kill lands AFTER it).
    round_, _, _ = SnapshotStore(str(tmp_path)).load_latest()
    assert round_ == 6


def test_fault_torn_write_leaves_previous_snapshot_loadable(tmp_path):
    store = SnapshotStore(str(tmp_path), sync=True,
                          fault_plan=FaultPlan(torn_at=1))
    store.save(3, {"x": np.asarray([3.0])}, {"signature": {}})
    with pytest.raises(SimulatedPreemption):
        store.save(6, {"x": np.asarray([6.0])}, {"signature": {}})
    # The half-written snapshot-6 file exists, but the manifest still
    # points at complete snapshot-3: restore never sees the torn file.
    assert "snapshot-00000006.npz" in os.listdir(tmp_path)
    with open(tmp_path / "snapshot-00000006.npz", "rb") as fh, \
            pytest.raises(Exception):
        np.load(fh)["x"]
    round_, arrays, _ = SnapshotStore(str(tmp_path)).load_latest()
    assert round_ == 3 and arrays["x"][0] == 3.0


def test_corrupt_manifest_is_clean_refusal_with_hint(tmp_path):
    store = SnapshotStore(str(tmp_path), sync=True)
    store.save(2, {"x": np.zeros(1)}, {"signature": {}})
    (tmp_path / "MANIFEST.json").write_text("{ not json !")
    with pytest.raises(CheckpointError) as ei:
        SnapshotStore(str(tmp_path)).load_latest()
    assert "corrupt" in str(ei.value)
    assert "snapshot-00000002.npz" in str(ei.value)     # recovery hint


def test_stale_manifest_pointing_at_missing_file_hints_history(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=5, sync=True)
    store.save(2, {"x": np.zeros(1)}, {"signature": {}})
    store.save(4, {"x": np.ones(1)}, {"signature": {}})
    os.unlink(tmp_path / "snapshot-00000004.npz")
    with pytest.raises(CheckpointError) as ei:
        SnapshotStore(str(tmp_path)).load_latest()
    assert "unreadable" in str(ei.value)
    assert "snapshot-00000002.npz" in ei.value.hint


def test_fault_plan_and_config_validation(tmp_path):
    with pytest.raises(ValueError):
        FaultPlan(kill_at=1, torn_at=2)
    assert resolve_checkpoint(None) is None
    assert resolve_checkpoint(str(tmp_path)).dir == str(tmp_path)
    cfg = CheckpointConfig(dir=str(tmp_path), keep=3)
    assert resolve_checkpoint(cfg) is cfg
    with pytest.raises(TypeError):
        resolve_checkpoint(42)
    assert RoundOptions(checkpoint=cfg).merged(chunk=2).checkpoint is cfg


def test_checkpointer_every_snapshots_nth_boundary_and_final(tmp_path):
    store = SnapshotStore(str(tmp_path), keep=99, sync=True)
    ck = CarryCheckpointer(store, signature={"surface": "t"}, total=10,
                           every=2)
    for start, end in [(0, 3), (3, 6), (6, 9), (9, 10)]:
        ck.on_segment(start, end, torch.zeros(2),
                      {"loss": torch.zeros(end - start)})
    ck.close()
    # Boundaries 2 and 4 (every=2) plus the final boundary: rounds 6, 10.
    snaps = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert snaps == ["snapshot-00000006.npz", "snapshot-00000010.npz"]


def test_restore_refuses_a_carry_of_another_shape(tmp_path):
    store = SnapshotStore(str(tmp_path), sync=True)
    store.save(2, {"carry/000": torch.zeros(3)}, {"signature": {}})
    _, arrays, meta = store.load_latest()
    with pytest.raises(CheckpointError, match="does not fit"):
        restore_carry(arrays, meta, torch.zeros(4))
    with pytest.raises(CheckpointError, match="missing carry leaf"):
        restore_carry(arrays, meta, (torch.zeros(3), torch.zeros(1)))


# ---------------------------------------------------------------------------
# npz checkpoint: bf16 and Python-number leaves, key-set validation.
# ---------------------------------------------------------------------------

def test_npz_checkpoint_roundtrips_bf16_and_int_leaves(tmp_path):
    path = str(tmp_path / "ck.npz")
    g = torch.Generator().manual_seed(9)
    tree = {"params": {"w": torch.randn((5, 3), generator=g)
                       .to(torch.bfloat16),
                       "b": torch.arange(4.0)},
            "step": 17, "blocks": [torch.ones(2, dtype=torch.int32)]}
    save_checkpoint(path, tree, step=17)
    like = {"params": {"w": torch.zeros((5, 3), dtype=torch.bfloat16),
                       "b": torch.zeros(4)},
            "step": 0, "blocks": [torch.zeros(2, dtype=torch.int32)]}
    out, step = load_checkpoint(path, like)
    assert step == 17
    _tree_equal(out, tree)
    with np.load(path) as data:
        assert "['params']['w']" in data.files
        assert data["['params']['w']"].dtype == np.uint16


def test_npz_load_rejects_mismatched_key_sets(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.zeros(2), "b": torch.ones(2)})
    with pytest.raises(ValueError) as ei:
        load_checkpoint(path, {"a": torch.zeros(2), "c": torch.ones(2)})
    msg = str(ei.value)
    assert "missing keys" in msg and "'c'" in msg
    assert "extra keys" in msg and "'b'" in msg


# ---------------------------------------------------------------------------
# Trainer: killed-and-resumed == uninterrupted, at every boundary.
# ---------------------------------------------------------------------------

def _trainer_args(dtype=torch.float32):
    loss_fn = _quad_loss(_centers(0, 8, _D))
    cfg = TrainerConfig(algorithm="dshb",
                        agg=AggregatorSpec(rule="cwtm", f=2, pre="nnm"),
                        byz=ByzantineConfig(f=2, attack="alie", eta=2.0),
                        track_kappa_hat=True)
    params = {"theta": torch.zeros((_D,), dtype=dtype)}
    batch = {"idx": np.arange(8)[:, None]}
    return (loss_fn, params, batch, sgd(clip=1.0), cfg, constant(0.1), 8)


def _trainer_kw():
    return dict(seed=3, engine="scan", chunk=2, eval_every=4,
                eval_fn=lambda p: -torch.sum(p["theta"].float() ** 2))


def _assert_trainer_equal(out, ref):
    p, o = out
    rp, ro = ref
    _tree_equal(p, rp)
    for k in ("loss", "direction_norm", "kappa_hat", "lr", "eval",
              "eval_step"):
        assert o["history"][k] == ro["history"][k], k
    assert o["best"]["acc"] == ro["best"]["acc"]
    assert o["best"]["norm"] == ro["best"]["norm"]
    _tree_equal(o["best"]["params"], ro["best"]["params"])
    _tree_equal(o["state"], ro["state"])


# 8 steps, chunk=2, eval at 4: boundaries at 2, 4, 6, 8 - ordinals 0..3.
_F32, _BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("fault,dtype", [
    (FaultPlan(kill_at=0), _F32), (FaultPlan(kill_at=1), _F32),
    (FaultPlan(kill_at=2), _F32), (FaultPlan(kill_at=3), _F32),
    (FaultPlan(torn_at=1), _F32), (FaultPlan(kill_at=1), _BF16)],
    ids=["kill@0", "kill@1", "kill@2", "kill@final", "torn@1", "kill@1-bf16"])
def test_trainer_kill_resume_bitwise(tmp_path, fault, dtype):
    ref = train_loop(*_trainer_args(dtype), **_trainer_kw())
    with pytest.raises(SimulatedPreemption):
        train_loop(*_trainer_args(dtype), **_trainer_kw(),
                   options=RoundOptions(checkpoint=CheckpointConfig(
                       dir=str(tmp_path), sync=True, keep=2,
                       fault_plan=fault)))
    out = train_loop(*_trainer_args(dtype), **_trainer_kw(),
                     options=RoundOptions(checkpoint=CheckpointConfig(
                         dir=str(tmp_path), sync=True, keep=2)))
    _assert_trainer_equal(out, ref)
    report = out[1]["scan_report"]
    # torn@1 rolls back to the previous boundary; kill@k resumes the next.
    expect = {0: 2, 1: 4, 2: 6, 3: 8}[fault.kill_at] \
        if fault.kill_at is not None else 2
    assert report["resumed_from"] == expect
    assert type(out[1]["state"]["step"]) is int


def test_trainer_checkpointed_fresh_run_matches_bare(tmp_path):
    """Checkpointing on (async writer) changes nothing about the math, and
    the snapshot count equals the boundary count."""
    ref = train_loop(*_trainer_args(), **_trainer_kw())
    out = train_loop(*_trainer_args(), **_trainer_kw(),
                     options=RoundOptions(checkpoint=CheckpointConfig(
                         dir=str(tmp_path))))
    _assert_trainer_equal(out, ref)
    assert out[1]["scan_report"]["snapshots"] == 4
    assert out[1]["scan_report"]["resumed_from"] == 0


def test_trainer_signature_mismatch_is_clean_refusal(tmp_path):
    opts = RoundOptions(checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                    sync=True))
    train_loop(*_trainer_args(), **_trainer_kw(), options=opts)
    kw = dict(_trainer_kw(), seed=4)
    with pytest.raises(CheckpointError, match="different experiment plan"):
        train_loop(*_trainer_args(), **kw, options=opts)


# ---------------------------------------------------------------------------
# Fed server: killed-and-resumed == uninterrupted.
# ---------------------------------------------------------------------------

def _fed_setup():
    loss_fn = _quad_loss(_centers(0, _N, _D))
    cfg = FedConfig(n_clients=_N, clients_per_round=_M, f=2,
                    agg=AggregatorSpec(rule="cwtm", f=2, pre="nnm"),
                    client=ClientConfig(local_lr=0.05, algorithm="dshb"))
    server = FedServer(loss_fn, sgd(clip=1.0), cfg, constant(0.1),
                       device="cpu")
    state = server.init_state({"theta": torch.zeros((_D,))})
    return server, state


def _assert_fed_equal(res, ref):
    (state, hist), (rstate, rhist) = res, ref
    _tree_equal(state, rstate)
    (a, ameta), (b, bmeta) = hist.pack(), rhist.pack()
    assert sorted(a) == sorted(b) and ameta == bmeta
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fault,resumed", [
    (FaultPlan(kill_at=1), 6), (FaultPlan(torn_at=1), 3),
    (FaultPlan(kill_at=3), 10)],
    ids=["kill@1", "torn@1", "kill@final"])
def test_fed_kill_resume_bitwise(tmp_path, fault, resumed):
    server, state = _fed_setup()
    ref = run_rounds(server, state, _idx_batch_fn, 10, seed=7,
                     schedule=constant_attack("alie", 3.0),
                     engine="scan", chunk=3)
    s2, st2 = _fed_setup()
    with pytest.raises(SimulatedPreemption):
        run_rounds(s2, st2, _idx_batch_fn, 10, seed=7,
                   schedule=constant_attack("alie", 3.0), engine="scan",
                   chunk=3, options=RoundOptions(
                       checkpoint=CheckpointConfig(
                           dir=str(tmp_path), sync=True, fault_plan=fault)))
    s3, st3 = _fed_setup()
    res = run_rounds(s3, st3, _idx_batch_fn, 10, seed=7,
                     schedule=constant_attack("alie", 3.0), engine="scan",
                     chunk=3, options=RoundOptions(
                         checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                     sync=True)))
    assert s3.last_scan_report["resumed_from"] == resumed
    _assert_fed_equal(res, ref)


def test_fed_signature_mismatch_is_clean_refusal(tmp_path):
    server, state = _fed_setup()
    run_rounds(server, state, _idx_batch_fn, 6, seed=7, engine="scan",
               chunk=3, options=RoundOptions(
                   checkpoint=CheckpointConfig(dir=str(tmp_path), sync=True)))
    s2, st2 = _fed_setup()
    with pytest.raises(CheckpointError, match="different experiment plan"):
        run_rounds(s2, st2, _idx_batch_fn, 6, seed=8, engine="scan",
                   chunk=3, options=RoundOptions(
                       checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                   sync=True)))


def test_fed_resume_false_ignores_existing_snapshots(tmp_path):
    server, state = _fed_setup()
    ref = run_rounds(server, state, _idx_batch_fn, 6, seed=7, engine="scan",
                     chunk=3, options=RoundOptions(
                         checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                     sync=True)))
    s2, st2 = _fed_setup()
    res = run_rounds(s2, st2, _idx_batch_fn, 6, seed=7, engine="scan",
                     chunk=3, options=RoundOptions(
                         checkpoint=CheckpointConfig(dir=str(tmp_path),
                                                     sync=True,
                                                     resume=False)))
    assert s2.last_scan_report["resumed_from"] == 0
    _assert_fed_equal(res, ref)


def test_fed_checkpoint_requires_scan_and_keeps_backend(tmp_path):
    server, state = _fed_setup()
    with pytest.raises(ValueError, match="requires engine='scan'"):
        run_rounds(server, state, _idx_batch_fn, 2, engine="loop",
                   options=RoundOptions(checkpoint=str(tmp_path)))
    with pytest.raises(ValueError, match="backend"):
        run_rounds(server, state, _idx_batch_fn, 2,
                   options=RoundOptions(backend="torch"))


# ---------------------------------------------------------------------------
# Fleet runner: restart recovery, one snapshot directory per bucket.
# ---------------------------------------------------------------------------

_OPT = sgd(clip=1.0)
_FLEET_LOSS = _quad_loss(_centers(0, _N, _D))


def _job(label, *, f=2, seed=0, rounds=5, eval_every=0):
    cfg = FedConfig(n_clients=_N, clients_per_round=_M, f=f,
                    agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                    client=ClientConfig(local_lr=0.05, algorithm="dshb",
                                        beta=0.9))
    eval_fn = (lambda params: -torch.sum(params["theta"] ** 2)) \
        if eval_every else None
    return FleetJob(label=label, cfg=cfg, loss_fn=_FLEET_LOSS, optimizer=_OPT,
                    params={"theta": torch.zeros((_D,))},
                    batch_fn=_idx_batch_fn, rounds=rounds, seed=seed,
                    schedule=constant_attack("alie", 2.0),
                    eval_fn=eval_fn, eval_every=eval_every,
                    lr_fn=lambda r: 0.1)


def _assert_same_result(a, b):
    (x, xm), (y, ym) = a.history.pack(), b.history.pack()
    assert xm == ym
    for k in y:
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert a.evals == b.evals and a.best_eval == b.best_eval
    _tree_equal(a.state, b.state)


def _fleet_jobs():
    return [_job("a", seed=0, rounds=6, eval_every=2),
            _job("b", seed=1, rounds=4, eval_every=2),
            _job("c", seed=2, rounds=6, f=3)]


@pytest.mark.parametrize("fault", [FaultPlan(kill_at=0), FaultPlan(kill_at=1),
                                   FaultPlan(torn_at=1)],
                         ids=["kill@0", "kill@1", "torn@1"])
def test_fleet_runner_kill_resume_bitwise(tmp_path, fault):
    ref = FleetRunner(_fleet_jobs(), chunk=2, device="cpu").run()
    with pytest.raises(SimulatedPreemption):
        FleetRunner(_fleet_jobs(), device="cpu", options=RoundOptions(
            chunk=2, checkpoint=CheckpointConfig(
                dir=str(tmp_path), sync=True, fault_plan=fault))).run()
    assert os.listdir(tmp_path) == ["bucket-000"]
    res = FleetRunner(_fleet_jobs(), device="cpu", options=RoundOptions(
        chunk=2, checkpoint=CheckpointConfig(dir=str(tmp_path),
                                             sync=True))).run()
    for a, b in zip(res, ref):
        _assert_same_result(a, b)
    manifest = json.loads(
        (tmp_path / "bucket-000" / "MANIFEST.json").read_text())
    assert manifest["latest"]["round"] == 6
    assert manifest["latest"]["meta"]["signature"] == {
        "surface": "fleet", "labels": ["a", "b", "c"], "rounds": [6, 4, 6],
        "seeds": [0, 1, 2], "chunk": 2}
