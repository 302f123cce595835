"""The port's segmented round engine and the fed server's two engines
against the reference (``repro.rounds``, ``repro.fed.run_rounds``).

``RoundEngine``: segment cuts, ``chunk_shapes``, the resume cursor and
its refusal off a boundary equal the reference's; ``on_boundary`` fires
before ``on_segment``; a run fetches its metrics once.

``run_rounds``: the reference's scan-vs-loop schedules
(``tests/test_rounds.py``: partial participation 6 of 10, rotating
identities, ``chunk=4`` so phase switches fall mid-segment) run through
the port's scan and loop engines and the reference's LOOP engine (the
reference's own scan and loop disagree bitwise in two of them, ROADMAP
queue 3).  The port's scan equals its loop bit for bit (one body, the
same per-round draws).  Against the reference: cohorts, attack and eta
metadata, m_byz and f_round EQUAL; per-round loss, direction_norm and
kappa_hat within rtol 1e-4, atol 1e-6; final parameters within 1e-4 of
their largest magnitude (the fleet parity test's tolerances,
tests/test_torch_fleet.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import FedServer as JServer
from repro.fed import RotatingByzantine as JRot
from repro.fed import constant_attack as j_constant
from repro.fed import ramp_eta as j_ramp
from repro.fed import run_rounds as j_run_rounds
from repro.fed import switch_attack as j_switch
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_lr
from repro.rounds import RoundEngine as JEngine
from repro.rounds import resolve_attack_operands as j_resolve
from repro.rounds import schedule_families as j_families
from repro.rounds import split_segments as j_split
from repro_torch.core.types import AggregatorSpec
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, RotatingByzantine, constant_attack,
    ramp_eta, run_rounds, switch_attack,
)
from repro_torch.obs import runtime as obs_runtime
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant
from repro_torch.rounds import (
    RoundEngine, resolve_attack_operands, round_seeds, schedule_families,
    split_segments,
)

torch.set_num_threads(2)

_N, _M, _D = 10, 6, 5
RTOL, ATOL = 1e-4, 1e-6


def _centers(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _j_quad_loss(centers):
    c_all = jnp.asarray(centers)

    def loss_fn(params, batch):
        c = c_all[batch["idx"][0]]
        return 0.5 * jnp.sum((params["theta"] - c) ** 2), {}
    return loss_fn


def _t_quad_loss(centers):
    c_all = torch.as_tensor(centers)

    def loss_fn(params, batch):
        c = c_all[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"] - c) ** 2), {}
    return loss_fn


def _idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


# ---------------------------------------------------------------------------
# RoundEngine.
# ---------------------------------------------------------------------------

def _t_body(state, op):
    x = state["x"] + torch.as_tensor(op["a"])
    return {"x": x}, {"x": x, "twice": 2 * torch.as_tensor(op["a"])}


def _j_body(state, op):
    x = state["x"] + op["a"]
    return {"x": x}, {"x": x, "twice": 2 * op["a"]}


_OPS = {"a": np.arange(1, 11, dtype=np.float32)}


@pytest.mark.parametrize("rounds,chunk,boundaries", [
    (10, None, ()), (10, 4, ()), (10, 3, (5,)), (10, None, (0, 10, 99)),
    (0, 4, ()), (10, 5, (5,)), (10, 4, (4, 4, 4)), (7, 2, (3, 6)),
])
def test_split_segments_equals_reference(rounds, chunk, boundaries):
    assert split_segments(rounds, chunk, boundaries) == \
        j_split(rounds, chunk, boundaries)


@pytest.mark.parametrize("chunk,boundaries,start", [
    (None, (), 0), (4, (), 0), (3, (5,), 0), (4, (), 4), (3, (5,), 5),
])
def test_round_engine_segments_and_resume_equal_reference(chunk, boundaries,
                                                          start):
    t_eng = RoundEngine(_t_body, chunk=chunk)
    j_eng = JEngine(_j_body, chunk=chunk)
    t_state, t_m = t_eng.run({"x": torch.zeros(())}, _OPS,
                             boundaries=boundaries, start=start)
    j_state, j_m = j_eng.run({"x": jnp.zeros(())}, _OPS,
                             boundaries=boundaries, start=start)
    assert t_eng.chunk_shapes == j_eng.chunk_shapes
    assert [s[:2] for s in t_eng.segment_log] == \
        RoundEngine._skip_to(split_segments(10, chunk, boundaries), start, 10)
    assert float(t_state["x"]) == float(j_state["x"])
    for k in ("x", "twice"):
        np.testing.assert_array_equal(t_m[k], np.asarray(j_m[k]))
    assert t_eng.trace_count == 1 and t_eng.transfer_count == 1


def test_round_engine_resume_off_boundary_raises_like_reference():
    for eng, state in ((RoundEngine(_t_body, chunk=4), {"x": torch.zeros(())}),
                       (JEngine(_j_body, chunk=4), {"x": jnp.zeros(())})):
        with pytest.raises(ValueError, match="segment boundary"):
            eng.run(state, _OPS, start=3)
        with pytest.raises(ValueError, match="segment boundary"):
            eng.run_loop(state, _OPS, start=3)


def test_round_engine_hooks_order_and_one_transfer_per_run():
    calls = []
    eng = RoundEngine(_t_body, chunk=4)
    before = obs_runtime.counters().get("rounds.transfers", 0.0)
    state, metrics = eng.run(
        {"x": torch.zeros(())}, _OPS,
        on_boundary=lambda end, st: calls.append(("boundary", end)),
        on_segment=lambda s, e, st, m: calls.append(("segment", e, len(m))))
    assert calls == [("boundary", 4), ("segment", 4, 4),
                     ("boundary", 8), ("segment", 8, 4),
                     ("boundary", 10), ("segment", 10, 2)]
    assert eng.transfer_count == 1
    assert obs_runtime.counters()["rounds.transfers"] == before + 1
    spans = [e for e in obs_runtime.history(name="rounds.segment")][-3:]
    assert [(e["args"]["start"], e["args"]["end"]) for e in spans] == \
        [(0, 4), (4, 8), (8, 10)]
    # The same body round by round: one fetch a round, the same numbers.
    loop = RoundEngine(_t_body, chunk=4)
    l_state, l_metrics = loop.run_loop({"x": torch.zeros(())}, _OPS)
    assert loop.transfer_count == 10
    assert float(l_state["x"]) == float(state["x"]) == 55.0
    for k in metrics:
        np.testing.assert_array_equal(l_metrics[k], metrics[k])
    # A second run of the engine builds nothing.
    eng.run({"x": torch.zeros(())}, _OPS)
    assert eng.trace_count == 1 and eng.transfer_count == 2


# ---------------------------------------------------------------------------
# Plans.
# ---------------------------------------------------------------------------

_SCHEDULES = {
    "alie": (lambda m: m.constant_attack("alie", 3.0), 2, {}),
    "switch-midchunk": (lambda m: m.switch_attack(
        (0, "none"), (3, "sf"), (7, "alie", 2.0)), 2, {}),
    "ramp": (lambda m: m.ramp_eta("foe", 1.0, 6.0, 4), 3, {}),
    "lf": (lambda m: m.constant_attack("lf"), 3, {}),
    "clean": (lambda m: m.constant_attack("none"), 0, {}),
    "mimic-localsgd": (lambda m: m.constant_attack("mimic"), 2,
                       {"local_steps": 2}),
    "no-kappa": (lambda m: m.constant_attack("alie", 4.0), 2,
                 {"track": False}),
}


class _J:
    constant_attack, switch_attack, ramp_eta = j_constant, j_switch, j_ramp


class _T:
    constant_attack, switch_attack, ramp_eta = constant_attack, \
        switch_attack, ramp_eta


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_resolve_attack_operands_equals_reference(name):
    make = _SCHEDULES[name][0]
    t_fam, t_ops, t_meta = resolve_attack_operands(make(_T), 12)
    j_fam, j_ops, j_meta = j_resolve(make(_J), 12)
    assert t_fam == j_fam == schedule_families(make(_T)) == \
        j_families(make(_J))
    for k in ("attack_id", "eta"):
        np.testing.assert_array_equal(t_ops[k], j_ops[k])
        assert t_ops[k].dtype == j_ops[k].dtype
    assert t_meta == j_meta


def test_round_seeds_are_the_seeds_generator_in_round_order():
    a, b = round_seeds(7, 10), round_seeds(7, 12)
    np.testing.assert_array_equal(a, b[:10])
    assert a.dtype == np.int64 and len(set(a.tolist())) == 10
    assert not np.array_equal(a, round_seeds(8, 10))


# ---------------------------------------------------------------------------
# run_rounds: the port's scan and loop against the reference's loop.
# ---------------------------------------------------------------------------

def _t_server(f, *, local_steps=0, track=True, centers=None, **kw):
    cfg = FedConfig(n_clients=_N, clients_per_round=_M, f=f,
                    agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                    client=ClientConfig(local_steps=local_steps,
                                        local_lr=0.05, algorithm="dshb"),
                    track_kappa_hat=track, **kw)
    return FedServer(_t_quad_loss(centers), sgd(clip=1.0), cfg,
                     constant(0.1), device="cpu")


def _j_run(make, f, kw, centers, rounds):
    cfg = JFed(n_clients=_N, clients_per_round=_M, f=f,
               agg=JSpec(rule="cwtm", f=f, pre="nnm"),
               client=JClient(local_steps=kw.get("local_steps", 0),
                              local_lr=0.05, algorithm="dshb"),
               track_kappa_hat=kw.get("track", True))
    server = JServer(_j_quad_loss(centers), j_sgd(clip=1.0), cfg, j_lr(0.1))
    state = server.init_state({"theta": jnp.zeros((_D,), jnp.float32)})
    return j_run_rounds(server, state, _idx_batch_fn, rounds,
                        schedule=make(_J),
                        byz_identity=JRot(_N, f, period=3) if f else None,
                        seed=7, engine="loop", chunk=4)


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_run_rounds_scan_and_loop_against_reference_loop(name):
    make, f, kw = _SCHEDULES[name]
    centers = _centers(0, _N, _D)
    rounds = 10
    out = {}
    for engine in ("loop", "scan"):
        server = _t_server(f, centers=centers, **kw)
        state = server.init_state({"theta": torch.zeros(_D)})
        out[engine] = run_rounds(
            server, state, _idx_batch_fn, rounds, schedule=make(_T),
            byz_identity=RotatingByzantine(_N, f, period=3) if f else None,
            seed=7, engine=engine, chunk=4)
        if engine == "scan":
            rep = server.last_scan_report
            assert rep["trace_count"] == 1 and rep["chunk_shapes"] == (2, 4)
            assert [s[:2] for s in rep["segments"]] == \
                [(0, 4), (4, 8), (8, 10)]
    (s_l, h_l), (s_s, h_s) = out["loop"], out["scan"]
    # The port's two engines: bit for bit.
    assert torch.equal(s_l["params"]["theta"], s_s["params"]["theta"])
    assert torch.equal(s_l["momentum"], s_s["momentum"])
    assert h_l.loss == h_s.loss and h_l.direction_norm == h_s.direction_norm
    np.testing.assert_array_equal(h_l.kappa_hat, h_s.kappa_hat)
    assert len(h_s.kappa_hat) == rounds
    assert np.isfinite(h_s.kappa_hat).all() == kw.get("track", True)
    assert h_l.lr == h_s.lr
    # Against the reference's loop.
    j_state, j_h = _j_run(make, f, kw, centers, rounds)
    for h in (h_l, h_s):
        assert h.attack == j_h.attack and h.eta == j_h.eta
        assert h.m_byz == j_h.m_byz and h.f_round == j_h.f_round
        assert len(h.cohorts) == len(j_h.cohorts) == rounds
        for a, b in zip(h.cohorts, j_h.cohorts):
            np.testing.assert_array_equal(a, b)
    _close(h_s.loss, j_h.loss, "loss")
    _close(h_s.direction_norm, j_h.direction_norm, "direction_norm")
    if kw.get("track", True):
        _close(h_s.kappa_hat, j_h.kappa_hat, "kappa_hat")
    np.testing.assert_allclose(h_s.lr, j_h.lr, rtol=0, atol=0)
    want = np.asarray(j_state["params"]["theta"])
    got = s_s["params"]["theta"].numpy()
    assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))


def test_run_rounds_refuses_unported_attack_and_taps():
    """Taps and the ``_opt`` attacks, refused before they were ported,
    now run: a tapped server builds (tests/test_torch_taps.py holds its
    taps to the reference), and the ``_opt`` attacks run on both engines,
    equal bit for bit (tests/test_torch_attacks_opt.py holds them to the
    reference)."""
    centers = _centers(0, _N, _D)
    out = []
    for engine in ("scan", "loop"):
        server = _t_server(2, centers=centers)
        state = server.init_state({"theta": torch.zeros(_D)})
        out.append(run_rounds(server, state, _idx_batch_fn, 2,
                              schedule=constant_attack("alie_opt"),
                              engine=engine)[0]["params"]["theta"])
    assert torch.equal(out[0], out[1]) and bool(torch.isfinite(out[0]).all())
    assert callable(server.round_fn("foe_opt", 2))
    tapped = _t_server(2, centers=centers, taps=True)
    assert tapped.cfg.taps and callable(tapped.round_fn("alie", 2))


def test_fed_scan_engine_cached_across_runs():
    """A server re-running the same schedule skeleton builds nothing."""
    centers = _centers(0, _N, _D)
    server = _t_server(2, centers=centers)
    sched = constant_attack("alie", 3.0)
    engines = []
    for new_builds in (1, 0):
        state = server.init_state({"theta": torch.zeros(_D)})
        _, hist = run_rounds(server, state, _idx_batch_fn, 20,
                             schedule=sched, seed=1, chunk=5)
        assert hist.rounds == 20
        rep = server.last_scan_report
        assert (rep["trace_count"], rep["total_trace_count"],
                rep["chunk_shapes"]) == (new_builds, 1, (5,))
        assert len(rep["segments"]) == 4
        engines.append(server.scan_engine(("alie",), 2, chunk=5))
    assert engines[0] is engines[1]
    assert server.round_fn("alie", 2) is server.round_fn("alie", 2)
