"""The port's runtime ring exporters (``repro_torch.obs.runtime``) and
``python -m repro_torch.launch.health``, held to the reference's
tests/test_obs.py exporter cases.

* JSONL: export, then :func:`import_jsonl` gives :func:`snapshot` back,
  a :class:`DispatchRecord` and a 0-d tensor among the arguments (made
  JSON values at export only);
* Chrome trace: valid JSON, phases X / i / C, ``ts`` nondecreasing;
* a fleet-service run exported end to end (the port's handle API in
  place of the reference's ``drain``): its ``fleet.segment`` spans and
  ``kernels.dispatch`` records, with their decisions, survive the round
  trip;
* the facade (``get_runtime`` and the module functions) is one ring, and
  every aggregate's dispatch record is the ring's head and an event;
* ``launch.health`` on the CPU writes both files, and its tap columns
  follow the reference example's on the same scenario.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorSpec as JSpec
from repro.fed import ClientConfig as JClient
from repro.fed import FedConfig as JFed
from repro.fed import FedServer as JServer
from repro.fed import run_rounds as j_run_rounds
from repro.fed import switch_attack as j_switch
from repro.optim import sgd as j_sgd
from repro.optim.schedules import constant as j_lr
from repro_torch import obs
from repro_torch.core.types import AggregatorSpec
from repro_torch.fed import ClientConfig, FedConfig
from repro_torch.fed.schedules import AttackPhase, AttackSchedule
from repro_torch.fleet import FleetJob
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.launch import health
from repro_torch.obs import runtime as obs_runtime
from repro_torch.optim import sgd
from repro_torch.rounds import RoundOptions
from repro_torch.serving import FleetService

torch.set_num_threads(2)


def test_jsonl_roundtrip_with_dispatch_record_and_tensor(tmp_path):
    rt = obs_runtime.Runtime()
    rt.event("tensor_arg", val=torch.tensor(1.5), n=np.float32(2.5))
    rec = kdispatch.DispatchRecord(requested="auto", backend="cuda",
                                   rule="cwtm", pre="nnm")
    rec.decisions.append(kdispatch.KernelDecision("gram", "cuda", "cuda"))
    rt.event("dataclass_arg", record=rec)
    with rt.span("seg", start=0, end=4):
        pass
    rt.inc("transfers", 3)
    # Emission keeps the tensor as it is (no device sync on the hot path).
    assert isinstance(rt.history()[0]["args"]["val"], torch.Tensor)
    path = tmp_path / "events.jsonl"
    n = rt.export_jsonl(str(path))
    lines = obs_runtime.import_jsonl(str(path))
    assert len(lines) == n == 4
    events = [line for line in lines if line["kind"] != "counter"]
    assert events == rt.snapshot()
    assert events[0]["args"] == {"val": 1.5, "n": 2.5}
    assert events[1]["args"]["record"]["rule"] == "cwtm"
    assert events[1]["args"]["record"]["decisions"][0]["primitive"] == "gram"
    counter = [line for line in lines if line["kind"] == "counter"][0]
    assert counter == {"name": "transfers", "kind": "counter",
                       "ts": counter["ts"], "value": 3.0}


def test_sanitize_leaves_wide_tensors_as_text():
    rt = obs_runtime.Runtime()
    rt.event("e", wide=torch.arange(3), arr=np.arange(2), t=(1, None))
    args = rt.snapshot()[0]["args"]
    assert isinstance(args["wide"], str) and isinstance(args["arr"], str)
    assert args["t"] == [1, None]


def test_chrome_trace_valid_and_monotonic(tmp_path):
    rt = obs_runtime.Runtime()
    with rt.span("outer"):
        rt.event("inner")
        with rt.span("nested"):
            pass
    rt.inc("c", 5)
    path = tmp_path / "trace.json"
    n = rt.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    rows = doc["traceEvents"]
    assert len(rows) == n == 4
    ts = [r["ts"] for r in rows]
    assert ts == sorted(ts)
    assert {r["name"]: r["ph"] for r in rows} == {
        "outer": "X", "nested": "X", "inner": "i", "c": "C"}
    for r in rows:
        if r["ph"] == "X":
            assert r["dur"] >= 0.0
        assert {"name", "ph", "pid", "tid", "ts"} <= set(r)


def test_facade_is_one_ring(tmp_path):
    obs_runtime.reset()
    obs.event("a", x=1)
    assert obs.get_runtime() is obs_runtime.get_runtime()
    assert [e["name"] for e in obs.get_runtime().history()] == ["a"]
    assert obs.snapshot() == obs_runtime.snapshot()
    assert obs.export_jsonl(str(tmp_path / "a.jsonl")) == 1
    assert obs.export_chrome_trace(str(tmp_path / "a.json")) == 1


_D = 6
_CENTERS = torch.as_tensor(np.random.default_rng(0).normal(
    size=(12, _D)).astype(np.float32))


def _loss(params, batch):
    c = _CENTERS[batch["idx"].long()][0]
    return 0.5 * torch.sum((params["theta"] - c) ** 2), {}


def _batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


_OPT = sgd(clip=1.0)


def _job(f, seed):
    cfg = FedConfig(n_clients=12, clients_per_round=8, f=f,
                    agg=AggregatorSpec(rule="cwtm", f=f, pre="nnm"),
                    client=ClientConfig(algorithm="dshb", beta=0.9))
    return FleetJob(label=f"f{f}s{seed}", cfg=cfg, loss_fn=_loss,
                    optimizer=_OPT, params={"theta": torch.zeros(_D)},
                    batch_fn=_batch_fn, rounds=6, seed=seed,
                    schedule=AttackSchedule((AttackPhase("sf", 0),)))


def test_service_run_exported_end_to_end(tmp_path):
    """Two tapped jobs through the service (submit, then results): the
    export holds the segments and the dispatch records, in order."""
    obs_runtime.reset()
    svc = FleetService(chunk=3, options=RoundOptions(taps=True), device="cpu")
    handles = [svc.submit(_job(2, 7)), svc.submit(_job(1, 8))]
    results = [h.result() for h in handles]
    assert all(r.history.tap_columns() for r in results)
    names = [e["name"] for e in obs_runtime.history()]
    assert names.count("fleet.segment") == 2        # 6 rounds / chunk 3
    assert "fleet.trace" in names and "kernels.dispatch" in names
    jsonl, chrome = tmp_path / "run.jsonl", tmp_path / "run.json"
    obs_runtime.export_jsonl(str(jsonl))
    n_rows = obs_runtime.export_chrome_trace(str(chrome))
    lines = obs_runtime.import_jsonl(str(jsonl))
    events = [line for line in lines if line["kind"] != "counter"]
    assert events == obs_runtime.snapshot()
    disp = [e for e in events if e["name"] == "kernels.dispatch"]
    assert disp and disp[-1]["args"]["record"]["decisions"]
    assert disp[-1]["args"]["record"]["dyn"] is True
    segs = [e for e in events if e["name"] == "fleet.segment"]
    assert [(e["args"]["start"], e["args"]["end"]) for e in segs] == \
        [(0, 3), (3, 6)]
    doc = json.loads(chrome.read_text())
    ts = [r["ts"] for r in doc["traceEvents"]]
    assert ts == sorted(ts) and len(ts) == n_rows == len(lines)


def test_launch_health_on_the_cpu(tmp_path, capsys):
    out = health.main(["--device", "cpu", "--rounds", "6",
                       "--export-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "<-- attack on" in printed and "chrome trace" in printed
    assert (tmp_path / "run.jsonl").stat().st_size > 0
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]
    lines = obs_runtime.import_jsonl(out["jsonl"])
    assert [line for line in lines if line["kind"] != "counter"] == \
        obs_runtime.snapshot()
    cols = out["columns"]
    assert out["switch"] == 3 and cols["dist_honest"].shape == (6,)
    # The reference example's scenario, its loop engine: the same taps.
    c_all = jnp.asarray(_CENTERS.numpy())

    def j_loss(params, batch):
        return 0.5 * jnp.sum((params["theta"] - c_all[batch["idx"][0]]) ** 2), {}

    cfg = JFed(n_clients=12, clients_per_round=8, f=2,
               agg=JSpec(rule="cwtm", f=2, pre="nnm"),
               client=JClient(algorithm="dshb", beta=0.9), taps=True)
    server = JServer(j_loss, j_sgd(clip=1.0), cfg, j_lr(0.1))
    _, hist = j_run_rounds(server, server.init_state(
        {"theta": jnp.zeros((_D,))}), _batch_fn, 6,
        schedule=j_switch((0, "none"), (3, "sf")), seed=0, engine="loop")
    want = hist.tap_columns()
    assert set(cols) == set(want)
    for k in want:
        np.testing.assert_allclose(cols[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert out["history"].attack == hist.attack


def test_dispatch_history_ring_and_events():
    """Each aggregate's record is the ring's head and a kernels.dispatch
    event holding that same record (tests/test_obs.py's ring case)."""
    from repro_torch.core.robust import robust_aggregate
    stack = {"x": torch.as_tensor(np.random.default_rng(0).normal(
        size=(8, 5)).astype(np.float32))}
    obs_runtime.reset()
    robust_aggregate(stack, AggregatorSpec(rule="cwtm", f=2, pre="nnm"))
    robust_aggregate(stack, AggregatorSpec(rule="gm", f=2))
    recent = kdispatch.dispatch_history(limit=2)
    assert [r.rule for r in recent] == ["cwtm", "gm"]
    assert kdispatch.last_dispatch() is recent[-1]
    assert obs.dispatch_history(limit=2)[-1] is recent[-1]
    assert obs.last_dispatch() is recent[-1]
    events = obs_runtime.history(name="kernels.dispatch")
    assert [e["args"]["record"] for e in events] == recent
    assert len(kdispatch.dispatch_history()) <= \
        kdispatch.DISPATCH_HISTORY_LIMIT


@pytest.mark.parametrize("name", ["export_jsonl", "export_chrome_trace",
                                  "import_jsonl", "snapshot", "get_runtime",
                                  "dispatch_history", "health_taps",
                                  "HealthTaps", "TAP_FIELDS"])
def test_obs_exports_the_reference_surface(name):
    from repro import obs as jobs
    assert name in obs.__all__ and name in jobs.__all__
    assert callable(getattr(obs, name)) or name == "TAP_FIELDS"
