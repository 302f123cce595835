"""The continuous fleet service end to end (counterpart of
``examples/fleet_scenarios.py`` and ``examples/preemptible_fleet.py``).

Without ``--kill-at``: every registered scenario (or ``--scenario``) x
``--seeds`` seeds is submitted to :class:`repro_torch.serving.FleetService`
by name; the service packs them into shape buckets and steps each bucket's
lanes together, and the example's table is printed.

With ``--kill-at K``, the preemption drill: one batch of jobs, registry
specs by name and a raw ``FleetJob``, one with a deadline, then after the
first boundary a mid-run submit and a cancel, runs (1) uninterrupted, (2)
checkpointed and killed right after its K-th boundary snapshot (0-based),
(3) restored from the directory alone (plus ``jobs=`` for the raw job) and
run to the end; every surviving handle's result must equal the
uninterrupted run's bit for bit.  Runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.service [--seeds 2] [--rounds 12]
  PYTHONPATH=src python -m repro_torch.launch.service --kill-at 2 [--chunk 3]
      [--scenario NAME ...] [--dir PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fed import list_scenarios
from repro_torch.fleet import ScenarioSpec, job_from_spec
from repro_torch.obs import runtime as obs_runtime
from repro_torch.resilience import (
    CheckpointConfig, FaultPlan, SimulatedPreemption,
)
from repro_torch.rounds import RoundOptions
from repro_torch.serving import FleetService
from repro_torch.tree import tree_leaves

#: The drill's default scenarios (the reference example's first three).
DRILL_SCENARIOS = 3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", action="append", default=None,
                    help="scenario(s) to run (default: all registered; the "
                         f"drill: the first {DRILL_SCENARIOS})")
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=None,
                    help="segment length = admission and snapshot cadence "
                         "(default: whole horizon; the drill: 3)")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="run the preemption drill, killed right after "
                         "this boundary snapshot (0-based)")
    ap.add_argument("--dir", default=None,
                    help="the drill's checkpoint directory (default: a "
                         "temporary one, removed afterwards)")
    ap.add_argument("--device", default="cuda")
    return ap


def _accuracy(res) -> float:
    acc = res.best_eval
    if acc is None and res.job.eval_fn is not None:
        acc = float(res.job.eval_fn(res.state["params"]))
    return float("nan") if acc is None else acc


def run_scenarios(names: list, seeds: int, rounds: int, chunk, device
                  ) -> dict:
    """Every scenario x seed through one service; prints the table."""
    svc = FleetService(chunk=chunk, device=device)
    handles = [svc.submit(ScenarioSpec(name, seed=seed, rounds=rounds))
               for name in names for seed in range(seeds)]
    print(f"submitted {svc.pending} jobs ({len(names)} scenarios x "
          f"{seeds} seeds)")
    t0 = time.perf_counter()
    svc.run_until_idle()
    wall = time.perf_counter() - t0
    print(f"ran in {wall:.1f}s — {len(handles) * rounds / wall:.1f} "
          f"aggregate rounds/s, {svc.trace_count} round programs\n")
    print(f"{'job':34s} {'acc':>6s} {'loss':>7s} {'kappa^':>7s}  attacks")
    results = {}
    for h in handles:
        res = h.result()
        results[h.job.label] = res
        hist = res.history
        kappa = f"{np.nanmean(hist.kappa_hat):7.3f}" \
            if np.isfinite(hist.kappa_hat).any() else "      -"
        segs = ",".join(f"{a}@r{s}" for a, s, _ in hist.attack_segments())
        print(f"{h.job.label:34s} {_accuracy(res):6.3f} "
              f"{hist.loss[-1]:7.3f} {kappa}  {segs}")
    return {"service": svc, "handles": handles, "results": results,
            "wall": wall}


def same_result(a, b) -> None:
    """Bit-for-bit equality of two FleetResults (state, history, evals)."""
    la, lb = tree_leaves(a.state), tree_leaves(b.state)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{a.label}: state diverged")
    (x, xm), (y, ym) = a.history.pack(), b.history.pack()
    if xm != ym or sorted(x) != sorted(y) or not all(
            np.array_equal(x[k], y[k], equal_nan=True) for k in y):
        raise AssertionError(f"{a.label}: history diverged")
    if a.evals != b.evals or a.best_eval != b.best_eval:
        raise AssertionError(f"{a.label}: evals diverged")


class _Drill:
    """The drill's jobs and events, replayed alike on every run: the
    initial submissions (specs by name, one raw FleetJob with a deadline),
    then at boundary 1 a mid-run submit and the cancel of the first
    job."""

    def __init__(self, names: list, seeds: int, rounds: int):
        self.specs = [ScenarioSpec(n, seed=s, rounds=rounds)
                      for n in names for s in range(seeds)]
        self.raw_spec = ScenarioSpec(names[0], seed=seeds, rounds=rounds,
                                     label=f"{names[0]}:raw")
        self.late = ScenarioSpec(names[-1], seed=seeds, rounds=rounds)
        self.raw_id = len(self.specs)
        self.events_done = False

    def raw_jobs(self) -> dict:
        """The raw job by id, materialised anew (restore's ``jobs=``)."""
        return {self.raw_id: job_from_spec(self.raw_spec)}

    def submit_initial(self, svc: FleetService) -> None:
        for spec in self.specs:
            svc.submit(spec)
        svc.submit(self.raw_jobs()[self.raw_id], deadline=1.0)

    def run(self, svc: FleetService) -> None:
        """Step to the end, applying the boundary-1 events once."""
        while True:
            if svc.steps == 1 and not self.events_done:
                svc.submit(self.late, deadline=2.0)
                svc.handle_of(0).cancel()
                self.events_done = True
            if not svc.step():
                return


def run_drill(names: list, seeds: int, rounds: int, chunk: int,
              kill_at: int, ckpt_dir: str, device) -> dict:
    """Uninterrupted, killed, restored; returns the three runs' facts."""
    drill = _Drill(names, seeds, rounds)
    ref_svc = FleetService(chunk=chunk, device=device)
    drill.submit_initial(ref_svc)
    drill.run(ref_svc)
    reference = {h.job_id: h._result for h in ref_svc.handles()}
    print(f"reference: {len(reference)} jobs ({len(names)} scenarios x "
          f"{seeds} seeds, a raw job, a mid-run submit, a cancel), "
          f"{rounds} rounds, segments of {chunk}")

    drill.events_done = False
    seq0 = obs_runtime.history(limit=1)
    seq0 = seq0[-1]["seq"] if seq0 else 0
    killed = FleetService(chunk=chunk, device=device, options=RoundOptions(
        checkpoint=CheckpointConfig(dir=ckpt_dir,
                                    fault_plan=FaultPlan(kill_at=kill_at))))
    drill.submit_initial(killed)
    try:
        drill.run(killed)
    except SimulatedPreemption as exc:
        done = sum(1 for h in killed.handles() if h.status() == "done")
        print(f"preempted after snapshot #{exc.ordinal} (step "
              f"{killed.steps}, {done}/{len(reference)} jobs done)")
    else:
        raise SystemExit("the fault plan never fired: raise --rounds or "
                         "lower --kill-at")
    killed._store.close()

    t0 = time.perf_counter()
    svc = FleetService.restore(CheckpointConfig(dir=ckpt_dir),
                               jobs=drill.raw_jobs(), device=device)
    restore_s = time.perf_counter() - t0
    by_status: dict = {}
    for h in svc.handles():
        by_status[h.status()] = by_status.get(h.status(), 0) + 1
    print(f"restored at step {svc.steps} in {restore_s:.4f} s: {by_status}")
    drill.run(svc)
    survivors = svc.handles()
    for h in survivors:
        same_result(h.result(), reference[h.job_id])
    svc._store.close()
    snaps = [(e["args"].get("bytes"), e["dur"])
             for e in obs_runtime.history(name="resilience.snapshot")
             if e["seq"] > seq0]
    print(f"all {len(survivors)} surviving handles bit-for-bit equal to "
          f"the uninterrupted run; snapshots (bytes, s): "
          f"{[(b, round(t, 4)) for b, t in snaps]}")
    return {"reference": reference, "service": svc, "survivors": survivors,
            "restore_s": restore_s, "snapshots": snaps}


def main(argv: Optional[list] = None) -> dict:
    """Run the scenarios (or, with ``--kill-at``, the drill); returns
    :func:`run_scenarios`' or :func:`run_drill`'s dict."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.kill_at is None:
        names = args.scenario or list_scenarios()
        return run_scenarios(names, args.seeds, args.rounds, args.chunk,
                             device)
    names = args.scenario or list_scenarios()[:DRILL_SCENARIOS]
    chunk = args.chunk if args.chunk is not None else 3
    with (contextlib.nullcontext(args.dir) if args.dir is not None
          else tempfile.TemporaryDirectory(prefix="fleet_service_")) as d:
        return run_drill(names, args.seeds, args.rounds, chunk,
                         args.kill_at, d, device)


if __name__ == "__main__":
    main()
