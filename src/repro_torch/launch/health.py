"""Robustness health dashboard: watch an attack switch on in the taps
(counterpart of ``examples/health_dashboard.py``, with the same flags
and printout, plus ``--device``).

Runs one tapped federated scenario (``FedConfig(taps=True)``: quadratic
loss, 12 clients, cohorts of 8, f = 2, NNM + CWTM) whose adversary is
quiet for the first half of the run and sign-flips from round
``rounds // 2``, and prints the per-round health-tap columns.  The
switch shows in every column: ``dist_honest`` and ``byz_mix_mass``
move, ``cos_honest`` dips, the Byzantine rows' ``trim_frac`` saturates.
The taps ride the run's one metric transfer.  Afterwards the runtime
ring (segments, kernel dispatch records, counters) is exported as JSONL
and as a Chrome trace (Perfetto / ``chrome://tracing``).  Runs on CUDA
unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.health
  PYTHONPATH=src python -m repro_torch.launch.health --device cpu \\
      --rounds 6 --export-dir out/
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.core.types import AggregatorSpec
from repro_torch.device import resolve_device
from repro_torch.fed import (
    ClientConfig, FedConfig, FedServer, run_rounds, switch_attack,
)
from repro_torch.obs import runtime as obs_runtime
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant

N_CLIENTS, COHORT, F, DIM = 12, 8, 2, 6


def quad_loss(centers: torch.Tensor):
    """0.5 ||theta - c_i||^2 for the client ``i`` of the batch."""
    def loss_fn(params, batch):
        c = centers[batch["idx"].long()][0]
        return 0.5 * torch.sum((params["theta"] - c) ** 2), {}
    return loss_fn


def idx_batch_fn(cohort, n_flip, rng):
    return {"idx": np.asarray(cohort)[:, None, None]}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--eta", type=float, default=None,
                    help="sign-flip strength (attack default if omitted)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export-dir", default=None,
                    help="where to write the runtime trace (default: tmp)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Run, print and export; returns {"history", "columns", "switch",
    "jsonl", "chrome", "events", "server"}."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    switch = args.rounds // 2

    obs_runtime.reset()
    centers = torch.as_tensor(np.random.default_rng(0).normal(
        size=(N_CLIENTS, DIM)).astype(np.float32), device=device)
    cfg = FedConfig(n_clients=N_CLIENTS, clients_per_round=COHORT, f=F,
                    agg=AggregatorSpec(rule="cwtm", f=F, pre="nnm"),
                    client=ClientConfig(algorithm="dshb", beta=0.9),
                    taps=True)
    server = FedServer(quad_loss(centers), sgd(clip=1.0), cfg, constant(0.1),
                       device=device)
    state = server.init_state({"theta": torch.zeros(DIM)})
    schedule = switch_attack((0, "none"), (switch, "sf", args.eta)) \
        if args.eta is not None else \
        switch_attack((0, "none"), (switch, "sf"))
    state, hist = run_rounds(server, state, idx_batch_fn, args.rounds,
                             schedule=schedule, seed=args.seed)

    cols = hist.tap_columns()
    print(f"mixtrim (cwtm+nnm), cohort {COHORT}/{N_CLIENTS}, f={F}; "
          f"attack 'none' -> 'sf' at round {switch}\n")
    hdr = (f"{'r':>3} {'attack':>6} {'loss':>8} {'dist':>8} {'cos':>7} "
           f"{'byz_mix':>8} {'trim(byz)':>9} {'trim(hon)':>9}")
    print(hdr)
    print("-" * len(hdr))
    m_byz = F                       # honest-first stack: byz rows last
    for r in range(args.rounds):
        tf = cols["trim_frac"][r]
        line = (f"{r:>3} {hist.attack[r]:>6} {hist.loss[r]:8.4f} "
                f"{cols['dist_honest'][r]:8.4f} "
                f"{cols['cos_honest'][r]:7.3f} "
                f"{cols['byz_mix_mass'][r]:8.4f} "
                f"{tf[-m_byz:].mean():9.3f} {tf[:-m_byz].mean():9.3f}")
        print(line + ("   <-- attack on" if r == switch else ""))

    pre, post = slice(0, switch), slice(switch, args.rounds)
    print(f"\nphase means: dist {cols['dist_honest'][pre].mean():.4f} -> "
          f"{cols['dist_honest'][post].mean():.4f}, "
          f"byz_mix {cols['byz_mix_mass'][pre].mean():.4f} -> "
          f"{cols['byz_mix_mass'][post].mean():.4f}")

    out_dir = args.export_dir or tempfile.mkdtemp(prefix="repro_obs_")
    os.makedirs(out_dir, exist_ok=True)
    jl = os.path.join(out_dir, "run.jsonl")
    ct = os.path.join(out_dir, "trace.json")
    n_ev = obs_runtime.export_jsonl(jl)
    obs_runtime.export_chrome_trace(ct)
    rep = server.last_scan_report
    print(f"\nruntime: {rep['total_trace_count']} round program(s), "
          f"{n_ev} events -> {jl}")
    print(f"chrome trace (Perfetto / chrome://tracing) -> {ct}")
    return {"history": hist, "columns": cols, "switch": switch, "jsonl": jl,
            "chrome": ct, "events": n_ev, "server": server}


if __name__ == "__main__":
    main()
