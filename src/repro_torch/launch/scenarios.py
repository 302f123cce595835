"""Federated scenario demo: named scenarios end to end (counterpart of
``examples/federated_scenarios.py``, with the same printout).

Runs partial participation + ALIE, rotating-identity Mimic, and local SGD
with a mid-training attack switch, each against the ``iid_baseline``
accuracy ceiling.  Runs on CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.scenarios [--full]
  PYTHONPATH=src python -m repro_torch.launch.scenarios --list
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenario foe_ramp
  PYTHONPATH=src python -m repro_torch.launch.scenarios --device cpu --rounds 2

Without ``--full`` or ``--rounds`` each scenario runs 20 rounds.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.fed import get_scenario, list_scenarios, run_scenario

DEMO = ("labelskew_alie_partial", "mimic_rotating", "dirichlet_localsgd")


def show(name: str, rounds: Optional[int], seed: int, device) -> dict:
    """Run one scenario and print its line; returns run_scenario's dict."""
    sc = get_scenario(name)
    out = run_scenario(name, rounds=rounds, seed=seed, device=device)
    hist = out["history"]
    counts = hist.participation_counts(sc.n_clients)
    segs = ", ".join(f"{a}@r{s}" for a, s, _ in hist.attack_segments())
    kappa = f"{np.mean(hist.kappa_hat):.3f}" if hist.kappa_hat else "-"
    final_loss = hist.loss[-1] if hist.loss else float("nan")
    print(f"{name:24s} acc={out['accuracy']:.3f} "
          f"loss={final_loss:6.3f} kappa^={kappa} "
          f"part={counts.min()}-{counts.max()}/{hist.rounds} "
          f"attacks=[{segs}]")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="run each scenario's full configured round count")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--scenario", action="append", default=None,
                    help="run specific scenario(s) instead of the demo trio")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Run the ceiling and the scenarios; returns {name: run_scenario's
    dict} (empty with ``--list``)."""
    args = build_parser().parse_args(argv)
    if args.list:
        for name in list_scenarios():
            sc = get_scenario(name)
            print(f"{name:24s} n={sc.n_clients:3d} m={sc.clients_per_round:3d} "
                  f"f={sc.f} K={sc.local_steps} {sc.rule}"
                  f"{'+' + sc.pre if sc.pre else ''}  {sc.description}")
        return {}
    device = resolve_device(args.device)
    rounds = args.rounds if args.rounds is not None else \
        (None if args.full else 20)
    names = args.scenario or DEMO

    print("ceiling:")
    outs = {"iid_baseline": show("iid_baseline", rounds, args.seed, device)}
    print("\nscenarios:")
    for n in names:
        outs[n] = show(n, rounds, args.seed, device)
    base = outs["iid_baseline"]["accuracy"]
    worst = min(outs[n]["accuracy"] for n in names)
    print(f"\nbaseline={base:.3f}  worst-scenario gap={base - worst:.3f}")
    return outs


if __name__ == "__main__":
    main()
