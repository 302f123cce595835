"""Breakdown-frontier sweep: where does each rule x attack pair collapse?
(counterpart of ``examples/breakdown_frontier.py``, with the same flags
and printout, plus ``--device``).

Pushes the Byzantine budget f toward the theoretical breakdown point
(n-1)//2 for every (rule, pre) x attack combination, vector attacks and
a data-poisoning column, and prints the empirical frontier beside the
theoretical one.  The default grid (5 rule rows x 4 attacks x f = 1..4
plus clean controls = 85 lanes) rides one FleetRunner.  Runs on CUDA
unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.breakdown
  PYTHONPATH=src python -m repro_torch.launch.breakdown --device cpu --rounds 6
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch.device import resolve_device
from repro_torch.robustness.breakdown import frontier_table, run_breakdown


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10, help="clients per lane")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--collapse-factor", type=float, default=2.0,
                    help="collapse = window loss > factor x clean lane's")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Run the sweep and print it; returns the report, with the sweep's
    host-clock seconds under ``"seconds"``."""
    args = build_parser().parse_args(argv)
    t0 = time.time()
    report = run_breakdown(n_clients=args.n, rounds=args.rounds,
                           collapse_factor=args.collapse_factor,
                           device=resolve_device(args.device))
    wall = time.time() - t0

    n_lanes = len(report["cells"]) and sum(
        len(c["losses"]) + 1 for c in report["cells"].values())
    print(f"swept {len(report['cells'])} cells ({n_lanes} lanes) in "
          f"{wall:.1f}s — {report['n_buckets']} buckets, "
          f"{report['trace_count']} compiles\n")

    print("empirical / theoretical frontier (max tolerated f):\n")
    print(frontier_table(report))

    print("\nper-cell window-mean losses (f=1..):")
    for key in sorted(report["cells"]):
        cell = report["cells"][key]
        clean = report["baseline_loss"][key.split("|", 1)[0]]
        losses = "  ".join(f"{v:8.3f}" for v in cell["losses"].values())
        marks = "".join("x" if cell["collapsed"][f] else "."
                        for f in sorted(cell["collapsed"]))
        print(f"  {key:24s} clean={clean:7.3f}  {losses}  [{marks}]")
    print("\n(x = collapsed; the undefended average row collapsing while "
          "every NNM row holds (n-1)//2 is the paper's claim, measured)")
    return dict(report, seconds=wall)


if __name__ == "__main__":
    main()
