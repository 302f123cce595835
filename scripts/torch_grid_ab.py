#!/usr/bin/env python3
"""Compare the fleet grid's ms per bucket-round of two checkouts on one
CUDA card, in turns: A, B, B, A.

    python3 scripts/torch_grid_ab.py PATH_A PATH_B [--rounds 100]

Each PATH is the root of a checkout (its ``src/`` holds ``repro_torch``).
Both checkouts' kernels are built first, in parallel; then each run is a
fresh process that runs ``repro_torch.launch.grid --full`` from its
checkout and reports, from ``FleetRunner.segment_log`` (host clock around
each segment, ending in its metric transfer), the median over buckets of
each bucket's median ms per bucket-round, and the grid's seconds.  Prints
one JSON line per run, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def child(tree: Path, rounds: int, build_only: bool) -> None:
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import _build
    _build.library()
    if build_only:
        return
    from repro_torch.launch import grid
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = grid.main(["--full", "--device", "cuda", "--rounds", str(rounds)])
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    per = {}
    for bi, _, nr, sec in out["runner"].segment_log:
        per.setdefault(bi, []).append(1e3 * sec / nr)
    meds = [statistics.median(v) for v in per.values()]
    print(json.dumps({"tree": str(tree), "seconds": wall,
                      "ms_per_bucket_round": statistics.median(meds),
                      "per_bucket": meds}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child is not None:
        child(a.child.resolve(), a.rounds, a.build_only)
        return 0
    if len(a.trees) != 2:
        ap.error("give two checkouts, A and B")
    me = str(Path(__file__).resolve())
    trees = [t.resolve() for t in a.trees]
    builds = [subprocess.Popen([sys.executable, me, "--child", str(t),
                                "--build-only"]) for t in trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    for t in (trees[0], trees[1], trees[1], trees[0]):
        r = subprocess.run([sys.executable, me, "--child", str(t), "--rounds",
                            str(a.rounds)], capture_output=True, text=True)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
