#!/usr/bin/env python3
"""One fleet lane against itself in buckets of other sizes, on the card.

    python3 scripts/torch_lane_solo.py [--rounds 12] [--device cuda]

Each of a set of the paper's grid cells (n = 17, f = 4, the 48-48-10 MLP)
runs alone for ``--rounds`` rounds in segments of 3: once as a 1-lane
``FleetRunner`` bucket ("solo") and once alone in a ``FleetService``
bucket of 2 and of 4 slots (the other slots empty).  Printed per cell and
bucket size: whether the per-round loss, direction_norm and final params
equal the solo run's bit for bit, else the largest relative difference;
and whether the 2- and 4-slot runs equal each other.  Then round 0's
pieces of one gm | nnm lane (client losses, client sends, the attacked
stack, the aggregate) computed in a bucket of 1 and of 3 lanes.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CELLS = ("gm|nnm|alie", "cwtm|nnm|alie", "krum|nnm|alie", "cwmed|nnm|sf",
         "baseline", "cwtm|bucketing|alie", "gm|None|foe",
         "krum|bucketing|mimic", "cwmed|None|lf", "gm|bucketing|sf")


def rel(a, b) -> float:
    return max((abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)),
               default=0.0)


def same(a, b) -> bool:
    return (a.history.loss == b.history.loss
            and a.history.direction_norm == b.history.direction_norm
            and all(torch.equal(x, y) for x, y in
                    zip(a.state["params"].values(),
                        b.state["params"].values())))


def round0_pieces(job, lanes: int, dev) -> dict:
    """Round 0 of ``job`` in lane 0 of a ``lanes``-lane bucket (the other
    lanes empty): client losses, sends, attacked stack, aggregate."""
    from torch.func import vmap
    from repro_torch.core import robust as robust_lib
    from repro_torch.core.attacks import apply_attack_batched
    from repro_torch.fed.clients import client_updates
    from repro_torch.fleet import init_lane_state, lane_filler, plan_lane_round
    from repro_torch.fleet.lanes import gather_lane_rows
    from repro_torch.fleet.runner import _OP_DTYPES, _pack_round, _to_device
    from repro_torch.rounds import stack_rounds
    from repro_torch.tree import tree_map
    cfg = job.cfg
    batch, cohort, ops, _ = plan_lane_round(job, 0,
                                            np.random.default_rng(job.seed))
    fb, fi, fo = lane_filler(job)
    k = lanes - 1
    plan = _to_device(stack_rounds([_pack_round(
        [batch] + [fb] * k, [cohort] + [fi] * k,
        {f: [ops[f]] + [fo[f]] * k for f in _OP_DTYPES})]), dev)
    state = tree_map(lambda *xs: torch.stack(xs),
                     *[init_lane_state(job, dev) for _ in range(lanes)])
    b = tree_map(lambda a: a[0], plan["batch"])
    o = {n: v[0] for n, v in plan["ops"].items()}
    mom = gather_lane_rows(state["momentum"], plan["idx"][0])
    clients = vmap(lambda p, m, bb, be, ll: client_updates(
        job.loss_fn, p, m, bb, cfg.client, beta=be, local_lr=ll))
    losses, sends, _ = clients(state["params"], mom, b, o["beta"],
                               o["local_lr"])
    att = apply_attack_batched(plan["attack_id"][0], sends, o["m_byz"],
                               etas=o["eta"], lane_ids=o["attack_id"])
    agg = robust_lib.batched_robust_aggregate(att, cfg.agg, o["f_agg"])
    return {"client losses": [losses[0]], "client sends": [s[0] for s in sends],
            "attacked stack": [s[0] for s in att],
            "aggregate": [s[0] for s in agg]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.fleet import FleetRunner
    from repro_torch.launch import grid
    from repro_torch.serving import FleetService
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    cells = {j.label: j for j in grid.build_jobs(full=True, alpha=0.1,
                                                 steps=args.rounds)}
    for label in CELLS:
        job = dataclasses.replace(cells[label], eval_every=3)
        solo = FleetRunner([job], chunk=3, device=dev).run()[0]
        res = {}
        for cap in (2, 4):
            svc = FleetService(max_lanes=cap, chunk=3, device=dev)
            res[cap] = svc.submit(job).result()
        line = []
        for cap, r in res.items():
            line.append(f"{cap} slots vs solo: " + (
                "bitwise" if same(r, solo) else
                f"loss {rel(r.history.loss, solo.history.loss):.1e}, "
                f"direction_norm {rel(r.history.direction_norm, solo.history.direction_norm):.1e}"))
        line.append("2 vs 4 slots: " + ("bitwise" if same(res[2], res[4])
                                         else "differ"))
        print(f"{label:22s} " + "; ".join(line), flush=True)
    job = cells["gm|nnm|alie"]
    one, three = round0_pieces(job, 1, dev), round0_pieces(job, 3, dev)
    for name in one:
        diffs = [float((a - b).abs().max()) for a, b in
                 zip(one[name], three[name])]
        print(f"round 0, gm|nnm|alie, 1 vs 3 lanes, {name}: " + (
            "bitwise" if max(diffs) == 0 else f"max abs diff {max(diffs):.3e}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
