"""Paper Table 2 in miniature on the fleet: aggregation x pre-aggregation x
attack under extreme heterogeneity (Dirichlet alpha = 0.1), n = 17,
f = 4, D-SHB with beta = 0.9 (counterpart of
``examples/byzantine_classification.py``).

Every (rule, pre) pair is one fleet shape bucket whose attack lanes train
together; the f = 0 ``average`` baseline is a bucket of its own.  Runs on
CUDA unless ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.grid [--full] [--alpha A]
      [--rounds R] [--device cpu]

``--full`` runs the paper's grid (rules cwtm, gm, krum, cwmed; attacks
alie, foe, sf, lf, mimic: 61 jobs in 13 buckets) for 300 rounds; without
it, cwtm and gm against alie, foe and lf for 100 rounds.  ``--rounds``
overrides the round count.
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.core.bucketing import default_bucket_size
from repro_torch.core.types import AggregatorSpec
from repro_torch.data import build_heterogeneous, make_classification
from repro_torch.fed import ClientConfig, FedConfig, constant_attack
from repro_torch.fed.scenarios import (
    SCENARIO_OPTIMIZER, _mlp_eval, _mlp_init, _mlp_loss, cohort_batch_fn,
)
from repro_torch.fleet import FleetJob, FleetRunner

N_WORKERS, F = 17, 4
PRES = (None, "bucketing", "nnm")


def _make_task(seed=0, dim=48, hard=True):
    """The synthetic 10-class task of the reference's accuracy grid (the
    same numpy calls): 6000 training and 3000 test samples."""
    x, y = make_classification(9000, 10, dim, noise=1.6 if hard else 1.0,
                               seed=seed)
    return (x[:6000], y[:6000]), (x[6000:], y[6000:])


def _grid_jobs(train, test, *, alpha, steps, seed=1, params=None,
               backend: str = "auto"):
    """A ``cell(label, rule, pre, attack, f)`` factory: one FleetJob per
    grid cell, sharing data / loss / optimizer objects so the cells of one
    (rule, pre) pack into one bucket.  ``params`` overrides the MLP init
    (the reference's, carried across, in the parity tests)."""
    (x, y), (xt, yt) = train, test
    ds = build_heterogeneous({"x": x, "y": y}, "y", N_WORKERS, alpha=alpha,
                             seed=seed)
    batch_fn = cohort_batch_fn(ds, 25, 0)
    every = max(steps // 3, 1)
    acc = _mlp_eval(xt, yt)
    init = params if params is not None else _mlp_init(seed, x.shape[1])

    def cell(label, rule, pre, attack, f):
        spec = AggregatorSpec(
            rule=rule, f=f, pre=pre, backend=backend,
            bucket_size=default_bucket_size(N_WORKERS, f)
            if pre == "bucketing" else None)
        cfg = FedConfig(n_clients=N_WORKERS, clients_per_round=N_WORKERS,
                        f=f, agg=spec,
                        client=ClientConfig(algorithm="dshb", beta=0.9))
        eta = 8.0 if attack in ("alie", "foe") else None
        return FleetJob(
            label=label, cfg=cfg, loss_fn=_mlp_loss,
            optimizer=SCENARIO_OPTIMIZER, params=init,
            batch_fn=batch_fn, rounds=steps, seed=seed,
            schedule=constant_attack(attack, eta),
            lr_fn=lambda r: 0.5 / (1.0 + r // every),
            eval_fn=acc, eval_every=max(steps // 8, 1))
    return cell


def grid(full: bool) -> tuple[tuple, tuple]:
    """(rules, attacks) of the grid."""
    rules = ("cwtm", "gm", "krum", "cwmed") if full else ("cwtm", "gm")
    attacks = ("alie", "foe", "sf", "lf", "mimic") if full \
        else ("alie", "foe", "lf")
    return rules, attacks


def build_jobs(*, full: bool, alpha: float, steps: int, params=None,
               backend: str = "auto") -> list:
    """The grid's jobs: the f = 0 baseline first, then rule x pre x
    attack."""
    rules, attacks = grid(full)
    train, test = _make_task()
    cell = _grid_jobs(train, test, alpha=alpha, steps=steps, params=params,
                      backend=backend)
    jobs = [cell("baseline", "average", None, "none", 0)]
    for rule in rules:
        for pre in PRES:
            for attack in attacks:
                jobs.append(cell(f"{rule}|{pre}|{attack}", rule, pre,
                                 attack, F))
    return jobs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--alpha", type=float, default=0.1)
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per job (default 300 with --full, else 100)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Optional[list] = None) -> dict:
    """Run the grid and print the reference example's table; returns
    {"results", "runner", "table"} (``table``: label -> best accuracy)."""
    args = build_parser().parse_args(argv)
    steps = args.rounds if args.rounds is not None else \
        (300 if args.full else 100)
    rules, attacks = grid(args.full)
    runner = FleetRunner(build_jobs(full=args.full, alpha=args.alpha,
                                    steps=steps), device=args.device)
    res = runner.run()
    results = {r.label: r.best_eval for r in res}

    print(f"baseline D-SHB (f=0): {results['baseline']:.3f}   "
          f"[{runner.n_buckets} shape buckets, "
          f"{runner.trace_count} round programs]\n")
    header = f"{'rule':8s} {'pre':10s} " + \
        "  ".join(f"{a:>6s}" for a in attacks) + "   worst"
    print(header)
    for rule in rules:
        for pre in PRES:
            accs = [results[f"{rule}|{pre}|{a}"] for a in attacks]
            print(f"{rule:8s} {str(pre):10s} " +
                  "  ".join(f"{a:6.3f}" for a in accs) +
                  f"  {min(accs):6.3f}")
        print()
    return {"results": res, "runner": runner, "table": results}


if __name__ == "__main__":
    main()
