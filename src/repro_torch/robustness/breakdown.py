"""Breakdown-frontier sweeps (counterpart of ``repro.robustness.breakdown``):
push f/n toward each rule's theoretical breakdown point and record where
training empirically collapses.

* grid = rule x attack family x ``f`` rising toward ``(n-1)//2``, with a
  clean ``f=0`` lane per rule as the collapse reference and plain
  averaging (predicted frontier 0) as the undefended control;
* every lane is a :class:`repro_torch.fleet.ScenarioSpec` on ONE
  :class:`~repro_torch.fleet.FleetRunner`: f, attack family, eta and the
  poison rate are per-lane operands, so only rule / pre and the poison
  kind split buckets (the NNM-CWTM rows run K5 + K4 a bucket-round, the
  gram-rule rows K5 + K3 per lane on a CUDA device);
* a cell is COLLAPSED when its final-window mean loss is non-finite or
  exceeds ``collapse_factor`` x the rule's clean-lane window;
* the frontier of (rule, attack) is the largest ``f`` with every
  ``f' <= f`` non-collapsed, reported beside
  :func:`repro_torch.core.theory.max_tolerable_f`.

The report's keys are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.theory import max_tolerable_f
from repro_torch.fed.poison import PoisonConfig
from repro_torch.fed.scenarios import Scenario
from repro_torch.fed.schedules import constant_attack
from repro_torch.fleet.runner import FleetRunner, ScenarioSpec, job_from_spec
from repro_torch.rounds import RoundOptions


@dataclasses.dataclass(frozen=True)
class BreakdownAttack:
    """One column of the breakdown grid: a gradient attack OR a poisoning.

    ``attack`` / ``eta`` name a fleet-runnable family
    (``DYN_ATTACK_FAMILIES``); ``poison`` instead corrupts the Byzantine
    clients' data while they compute honestly."""
    name: str
    attack: str = "none"
    eta: Optional[float] = None
    poison: Optional[PoisonConfig] = None

    def __post_init__(self):
        if self.poison is not None and self.attack != "none":
            raise ValueError(
                "a BreakdownAttack is either a gradient attack or a "
                f"poisoning, not both ({self.name!r})")


#: The default attack grid: sign flip, ALIE, FOE and full-rate label-flip
#: poisoning (the reference's).
DEFAULT_ATTACKS = (
    BreakdownAttack("sf", attack="sf"),
    BreakdownAttack("alie", attack="alie", eta=8.0),
    BreakdownAttack("foe", attack="foe", eta=20.0),
    BreakdownAttack("poison_lf",
                    poison=PoisonConfig(kind="labelflip", rate=1.0)),
)

#: (rule, pre) rows: the NNM-composed zoo the paper certifies, plus plain
#: averaging as the undefended control (predicted frontier 0).
DEFAULT_RULES = (
    ("cwtm", "nnm"),
    ("krum", "nnm"),
    ("gm", "nnm"),
    ("autogm", "nnm"),
    ("average", None),
)


#: The lanes' Dirichlet label skew, batch size and server step, and the
#: final window of rounds whose mean loss a cell is judged by (the
#: reference's defaults).
ALPHA = 0.3
BATCH_SIZE = 16
SERVER_LR = 0.2
WINDOW = 4


def _rule_key(rule: str, pre: Optional[str]) -> str:
    return f"{pre or 'none'}-{rule}"


def _lane_scenario(rule: str, pre: Optional[str], f: int,
                   att: Optional[BreakdownAttack], *, n: int,
                   rounds: int) -> Scenario:
    return Scenario(
        name=f"bd-{_rule_key(rule, pre)}-{att.name if att else 'clean'}-f{f}",
        description="breakdown-frontier sweep lane",
        n_clients=n, clients_per_round=n, f=f,
        rule=rule, pre=pre,
        attack=constant_attack(att.attack, eta=att.eta) if att is not None
        else constant_attack("none"),
        poison=att.poison if att is not None else None,
        alpha=ALPHA, batch_size=BATCH_SIZE,
        server_lr=SERVER_LR, rounds=rounds)


def run_breakdown(rules: Sequence[tuple] = DEFAULT_RULES,
                  attacks: Sequence[BreakdownAttack] = DEFAULT_ATTACKS, *,
                  n_clients: int = 10, fs: Optional[Sequence[int]] = None,
                  rounds: int = 12, seed: int = 0,
                  collapse_factor: float = 2.0,
                  params: Optional[dict] = None, device=None,
                  options: Optional[RoundOptions] = None) -> dict:
    """Run the full grid as one fleet and return the frontier report.

    Returns a dict with ``cells`` (``{"<pre>-<rule>|<attack>": {"losses":
    {f: window mean}, "collapsed": {f: bool}, "frontier": int}}``),
    ``frontier`` (``{cell_key: empirical f*}``), ``predicted`` (``{rule_key:
    theory f*}``), ``baseline_loss`` (per rule_key, the clean lane's
    window mean), ``trace_count`` / ``n_buckets`` (the fleet's round
    programs and shape buckets), and the sweep's settings.

    ``params``: every lane's initial MLP parameters (e.g. the reference's
    init carried across with ``repro_torch.interop``), else the port's own
    init for ``seed``.  ``device`` / ``options`` go to the
    :class:`FleetRunner` (CUDA unless ``device="cpu"``)."""
    fmax = (n_clients - 1) // 2
    fs = tuple(fs) if fs is not None else tuple(range(1, fmax + 1))
    if any(f <= 0 or f > fmax for f in fs):
        raise ValueError(f"fs must be in [1, {fmax}], got {fs}")
    fs = tuple(sorted(fs))

    jobs, tags = [], []

    def add(rule, pre, f, att):
        rk = _rule_key(rule, pre)
        sc = _lane_scenario(rule, pre, f, att, n=n_clients, rounds=rounds)
        label = f"{rk}|{att.name if att else 'clean'}|f{f}"
        job = job_from_spec(ScenarioSpec(scenario=sc, seed=seed, label=label))
        jobs.append(job if params is None
                    else dataclasses.replace(job, params=params))
        tags.append((rk, att.name if att else None, f))

    for rule, pre in rules:
        add(rule, pre, 0, None)                 # collapse reference lane
        for att in attacks:
            for f in fs:
                add(rule, pre, f, att)

    runner = FleetRunner(jobs, options=options, device=device)
    results = runner.run()

    base_loss: dict[str, float] = {}
    cell_losses: dict[tuple, dict[int, float]] = {}
    for (rk, att_name, f), res in zip(tags, results):
        w = res.history.loss[-min(WINDOW, len(res.history.loss)):]
        m = float(np.mean(w))
        if att_name is None:
            base_loss[rk] = m
        else:
            cell_losses.setdefault((rk, att_name), {})[f] = m

    cells: dict[str, dict] = {}
    frontier: dict[str, int] = {}
    for (rk, att_name), losses in cell_losses.items():
        ref = base_loss[rk]
        collapsed = {f: (not np.isfinite(losses[f]))
                     or losses[f] > collapse_factor * ref for f in fs}
        front = 0
        for f in fs:
            if collapsed[f]:
                break
            front = f
        key = f"{rk}|{att_name}"
        cells[key] = {"losses": {int(f): losses[f] for f in fs},
                      "collapsed": {int(f): bool(collapsed[f]) for f in fs},
                      "frontier": front}
        frontier[key] = front

    predicted = {_rule_key(rule, pre): max_tolerable_f(rule, n_clients,
                                                       pre=pre)
                 for rule, pre in rules}
    return {"n_clients": n_clients, "fs": [int(f) for f in fs],
            "rounds": rounds, "seed": seed,
            "collapse_factor": collapse_factor, "window": WINDOW,
            "cells": cells, "frontier": frontier, "predicted": predicted,
            "baseline_loss": base_loss,
            "trace_count": runner.trace_count,
            "n_buckets": runner.n_buckets}


def frontier_table(report: dict) -> str:
    """Human-readable frontier grid (rules x attacks, ``emp/theory``)."""
    rks = sorted(report["predicted"])
    atts = sorted({k.split("|", 1)[1] for k in report["frontier"]})
    widths = [max(len("rule"), *(len(r) for r in rks))]
    header = "rule".ljust(widths[0])
    for a in atts:
        header += f"  {a:>10s}"
    lines = [header, "-" * len(header)]
    for rk in rks:
        row = rk.ljust(widths[0])
        for a in atts:
            emp = report["frontier"].get(f"{rk}|{a}")
            cell = "-" if emp is None else f"{emp}/{report['predicted'][rk]}"
            row += f"  {cell:>10s}"
        lines.append(row)
    return "\n".join(lines)
