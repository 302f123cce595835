"""The declarative scenario registry and its synthetic task (counterpart
of ``repro.fed.scenarios``).

A :class:`Scenario` fully determines a federated run: population and
participation, client computation, aggregation, the adversary (attack
schedule, identity rotation, data poisoning), the quarantine guard and
the data.  :func:`build_scenario` materialises one into a
:class:`~repro_torch.fed.server.FedServer`, its state, batch function and
eval; :func:`run_scenario` runs it end to end.  The fleet
(:mod:`repro_torch.fleet`) packs the same scenarios into lanes.

The task: a 10-class classification problem on 48-dimensional synthetic
features (standing in for MNIST), Dirichlet-heterogeneous shards, and a
48 -> 48 -> 10 ReLU MLP.  Its init draws from a ``torch.Generator`` seeded
with the job's seed; the reference draws from a JAX PRNG key, so the two
give different numbers for the same seed (``run_scenario(params=...)``
with ``repro_torch.interop.mlp_params_from_numpy`` carries the
reference's init across when both must start alike).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.types import AggregatorSpec
from repro_torch.data import build_heterogeneous, make_classification
from repro_torch.data.pipeline import (
    WorkerDataset, infer_n_classes, sample_worker_batch,
)
from repro_torch.fed.clients import ClientConfig
from repro_torch.fed.schedules import (
    AttackSchedule, FixedByzantine, RotatingByzantine, constant_attack,
    ramp_eta, switch_attack,
)
from repro_torch.fed.poison import PoisonConfig
from repro_torch.fed.server import FedConfig, FedServer, run_rounds
from repro_torch.optim import sgd
from repro_torch.optim.schedules import constant as constant_lr
from repro_torch.robustness.guard import QuarantineConfig
from repro_torch.rounds import RoundOptions

Tensor = torch.Tensor

#: The fleet's shared server optimizer: one OBJECT, since the optimizer
#: is bucket-key material (lanes of one bucket share its update).
SCENARIO_OPTIMIZER = sgd(clip=2.0)


# ---------------------------------------------------------------------------
# The synthetic task.
# ---------------------------------------------------------------------------

def _mlp_init(seed: Union[int, torch.Generator], din: int, h: int = 48,
              n_classes: int = 10, device=None) -> dict:
    """The MLP's parameters: w1 (din, h) and w2 (h, n_classes) normal with
    fan-in scaling, zero biases; fp32 on ``device`` (CPU by default)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    w1 = torch.randn((din, h), generator=gen) * (din ** -0.5)
    w2 = torch.randn((h, n_classes), generator=gen) * (h ** -0.5)
    params = {"w1": w1, "b1": torch.zeros(h), "w2": w2,
              "b2": torch.zeros(n_classes)}
    return {k: v.to(device) for k, v in params.items()} if device else params


def _mlp_loss(p: dict, b: dict) -> tuple[Tensor, dict]:
    """Mean cross-entropy of the ReLU MLP on one worker batch."""
    h = torch.relu(b["x"] @ p["w1"] + p["b1"])
    lp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
    return -torch.take_along_dim(lp, b["y"][:, None].long(), dim=1).mean(), {}


def _mlp_eval(xt: np.ndarray, yt: np.ndarray) -> Callable:
    """Test-accuracy closure of the MLP: ``acc(params)`` returns a 0-d
    tensor on the parameters' device (the test set moves there once)."""
    cache: dict = {}

    def acc(p: dict) -> Tensor:
        dev = p["w1"].device
        if dev not in cache:
            cache[dev] = (torch.as_tensor(np.asarray(xt), device=dev),
                          torch.as_tensor(np.asarray(yt), device=dev).long())
        x, y = cache[dev]
        h = torch.relu(x @ p["w1"] + p["b1"])
        return (torch.argmax(h @ p["w2"] + p["b2"], -1) == y).float().mean()

    return acc


def cohort_batch_fn(ds: WorkerDataset, batch_size: int, local_steps: int,
                    labels_key: str = "y") -> Callable:
    """``batch_fn(cohort_ids, n_flip, rng)`` over a sharded dataset: numpy
    leaves (m, L, batch, ...) with L = max(local_steps, 1); the LAST
    ``n_flip`` cohort rows get flipped labels (l -> C-1-l).  The same
    numpy calls as the reference, so the same batches."""
    n_slices = max(local_steps, 1)
    n_classes = infer_n_classes(ds, labels_key)

    def batch_fn(cohort_ids, n_flip, rng):
        m = len(cohort_ids)
        rows = [sample_worker_batch(ds, w, n_slices * batch_size, rng,
                                    flip=row >= m - n_flip,
                                    labels_key=labels_key,
                                    n_classes=n_classes)
                for row, w in enumerate(cohort_ids)]
        return {k: np.stack([r[k].reshape((n_slices, batch_size)
                                          + r[k].shape[1:]) for r in rows])
                for k in ds.arrays}

    return batch_fn


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything that determines a federated run, declaratively.
    ``poison`` is the data-poisoning threat model (:mod:`repro_torch.fed.poison`),
    ``guard`` the in-round quarantine (:mod:`repro_torch.robustness.guard`)."""
    name: str
    description: str
    n_clients: int = 17
    clients_per_round: int = 17
    f: int = 4
    local_steps: int = 0
    local_lr: float = 0.05
    algorithm: str = "dshb"
    beta: float = 0.9
    rule: str = "cwtm"
    pre: Optional[str] = "nnm"
    attack: AttackSchedule = constant_attack("none")
    rotate_byz_every: Optional[int] = None
    poison: Optional[PoisonConfig] = None
    guard: Optional[QuarantineConfig] = None
    alpha: float = 0.1
    batch_size: int = 16
    server_lr: float = 0.2
    rounds: int = 50

    def fed_config(self) -> FedConfig:
        return FedConfig(
            n_clients=self.n_clients,
            clients_per_round=self.clients_per_round,
            f=self.f,
            agg=AggregatorSpec(rule=self.rule, f=self.f, pre=self.pre),
            client=ClientConfig(local_steps=self.local_steps,
                                local_lr=self.local_lr,
                                algorithm=self.algorithm, beta=self.beta),
            poison=self.poison, guard=self.guard)

    def byz_identity(self):
        if self.rotate_byz_every is None:
            return FixedByzantine(self.n_clients, self.f)
        return RotatingByzantine(self.n_clients, self.f,
                                 period=self.rotate_byz_every)


SCENARIOS: dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def list_scenarios() -> list[str]:
    return sorted(SCENARIOS)


def build_scenario(scenario: Scenario, *, seed: int = 0, dim: int = 48,
                   n_samples: int = 9000, noise: float = 1.6,
                   params: Optional[dict] = None, device=None,
                   options: Optional[RoundOptions] = None):
    """Materialise a scenario: ``(server, state, batch_fn, eval_fn)``.

    The data are the reference's (the same numpy calls); the MLP starts
    from ``params`` when given (e.g. the reference's init carried across
    with ``repro_torch.interop.mlp_params_from_numpy``), else from the
    port's own init for ``seed``.  Runs on CUDA unless ``device="cpu"``;
    ``options`` go to the :class:`FedServer`."""
    x, y = make_classification(n_samples, 10, dim, noise=noise, seed=seed)
    split = (n_samples * 2) // 3
    ds = build_heterogeneous({"x": x[:split], "y": y[:split]}, "y",
                             scenario.n_clients, alpha=scenario.alpha,
                             seed=seed)
    xt, yt = x[split:], y[split:]

    server = FedServer(_mlp_loss, SCENARIO_OPTIMIZER, scenario.fed_config(),
                       constant_lr(scenario.server_lr), options,
                       device=device)
    state = server.init_state(params if params is not None
                              else _mlp_init(seed, dim))
    batch_fn = cohort_batch_fn(ds, scenario.batch_size, scenario.local_steps)
    return server, state, batch_fn, _mlp_eval(xt, yt)


def run_scenario(name: Union[str, Scenario], *, rounds: Optional[int] = None,
                 seed: int = 0, verbose: bool = False,
                 params: Optional[dict] = None, device=None,
                 options: Optional[RoundOptions] = None) -> dict:
    """End to end: registry name (or a Scenario) -> trained state and
    diagnostics ``{"scenario", "server", "state", "history", "accuracy",
    "summary"}``."""
    sc = get_scenario(name) if isinstance(name, str) else name
    server, state, batch_fn, eval_fn = build_scenario(
        sc, seed=seed, params=params, device=device, options=options)
    state, hist = run_rounds(server, state, batch_fn,
                             rounds if rounds is not None else sc.rounds,
                             schedule=sc.attack,
                             byz_identity=sc.byz_identity(), seed=seed)
    out = {"scenario": sc, "server": server, "state": state,
           "history": hist, "accuracy": float(eval_fn(state["params"])),
           "summary": hist.summary()}
    if verbose:
        print(f"[{sc.name}] acc={out['accuracy']:.3f} {out['summary']}")
    return out


# ---------------------------------------------------------------------------
# Built-in scenarios (the reference's, field for field).
# ---------------------------------------------------------------------------

register(Scenario(
    name="iid_baseline",
    description="No adversary, near-IID shards, plain averaging — the "
                "accuracy ceiling every robust scenario is judged against.",
    n_clients=17, clients_per_round=17, f=0,
    rule="average", pre=None, attack=constant_attack("none"),
    alpha=10.0, rounds=50))

register(Scenario(
    name="labelskew_alie_partial",
    description="Extreme label skew (Dirichlet 0.1) + ALIE under partial "
                "participation: 12 of 20 clients per round, f rescaled to "
                "the cohort.",
    n_clients=20, clients_per_round=12, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("alie", eta=8.0),
    alpha=0.1, rounds=60))

register(Scenario(
    name="mimic_rotating",
    description="Mimic attack with a Byzantine identity set that rotates "
                "every 5 rounds — freshly-turned clients carry honest "
                "momentum, the hard case for server-side filtering.",
    n_clients=17, clients_per_round=17, f=4,
    rule="gm", pre="nnm",
    attack=constant_attack("mimic"), rotate_byz_every=5,
    alpha=0.5, rounds=60))

register(Scenario(
    name="dirichlet_localsgd",
    description="Local SGD (4 client steps/round) over Dirichlet-0.3 "
                "shards with 10/20 participation; the adversary switches "
                "family ALIE -> FOE at round 25.",
    n_clients=20, clients_per_round=10, f=3,
    local_steps=4, local_lr=0.1,
    rule="cwtm", pre="nnm",
    attack=switch_attack((0, "alie", 8.0), (25, "foe", 20.0)),
    alpha=0.3, rounds=60))

register(Scenario(
    name="foe_ramp",
    description="FOE whose eta ramps 0.5 -> 20 over 40 rounds (no "
                "recompilation: eta is a traced scalar), NNM+CWTM defense.",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=ramp_eta("foe", 0.5, 20.0, 40),
    alpha=0.3, rounds=60))

register(Scenario(
    name="poison_labelflip",
    description="Data poisoning, label-flip flavor: Byzantine clients "
                "train honestly on batches whose labels are flipped at a "
                "60% rate device-side — corruption enters through the "
                "data pipeline, the strictly weaker threat model of "
                "Farhadkhani et al.",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("none"),
    poison=PoisonConfig(kind="labelflip", rate=0.6),
    alpha=0.3, rounds=60))

register(Scenario(
    name="poison_feature",
    description="Feature-perturbation poisoning: Gaussian noise at 2x "
                "data scale on half of each Byzantine client's samples, "
                "defended by NNM+AutoGM (adaptive weights downweight the "
                "inflated-gradient clients).",
    n_clients=17, clients_per_round=17, f=4,
    rule="autogm", pre="nnm",
    attack=constant_attack("none"),
    poison=PoisonConfig(kind="feature", rate=0.5, strength=2.0),
    alpha=0.3, rounds=60))

register(Scenario(
    name="faulty_nan_quarantine",
    description="Non-adversarial fault model: f workers emit NaN updates "
                "every round; the in-round quarantine guard replaces them "
                "with the kept-row median so the run degrades gracefully "
                "instead of destroying every round.",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("nan"),
    guard=QuarantineConfig(),
    alpha=0.3, rounds=50))

register(Scenario(
    name="labelflip_partial",
    description="Label-flip adversary (honest computation on flipped "
                "labels, injected through the data pipeline) under 13/20 "
                "participation.",
    n_clients=20, clients_per_round=13, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("lf"),
    alpha=0.3, rounds=60))
