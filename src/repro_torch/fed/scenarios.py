"""The fleet's synthetic task and the declarative scenario registry
(counterpart of the parts of ``repro.fed.scenarios`` the fleet needs).

The task: a 10-class classification problem on 48-dimensional synthetic
features (standing in for MNIST), Dirichlet-heterogeneous shards, and a
48 -> 48 -> 10 ReLU MLP.  Its init draws from a ``torch.Generator`` seeded
with the job's seed; the reference draws from a JAX PRNG key, so the two
give different numbers for the same seed (``repro_torch.interop`` carries
the reference's init across when both must start alike).

``Scenario`` / ``register`` / ``get_scenario`` mirror the registry and its
built-ins.  ``build_scenario`` / ``run_scenario`` (the single-scenario fed
engine) wait for ``FedServer`` (ROADMAP queue 1, item 7); the built-ins
that poison data or guard the round raise when materialised, naming their
ROADMAP items.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.types import AggregatorSpec
from repro_torch.data.pipeline import (
    WorkerDataset, infer_n_classes, sample_worker_batch,
)
from repro_torch.fed.clients import ClientConfig
from repro_torch.fed.schedules import (
    AttackSchedule, FixedByzantine, RotatingByzantine, constant_attack,
    ramp_eta, switch_attack,
)
from repro_torch.fed.server import FedConfig
from repro_torch.optim import sgd

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
    ``poison`` / ``guard`` describe the data-poisoning threat model and
    the in-round quarantine (their ports are ROADMAP items 7 and 10)."""
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
    poison: Optional[Any] = None
    guard: Optional[Any] = None
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


register(Scenario(
    name="iid_baseline",
    description="No adversary, near-IID shards, plain averaging.",
    n_clients=17, clients_per_round=17, f=0,
    rule="average", pre=None, attack=constant_attack("none"),
    alpha=10.0, rounds=50))

register(Scenario(
    name="labelskew_alie_partial",
    description="Extreme label skew (Dirichlet 0.1) + ALIE under partial "
                "participation: 12 of 20 clients per round.",
    n_clients=20, clients_per_round=12, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("alie", eta=8.0),
    alpha=0.1, rounds=60))

register(Scenario(
    name="mimic_rotating",
    description="Mimic attack with a Byzantine identity set that rotates "
                "every 5 rounds.",
    n_clients=17, clients_per_round=17, f=4,
    rule="gm", pre="nnm",
    attack=constant_attack("mimic"), rotate_byz_every=5,
    alpha=0.5, rounds=60))

register(Scenario(
    name="dirichlet_localsgd",
    description="Local SGD (4 client steps/round), 10/20 participation; "
                "ALIE -> FOE at round 25.",
    n_clients=20, clients_per_round=10, f=3,
    local_steps=4, local_lr=0.1,
    rule="cwtm", pre="nnm",
    attack=switch_attack((0, "alie", 8.0), (25, "foe", 20.0)),
    alpha=0.3, rounds=60))

register(Scenario(
    name="foe_ramp",
    description="FOE whose eta ramps 0.5 -> 20 over 40 rounds, NNM+CWTM.",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=ramp_eta("foe", 0.5, 20.0, 40),
    alpha=0.3, rounds=60))

register(Scenario(
    name="poison_labelflip",
    description="Data poisoning, label-flip flavour (60% rate).",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("none"),
    poison={"kind": "labelflip", "rate": 0.6},
    alpha=0.3, rounds=60))

register(Scenario(
    name="poison_feature",
    description="Feature-perturbation poisoning, NNM+AutoGM.",
    n_clients=17, clients_per_round=17, f=4,
    rule="autogm", pre="nnm",
    attack=constant_attack("none"),
    poison={"kind": "feature", "rate": 0.5, "strength": 2.0},
    alpha=0.3, rounds=60))

register(Scenario(
    name="faulty_nan_quarantine",
    description="f workers emit NaN updates; the in-round quarantine guard "
                "replaces them.",
    n_clients=17, clients_per_round=17, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("nan"),
    guard={"kind": "quarantine"},
    alpha=0.3, rounds=50))

register(Scenario(
    name="labelflip_partial",
    description="Label-flip adversary under 13/20 participation.",
    n_clients=20, clients_per_round=13, f=4,
    rule="cwtm", pre="nnm",
    attack=constant_attack("lf"),
    alpha=0.3, rounds=60))
