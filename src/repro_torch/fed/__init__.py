"""Federated scenario engine of the port (counterpart of ``repro.fed``):
clients, attack schedules, data poisoning, the server (``FedServer`` /
``run_rounds``), histories, and the declarative scenario registry
(``build_scenario`` / ``run_scenario``)."""
from repro_torch.fed.clients import (
    ClientConfig, client_updates, gather_rows, init_client_momentum,
    scatter_rows,
)
from repro_torch.fed.metrics import FedHistory, kappa_hat
from repro_torch.fed.poison import (
    POISON_KINDS, PoisonConfig, poison_batch, poison_batch_lanes,
)
from repro_torch.fed.schedules import (
    AttackPhase, AttackSchedule, FixedByzantine, RotatingByzantine,
    constant_attack, ramp_eta, switch_attack,
)
from repro_torch.fed.scenarios import (
    SCENARIO_OPTIMIZER, SCENARIOS, Scenario, build_scenario,
    cohort_batch_fn, get_scenario, list_scenarios, register, run_scenario,
)
from repro_torch.fed.server import (
    FedConfig, FedServer, cohort_breakdown, rescale_f, run_rounds,
    sample_cohort,
)

__all__ = [
    "ClientConfig", "client_updates", "gather_rows", "init_client_momentum",
    "scatter_rows", "FedHistory", "kappa_hat",
    "POISON_KINDS", "PoisonConfig", "poison_batch", "poison_batch_lanes",
    "AttackPhase",
    "AttackSchedule", "FixedByzantine", "RotatingByzantine",
    "constant_attack", "ramp_eta", "switch_attack", "SCENARIO_OPTIMIZER",
    "SCENARIOS", "Scenario", "build_scenario", "cohort_batch_fn",
    "get_scenario", "list_scenarios", "register", "run_scenario",
    "FedConfig", "FedServer", "cohort_breakdown", "rescale_f", "run_rounds",
    "sample_cohort",
]
