"""Federated pieces of the port (counterpart of ``repro.fed``): clients,
schedules, the server's host part, histories, and the fleet's task and
scenario registry.  ``FedServer`` / ``run_rounds`` and data poisoning are
not ported yet (ROADMAP queue 1, item 7)."""
from repro_torch.fed.clients import (
    ClientConfig, client_updates, gather_rows, init_client_momentum,
    scatter_rows,
)
from repro_torch.fed.metrics import FedHistory, kappa_hat
from repro_torch.fed.schedules import (
    AttackPhase, AttackSchedule, FixedByzantine, RotatingByzantine,
    constant_attack, ramp_eta, switch_attack,
)
from repro_torch.fed.scenarios import (
    SCENARIO_OPTIMIZER, SCENARIOS, Scenario, cohort_batch_fn, get_scenario,
    list_scenarios, register,
)
from repro_torch.fed.server import (
    FedConfig, cohort_breakdown, rescale_f, sample_cohort,
)

__all__ = [
    "ClientConfig", "client_updates", "gather_rows", "init_client_momentum",
    "scatter_rows", "FedHistory", "kappa_hat", "AttackPhase",
    "AttackSchedule", "FixedByzantine", "RotatingByzantine",
    "constant_attack", "ramp_eta", "switch_attack", "SCENARIO_OPTIMIZER",
    "SCENARIOS", "Scenario", "cohort_batch_fn", "get_scenario",
    "list_scenarios", "register", "FedConfig", "cohort_breakdown",
    "rescale_f", "sample_cohort",
]
