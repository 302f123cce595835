"""Multi-tenant fleet engine: B federated scenarios stepped together per
shape bucket (counterpart of ``repro.fleet``; the continuous service is
not ported yet, ROADMAP queue 1, item 12)."""
from repro_torch.fleet.lanes import (
    LANE_OP_FIELDS, build_fleet_round, build_fleet_scan, build_lane_round,
)
from repro_torch.fleet.runner import (
    FleetJob, FleetResult, FleetRunner, LaneBucket, ScenarioSpec,
    apply_job_options, bucket_key, init_lane_state, job_from_spec,
    lane_filler, plan_lane_round, run_fleet,
)
from repro_torch.fed.scenarios import SCENARIO_OPTIMIZER

__all__ = [
    "LANE_OP_FIELDS", "build_fleet_round", "build_fleet_scan",
    "build_lane_round", "FleetJob", "FleetResult", "FleetRunner",
    "LaneBucket", "SCENARIO_OPTIMIZER", "ScenarioSpec", "apply_job_options",
    "bucket_key", "init_lane_state", "job_from_spec", "lane_filler",
    "plan_lane_round", "run_fleet",
]
