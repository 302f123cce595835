"""Multi-tenant fleet engine: B federated scenarios stepped together per
shape bucket, run to completion (``FleetRunner``) or continuously, with
jobs admitted and evicted at segment boundaries (``ContinuousBucket``,
which :class:`repro_torch.serving.FleetService` drives).  Counterpart of
``repro.fleet``; lanes may be poisoned, guarded, tapped or hierarchical
(``agg.hier`` with an explicit ``bucket_size``)."""
from repro_torch.fleet.lanes import (
    LANE_OP_FIELDS, build_fleet_round, build_fleet_scan, build_lane_admit,
    build_lane_round,
)
from repro_torch.fleet.runner import (
    ContinuousBucket, FleetJob, FleetResult, FleetRunner, LaneBucket,
    LaneSlot, ScenarioSpec, apply_job_options, bucket_key, init_lane_state,
    job_from_spec, lane_draws, lane_filler, lane_generator, plan_lane_round,
    run_fleet,
)
from repro_torch.fed.scenarios import SCENARIO_OPTIMIZER

__all__ = [
    "LANE_OP_FIELDS", "build_fleet_round", "build_fleet_scan",
    "build_lane_admit", "build_lane_round",
    "ContinuousBucket", "FleetJob", "FleetResult", "FleetRunner",
    "LaneBucket", "LaneSlot", "SCENARIO_OPTIMIZER", "ScenarioSpec",
    "apply_job_options", "bucket_key", "init_lane_state",
    "job_from_spec", "lane_draws", "lane_filler", "lane_generator",
    "plan_lane_round", "run_fleet",
]
