"""Continuous planning service: a streaming control plane over the batched
engine (DESIGN.md D8).

* :mod:`repro_torch.fleet.service.control`   — the clocked tick loop.
* :mod:`repro_torch.fleet.service.drift`     — staleness scoring.
* :mod:`repro_torch.fleet.service.queue`     — request mailbox with
  per-tick coalescing.
* :mod:`repro_torch.fleet.service.shard`     — split of the engine over
  devices along the cell axis.
* :mod:`repro_torch.fleet.service.telemetry` — plans/sec, replan fraction,
  latency percentiles, drift histogram (JSON).
* :mod:`repro_torch.fleet.service.loadgen`   — Poisson open-loop load generator.
"""
from repro_torch.fleet.service.control import (PlanningService,
                                               ServiceConfig, TickRecord)
from repro_torch.fleet.service.drift import DriftConfig, DriftReport
from repro_torch.fleet.service.loadgen import run_load
from repro_torch.fleet.service.queue import CoalescingQueue, PlanRequest
from repro_torch.fleet.service.shard import cell_mesh, solve_fleet_sharded
from repro_torch.fleet.service.telemetry import Telemetry

__all__ = [
    "PlanningService", "ServiceConfig", "TickRecord",
    "DriftConfig", "DriftReport",
    "CoalescingQueue", "PlanRequest",
    "Telemetry", "run_load", "cell_mesh",
    "solve_fleet_sharded",
]
