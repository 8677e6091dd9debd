"""Fleet-scale planning on top of the paper's core algorithms.

* :mod:`repro_torch.fleet.batch`    — stacked scenarios + batched SROA.
* :mod:`repro_torch.fleet.dynamics` — mobility / fading / churn streams,
  per cell and for a whole fleet.
* :mod:`repro_torch.fleet.engine`   — batched assignment search (TSIA over
  every cell at once).
* :mod:`repro_torch.fleet.incremental` — engine front end, the host
  reference loop and warm-start re-planning.
* :mod:`repro_torch.fleet.planner`  — the cached :class:`FleetPlanner`.
* :mod:`repro_torch.fleet.service`  — the streaming control plane.

Not ported yet: ``horizon`` and ``topology``.
"""
from repro_torch.fleet.batch import (FleetScenario, candidate_assigns_device,
                                     draw_fleet, fleet_assignments,
                                     fleet_constants, fleet_from_numpy,
                                     solve_batch, solve_candidates,
                                     stack_scenarios)
from repro_torch.fleet.engine import (EngineResult, EngineTrace,
                                      solve_assignment,
                                      solve_fleet_assignments)
from repro_torch.fleet.planner import FleetPlanner, PlanResult, scenario_digest
from repro_torch.fleet.service import (PlanningService, ServiceConfig,
                                       solve_fleet_sharded)

__all__ = [
    "FleetScenario", "candidate_assigns_device", "draw_fleet",
    "fleet_assignments", "fleet_constants", "fleet_from_numpy",
    "solve_batch", "solve_candidates", "stack_scenarios",
    "EngineResult", "EngineTrace", "solve_assignment",
    "solve_fleet_assignments",
    "FleetPlanner", "PlanResult", "scenario_digest",
    "PlanningService", "ServiceConfig", "solve_fleet_sharded",
]
