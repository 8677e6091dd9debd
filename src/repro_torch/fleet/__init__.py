"""Fleet-scale planning on top of the paper's core algorithms.

* :mod:`repro_torch.fleet.batch`    — stacked scenarios + batched SROA.
* :mod:`repro_torch.fleet.dynamics` — mobility / fading / churn streams,
  per cell and for a whole fleet.
* :mod:`repro_torch.fleet.engine`   — batched assignment search (TSIA over
  every cell at once).
* :mod:`repro_torch.fleet.incremental` — engine front end, the host
  reference loop and warm-start re-planning.
* :mod:`repro_torch.fleet.planner`  — the cached :class:`FleetPlanner`.
* :mod:`repro_torch.fleet.horizon`  — rolling-horizon (MPC) planning over a
  predicted mobility window with switching costs (DESIGN.md D10).
* :mod:`repro_torch.fleet.topology` — bilevel topology design: edge
  placement/activation as decision variables (DESIGN.md D12).
* :mod:`repro_torch.fleet.service`  — the streaming control plane.
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
from repro_torch.fleet.horizon import (HorizonConfig, count_handovers,
                                       estimate_switch_cost,
                                       plan_fleet_horizon)
from repro_torch.fleet.topology import (TopologyConfig, TopologyResult,
                                        design_topology, proxy_cost,
                                        uniform_mask, with_edge_mask)

__all__ = [
    "FleetScenario", "candidate_assigns_device", "draw_fleet",
    "fleet_assignments", "fleet_constants", "fleet_from_numpy",
    "solve_batch", "solve_candidates", "stack_scenarios",
    "EngineResult", "EngineTrace", "solve_assignment",
    "solve_fleet_assignments",
    "FleetPlanner", "PlanResult", "scenario_digest",
    "PlanningService", "ServiceConfig", "solve_fleet_sharded",
    "HorizonConfig", "count_handovers", "estimate_switch_cost",
    "plan_fleet_horizon",
    "TopologyConfig", "TopologyResult", "design_topology", "proxy_cost",
    "uniform_mask", "with_edge_mask",
]
