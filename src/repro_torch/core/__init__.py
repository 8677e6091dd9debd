"""The paper's core: scenario model, HFL cost model and SROA (Algs 2-4).

TSIA (``core/tsia.py``) and the baselines are not ported yet.
"""
from repro_torch.core import sroa, system_model, wireless
from repro_torch.core.sroa import (SroaConfig, SroaResult, solve as sroa_solve,
                                   solve_plus as sroa_solve_plus)
from repro_torch.core.system_model import evaluate, objective, sroa_constants
from repro_torch.core.wireless import (Scenario, ScenarioSpec, draw_scenario,
                                       nearest_edge_assignment,
                                       scenario_from_numpy)

__all__ = [
    "sroa", "system_model", "wireless", "SroaConfig", "SroaResult",
    "sroa_solve", "sroa_solve_plus", "evaluate", "objective",
    "sroa_constants", "Scenario", "ScenarioSpec", "draw_scenario",
    "nearest_edge_assignment", "scenario_from_numpy",
]
