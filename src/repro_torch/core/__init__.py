"""The paper's core: HFL cost model + SROA (Algs 2-4) + TSIA (Alg 5), and
the baselines the paper compares them against."""
from repro_torch.core import (assignment_baselines, baselines, sroa,
                              system_model, tsia, wireless)
from repro_torch.core.sroa import (SroaConfig, SroaResult, solve as sroa_solve,
                                   solve_plus as sroa_solve_plus)
from repro_torch.core.system_model import evaluate, objective, sroa_constants
from repro_torch.core.tsia import TsiaResult, solve as tsia_solve
from repro_torch.core.wireless import (Scenario, ScenarioSpec, draw_scenario,
                                       nearest_edge_assignment,
                                       scenario_from_numpy)

__all__ = [
    "assignment_baselines", "baselines", "sroa", "system_model", "tsia",
    "wireless", "SroaConfig", "SroaResult", "sroa_solve", "sroa_solve_plus",
    "evaluate", "objective", "sroa_constants", "TsiaResult", "tsia_solve",
    "Scenario", "ScenarioSpec", "draw_scenario", "nearest_edge_assignment",
    "scenario_from_numpy",
]
