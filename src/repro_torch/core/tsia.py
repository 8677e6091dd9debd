"""TSIA — Two-Stage Iterative Algorithm for user assignment (paper §V, Alg 5).

Stage 1 repeatedly moves the *costly user* (argmax b_n, Definition 2) of the
*costly edge* (argmax R_m, Definition 1) to the *economic edge* (argmin R_m).
Stage 2 restarts from the best pattern found and fine-tunes by moving the
*economic user* (argmin b_n) instead.  TSIA is deterministic (Remark 1); it
stops when an assignment pattern repeats (the paper's convergence criterion,
Fig 5) or when an iteration cap is hit.  The best pattern ever visited is
returned.

Each visited pattern is scored by one SROA solve (Algorithm 4) and the cost
model; the loop itself stays on the host in numpy, since every decision
branches on the scores.  Under ``SroaConfig(fused=True)`` a score is one
launch of kernel K2 at one problem; under ``use_pallas=True`` the eager
nest's inversions go through kernel K1.

This is the paper-faithful reference oracle: production planning routes
through the batched engine (:mod:`repro_torch.fleet.engine`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.system_model import evaluate
from repro_torch.core.wireless import Scenario, nearest_edge_assignment


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass
class TsiaHistory:
    """Trace of the assignment process (enables the paper's Figs 5-6)."""

    R_trace: list                 # objective after every assigning iteration
    moves: list                   # (stage, q, user, from_edge, to_edge)
    iters_stage1: int = 0
    iters_stage2: int = 0

    @property
    def total_iters(self) -> int:
        return self.iters_stage1 + self.iters_stage2


class TsiaResult(NamedTuple):
    assign: np.ndarray
    sroa: sroa.SroaResult
    R: float
    history: TsiaHistory


def _score(scn: Scenario, assign: np.ndarray, lam, cfg: sroa.SroaConfig):
    """One assigning iteration: SROA + per-edge costs R_m (eq 23)."""
    a = torch.tensor(np.asarray(assign), dtype=torch.int32,
                     device=scn.device)
    res = sroa.solve(scn, a, lam, cfg)
    cb = evaluate(scn, a, res.b, res.f, res.p, lam)
    return res, _host(cb.R_m), float(cb.R), _host(res.b)


def solve(scn: Scenario, lam=1.0, cfg: sroa.SroaConfig = sroa.SroaConfig(),
          init_assign: np.ndarray | None = None,
          max_iters_per_stage: int | None = None,
          score_fn: Callable | None = None) -> TsiaResult:
    """Run both TSIA stages and return the best pattern found.

    ``score_fn(assign)`` replaces the scoring step; it returns
    ``(sroa_result, R_m, R, b)`` as :func:`_score` does.
    """
    N, M = scn.N, scn.M
    if max_iters_per_stage is None:
        max_iters_per_stage = max(4 * N, 64)
    score = score_fn or (lambda a: _score(scn, a, lam, cfg))

    if init_assign is None:
        init_assign = _host(nearest_edge_assignment(scn))       # Alg 5 line 5
    assign = np.array(_host(init_assign), dtype=np.int32)

    hist = TsiaHistory(R_trace=[], moves=[])
    best_res, R_m, R, b = score(assign)
    best_R, best_assign = R, assign.copy()
    hist.R_trace.append(R)

    for stage in (1, 2):
        if stage == 2:
            assign = best_assign.copy()                    # Alg 5 line 9
            best_res, R_m, R, b = score(assign)
        seen = {assign.tobytes()}
        for q in range(max_iters_per_stage):
            counts = np.bincount(assign, minlength=M)
            # Definition 1 — only edges with users can be "costly".
            R_m_occ = np.where(counts > 0, R_m, -np.inf)
            m_plus = int(np.argmax(R_m_occ))
            m_minus = int(np.argmin(R_m))
            if m_plus == m_minus or counts[m_plus] == 0:
                break
            in_plus = np.flatnonzero(assign == m_plus)
            if stage == 1:      # costly user: argmax b_n within m+ (Def 2)
                user = int(in_plus[np.argmax(b[in_plus])])
            else:               # economic user: argmin b_n within m+
                user = int(in_plus[np.argmin(b[in_plus])])
            assign[user] = m_minus
            hist.moves.append((stage, q, user, m_plus, m_minus))

            res, R_m, R, b = score(assign)
            hist.R_trace.append(R)
            if stage == 1:
                hist.iters_stage1 += 1
            else:
                hist.iters_stage2 += 1
            if R < best_R:                                        # Alg 5 19-21
                best_R, best_assign, best_res = R, assign.copy(), res
            key = assign.tobytes()
            if key in seen:     # pattern revisited -> converged (Remark 1)
                break
            seen.add(key)

    return TsiaResult(assign=best_assign, sroa=best_res, R=best_R,
                      history=hist)
