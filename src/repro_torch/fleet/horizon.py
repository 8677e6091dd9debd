"""Rolling-horizon (MPC-style) fleet planning — DESIGN.md D10.

The paper's TSIA optimizes a snapshot: every replan is memoryless, so under
Gauss-Markov mobility a user drifting along an edge boundary ping-pongs
between edges, paying the model re-upload at every handover.  This module
plans over a PREDICTED WINDOW instead:

1. :func:`repro_torch.fleet.dynamics.predict_fleet_rollout` extrapolates
   the mobility state K slots ahead into (C, K, N, M) predicted-gain
   stacks, slot 0 = the live channel;
2. the engine's descent/escape loop runs unchanged, but each candidate is
   scored against ALL K slots plus a switching cost charging the model
   re-upload for every user moved off the incumbent (deployed) assignment
   (:func:`repro_torch.fleet.engine._score_horizon`; the K slots of every
   candidate ride in the round's one K2 launch);
3. :func:`plan_fleet_horizon` runs that over a whole fleet in one search.

Horizon 1 with zero switching cost is bitwise the snapshot path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.system_model import rate
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import dynamics
from repro_torch.fleet import engine as fengine
from repro_torch.fleet.service import shard as fshard


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class HorizonConfig:
    """Rolling-horizon knobs: ``K`` slots scored per candidate (1 =
    snapshot planning) and ``switch_cost``, the weighted-cost charge per
    handover (calibrate it with :func:`estimate_switch_cost`, or set it
    by policy)."""

    K: int = 4
    switch_cost: float = 0.0


def count_handovers(prev_assigns, assigns, active) -> int:
    """Users active in ``active`` whose edge changed between two plans.

    Pass the AND of both ticks' activity: a new user getting its first
    edge is not a handover, and a departed slot's stale value costs
    nothing.
    """
    prev = _host(prev_assigns)
    cur = _host(assigns)
    return int(((prev != cur) & np.asarray(_host(active), bool)).sum())


def estimate_switch_cost(fleet: fbatch.FleetScenario, assigns,
                         alloc: sroa.SroaResult, lam: float = 1.0,
                         comps=None, ladder=None) -> float:
    """Calibrate the per-handover charge from a live allocation.

    A handover forces one model re-upload over the new link, whose weighted
    cost is about the user's current upload airtime cost
    ``(p + lam) * s_eff / r``; the result is the mean over active users.
    ``s_eff`` is the effective payload ``s_bits * size_mult *
    bytes_factor[comp]`` (D11); without ``comps``/``ladder`` the tier
    sizes alone.  The rate is taken in float32, as the cost model is.
    """
    assigns = np.asarray(_host(assigns), np.int32)
    gain = _host(fleet.cells.gain).astype(np.float64)        # (C, N, M)
    g_own = np.take_along_axis(gain, assigns[..., None].astype(np.int64),
                               axis=2)[..., 0]
    b = _host(alloc.b).astype(np.float64)
    p = _host(alloc.p).astype(np.float64)
    N0 = _host(fleet.cells.N0).astype(np.float64)[:, None]

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32))

    r = rate(f32(b), f32(g_own), f32(p), f32(N0)).numpy().astype(np.float64)
    s_bits = _host(fleet.cells.s_bits).astype(np.float64)[:, None]
    s_eff = s_bits * _host(fleet.cells.size_mult).astype(np.float64)
    if comps is not None and ladder is not None:
        bf = np.asarray(ladder.bytes_factors(), np.float64)
        s_eff = s_eff * bf[np.clip(np.asarray(_host(comps), np.int64), 0,
                                   len(ladder) - 1)]
    t_up = np.where(r > 0, s_eff / np.maximum(r, 1e-9), 0.0)
    w = np.asarray(_host(fleet.mask), bool)
    cost = (p + lam) * t_up
    n_act = max(int(w.sum()), 1)
    return float(np.where(w, cost, 0.0).sum() / n_act)


def plan_fleet_horizon(fleet: fbatch.FleetScenario,
                       state: dynamics.FleetDynamicsState,
                       K: int = 4, switch_cost: float = 0.0,
                       incumbents=None, init_assigns=None, lam=1.0,
                       cfg: sroa.SroaConfig = sroa.SroaConfig(),
                       stream_cfg: dynamics.StreamConfig | None = None,
                       max_rounds: int = 48, escape_iters: int = 6,
                       top_k: int = 0, n_starts: int = 1, devices=None,
                       rows: np.ndarray | None = None, gain_stacks=None,
                       ladder=None, init_comps=None,
                       tail_inits=None) -> fengine.EngineResult:
    """MPC plan for every cell of a fleet in one engine search.

    Builds the (C, K, N, M) predicted-gain stacks from the fleet's
    dynamics ``state`` (or takes ``gain_stacks`` a caller already built)
    and runs the time-expanded search, split over ``devices`` when
    given.  ``incumbents`` is the deployed assignment the switching cost
    bills against (default: the warm start ``init_assigns``); ``rows``
    maps a sliced sub-fleet back to its rows of ``state``.
    ``ladder``/``init_comps`` add the compression search (D11) and
    ``tail_inits`` (C, N) each cell's receding-horizon warm start.
    """
    stacks = (gain_stacks if gain_stacks is not None
              else dynamics.predict_fleet_rollout(fleet, state, K,
                                                  cfg=stream_cfg, rows=rows))
    dev = fleet.device

    def i32(x):
        return None if x is None else torch.tensor(
            np.asarray(_host(x), np.int32), device=dev)

    return fshard.solve_fleet_sharded(
        fleet, i32(init_assigns), lam, cfg, max_rounds, escape_iters,
        devices=devices, top_k=top_k, n_starts=n_starts,
        gain_stacks=torch.as_tensor(np.asarray(_host(stacks), np.float32),
                                    device=dev),
        switch_cost=float(switch_cost), incumbents=i32(incumbents),
        ladder=ladder, init_comps=i32(init_comps),
        tail_inits=i32(tail_inits))
