"""Poisson open-loop load generator for the planning service.

Requests arrive as an open-loop Poisson process clocked against the
control plane's tick cadence: each tick draws ``Poisson(req_per_tick)``
arrivals, submits them (they coalesce into that tick's single engine
call), then advances the service.  The returned snapshot is the service's
telemetry record measured after the warm-up window.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fleet.service.control import PlanningService


def run_load(service: PlanningService, ticks: int = 20,
             req_per_tick: float = 2.0, seed: int = 0,
             warmup_ticks: int = 0, on_tick=None) -> dict:
    """Drive ``service`` under Poisson request load; return telemetry.

    Args:
      service:      a live :class:`PlanningService`.
      ticks:        measured control-plane ticks to run.
      req_per_tick: Poisson intensity of plan requests per tick.
      seed:         arrival-process seed (independent of the dynamics seed).
      warmup_ticks: unmeasured ticks run first.
      on_tick:      optional callback ``(TickRecord) -> None``.
    """
    rng = np.random.default_rng(seed)
    for _ in range(warmup_ticks):
        service.submit()
        service.tick()
    service.telemetry.reset()
    pending = []
    for _ in range(ticks):
        n_k = int(rng.poisson(req_per_tick))
        pending += [service.submit() for _ in range(n_k)]
        rec = service.tick()
        if on_tick is not None:
            on_tick(rec)
    snap = service.telemetry.snapshot()
    snap["unserved"] = sum(not r.ready() for r in pending)
    return snap
