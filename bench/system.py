"""The system under test: the port's planning service, built from a
configuration and a traffic mix as the serving CLI builds it
(``repro_torch.launch.serve.build_service``), over the benchmark's fleet.

This is the one module of the harness that imports the program.  It hands
the program the benchmark's inputs and reads back what the program
publishes: the live fleet, the deployed assignments and allocation, and
the telemetry counters.
"""
from __future__ import annotations

import numpy as np
import torch

# The leaves of a scenario the dynamics move, read back for the judge.
LIVE_LEAVES = ("user_pos", "gain", "c", "D")


def build(cfg: dict, traffic: dict, cells: dict, mask: np.ndarray,
          seed: int, device: str = "cuda"):
    """The planning service over the fleet ``cells``/``mask``; its
    bootstrap search runs here."""
    from repro_torch.core import sroa
    from repro_torch.core.wireless import ScenarioSpec
    from repro_torch.fleet.batch import fleet_from_numpy
    from repro_torch.fleet.dynamics import StreamConfig
    from repro_torch.fleet.service import (DriftConfig, PlanningService,
                                           ServiceConfig)

    solver = cfg["solver"]
    n_users = mask.sum(axis=1).astype(np.int32)
    fleet = fleet_from_numpy({"cells": cells, "mask": mask,
                              "n_users": n_users}, device)
    spec = ScenarioSpec(
        N=cfg["users_max"], M=cfg["edges"], side_m=cfg["side_m"],
        shadow_std_db=cfg["shadow_std_db"], c_range=tuple(cfg["c_range"]),
        D_range=tuple(cfg["D_range"]))
    svc_cfg = ServiceConfig(
        drift=DriftConfig(**traffic["drift"]),
        stream=StreamConfig(**traffic["stream"]),
        event_rate=traffic["event_rate"], max_rounds=solver["max_rounds"],
        escape_iters=solver["escape_iters"], top_k=solver["top_k"])
    sroa_cfg = sroa.SroaConfig(
        b_iters=solver["b_iters"], f_iters=solver["f_iters"],
        p_iters=solver["p_iters"], t_iters=solver["t_iters"], fused=True)
    return PlanningService(fleet, lam=cfg["lam"], sroa_cfg=sroa_cfg,
                           cfg=svc_cfg, spec=spec, seed=seed, device=device)


def caps(cfg: dict) -> dict:
    """The SROA iteration caps of a configuration."""
    return {k: cfg["solver"][k]
            for k in ("b_iters", "f_iters", "p_iters", "t_iters")}


def snapshot(svc) -> dict:
    """Host copies of what the service publishes after a tick: the live
    leaves and mask, the deployed assignments and the re-priced plan."""
    cells = svc.fleet.cells
    out = {k: getattr(cells, k).detach().cpu().numpy().copy()
           for k in LIVE_LEAVES}
    out["mask"] = svc.fleet.mask.detach().cpu().numpy().copy()
    out["assign"] = np.asarray(svc.assigns).copy()
    alloc = svc.alloc
    for k in ("b", "f", "p", "t", "R"):
        out[k] = np.asarray(getattr(alloc, k), np.float64).copy()
    return out


def counters(svc) -> dict:
    """The service's telemetry counters over the window."""
    t = svc.telemetry
    return {"cells": t.cells, "cells_replanned": t.cells_replanned}


def synchronize() -> None:
    torch.cuda.synchronize()
