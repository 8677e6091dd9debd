"""Multi-device split of the fleet engine over the cell axis.

D5 padding makes every per-cell shape static and cells are independent
problems, so a fleet splits trivially: given more than one device, the cell
axis is cut into one contiguous chunk per device, each chunk's search runs
on its device, and the results concatenate back in order on the first
device.  The chunks run one after another (each engine call synchronises
with the host every round), so the split spreads memory, not time; it is
used only when the caller lists the devices.  With one device (or none
given) :func:`solve_fleet_sharded` is the plain
:func:`repro_torch.fleet.engine.solve_fleet_assignments` call, as the JAX
service's ``cell_mesh`` returns None on a single device.
"""
from __future__ import annotations

import torch

from repro_torch.core import sroa
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import engine as fengine
from repro_torch.runtime.sharding import cell_mesh  # noqa: F401 (re-export)


def _concat(outs, dev):
    if isinstance(outs[0], tuple):
        return type(outs[0])(*(_concat(xs, dev) for xs in zip(*outs)))
    return torch.cat([x.to(dev) for x in outs], dim=0)


def solve_fleet_sharded(fleet: fbatch.FleetScenario, init_assigns=None,
                        lam=1.0, cfg: sroa.SroaConfig = sroa.SroaConfig(),
                        max_rounds: int = 48, escape_iters: int = 6,
                        devices=None, top_k: int = 0, n_starts: int = 1,
                        gain_stacks=None, switch_cost: float = 0.0,
                        incumbents=None, ladder=None, init_comps=None,
                        tail_inits=None) -> fengine.EngineResult:
    """Fleet-wide assignment search, split over ``devices`` when given.

    ``devices`` is a list of at least two torch devices (see
    :func:`repro_torch.runtime.sharding.cell_mesh`); None runs the single-device path.  The per-cell
    operands of the horizon (``gain_stacks`` (C, K, N, M), ``incumbents``),
    the compression search (``init_comps``) and the warm starts
    (``tail_inits``) split with the cells.
    """
    kw = dict(lam=lam, cfg=cfg, max_rounds=max_rounds,
              escape_iters=escape_iters, top_k=top_k, n_starts=n_starts,
              switch_cost=switch_cost, ladder=ladder)
    per_cell = dict(gain_stacks=gain_stacks, incumbents=incumbents,
                    init_comps=init_comps, tail_inits=tail_inits)
    if not devices or len(devices) < 2:
        return fengine.solve_fleet_assignments(fleet, init_assigns, **kw,
                                               **per_cell)
    if init_assigns is None:
        init_assigns = fbatch.fleet_assignments(fleet)
    init = torch.as_tensor(init_assigns, dtype=torch.int32,
                           device=fleet.device)
    lam_v = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=fleet.device), (fleet.C,))
    per_cell = {k: None if v is None else torch.as_tensor(
        v, device=fleet.device) for k, v in per_cell.items()}
    chunks = torch.arange(fleet.C, device=fleet.device).tensor_split(
        len(devices))
    outs = []
    for dev, idx in zip(devices, chunks):
        if idx.numel() == 0:
            continue
        kw["lam"] = lam_v[idx].to(dev)
        part = {k: None if v is None else v[idx].to(dev)
                for k, v in per_cell.items()}
        outs.append(fengine.solve_fleet_assignments(
            fleet.index(idx).to(dev), init[idx].to(dev), **kw, **part))
    return _concat(outs, fleet.device)
