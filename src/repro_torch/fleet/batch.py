"""Batched SROA over stacked scenarios (the fleet engine's data plane).

A :class:`FleetScenario` stacks C heterogeneous cells — each its own
:class:`~repro_torch.core.wireless.Scenario` with its own user count,
bandwidth budget and model size — into one scenario with a leading (C,)
axis, a common padded user axis and a validity mask.  :func:`solve_batch`
runs the paper's Algorithm 4 for every cell as one batched solve: each
cell's bisection trajectory is the one it would follow alone (problems
freeze one by one, DESIGN.md D2), and with ``SroaConfig.fused`` the whole
batch is one launch of kernel K2.

Padded users are neutralized through
:func:`repro_torch.core.system_model.mask_constants` (D5).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.system_model import (SroaConstants, sroa_constants,
                                           sroa_constants_batched)
from repro_torch.core.wireless import (PER_USER_FIELDS, Scenario, ScenarioSpec,
                                       draw_scenario_numpy,
                                       nearest_edge_assignment,
                                       scenario_from_numpy)


class FleetScenario(NamedTuple):
    """C cells stacked on a leading axis, padded to a common user count."""

    cells: Scenario          # every leaf stacked: (C, ...) per cell
    mask: torch.Tensor       # (C, N_max) bool — True = real user
    n_users: torch.Tensor    # (C,) int32 true user count per cell

    @property
    def C(self) -> int:
        return self.mask.shape[0]

    @property
    def N_max(self) -> int:
        return self.mask.shape[1]

    @property
    def M(self) -> int:
        return self.cells.edge_pos.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def edge_mask(self) -> torch.Tensor | None:
        """(C, M) bool activation mask, or None when every site is live
        (D12)."""
        return self.cells.edge_mask

    def cell(self, i: int) -> Scenario:
        """The i-th cell as a standalone, unpadded Scenario."""
        n = int(self.n_users[i])
        s = map_scenario(lambda x: x[i], self.cells)
        return s._replace(**{name: getattr(s, name)[:n]
                             for name in PER_USER_FIELDS})

    def index(self, idx: torch.Tensor) -> "FleetScenario":
        """The sub-fleet of the cells ``idx`` (in that order)."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        return FleetScenario(cells=map_scenario(lambda x: x[idx], self.cells),
                             mask=self.mask[idx], n_users=self.n_users[idx])

    def to(self, device) -> "FleetScenario":
        return FleetScenario(
            cells=map_scenario(lambda x: x.to(device), self.cells),
            mask=self.mask.to(device), n_users=self.n_users.to(device))


def map_scenario(fn, scn: Scenario, *rest: Scenario) -> Scenario:
    """Apply ``fn`` leaf by leaf to one or more scenarios (a ``None`` leaf
    stays ``None``)."""
    return Scenario(**{
        name: (None if getattr(scn, name) is None
               else fn(*(getattr(s, name) for s in (scn,) + rest)))
        for name in Scenario._fields})


def _pad_users(scn: Scenario, n_max: int) -> Scenario:
    """Pad every per-user leaf to n_max by replicating the last user.

    Correctness never depends on the padded rows: the fleet mask zeroes
    their SROA constants.
    """
    pad = n_max - scn.N
    if pad == 0:
        return scn
    out = {}
    for name in PER_USER_FIELDS:
        x = getattr(scn, name)
        reps = x[-1:].repeat_interleave(pad, dim=0)
        out[name] = torch.cat([x, reps], dim=0)
    return scn._replace(**out)


def stack_scenarios(scns: Sequence[Scenario],
                    n_max: int | None = None) -> Scenario:
    """Stack scenarios (same M; user counts may differ) on a leading axis."""
    n_max = n_max or max(s.N for s in scns)
    ms = {s.M for s in scns}
    if len(ms) != 1:
        raise ValueError(f"all cells must share an edge count, got {ms}")
    padded = [_pad_users(s, n_max) for s in scns]
    return map_scenario(lambda *xs: torch.stack(xs), *padded)


def fleet_from_scenarios(scns: Sequence[Scenario]) -> FleetScenario:
    """Wrap standalone scenarios into a padded, masked FleetScenario."""
    ns = np.array([s.N for s in scns], np.int32)
    n_max = int(ns.max())
    dev = scns[0].device
    mask = torch.as_tensor(np.arange(n_max)[None, :] < ns[:, None],
                           device=dev)
    return FleetScenario(cells=stack_scenarios(scns, n_max), mask=mask,
                         n_users=torch.as_tensor(ns, device=dev))


def fleet_from_numpy(d: dict, device="cuda") -> FleetScenario:
    """Build a FleetScenario from numpy leaves (e.g. a JAX fleet's arrays):
    ``d["cells"]`` holds the stacked scenario leaves, ``d["mask"]`` and
    ``d["n_users"]`` the padding mask and user counts."""
    return FleetScenario(
        cells=scenario_from_numpy(d["cells"], device),
        mask=torch.tensor(np.asarray(d["mask"], bool), device=device),
        n_users=torch.tensor(np.asarray(d["n_users"], np.int32),
                             device=device))


def draw_fleet(seed: int, n_cells: int, spec: ScenarioSpec | None = None, *,
               n_range: tuple[int, int] = (24, 56),
               b_scale_range: tuple[float, float] = (0.5, 2.0),
               s_scale_range: tuple[float, float] = (0.5, 2.0),
               device="cuda") -> FleetScenario:
    """Draw a heterogeneous fleet of cells (bitwise the JAX draw).

    Each cell varies in user count (``n_range``), per-edge bandwidth budget
    (paper range scaled by ``b_scale_range``) and model size
    (``s_scale_range`` x the spec's s_bytes).  Cells are drawn and padded
    on the host and move to ``device`` in one copy per leaf.
    """
    spec = spec or ScenarioSpec()
    rng = np.random.default_rng(seed)
    cells = []
    for _ in range(n_cells):
        n = int(rng.integers(n_range[0], n_range[1] + 1))
        k_b = float(rng.uniform(*b_scale_range))
        k_s = float(rng.uniform(*s_scale_range))
        lo, hi = spec.B_edge_range_hz
        cell_spec = dataclasses.replace(
            spec, N=n, B_edge_range_hz=(lo * k_b, hi * k_b),
            s_bytes=spec.s_bytes * k_s)
        cells.append(draw_scenario_numpy(int(rng.integers(2 ** 31)),
                                         cell_spec))
    ns = np.array([c["c"].shape[0] for c in cells], np.int32)
    n_max = int(ns.max())

    def pad(x):
        reps = np.repeat(x[-1:], n_max - x.shape[0], axis=0)
        return np.concatenate([x, reps], axis=0)

    stacked = {name: np.stack([pad(c[name]) if name in PER_USER_FIELDS
                               else c[name] for c in cells])
               for name in cells[0]}
    return fleet_from_numpy(
        {"cells": stacked, "mask": np.arange(n_max)[None, :] < ns[:, None],
         "n_users": ns}, device)


def fleet_assignments(fleet: FleetScenario) -> torch.Tensor:
    """(C, N_max) nearest-edge init for every cell (Alg 5 line 5)."""
    return nearest_edge_assignment(fleet.cells)


def fleet_constants(fleet: FleetScenario, assigns: torch.Tensor,
                    comps=None, ladder=None) -> SroaConstants:
    """Masked, per-cell SROA constants with a leading (C,) axis."""
    return sroa_constants(fleet.cells, assigns, fleet.mask, comps, ladder)


def solve_constants_batch(consts: SroaConstants, B, b_max, f_max, p_max, N0,
                          lam, cfg: sroa.SroaConfig = sroa.SroaConfig()
                          ) -> sroa.SroaResult:
    """Algorithm 4 over pre-stacked constants: per-user leaves (B, N),
    per-scenario scalars (B,).  Results stack the same way."""
    return sroa.solve_constants_impl(consts, B, b_max, f_max, p_max, N0, lam,
                                     cfg)


def solve_batch(fleet: FleetScenario, assigns: torch.Tensor | None = None,
                lam=1.0, cfg: sroa.SroaConfig = sroa.SroaConfig(),
                comps=None, ladder=None) -> sroa.SroaResult:
    """Batched SROA for a whole fleet: C scenarios in one batched solve.

    Args:
      fleet:   stacked cells.
      assigns: (C, N_max) int32 per-cell assignments (nearest-edge default).
      lam:     scalar or (C,) objective weight(s).
    Returns:
      SroaResult with leading (C,) axes; padded users carry ~zero bandwidth.
    """
    if assigns is None:
        assigns = fleet_assignments(fleet)
    consts = fleet_constants(fleet, torch.as_tensor(assigns,
                                                    device=fleet.device),
                             comps, ladder)
    B = fleet.cells.B_open
    lam_v = torch.broadcast_to(torch.as_tensor(lam, dtype=torch.float32,
                                               device=fleet.device),
                               (fleet.C,))
    return solve_constants_batch(consts, B, B, fleet.cells.f_max,
                                 fleet.cells.p_max, fleet.cells.N0, lam_v, cfg)


def candidate_assigns_device(assign: torch.Tensor, M: int,
                             movable: torch.Tensor | None = None,
                             edge_mask: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-move neighbourhood with fixed-size padding, for (..., N).

    Row 0 is the current pattern; rows 1..N*(M-1) move user ``n`` to edge
    ``(assign[n] + k) % M`` for k in 1..M-1.  The candidate count
    ``A = 1 + N*(M-1)`` depends only on the shapes, never on the masks:
    moves of non-movable users, and moves onto a site closed in
    ``edge_mask`` (..., M) (D12), are flagged invalid, not dropped.

    Returns:
      cands: (..., A, N) int32 candidate patterns.
      valid: (..., A) bool.
    """
    assign = assign.to(torch.int32)
    lead, N = assign.shape[:-1], assign.shape[-1]
    dev = assign.device
    if movable is None:
        movable = torch.ones(lead + (N,), dtype=torch.bool, device=dev)
    offs = torch.arange(1, M, dtype=torch.int32, device=dev)
    dst = (assign[..., :, None] + offs) % M                    # (.., N, M-1)
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    moves = torch.where(eye[:, None, :], dst[..., :, :, None],
                        assign[..., None, None, :])             # (.., N, M-1, N)
    cands = torch.cat([assign[..., None, :],
                       moves.reshape(lead + (N * (M - 1), N))], dim=-2)
    move_ok = torch.broadcast_to(movable.to(torch.bool), lead + (N,)
                                 ).repeat_interleave(M - 1, dim=-1)
    if edge_mask is not None:
        em = torch.broadcast_to(edge_mask.to(torch.bool), lead + (M,))
        move_ok = move_ok & torch.gather(
            em, -1, dst.reshape(lead + (N * (M - 1),)).long())
    valid = torch.cat([torch.ones(lead + (1,), dtype=torch.bool, device=dev),
                       move_ok], dim=-1)
    return cands, valid


def solve_candidates(scn: Scenario, assigns: torch.Tensor, lam=1.0,
                     cfg: sroa.SroaConfig = sroa.SroaConfig(),
                     mask: torch.Tensor | None = None) -> sroa.SroaResult:
    """Batched SROA for A candidate assignments (A, N) of ONE scenario."""
    assigns = torch.as_tensor(assigns, dtype=torch.int32, device=scn.device)
    consts = sroa_constants_batched(scn, assigns, mask)
    B = scn.B_open
    return sroa.solve_constants_impl(consts, B, B, scn.f_max, scn.p_max,
                                     scn.N0, lam, cfg)
