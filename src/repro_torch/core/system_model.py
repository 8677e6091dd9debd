"""HFL energy/delay cost model — paper §III eqs (4)-(15), batched tensors.

The single source of truth for the objective value.  Every function takes a
scenario whose leaves carry a leading batch shape S (see
:mod:`repro_torch.core.wireless`) and per-user tensors of shape S' + (N,)
where S' broadcasts against S: a candidate axis is a size-1 axis inserted
into the scenario's leaves (:func:`expand_scenario`), never a vmap.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.wireless import Scenario

_BIG = 1e30
_LOG2 = math.log(2.0)


def _col(x: torch.Tensor) -> torch.Tensor:
    """Per-problem scalar -> a column that broadcasts over the last axis."""
    return x[..., None]


def expand_scenario(scn: Scenario, dim: int) -> Scenario:
    """Insert a size-1 batch axis at ``dim`` of every leaf's batch shape.

    ``dim`` counts within the batch shape S, so ``expand_scenario(fleet
    .cells, 1)`` turns (C, ...) leaves into (C, 1, ...) leaves that
    broadcast against a (C, A, N) candidate axis.
    """
    return scn._replace(**{
        name: getattr(scn, name).unsqueeze(dim)
        for name in Scenario._fields if getattr(scn, name) is not None})


def ladder_factors(ladder, like: torch.Tensor):
    """(epoch, bytes) factors of a compression ladder as f32 tensors."""
    kw = dict(dtype=torch.float32, device=like.device)
    return (torch.tensor(ladder.epoch_factors(), **kw),
            torch.tensor(ladder.bytes_factors(), **kw))


def ladder_levels(comp: torch.Tensor, ladder) -> torch.Tensor:
    """Compression levels clipped onto the ladder, as gather indices."""
    return torch.clamp(comp.long(), 0, len(ladder) - 1)


def effective_loads(scn: Scenario, comp: torch.Tensor | None = None,
                    ladder=None):
    """Per-user effective (cycles/sample, upload bits) under tiers + comp.

    Tier multipliers always apply (all-ones is bitwise the homogeneous
    model).  With a per-user compression level ``comp`` (..., N) and a
    :class:`repro_torch.fed.compression.CompressionLadder`, the level's
    epoch factor scales compute and its bytes factor scales the upload
    (DESIGN.md D11).
    """
    c_eff = scn.c * scn.cycle_mult
    s_eff = _col(scn.s_bits) * scn.size_mult
    if comp is not None and ladder is not None:
        ef, bf = ladder_factors(ladder, c_eff)
        lv = ladder_levels(comp, ladder)
        c_eff = c_eff * ef[lv]
        s_eff = s_eff * bf[lv]
    return c_eff, s_eff


def rate(b: torch.Tensor, gain: torch.Tensor, p: torch.Tensor,
         N0) -> torch.Tensor:
    """Achievable FDMA rate (eq 6): r = b log2(1 + g p / (N0 b)).

    Safe at b == 0 (rate -> 0) and p == 0 (rate -> 0).
    """
    b_safe = torch.clamp_min(b, 1e-9)
    snr = gain * p / (N0 * b_safe)
    return torch.where(b > 0, b_safe * torch.log1p(snr) / _LOG2, 0.0)


class CostBreakdown(NamedTuple):
    T_cmp: torch.Tensor      # (N,) per-edge-iteration computation delay (eq 4)
    E_cmp: torch.Tensor      # (N,) computation energy                   (eq 5)
    T_com: torch.Tensor      # (N,) upload delay                         (eq 7)
    E_com: torch.Tensor      # (N,) upload energy                        (eq 8)
    T_m: torch.Tensor        # (M,) per-global-iteration edge delay      (eq 9)
    E_m: torch.Tensor        # (M,) per-global-iteration edge energy     (eq 10)
    T_cloud: torch.Tensor    # (M,) edge->cloud delay                    (eq 11)
    E_cloud: torch.Tensor    # (M,) edge->cloud energy                   (eq 12)
    R_m: torch.Tensor        # (M,) per-edge weighted cost               (eq 23)
    T_sum: torch.Tensor      # () total delay  (eq 13, x I)
    E_sum: torch.Tensor      # () total energy (eq 14, x I)
    R: torch.Tensor          # () objective    (eq 15)
    b_per_edge: torch.Tensor  # (M,) bandwidth actually used per edge


def members(assign: torch.Tensor, M: int) -> torch.Tensor:
    """One-hot membership matrix (..., N, M) from an int assignment."""
    return F.one_hot(assign.long(), M).to(torch.float32)


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def evaluate(scn: Scenario, assign: torch.Tensor, b: torch.Tensor,
             f: torch.Tensor, p: torch.Tensor, lam,
             mask: torch.Tensor | None = None,
             comp: torch.Tensor | None = None,
             ladder=None) -> CostBreakdown:
    """Evaluate the full paper cost model (eqs 4-15) for a batch of plans.

    Args:
      scn:    scenario (batch shape S).
      assign: S' + (N,) int user -> edge assignment.
      b, f, p: S' + (N,) bandwidth (Hz), CPU frequency (Hz), power (W).
      lam:    importance weight lambda in eq (15); scalar or shaped S'.
      mask:   optional S' + (N,) bool; False = inactive/padded user,
              excluded from every aggregate.
    """
    psi = members(assign, scn.M)                        # (.., N, M)
    if mask is not None:
        psi = psi * mask.to(psi.dtype)[..., None]
    gain_n = torch.sum(psi * scn.gain, dim=-1)          # h_n: gain to own edge
    lam = _as_tensor(lam, b)

    c_eff, s_eff = effective_loads(scn, comp, ladder)
    f_safe = torch.clamp_min(f, 1.0)
    T_cmp = _col(scn.L) * c_eff * scn.D / f_safe                      # eq (4)
    E_cmp = 0.5 * _col(scn.alpha) * _col(scn.L) * (f * f) * c_eff * scn.D  # (5)

    r = rate(b, gain_n, p, _col(scn.N0))                               # eq (6)
    T_com = torch.where(r > 0, s_eff / torch.clamp_min(r, 1e-9), _BIG)  # (7)
    E_com = p * T_com                                                   # eq (8)

    per_user = T_cmp + T_com
    occupied = psi.sum(dim=-2) > 0                      # (.., M)
    T_m = _col(scn.K) * torch.amax(
        torch.where(psi > 0, per_user[..., None], -_BIG), dim=-2)      # eq (9)
    T_m = torch.where(occupied, T_m, 0.0)
    E_m = _col(scn.K) * torch.sum(psi * (E_cmp + E_com)[..., None], dim=-2)

    T_cloud = torch.where(occupied, scn.T_cloud(), 0.0)                # eq (11)
    E_cloud = torch.where(occupied, scn.E_cloud(), 0.0)                # eq (12)

    T = torch.amax(T_cloud + T_m, dim=-1)                              # eq (13)
    E = torch.sum(E_cloud + E_m, dim=-1)                               # eq (14)
    T_sum = scn.I * T
    E_sum = scn.I * E
    R = E_sum + lam * T_sum                                            # eq (15)

    R_m = _col(scn.I) * ((E_cloud + E_m) + _col(lam) * (T_cloud + T_m))
    b_per_edge = torch.sum(psi * b[..., None], dim=-2)
    return CostBreakdown(T_cmp, E_cmp, T_com, E_com, T_m, E_m,
                         T_cloud, E_cloud, R_m, T_sum, E_sum, R, b_per_edge)


def objective(scn: Scenario, assign, b, f, p, lam) -> torch.Tensor:
    return evaluate(scn, assign, b, f, p, lam).R


def evaluate_candidates(scn: Scenario, assigns: torch.Tensor,
                        b: torch.Tensor, f: torch.Tensor, p: torch.Tensor,
                        lam, mask: torch.Tensor | None = None,
                        comps: torch.Tensor | None = None,
                        ladder=None) -> CostBreakdown:
    """:func:`evaluate` of A candidate patterns (A, N) of ONE scenario.

    ``mask`` (N,) is shared by every candidate.  Leaves carry a leading
    (A,) axis.
    """
    return evaluate(expand_scenario(scn, 0), assigns, b, f, p, lam,
                    mask, comps, ladder)


class SroaConstants(NamedTuple):
    """Per-user constants of problem (17)-(22); eqs (18)-(20)."""

    A: torch.Tensor      # (N,)  A_n = (alpha/2) I K L c_n D_n
    J: torch.Tensor      # (N,)  J_n = I K L c_n D_n
    H: torch.Tensor      # (N,)  H_n = I K s
    delta: torch.Tensor  # (N,)  delta_n = I * T_cloud of own edge
    h: torch.Tensor      # (N,)  channel gain to own edge
    E_cloud_total: torch.Tensor  # () I * sum_m E_cloud (the omitted constant)


def sroa_constants(scn: Scenario, assign: torch.Tensor,
                   mask: torch.Tensor | None = None,
                   comp: torch.Tensor | None = None,
                   ladder=None) -> SroaConstants:
    psi = members(assign, scn.M)
    if mask is not None:
        psi = psi * mask.to(psi.dtype)[..., None]
    IKL = scn.I * scn.K * scn.L
    occupied = psi.sum(dim=-2) > 0
    T_cloud = torch.where(occupied, scn.T_cloud(), 0.0)
    E_cloud = torch.where(occupied, scn.E_cloud(), 0.0)
    c_eff, s_eff = effective_loads(scn, comp, ladder)
    # Every per-user leaf spans the full batch shape, as the vmapped JAX
    # constants do, even where it does not depend on the assignment.
    shape = psi.shape[:-1]
    consts = SroaConstants(
        A=(0.5 * _col(scn.alpha) * _col(IKL) * c_eff * scn.D).expand(shape),
        J=(_col(IKL) * c_eff * scn.D).expand(shape),
        H=(_col(scn.I * scn.K) * s_eff).expand(shape),
        delta=_col(scn.I) * torch.sum(psi * T_cloud[..., None, :], dim=-1),
        h=torch.sum(psi * scn.gain, dim=-1),
        E_cloud_total=scn.I * torch.sum(E_cloud, dim=-1),
    )
    if mask is not None:
        consts = mask_constants(consts, mask)
    return consts


def sroa_constants_batched(scn: Scenario, assigns: torch.Tensor,
                           mask: torch.Tensor | None = None,
                           comps: torch.Tensor | None = None,
                           ladder=None) -> SroaConstants:
    """Stacked constants for A candidate assignments (A, N) of ONE scenario.

    Per-user leaves come back (A, N), ``E_cloud_total`` (A,).
    """
    return sroa_constants(expand_scenario(scn, 0), assigns, mask, comps,
                          ladder)


def mask_constants(consts: SroaConstants,
                   mask: torch.Tensor) -> SroaConstants:
    """Neutralize padded users so they contribute ~nothing to a solve.

    A masked user gets A = J = H = delta = 0 and h = 1: its rate target
    collapses to 0, its bandwidth to ~b_max * 2**-iters, and both of its
    energy terms vanish.
    """
    m = mask.to(torch.bool)
    return consts._replace(
        A=torch.where(m, consts.A, 0.0), J=torch.where(m, consts.J, 0.0),
        H=torch.where(m, consts.H, 0.0),
        delta=torch.where(m, consts.delta, 0.0),
        h=torch.where(m, consts.h, 1.0))
