"""SROA — Spectrum Resource Optimization Algorithm (paper §IV, Algs 2-4).

Given a user->edge assignment, SROA minimizes ``R = E_sum + lambda * T_sum``
over (b, f, p) via three nested binary searches, exactly following the
paper:

* Algorithm 2: optimal (b, f) for fixed (p, t).  All N users' frequency
  intervals are bisected in lockstep from the scalar predicate
  ``b_sum < B``; the innermost per-user bandwidth bisection inverts the
  monotone rate function b*log2(1 + G/b) (Lemma 1).
* Algorithm 3: optimal p for fixed t, bounded below by Lemma 2.
* Algorithm 4: outer bisection on the deadline t, tracking the best R.

Every solve here is batched: per-user tensors are (P, N) and per-problem
scalars (P, 1) inside the nest.  Each ``while`` level is a host loop over
the batch in which a problem freezes once its own condition fails, as a
vmapped ``lax.while_loop`` freezes it (DESIGN.md D2), so a problem's
trajectory does not depend on the batch it rides in.

``SroaConfig.fused`` sends the whole nest to kernel K2 and
``SroaConfig.use_pallas`` sends the Lemma-1 inversion to kernel K1 (the
names are the JAX package's; on CUDA tensors they launch the hand-written
Hopper kernels, on CPU tensors their plain PyTorch versions).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.system_model import SroaConstants, sroa_constants
from repro_torch.core.wireless import LN2, Scenario
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

_BIG = 1e30


@dataclasses.dataclass(frozen=True)
class SroaConfig:
    eps0: float = 1e-4       # Algorithm 2 tolerance (f bisection)
    eps1: float = 1e-4       # Algorithm 3 tolerance (p bisection)
    eps2: float = 1e-4       # Algorithm 4 tolerance (t bisection)
    b_iters: int = 42        # innermost bandwidth bisection iterations
    f_iters: int = 40        # iteration caps (tolerance usually hits first)
    p_iters: int = 36
    t_iters: int = 48
    t_low: float = 1.0       # seconds; only used when auto_bounds=False
    t_up: float = 3e7        # (and as the _auto_bounds bracket)
    auto_bounds: bool = True  # derive [t_low, t_up] from the scenario
    refine_iters: int = 0    # >0: beyond-paper golden-section polish of t*
    use_pallas: bool = False  # route invert_rate through kernel K1
    fused: bool = False      # run Algs 2-4 in ONE kernel launch (K2)


class SroaResult(NamedTuple):
    b: torch.Tensor         # (..., N) Hz
    f: torch.Tensor         # (..., N) Hz
    p: torch.Tensor         # (..., N) W
    t: torch.Tensor         # (...)   optimal deadline t*
    R: torch.Tensor         # (...)   objective value tracked by Algorithm 4
    b_sum: torch.Tensor     # (...)   total bandwidth used
    feasible: torch.Tensor  # (...)   bool, b_sum <= B at the solution


def rate_fn(b: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """h(b) = b log2(1 + G/b); monotone increasing, sup = G/ln2 (Lemma 1)."""
    b_safe = torch.clamp_min(b, 1e-12)
    return torch.where(b > 0, b_safe * torch.log1p(G / b_safe) / LN2, 0.0)


def invert_rate(G: torch.Tensor, target: torch.Tensor, b_max,
                iters: int = 42) -> torch.Tensor:
    """Smallest b with b*log2(1+G/b) >= target (bisection oracle).

    Returns b_max where even b_max cannot reach the target (infeasible).
    ``b_max`` broadcasts against ``G``.
    """
    bm = torch.broadcast_to(torch.as_tensor(b_max, dtype=G.dtype,
                                            device=G.device), G.shape)
    feas = rate_fn(bm, G) >= target
    # Every midpoint is > 0, where rate_fn and the kernels' rate agree, so
    # the bisection steps are the plain K1 loop.
    hi = kref.bisect_rate_plain(G, target, bm, iters)
    return torch.where(feas, hi, bm)


def _invert_rate_dispatch(G, target, b_max, iters: int, use_pallas: bool):
    if use_pallas:
        # (P, N) operands with a (P, 1) cap: one flattened K1 launch.
        return kops.sroa_invert_rate_batched(G, target, b_max[..., 0],
                                             iters=iters)
    return invert_rate(G, target, b_max, iters=iters)


def _bisect(lo, hi, gap_fn, eps: float, cap: int, step):
    """Per-problem bisection that freezes each problem once it converges.

    ``step(mid)`` returns the (P, 1) predicate that moves ``hi`` to the
    midpoint; ``gap_fn(lo, hi)`` the (P, 1) relative gap.
    """
    for _ in range(cap):
        act = gap_fn(lo, hi) > eps
        if not bool(act.any()):
            break
        mid = 0.5 * (lo + hi)
        down = step(mid)
        lo = torch.where(act & ~down, mid, lo)
        hi = torch.where(act & down, mid, hi)
    return lo, hi


# --------------------------------------------------------------------------
# Algorithm 2: optimal (b, f) with fixed (p, t)
# --------------------------------------------------------------------------
def algorithm2(consts: SroaConstants, p: torch.Tensor, t, B, b_max,
               f_max: torch.Tensor, N0, cfg: SroaConfig):
    """Returns (b, f, b_sum).  Per-user operands (P, N); t, B, b_max and N0
    per problem (P, 1).  Lockstep bisection on f, inner inversion for b."""
    G = p * consts.h / N0
    # Lemma 1 lower bound: f >= J / (t - delta - ln2 * H / G).
    denom = t - consts.delta - LN2 * consts.H / torch.clamp_min(G, 1e-30)
    f_lo0 = torch.where(denom > 0, consts.J / torch.clamp_min(denom, 1e-30),
                        f_max)
    f_lo0 = torch.minimum(torch.clamp_min(f_lo0, 0.0), f_max)

    def b_of_f(f):
        tau = t - consts.delta - consts.J / torch.clamp_min(f, 1.0)
        target = torch.where(tau > 0, consts.H / torch.clamp_min(tau, 1e-30),
                             _BIG)
        return _invert_rate_dispatch(G, target, b_max, cfg.b_iters,
                                     cfg.use_pallas)

    def gap(lo, hi):
        return torch.amax((hi - lo) / torch.clamp_min(hi, 1.0), dim=-1,
                          keepdim=True)

    def spare(f):                 # bandwidth to spare -> lower f (save E)
        return torch.sum(b_of_f(f), dim=-1, keepdim=True) < B

    _, f = _bisect(f_lo0, f_max, gap, cfg.eps0, cfg.f_iters, spare)
    b = b_of_f(f)                 # f_hi: the feasible side
    return b, f, torch.sum(b, dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# Algorithm 3: optimal p with fixed t
# --------------------------------------------------------------------------
def algorithm3(consts: SroaConstants, t, B, b_max, f_max, p_max, N0,
               cfg: SroaConfig):
    """Returns (b, f, p, b_sum); shapes as :func:`algorithm2`."""
    # Lemma 2 lower bound at b = b_max, f = f_max.
    gamma = consts.H / b_max
    eta = t - consts.delta - consts.J / f_max
    zeta = N0 * b_max / consts.h
    expo = torch.clamp(gamma / torch.clamp_min(eta, 1e-30), 0.0, 60.0)
    p_lo0 = torch.where(eta > 0, zeta * (torch.exp2(expo) - 1.0), p_max)
    p_lo0 = torch.minimum(torch.clamp_min(p_lo0, 0.0), p_max)

    def gap(lo, hi):
        return torch.amax((hi - lo) / torch.clamp_min(hi, 1e-12), dim=-1,
                          keepdim=True)

    def spare(p):                 # spare bandwidth -> lower p (save E)
        return algorithm2(consts, p, t, B, b_max, f_max, N0, cfg)[2] < B

    _, p = _bisect(p_lo0, p_max, gap, cfg.eps1, cfg.p_iters, spare)
    b, f, b_sum = algorithm2(consts, p, t, B, b_max, f_max, N0, cfg)
    return b, f, p, b_sum


# --------------------------------------------------------------------------
# Algorithm 4: outer bisection on t
# --------------------------------------------------------------------------
def _energy(consts: SroaConstants, b, f, p, N0):
    """Total E_sum of problem (17) + the constant cloud term (eq 14)."""
    G = p * consts.h / N0
    T_com = torch.where(b > 0, consts.H / torch.clamp_min(rate_fn(b, G),
                                                          1e-30), _BIG)
    E_com = p * T_com                       # already scaled by I*K via H
    E_cmp = consts.A * (f * f)
    return torch.sum(E_com + E_cmp, dim=-1, keepdim=True) + \
        consts.E_cloud_total


def _auto_bounds(consts: SroaConstants, B, f_max, p_max, N0, lam,
                 cfg: SroaConfig):
    """Derive [t_lo, t_up] for Algorithm 4 from the scenario itself.

    t_lo: slightly below the smallest feasible deadline at f_max/p_max;
    t_up: a multiple (growing with 1/lam) of the equal-split delay.
    """
    G = p_max * consts.h / N0
    lo = torch.full_like(B, cfg.t_low)
    hi = torch.full_like(B, cfg.t_up)
    for _ in range(cfg.t_iters):
        mid = 0.5 * (lo + hi)
        tau = mid - consts.delta - consts.J / f_max
        target = torch.where(tau > 0, consts.H / torch.clamp_min(tau, 1e-30),
                             _BIG)
        # Strict: an infeasible deadline pegs a user at b = b_max = B, so a
        # single-user cell sums to EXACTLY B and `<=` would call every t
        # feasible.  A feasible minimal allocation never lands on B.
        ok = torch.sum(invert_rate(G, target, B, iters=cfg.b_iters), dim=-1,
                       keepdim=True) < B
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    t_min = hi

    # Equal-split delay; the head count is the number of *real* users
    # (H > 0) so a padded fleet cell follows its standalone t-grid.
    n_eff = torch.clamp_min(torch.sum((consts.H > 0).to(torch.float32),
                                      dim=-1, keepdim=True), 1.0)
    T_com = consts.H / torch.clamp_min(rate_fn(B / n_eff, G), 1e-30)
    t_naive = torch.amax(T_com + consts.J / f_max + consts.delta, dim=-1,
                         keepdim=True)
    t_lo = 0.95 * t_min
    # A true division (``8.0 / tensor`` multiplies by the reciprocal).
    factor = torch.clamp(torch.full_like(lam, 8.0)
                         / torch.clamp_min(lam, 1e-30), 8.0, 2e4)
    t_up = torch.maximum(factor * t_naive, 2.0 * t_lo)
    return t_lo, t_up


def _solve_constants_fused(consts: SroaConstants, B, b_max, f_max, p_max,
                           N0, lam, cfg: SroaConfig) -> SroaResult:
    """The whole nest in one launch of kernel K2 (its plain version on
    CPU).  Agrees with the host-loop nest to bisection tolerance."""
    b, f, p, t, R, b_sum, feas = kops.sroa_solve_batched(
        consts.A, consts.J, consts.H, consts.delta, consts.h, f_max, p_max,
        B, b_max, N0, lam, consts.E_cloud_total, b_iters=cfg.b_iters,
        f_iters=cfg.f_iters, p_iters=cfg.p_iters, t_iters=cfg.t_iters,
        eps0=cfg.eps0, eps1=cfg.eps1, eps2=cfg.eps2, t_low=cfg.t_low,
        t_up=cfg.t_up)
    return SroaResult(b=b, f=f, p=p, t=t, R=R, b_sum=b_sum, feasible=feas)


def _select(cond, new: tuple, old: tuple) -> tuple:
    return tuple(torch.where(cond, n, o) for n, o in zip(new, old))


def solve_constants_impl(consts: SroaConstants, B, b_max, f_max, p_max, N0,
                         lam, cfg: SroaConfig = SroaConfig()) -> SroaResult:
    """Algorithm 4 on pre-computed constants, for a batch of problems.

    Per-user leaves are (..., N) and per-problem operands (...) or scalar;
    every leading axis is one independent problem.  With ``cfg.fused``
    (and automatic bounds, no polish) the nest runs in kernel K2.
    """
    if cfg.fused and cfg.auto_bounds and cfg.refine_iters == 0:
        return _solve_constants_fused(consts, B, b_max, f_max, p_max, N0,
                                      lam, cfg)
    h = torch.as_tensor(consts.h, dtype=torch.float32)
    lead, N = h.shape[:-1], h.shape[-1]
    P = math.prod(lead)
    dev = h.device

    def fu(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return torch.broadcast_to(x, lead + (N,)).reshape(P, N)

    def fs(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return torch.broadcast_to(x, lead).reshape(P, 1)

    c = SroaConstants(A=fu(consts.A), J=fu(consts.J), H=fu(consts.H),
                      delta=fu(consts.delta), h=fu(consts.h),
                      E_cloud_total=fs(consts.E_cloud_total))
    B, b_max, N0, lam = fs(B), fs(b_max), fs(N0), fs(lam)
    f_max, p_max = fu(f_max), fu(p_max)
    b_tol = B * (1.0 + 1e-3)

    def eval_t(t):
        b, f, p, b_sum = algorithm3(c, t, B, b_max, f_max, p_max, N0, cfg)
        return b, f, p, b_sum, _energy(c, b, f, p, N0) + lam * t

    def eval_t_plus(t):
        """Beyond-paper (SROA+): also evaluate f-prioritized candidates at
        fixed power levels and keep the best."""
        best = eval_t(t)
        for scale in (1.0, 1e-1, 1e-2, 1e-3):
            p_c = p_max * scale
            b, f, b_sum = algorithm2(c, p_c, t, B, b_max, f_max, N0, cfg)
            R = _energy(c, b, f, p_c, N0) + lam * t
            better = (b_sum <= b_tol) & (R < best[4])
            best = _select(better, (b, f, p_c, b_sum, R), best)
        return best

    if cfg.auto_bounds:
        t_lo0, t_up0 = _auto_bounds(c, B, f_max, p_max, N0, lam, cfg)
    else:
        t_lo0 = torch.full_like(B, cfg.t_low)
        t_up0 = torch.full_like(B, cfg.t_up)

    # Seed "best" with the largest deadline (always feasible if anything is).
    b0, f0, p0, bsum0, R0 = eval_t(t_up0)
    best = (b0, f0, p0, t_up0, R0, bsum0)
    R_star = torch.where(bsum0 > b_tol, _BIG, R0)
    t_lo, t_up = t_lo0, t_up0
    for _ in range(cfg.t_iters):
        act = (t_up - t_lo) / t_up > cfg.eps2
        if not bool(act.any()):
            break
        t = 0.5 * (t_lo + t_up)
        b, f, p, b_sum, R = eval_t(t)
        infeasible = b_sum > b_tol
        improved = act & ~infeasible & (R <= R_star)
        t_lo = torch.where(act & (infeasible | (R > R_star)), t, t_lo)
        t_up = torch.where(improved, t, t_up)
        R_star = torch.where(improved, R, R_star)
        best = _select(improved, (b, f, p, t, R, b_sum), best)
    b, f, p, t, R, b_sum = best

    if cfg.refine_iters > 0:
        # Beyond-paper polish (SROA+): coarse log-grid scan over
        # [t_lo, t_up], then golden-section around the best bracket.
        def R_at(t):
            _, _, _, b_sum_t, Rt = eval_t_plus(t)
            return torch.where(b_sum_t > b_tol, _BIG, Rt)

        n_grid = 16
        a0 = torch.log(torch.clamp_min(t_lo0, 1e-3))
        a1 = torch.log(t_up0)
        steps = torch.arange(n_grid, dtype=torch.float32, device=dev)
        grid = a0 + (a1 - a0) / (n_grid - 1) * steps
        grid[:, -1:] = a1
        ts = torch.exp(grid)                          # (P, n_grid)
        t_g, R_g = t, R
        for i in range(n_grid):
            Rt = R_at(ts[:, i:i + 1])
            better_i = Rt < R_g
            t_g = torch.where(better_i, ts[:, i:i + 1], t_g)
            R_g = torch.where(better_i, Rt, R_g)

        gr = 0.6180339887498949
        lo, hi = 0.5 * t_g, torch.minimum(2.5 * t_g, t_up0)
        for _ in range(cfg.refine_iters):
            x1 = hi - gr * (hi - lo)
            x2 = lo + gr * (hi - lo)
            shrink_hi = R_at(x1) < R_at(x2)
            lo, hi = (torch.where(shrink_hi, lo, x1),
                      torch.where(shrink_hi, x2, hi))
        t_ref = 0.5 * (lo + hi)
        b2, f2, p2, bsum2, R2 = eval_t_plus(t_ref)
        better = (bsum2 <= b_tol) & (R2 < R)
        b, f, p, t, R, b_sum = _select(better, (b2, f2, p2, t_ref, R2, bsum2),
                                       (b, f, p, t, R, b_sum))

    def out_u(x):
        return x.reshape(lead + (N,))

    def out_s(x):
        return x.reshape(lead)

    return SroaResult(b=out_u(b), f=out_u(f), p=out_u(p), t=out_s(t),
                      R=out_s(R), b_sum=out_s(b_sum),
                      feasible=out_s(b_sum <= b_tol))


solve_constants = solve_constants_impl


def solve(scn: Scenario, assign: torch.Tensor, lam,
          cfg: SroaConfig = SroaConfig(), comp=None,
          ladder=None) -> SroaResult:
    """SROA for one assignment pattern: the paper's Algorithm 4 end-to-end.

    Batched scenarios (leading shape S) with assignments S + (N,) solve as
    independent problems.
    """
    consts = sroa_constants(scn, assign, comp=comp, ladder=ladder)
    B = scn.B_open
    return solve_constants_impl(consts, B, B, scn.f_max, scn.p_max, scn.N0,
                                torch.as_tensor(lam, dtype=torch.float32,
                                                device=scn.device), cfg)


def solve_plus(scn: Scenario, assign: torch.Tensor, lam,
               cfg: SroaConfig = SroaConfig()) -> SroaResult:
    """Beyond-paper SROA+: Algorithm 4 followed by a golden-section polish
    of t*.  Never worse than the paper's solution."""
    cfg = dataclasses.replace(cfg, refine_iters=max(cfg.refine_iters, 32))
    return solve(scn, assign, lam, cfg)
