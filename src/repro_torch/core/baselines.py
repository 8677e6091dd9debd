"""Resource-allocation baselines the paper compares against (Figs 2-3).

Each baseline is re-implemented at the level of detail the paper uses for
comparison (DESIGN.md D3).  All of them return a full (b, f, p) allocation
for a given assignment and are scored through
:func:`repro_torch.core.system_model.evaluate` — the same cost model as
SROA — so the comparison is apples-to-apples:

* ``naive_equal``  — equal bandwidth split, f_max, p_max (sanity floor).
* ``jdsra``  [32]  — latency-constrained scheduling: delay-optimal bandwidth
  (smallest common deadline with sum b <= B), f = f_max, p = p_max.
* ``era``    [33]  — energy-efficient radio resource allocation: minimizes
  energy under a fixed (not optimized) deadline taken from the naive
  configuration.
* ``fedl``   [34]  — per-user energy/delay balance of f (closed form) and p
  (golden search) with an equal bandwidth split.
* ``hfel_ra``[35]  — HFEL's per-edge joint (b, f) with p = p_max and the
  per-edge bandwidth budgets B_m (no global pooling).
* ``juara_ra``[39] — bandwidth-only allocation at a delay target swept
  downward in fixed steps, f = f_max, p = p_max.

Routing follows the JAX package: ``jdsra``, ``era`` and ``juara_ra`` invert
the rate with the plain :func:`~repro_torch.core.sroa.invert_rate`;
``hfel_ra`` goes through :func:`~repro_torch.core.sroa.algorithm2`, whose
inversion follows ``cfg.use_pallas`` (kernel K1 on a card); ``sroa_ra``
goes through :func:`~repro_torch.core.sroa.solve` (kernel K2 when
``cfg.fused``).  Every result lies on the scenario's device.

OFDMA variants quantize any method's bandwidth vector onto a subcarrier grid
(:func:`to_ofdma`), mirroring the paper's Fig 2(b)/3(b) split.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.sroa import (SroaConfig, algorithm2, invert_rate,
                                   rate_fn)
from repro_torch.core.system_model import evaluate, sroa_constants
from repro_torch.core.wireless import Scenario

_BIG = 1e30
SUBCARRIER_HZ = 15e3


class RaResult(NamedTuple):
    b: torch.Tensor
    f: torch.Tensor
    p: torch.Tensor


def _assign(scn: Scenario, assign) -> torch.Tensor:
    """An assignment (numpy or tensor) as an int32 tensor on the
    scenario's device."""
    if isinstance(assign, torch.Tensor):
        return assign.to(device=scn.device, dtype=torch.int32)
    return torch.tensor(np.asarray(assign), dtype=torch.int32,
                        device=scn.device)


def _f32(x, scn: Scenario) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=scn.device)


# --------------------------------------------------------------------------
def naive_equal(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig()):
    N = scn.N
    b = torch.broadcast_to(scn.B_total / N, (N,)).clone()
    return RaResult(b=b, f=scn.f_max, p=scn.p_max)


# --------------------------------------------------------------------------
def jdsra(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig()):
    """Delay-optimal bandwidth at f_max/p_max: bisect the common deadline."""
    consts = sroa_constants(scn, _assign(scn, assign))
    B = scn.B_total
    G = scn.p_max * consts.h / scn.N0

    def b_of_t(t):
        tau = t - consts.delta - consts.J / scn.f_max
        target = torch.where(tau > 0, consts.H / torch.clamp_min(tau, 1e-30),
                             _BIG)
        return invert_rate(G, target, B, iters=cfg.b_iters)

    lo, hi = _f32(cfg.t_low, scn), _f32(cfg.t_up, scn)
    for _ in range(cfg.t_iters):
        mid = 0.5 * (lo + hi)
        ok = torch.sum(b_of_t(mid)) <= B
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return RaResult(b=b_of_t(hi), f=scn.f_max, p=scn.p_max)


# --------------------------------------------------------------------------
def era(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig(),
        mu_iters: int = 48):
    """ERA [33]: bandwidth-only energy-efficient allocation.

    CPU frequency and transmit power are fixed (f_max, p_max); bandwidth is
    water-filled on the marginal transmission energy (bisection on the
    multiplier mu), floored at the deadline-meeting minimum, under a
    per-round latency budget taken from the naive configuration.
    """
    a = _assign(scn, assign)
    consts = sroa_constants(scn, a)
    B = scn.B_total
    naive = naive_equal(scn, a, lam)
    t_dl = evaluate(scn, a, naive.b, naive.f, naive.p, lam).T_sum
    tau = torch.clamp_min(t_dl - consts.delta - consts.J / scn.f_max, 1e-3)
    G = scn.p_max * consts.h / scn.N0
    b_min = invert_rate(G, consts.H / tau, B, iters=cfg.b_iters)

    def E_com(b):                          # decreasing convex in b
        return scn.p_max * consts.H / torch.clamp_min(rate_fn(b, G), 1e-30)

    def neg_marginal(b):                   # -dE/db > 0, decreasing in b
        db = torch.clamp_min(b, 1.0) * 1e-4
        return (E_com(b) - E_com(b + db)) / db

    def b_of_mu(mu):
        lo = torch.ones_like(G)
        hi = torch.broadcast_to(B, G.shape).clone()
        for _ in range(cfg.b_iters):
            mid = 0.5 * (lo + hi)
            more = neg_marginal(mid) > mu  # still worth more bandwidth
            lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
        return torch.maximum(0.5 * (lo + hi), b_min)

    mu_lo, mu_hi = _f32(1e-20, scn), _f32(1e3, scn)
    for _ in range(mu_iters):
        mid = torch.sqrt(mu_lo * mu_hi)    # log-scale bisection on mu
        over = torch.sum(b_of_mu(mid)) > B  # too much bandwidth -> raise mu
        mu_lo, mu_hi = (torch.where(over, mid, mu_lo),
                        torch.where(over, mu_hi, mid))
    b = b_of_mu(torch.sqrt(mu_lo * mu_hi))
    b = b * torch.clamp_max(B / torch.clamp_min(torch.sum(b), 1.0), 1.0)
    return RaResult(b=b, f=scn.f_max, p=scn.p_max)


# --------------------------------------------------------------------------
def fedl(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig(),
         golden_iters: int = 60):
    """Per-user energy/delay balance, equal bandwidth (single-server FL)."""
    consts = sroa_constants(scn, _assign(scn, assign))
    N = scn.N
    b = torch.broadcast_to(scn.B_total / N, (N,)).clone()
    w = lam / N                       # per-user share of the delay weight
    # f*: argmin_f A f^2 + w J / f  ->  f* = (w J / (2 A))^(1/3)
    f_star = (w * consts.J / (2.0 * torch.clamp_min(consts.A, 1e-38))
              ) ** (1.0 / 3.0)
    f = torch.minimum(torch.clamp_min(f_star, 1e6), scn.f_max)

    # p*: argmin_p (p + w) * H / (b log2(1 + h p / (N0 b))), golden search
    def cost_p(p):
        r = rate_fn(b, p * consts.h / scn.N0)
        return (p + w) * consts.H / torch.clamp_min(r, 1e-30)

    gr = 0.5 * (math.sqrt(5.0) - 1.0)
    lo = torch.full((N,), 1e-6, device=scn.device)
    hi = scn.p_max
    for _ in range(golden_iters):
        x1 = hi - gr * (hi - lo)
        x2 = lo + gr * (hi - lo)
        shrink_hi = cost_p(x1) < cost_p(x2)
        lo, hi = (torch.where(shrink_hi, lo, x1),
                  torch.where(shrink_hi, x2, hi))
    return RaResult(b=b, f=f, p=0.5 * (lo + hi))


# --------------------------------------------------------------------------
def _hfel_edge_solve(sub, B_m, f_max, p_max, N0, lam, cfg: SroaConfig):
    """Per-edge HFEL solve: value-bisect t_m; (b, f) via Algorithm 2 at
    fixed p = p_max; per-edge budget B_m (no pooling).

    The JAX package's ``lax.while_loop``, as a host loop with the same
    condition, body and selections.  ``sub`` holds the edge's members'
    constants (n,); one problem of n users goes through Algorithm 2.
    """
    row = lambda x: x[None]                               # noqa: E731
    col = lambda x: x.reshape(1, 1)                       # noqa: E731
    sub2 = sub._replace(A=row(sub.A), J=row(sub.J), H=row(sub.H),
                        delta=row(sub.delta), h=row(sub.h))
    p2, f2, B2, N02 = row(p_max), row(f_max), col(B_m), col(N0)

    def eval_t(t):
        bb, ff, b_sum = algorithm2(sub2, p2, col(t), B2, B2, f2, N02, cfg)
        bb, ff = bb[0], ff[0]
        E = torch.sum(sub.A * (ff * ff) +
                      p_max * sub.H /
                      torch.clamp_min(rate_fn(bb, p_max * sub.h / N0),
                                      1e-30))
        return bb, ff, b_sum.reshape(()), E + lam * t

    t_lo = torch.tensor(cfg.t_low, dtype=torch.float32, device=B_m.device)
    t_up = torch.tensor(cfg.t_up, dtype=torch.float32, device=B_m.device)
    b0, f0, _, R_star = eval_t(t_up)
    best = (b0, f0)
    it = 0
    while bool((t_up - t_lo) / t_up > cfg.eps2) and it < cfg.t_iters:
        t = 0.5 * (t_lo + t_up)
        bb, ff, b_sum, R = eval_t(t)
        infeasible = b_sum > B_m * (1.0 + 1e-3)
        improved = ~infeasible & (R <= R_star)
        t_lo = torch.where(infeasible | (R > R_star), t, t_lo)
        t_up = torch.where(improved, t, t_up)
        R_star = torch.where(improved, R, R_star)
        best = tuple(torch.where(improved, new, old)
                     for new, old in zip((bb, ff), best))
        it += 1
    return best


def hfel_ra(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig()):
    """HFEL: per-edge joint (b, f) with p = p_max and per-edge budgets B_m."""
    a = _assign(scn, assign)
    assign_np = a.cpu().numpy()
    b = torch.zeros(scn.N, device=scn.device)
    f = torch.zeros(scn.N, device=scn.device)
    consts = sroa_constants(scn, a)
    lam_t = _f32(lam, scn)
    for m in range(scn.M):
        idx = np.flatnonzero(assign_np == m)
        if idx.size == 0:
            continue
        ix = torch.as_tensor(idx, device=scn.device)
        sub = consts._replace(A=consts.A[ix], J=consts.J[ix],
                              H=consts.H[ix], delta=consts.delta[ix],
                              h=consts.h[ix])
        bb, ff = _hfel_edge_solve(sub, scn.B_edges[m], scn.f_max[ix],
                                  scn.p_max[ix], scn.N0, lam_t, cfg)
        b[ix], f[ix] = bb, ff
    return RaResult(b=b, f=f, p=scn.p_max)


# --------------------------------------------------------------------------
def _linspace(start: torch.Tensor, stop: float, num: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in float32: start (1 - s) + stop s
    with s = i / (num - 1), then the endpoint itself."""
    div = num - 1
    s = (torch.arange(div, dtype=torch.float32, device=start.device)
         / torch.tensor(float(div), device=start.device))
    stop_t = torch.tensor(stop, dtype=torch.float32, device=start.device)
    return torch.cat([start * (1 - s) + stop_t * s, stop_t[None]])


def juara_ra(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig(),
             steps: int = 100):
    """Bandwidth-only: sweep the delay target downward in fixed steps."""
    a = _assign(scn, assign)
    consts = sroa_constants(scn, a)
    B = scn.B_total
    G = scn.p_max * consts.h / scn.N0
    naive = naive_equal(scn, a, lam)
    t_hi = evaluate(scn, a, naive.b, naive.f, naive.p, lam).T_sum
    # Every deadline of the fixed-step sweep at once: (steps, 1) against
    # the (N,) users, as the JAX package's vmap over the sweep.
    ts = _linspace(t_hi, cfg.t_low, steps)[:, None]
    tau = ts - consts.delta - consts.J / scn.f_max
    target = torch.where(tau > 0, consts.H / torch.clamp_min(tau, 1e-30),
                         _BIG)
    bs = invert_rate(torch.broadcast_to(G, target.shape), target, B,
                     iters=cfg.b_iters)
    feas = torch.sum(bs, dim=-1) <= B
    E = torch.sum(consts.A * (scn.f_max * scn.f_max) +
                  scn.p_max * consts.H /
                  torch.clamp_min(rate_fn(bs, G), 1e-30), dim=-1) \
        + consts.E_cloud_total
    Rs = torch.where(feas, E + lam * ts[:, 0], _BIG)
    i = torch.argmin(Rs)
    return RaResult(b=bs[i], f=scn.f_max, p=scn.p_max)


# --------------------------------------------------------------------------
def sroa_ra(scn: Scenario, assign, lam, cfg: SroaConfig = SroaConfig()):
    """The paper's SROA, exposed under the common RA interface."""
    res = sroa.solve(scn, _assign(scn, assign), lam, cfg)
    return RaResult(b=res.b, f=res.f, p=res.p)


# --------------------------------------------------------------------------
def to_ofdma(scn: Scenario, ra: RaResult,
             subcarrier_hz: float = SUBCARRIER_HZ) -> RaResult:
    """Quantize a bandwidth vector onto the OFDMA subcarrier grid.

    Floors each b_n to the grid, then hands the freed subcarriers back to the
    users with the largest fractional remainders (greedy), keeping sum b <= B.
    """
    b = ra.b.detach().cpu().numpy().astype(np.float64)
    q = np.floor(b / subcarrier_hz)
    frac = b / subcarrier_hz - q
    spare = int(np.floor((float(scn.B_total) - q.sum() * subcarrier_hz)
                         / subcarrier_hz))
    if spare > 0:
        order = np.argsort(-frac)
        q[order[:spare]] += 1.0
    return RaResult(b=torch.tensor(q * subcarrier_hz, dtype=torch.float32,
                                   device=ra.b.device),
                    f=ra.f, p=ra.p)


RA_METHODS: Dict[str, Callable] = {
    "SROA": sroa_ra,
    "FEDL": fedl,
    "HFEL": hfel_ra,
    "JDSRA": jdsra,
    "ERA": era,
    "JUARA": juara_ra,
    "naive": naive_equal,
}
