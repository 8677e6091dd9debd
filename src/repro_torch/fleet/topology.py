"""Bilevel topology design: edge placement/activation as variables (D12).

Every layer below this one optimizes over a FIXED edge topology.  Here
each cell's geometry is a candidate-site set of size ``M_cand`` (a
superset of the live edges) with a per-site open/close activation mask
and a per-site activation cost, and the topology itself becomes a
decision variable:

* the OUTER loop proposes topology moves — open a closed site, close an
  open one, or relocate (close+open in one step) — ranked by a cheap
  airtime/coverage proxy (:func:`proxy_cost`, no SROA solves);
* the INNER loop re-solves assignment + SROA for the proposed masks with
  the batched engine, where closed sites are excluded via
  ``Scenario.edge_mask`` (mirroring the padded-user mask machinery: the
  mask re-flags candidate moves instead of changing any shape, and an
  all-sites-open mask is bitwise the fixed-M path).

Every outer round batches ONE proposal per cell into a single
full-fleet engine search — C inner searches per round regardless of how
many cells are redesigning.  Greedy accept on the TRUE total cost
(eq-15 objective + ``edge_cost`` per open site) makes the design
monotone: the returned topology never costs more than the starting one.

The service runs this on a slow two-timescale cadence
(``ServiceConfig.topology_period`` ticks per redesign) between fast
drift-gated reassignment ticks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.fleet import engine as fengine
from repro_torch.fleet.batch import FleetScenario, fleet_assignments


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Outer-loop knobs for :func:`design_topology`.

    ``edge_cost`` is the activation cost per OPEN site in weighted
    eq-15 cost units (the total the design minimizes is
    ``R + edge_cost * n_open``); ``min_open`` floors how many sites a
    cell must keep; ``fixed_count`` restricts proposals to relocations
    (open-site count conserved — the equal-count comparison the bench
    pins); ``max_rounds`` caps outer proposal rounds.
    """

    edge_cost: float = 0.0
    min_open: int = 1
    fixed_count: bool = False
    max_rounds: int = 8

    def __post_init__(self):
        if self.edge_cost < 0:
            raise ValueError("TopologyConfig.edge_cost must be >= 0")
        if self.min_open < 1:
            raise ValueError("TopologyConfig.min_open must be >= 1")
        if self.max_rounds < 0:
            raise ValueError("TopologyConfig.max_rounds must be >= 0")


class TopologyResult(NamedTuple):
    """Designed topology + the inner solution under it (all host arrays)."""

    fleet: FleetScenario      # input fleet with the designed mask installed
    edge_mask: np.ndarray     # (C, M) final activation mask
    assigns: np.ndarray       # (C, N) assignment under the designed topology
    comps: np.ndarray        # (C, N) compression levels (zeros, ladder off)
    R: np.ndarray            # (C,) eq-15 objective per cell
    n_open: np.ndarray       # (C,) open-site count per cell
    total: np.ndarray        # (C,) R + edge_cost * n_open
    history: tuple           # accepted moves: (round, cell, closed, opened)
    inner_rounds: int        # outer rounds that ran an inner solve


def uniform_mask(C: int, M: int, n_open: int) -> np.ndarray:
    """(C, M) fixed uniform placement: the first ``n_open`` sites open.

    The baseline topology the bench compares against — no knowledge of
    the draw's geometry or bandwidths, same open count everywhere.
    """
    if not 1 <= n_open <= M:
        raise ValueError(f"n_open must be in [1, {M}], got {n_open}")
    em = np.zeros((C, M), bool)
    em[:, :n_open] = True
    return em


def with_edge_mask(fleet: FleetScenario,
                   edge_mask: np.ndarray | None) -> FleetScenario:
    """The fleet with ``edge_mask`` (C, M) installed on every cell (None
    removes it).

    The mask is a ``Scenario`` leaf, so it rides every leaf-wise map —
    planner slicing, the service's sub-fleets, device splits, cache
    digests — with no further plumbing.
    """
    em = None if edge_mask is None else torch.as_tensor(
        np.asarray(_host(edge_mask), bool), device=fleet.device)
    return fleet._replace(cells=fleet.cells._replace(edge_mask=em))


def _proxy_rows(gain: np.ndarray, B_edges: np.ndarray, mask: np.ndarray,
                p: np.ndarray, N0: float, s_eff: np.ndarray, ik: float,
                masks: np.ndarray, lam: float) -> np.ndarray:
    """(P,) airtime proxy of ONE cell under P candidate masks (vectorized).

    Each active user associates with its best-gain OPEN site and gets an
    equal share of the open bandwidth; the proxy is the summed weighted
    upload cost ``I*K * (p_max + lam) * s_eff / r`` — the same
    marginal-cost currency as the top-k move kernel.  Coverage is priced
    implicitly: closing the only site near a user collapses its best
    gain and the proxy blows up with its airtime.
    """
    em = np.asarray(masks, bool)                             # (P, M)
    g_best = np.max(np.where(em[:, None, :], gain[None], 0.0), axis=2)
    B_open = np.sum(np.where(em, B_edges[None], 0.0), axis=1)
    n_act = max(int(mask.sum()), 1)
    b_bar = (B_open / n_act)[:, None]                        # (P, 1)
    r = b_bar * np.log2(1.0 + g_best * p[None]
                        / np.maximum(N0 * b_bar, 1e-30))
    t_up = s_eff[None] / np.maximum(r, 1e-12)
    cost = ik * (p[None] + lam) * t_up
    return np.where(mask[None], cost, 0.0).sum(axis=1)


def _proxy_operands(fleet: FleetScenario) -> tuple:
    """The fleet's leaves :func:`_proxy_rows` reads, as float64 numpy."""
    c = fleet.cells

    def f64(x):
        return _host(x).astype(np.float64)

    s_eff = f64(c.s_bits)[:, None] * f64(c.size_mult)
    return (f64(c.gain), f64(c.B_edges), _host(fleet.mask).astype(bool),
            f64(c.p_max), f64(c.N0), s_eff, f64(c.I) * f64(c.K))


def proxy_cost(fleet: FleetScenario, edge_mask: np.ndarray,
               lam: float = 1.0) -> np.ndarray:
    """(C,) cheap airtime/coverage proxy of eq-15 under a mask (no solves).

    Per-cell :func:`_proxy_rows` with one mask each — the outer loop's
    ranking signal, also useful standalone for telemetry.
    """
    em = np.asarray(_host(edge_mask), bool)
    gain, B_edges, mask, p, N0, s_eff, ik = _proxy_operands(fleet)
    return np.array([
        _proxy_rows(gain[c], B_edges[c], mask[c], p[c], float(N0[c]),
                    s_eff[c], float(ik[c]), em[c:c + 1], lam)[0]
        for c in range(fleet.C)])


def _cell_proposals(em_row: np.ndarray, topo: TopologyConfig) -> list:
    """All single-step masks reachable from ``em_row`` under the config.

    Relocations (close one open site, open one closed) conserve the open
    count; pure opens/closes change it and are skipped when
    ``fixed_count`` is set or the ``min_open`` floor binds.  O(M^2) masks
    for M candidate sites — tiny, and only ONE survives proxy ranking.
    """
    open_idx = np.flatnonzero(em_row)
    closed_idx = np.flatnonzero(~em_row)
    out = []
    for i in open_idx:
        for j in closed_idx:
            m = em_row.copy()
            m[i], m[j] = False, True
            out.append((m, int(i), int(j)))
    if not topo.fixed_count:
        for j in closed_idx:
            m = em_row.copy()
            m[j] = True
            out.append((m, -1, int(j)))
        if len(open_idx) > topo.min_open:
            for i in open_idx:
                m = em_row.copy()
                m[i] = False
                out.append((m, int(i), -1))
    return out


def _remap_to_open(assigns: np.ndarray, em: np.ndarray,
                   fleet: FleetScenario) -> np.ndarray:
    """Re-home assignment entries whose edge is closed under ``em``."""
    ne = _host(fleet_assignments(with_edge_mask(fleet, em))).astype(np.int32)
    valid = np.take_along_axis(np.asarray(em, bool),
                               np.asarray(assigns, np.int64), axis=1)
    return np.where(valid, assigns, ne).astype(np.int32)


def design_topology(fleet: FleetScenario, lam=1.0,
                    cfg: sroa.SroaConfig = sroa.SroaConfig(),
                    topo: TopologyConfig = TopologyConfig(),
                    edge_mask: np.ndarray | None = None,
                    init_assigns: np.ndarray | None = None, *,
                    max_rounds: int = 16, escape_iters: int = 2,
                    top_k: int = 0, n_starts: int = 1) -> TopologyResult:
    """Bilevel greedy topology design over a fleet's candidate sites.

    Starting from ``edge_mask`` (the fleet's installed mask, or all-open),
    each outer round picks the best-proxy untried move per cell, batches
    all proposals into ONE full-fleet inner engine solve (same treedef
    every round — one compile covers the whole design run), and accepts
    per cell exactly when the TRUE total cost ``R + edge_cost * n_open``
    strictly improves.  Greedy accept makes the result monotone: the
    returned topology never totals worse than the starting one, and with
    ``fixed_count`` the open-site count is conserved (the equal-count
    claim the bench asserts).

    ``max_rounds``/``escape_iters``/``top_k``/``n_starts`` are the inner
    engine's knobs (D7/D9); keep them modest — the outer loop re-solves
    the fleet up to ``topo.max_rounds`` times.
    """
    C, M = fleet.C, fleet.M
    if edge_mask is None:
        em0 = fleet.cells.edge_mask
        em = (np.ones((C, M), bool) if em0 is None
              else _host(em0).astype(bool))
    else:
        em = np.asarray(edge_mask, bool).copy()
    if (em.sum(axis=1) < topo.min_open).any():
        raise ValueError("initial edge_mask violates TopologyConfig.min_open")

    def inner(masks: np.ndarray, warm: np.ndarray):
        out = fengine.solve_fleet_assignments(
            with_edge_mask(fleet, masks),
            torch.as_tensor(_remap_to_open(warm, masks, fleet),
                            device=fleet.device), lam, cfg,
            max_rounds, escape_iters, top_k, n_starts)
        return (_host(out.assign).astype(np.int32),
                _host(out.R).astype(np.float64),
                _host(out.comp).astype(np.int32))

    warm = (_host(fleet_assignments(with_edge_mask(fleet, em)))
            .astype(np.int32)
            if init_assigns is None
            else np.array(_host(init_assigns), np.int32))
    assigns, R, comps = inner(em, warm)
    n_open = em.sum(axis=1)
    total = R + topo.edge_cost * n_open
    lam_f = float(np.mean(np.asarray(_host(lam), np.float64)))
    gain, B_edges, umask, p, N0, s_eff, ik = _proxy_operands(fleet)
    history: list = []
    tried = {(c, em[c].tobytes()) for c in range(C)}
    rounds = 0
    for rnd in range(topo.max_rounds):
        trial = em.copy()
        moves: dict[int, tuple[int, int]] = {}
        for c in range(C):
            props = [(m, i, j) for m, i, j in _cell_proposals(em[c], topo)
                     if (c, m.tobytes()) not in tried]
            if not props:
                continue
            # Rank untried moves by proxy + activation: one vectorized
            # numpy pass over all of the cell's proposal masks.
            rows = np.stack([m for m, _, _ in props])
            score = (_proxy_rows(gain[c], B_edges[c], umask[c], p[c],
                                 float(N0[c]), s_eff[c], float(ik[c]),
                                 rows, lam_f)
                     + topo.edge_cost * rows.sum(axis=1))
            k = int(np.argmin(score))
            trial[c] = props[k][0]
            moves[c] = (props[k][1], props[k][2])
            tried.add((c, props[k][0].tobytes()))
        if not moves:
            break
        rounds += 1
        t_assigns, t_R, t_comps = inner(trial, assigns)
        t_total = t_R + topo.edge_cost * trial.sum(axis=1)
        for c, (closed, opened) in moves.items():
            if t_total[c] < total[c] - 1e-9:
                em[c] = trial[c]
                assigns[c] = t_assigns[c]
                comps[c] = t_comps[c]
                R[c], total[c] = t_R[c], t_total[c]
                history.append((rnd, c, closed, opened))
    n_open = em.sum(axis=1)
    return TopologyResult(fleet=with_edge_mask(fleet, em), edge_mask=em,
                          assigns=assigns, comps=comps, R=R,
                          n_open=n_open.astype(np.int64),
                          total=R + topo.edge_cost * n_open,
                          history=tuple(history), inner_rounds=rounds)
