"""Incremental TSIA front end: the batched engine and the host reference loop.

:func:`solve` is a thin host wrapper around the assignment engine
(:func:`repro_torch.fleet.engine.solve_assignment`), which runs the whole
descent + escape search for one cell; the wrapper rebuilds the
:class:`BatchedTsiaHistory` (trace, moves, round-trip accounting) from the
engine's fixed-size trace buffers.

:func:`solve_host` is the host-driven loop: one batched SROA call per
assigning iteration over the full single-move neighbourhood (one launch of
kernel K2 at P = 1 + n_movable (M - 1) under ``SroaConfig.fused``), then
the cost model over every candidate at once.  It is the oracle the engine
is parity-tested against.

:func:`replan` warm-starts either path from a previous assignment after a
dynamics event, seeding only new users via nearest-edge init; the engine
route takes the rolling horizon (``gain_stack``/``switch_cost``, DESIGN.md
D10), compression ladders (``ladder``/``init_comp``, D11) and edge masks
(D12).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.system_model import evaluate_candidates
from repro_torch.core.wireless import Scenario, nearest_edge_assignment
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import engine as fengine


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass
class BatchedTsiaHistory:
    """Trace plus the round-trip accounting the fleet engine optimizes."""

    R_trace: list                 # best-known R after every round
    moves: list                   # (round, user, from_edge, to_edge, kind)
    rounds: int = 0               # assigning iterations (batched)
    solve_calls: int = 0          # batched SROA calls
    candidates_evaluated: int = 0  # patterns scored across all calls

    @property
    def round_trips_per_candidate(self) -> float:
        return self.solve_calls / max(self.candidates_evaluated, 1)


class BatchedTsiaResult(NamedTuple):
    assign: np.ndarray
    sroa: sroa.SroaResult        # numpy leaves
    R: float
    history: BatchedTsiaHistory
    comp: np.ndarray | None = None   # per-user compression levels (D11;
    #                                  None on the host path / ladder off)


def candidate_assigns(assign: np.ndarray, M: int,
                      movable: np.ndarray | None = None) -> np.ndarray:
    """(A, N) candidate patterns: row 0 = current, then all single moves."""
    assign = np.asarray(assign, np.int32)
    N = assign.shape[0]
    movable = np.ones(N, bool) if movable is None else np.asarray(movable,
                                                                  bool)
    rows = [assign]
    for n in np.flatnonzero(movable):
        for m in range(M):
            if m == assign[n]:
                continue
            cand = assign.copy()
            cand[n] = m
            rows.append(cand)
    return np.stack(rows)


def _first_move(base: np.ndarray, cand: np.ndarray) -> tuple[int, int, int]:
    n = int(np.flatnonzero(base != cand)[0])
    return n, int(base[n]), int(cand[n])


def _history_from_trace(res: fengine.EngineResult, n_movable: int,
                        M: int, top_k: int = 0) -> BatchedTsiaHistory:
    """Rebuild the host-side history from the engine's trace buffers."""
    rounds = int(res.rounds)
    valid = _host(res.trace.rounds_valid)
    R_best = _host(res.trace.R_best)
    mv = _host(res.trace.moves)
    hist = BatchedTsiaHistory(R_trace=[], moves=[], rounds=rounds,
                              solve_calls=1)
    # Every executed round scored the fixed-size candidate set: the full
    # neighbourhood (current pattern + movable users' moves), or only the
    # k kernel-nominated moves on the pruned path.  With no rounds
    # (max_rounds=0) the engine still scores the init pattern.
    per_round = (1 + top_k) if top_k else (1 + n_movable * (M - 1))
    hist.candidates_evaluated = rounds * per_round if rounds else 1
    kind_name = {fengine.KIND_DESCENT: "descent",
                 fengine.KIND_ESCAPE: "escape",
                 fengine.KIND_COMP: "comp"}
    for r in np.flatnonzero(valid):
        hist.R_trace.append(float(R_best[r]))
        user, src, dst, kind, moved = (int(x) for x in mv[r])
        if moved:
            hist.moves.append((int(r) + 1, user, src, dst,
                               kind_name[kind]))
    return hist


def _sroa_host(res: sroa.SroaResult) -> sroa.SroaResult:
    return sroa.SroaResult(*(_host(x) for x in res))


def solve(scn: Scenario, lam=1.0,
          cfg: sroa.SroaConfig = sroa.SroaConfig(),
          init_assign: np.ndarray | None = None,
          max_rounds: int = 64, escape_iters: int = 8,
          mask: np.ndarray | None = None, top_k: int = 0,
          n_starts: int = 1,
          gain_stack: np.ndarray | None = None,
          switch_cost: float = 0.0,
          incumbent: np.ndarray | None = None,
          ladder=None,
          init_comp: np.ndarray | None = None) -> BatchedTsiaResult:
    """Batched TSIA through the engine: one search for the cell.

    ``mask`` marks active users (inactive slots are never moved and carry
    zero cost); ``top_k`` and ``n_starts`` are the engine's search knobs
    (move pruning through kernel K3, and restarts; DESIGN.md D9);
    ``gain_stack`` (K, N, M, e.g. :func:`repro_torch.fleet.dynamics
    .predict_rollout`) with ``switch_cost``/``incumbent`` switches to the
    horizon objective (D10); ``ladder``/``init_comp`` make per-user
    compression a joint decision variable (D11).
    """
    dev = scn.device
    tmask = (torch.ones(scn.N, dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(np.asarray(_host(mask), bool), device=dev))
    init = (None if init_assign is None
            else torch.as_tensor(np.asarray(_host(init_assign), np.int32),
                                 device=dev))
    res = fengine.solve_assignment(scn, init, tmask, lam, cfg=cfg,
                                   max_rounds=max_rounds,
                                   escape_iters=escape_iters,
                                   top_k=top_k, n_starts=n_starts,
                                   gain_stack=gain_stack,
                                   switch_cost=float(switch_cost),
                                   incumbent=incumbent, ladder=ladder,
                                   init_comp=init_comp)
    n_movable = int(tmask.sum())
    hist = _history_from_trace(res, n_movable, scn.M, top_k)
    return BatchedTsiaResult(assign=_host(res.assign),
                             sroa=_sroa_host(res.sroa), R=float(res.R),
                             history=hist,
                             comp=None if ladder is None
                             else _host(res.comp))


def solve_host(scn: Scenario, lam=1.0,
               cfg: sroa.SroaConfig = sroa.SroaConfig(),
               init_assign: np.ndarray | None = None,
               max_rounds: int = 64, escape_iters: int = 8,
               mask: np.ndarray | None = None) -> BatchedTsiaResult:
    """Host loop, one batched SROA call per round (the engine's oracle)."""
    M = scn.M
    dev = scn.device
    movable = None if mask is None else np.asarray(_host(mask), bool)
    tmask = None if mask is None else torch.as_tensor(movable, device=dev)
    if init_assign is None:
        init_assign = nearest_edge_assignment(scn)
    current = np.array(_host(init_assign), np.int32)

    hist = BatchedTsiaHistory(R_trace=[], moves=[])

    def score(cands: np.ndarray):
        tc = torch.as_tensor(cands, device=dev)
        res = fbatch.solve_candidates(scn, tc, lam, cfg, tmask)
        ev = evaluate_candidates(scn, tc, res.b, res.f, res.p, lam, tmask)
        hist.solve_calls += 1
        hist.candidates_evaluated += len(cands)
        return res, _host(ev.R), _host(ev.R_m)

    best_R = np.inf
    best_assign = current.copy()
    best_res = None
    seen = {current.tobytes()}
    escapes = 0

    while hist.rounds < max_rounds:
        hist.rounds += 1
        cands = candidate_assigns(current, M, movable)
        res, R, R_m = score(cands)
        j = int(np.argmin(R))
        if R[j] < best_R:
            best_R = float(R[j])
            best_assign = cands[j].copy()
            best_res = sroa.SroaResult(*(_host(x[j]) for x in res))
        hist.R_trace.append(float(min(best_R, R[0])))

        if j != 0:                       # improving move exists -> descend
            user, src, dst = _first_move(current, cands[j])
            hist.moves.append((hist.rounds, user, src, dst, "descent"))
            current = cands[j].copy()
        else:                            # local optimum -> paper-style escape
            if escapes >= escape_iters:
                break
            counts = np.bincount(
                current[movable] if movable is not None else current,
                minlength=M)
            R_m0 = R_m[0]
            R_m_occ = np.where(counts > 0, R_m0, -np.inf)
            m_plus = int(np.argmax(R_m_occ))
            m_minus = int(np.argmin(R_m0))
            if m_plus == m_minus or counts[m_plus] == 0:
                break
            in_plus = np.flatnonzero(current == m_plus)
            if movable is not None:
                in_plus = in_plus[movable[in_plus]]
            if in_plus.size == 0:
                break
            b0 = _host(res.b[0])
            user = int(in_plus[np.argmax(b0[in_plus])])   # costly user
            current = current.copy()
            current[user] = m_minus
            hist.moves.append((hist.rounds, user, m_plus, m_minus,
                               "escape"))
            escapes += 1

        key = current.tobytes()
        if key in seen:                  # pattern revisited -> converged
            break
        seen.add(key)

    if best_res is None:                 # max_rounds == 0 degenerate case
        res, R, _ = score(current[None])
        best_R, best_assign = float(R[0]), current.copy()
        best_res = sroa.SroaResult(*(_host(x[0]) for x in res))

    return BatchedTsiaResult(assign=best_assign, sroa=best_res, R=best_R,
                             history=hist)


def replan(scn: Scenario, prev_assign: np.ndarray, lam=1.0,
           cfg: sroa.SroaConfig = sroa.SroaConfig(),
           new_users: np.ndarray | None = None,
           mask: np.ndarray | None = None,
           max_rounds: int = 16, escape_iters: int = 2,
           use_engine: bool = True, top_k: int = 0,
           n_starts: int = 1,
           gain_stack: np.ndarray | None = None,
           switch_cost: float = 0.0, ladder=None,
           init_comp: np.ndarray | None = None) -> BatchedTsiaResult:
    """Warm-start re-planning after a dynamics event.

    Keeps the previous assignment for surviving users and seeds arrivals —
    ``new_users`` slot indices, e.g. ``ChurnEvents.arrived`` — by
    nearest-edge init, then runs a short batched-TSIA polish instead of a
    cold full search.  With a ``gain_stack`` (horizon mode, engine route
    only) the previous assignment doubles as the incumbent the switching
    cost bills against; under an edge mask (D12) users whose edge closed
    re-home to their nearest open edge first.
    """
    init = np.array(_host(prev_assign), np.int32).copy()
    init = np.clip(init, 0, scn.M - 1)
    if scn.edge_mask is not None:
        em = _host(scn.edge_mask).astype(bool)
        if not em.all():
            ne_open = _host(nearest_edge_assignment(scn))
            init = np.where(em[init], init, ne_open).astype(np.int32)
    if new_users is not None and len(new_users):
        ne = _host(nearest_edge_assignment(scn))
        init[np.asarray(new_users, int)] = ne[np.asarray(new_users, int)]
    # Arrivals have no deployed edge to hand over from: their incumbent is
    # the nearest-edge seed, so parking them there is free.
    incumbent = init.copy()
    if use_engine:
        return solve(scn, lam, cfg, init_assign=init, max_rounds=max_rounds,
                     escape_iters=escape_iters, mask=mask, top_k=top_k,
                     n_starts=n_starts, gain_stack=gain_stack,
                     switch_cost=switch_cost, incumbent=incumbent,
                     ladder=ladder, init_comp=init_comp)
    return solve_host(scn, lam, cfg, init_assign=init,
                      max_rounds=max_rounds, escape_iters=escape_iters,
                      mask=mask)
