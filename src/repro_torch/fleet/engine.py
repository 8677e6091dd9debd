"""Batched assignment engine: TSIA over every cell of a fleet at once.

The JAX engine runs each cell's whole search in one jitted
``lax.while_loop`` and vmaps it over cells.  Here the loop is a host loop
over rounds and every piece of state carries a leading cell axis: each
round enumerates the candidates of every cell (the full ``1 + N*(M-1)``
neighbourhood, or the k moves kernel K3 nominates when ``top_k > 0``),
scores the whole flattened cell x candidate batch in ONE batched SROA solve
(one launch of kernel K2 under ``SroaConfig.fused``), and applies descent,
the paper's Definition 1/2 escape, best-ever tracking and Remark-1 revisit
detection per cell.  A cell that stops (converged or out of rounds) freezes
while the rest go on, exactly as under the vmapped ``while_loop``, so a
cell's search does not depend on the batch it rides in (DESIGN.md D2/D7).
The search history lands in fixed-size trace buffers (:class:`EngineTrace`).

Ported: the snapshot search with ``n_starts <= 2``.  Horizon scoring
(``gain_stack``, D10), compression ladders (D11), edge masks (D12) and
``n_starts > 2`` (whose random starts come from ``jax.random``) raise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import sroa
from repro_torch.core.system_model import (evaluate, expand_scenario,
                                           sroa_constants)
from repro_torch.core.wireless import Scenario, nearest_edge_assignment
from repro_torch.fleet.batch import (FleetScenario, candidate_assigns_device,
                                     fleet_assignments, map_scenario)
from repro_torch.kernels import ops as kops

_BIG = 1e30

# Move-kind codes in EngineTrace.moves[:, 3].
KIND_DESCENT = 0
KIND_ESCAPE = 1


class EngineTrace(NamedTuple):
    """Fixed-size search trace (one row per assigning round).

    Rows past the executed round count have ``rounds_valid == False``.
    ``moves`` rows are (user, src_edge, dst_edge, kind, moved).
    """

    R_best: torch.Tensor        # (T,) f32 best-ever evaluate-R after round
    R_current: torch.Tensor     # (T,) f32 evaluate-R of the round's pattern
    moves: torch.Tensor         # (T, 5) i32 (user, src, dst, kind, moved)
    rounds_valid: torch.Tensor  # (T,) bool


class EngineResult(NamedTuple):
    assign: torch.Tensor     # (N,) i32 best pattern ever visited
    R: torch.Tensor          # () f32 evaluate-R (eq 15) of ``assign``
    sroa: sroa.SroaResult    # SROA allocation for ``assign``
    rounds: torch.Tensor     # () i32 assigning iterations executed
    escapes: torch.Tensor    # () i32 Definition-1/2 escapes taken
    converged: torch.Tensor  # () bool — stopped by revisit/exhaustion
    trace: EngineTrace
    R_search: torch.Tensor   # () f32 objective the search minimized
    comp: torch.Tensor       # (N,) i32 compression levels (all zeros)


def _unsupported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet")


def _check_snapshot(ladder=None, gain_stack=None, edge_mask=None,
                    n_starts: int = 1, tail=None) -> None:
    if gain_stack is not None or tail is not None:
        _unsupported("rolling-horizon scoring (DESIGN.md D10)")
    if ladder is not None and len(ladder) >= 2:
        _unsupported("compression as a search variable (DESIGN.md D11)")
    if edge_mask is not None:
        _unsupported("edge masks (topology design, DESIGN.md D12)")
    if n_starts > 2:
        _unsupported("n_starts > 2 (random restarts drawn with jax.random)")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[c, idx[c]] along dim 1 for every row c."""
    idx = idx.long()
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 1))
                        .expand((x.shape[0], 1) + x.shape[2:])).squeeze(1)


def escape_move(assign: torch.Tensor, R_m: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor, M: int, edge_mask=None):
    """The paper's Definition 1/2 escape for (..., N) assignments.

    Costly edge m+ = argmax R_m over occupied edges (Definition 1),
    economic edge m- = argmin R_m, costly user = argmax b_n among the
    movable members of m+ (Definition 2).  Returns (user, m_plus, m_minus,
    ok); ``ok`` is False when the move is undefined.
    """
    _check_snapshot(edge_mask=edge_mask)
    mask = mask.to(torch.bool)
    psi = F.one_hot(assign.long(), M).to(torch.float32)
    psi = psi * mask.to(torch.float32)[..., None]
    counts = psi.sum(dim=-2)                                  # (..., M)
    R_m_occ = torch.where(counts > 0, R_m, -torch.inf)
    m_plus = torch.argmax(R_m_occ, dim=-1)
    m_minus = torch.argmin(R_m, dim=-1)
    member = (assign == m_plus[..., None]) & mask
    user = torch.argmax(torch.where(member, b, -torch.inf), dim=-1)
    occupied = torch.gather(counts, -1, m_plus[..., None])[..., 0] > 0
    ok = (m_plus != m_minus) & occupied & member.any(dim=-1)
    return (user.to(torch.int32), m_plus.to(torch.int32),
            m_minus.to(torch.int32), ok)


def _move_H(scn: Scenario, comp=None, ladder=None) -> torch.Tensor:
    """(..., N) per-user on-wire bits the move-score kernel prices."""
    if comp is not None or ladder is not None:
        _unsupported("compression ladders (DESIGN.md D11)")
    return scn.s_bits[..., None] * scn.size_mult


def _pruned_candidates(scn: Scenario, current: torch.Tensor,
                       mask: torch.Tensor, top_k: int):
    """The k+1 candidate patterns kernel K3 nominates, for every cell.

    Row 0 is the current pattern; rows 1..k apply the k cheapest moves by
    the kernel's marginal-cost estimate.  Padding rows (score >= _BIG/2:
    fewer than k valid moves) are flagged invalid.  Returns cands
    (C, k+1, N) and valid (C, k+1).
    """
    _check_snapshot(edge_mask=scn.edge_mask)
    user, dst, score = kops.topk_move_scores(
        scn.gain, _move_H(scn), scn.p_max, current, mask, scn.N0,
        scn.B_open, k=top_k)
    rows = current[:, None, :].repeat(1, top_k, 1)            # (C, k, N)
    rows.scatter_(2, user[..., None].long(), dst[..., None])
    cands = torch.cat([current[:, None, :], rows], dim=1)
    valid = torch.cat([torch.ones_like(score[:, :1], dtype=torch.bool),
                       score < _BIG / 2], dim=1)
    return cands, valid


def _score_neighbourhood(scn: Scenario, cands: torch.Tensor,
                         mask: torch.Tensor, lam, cfg: sroa.SroaConfig):
    """Batched SROA + cost model over every cell's candidates at once.

    ``scn`` has batch shape (C,), ``cands`` is (C, A, N): the C*A problems
    flatten into ONE batched solve (one K2 launch when fused).
    """
    cs = expand_scenario(scn, 1)                              # (C, 1, ...)
    consts = sroa_constants(cs, cands, mask[:, None, :])
    B = cs.B_open
    res = sroa.solve_constants_impl(consts, B, B, cs.f_max, cs.p_max, cs.N0,
                                    lam[:, None], cfg)
    ev = evaluate(cs, cands, res.b, res.f, res.p, lam[:, None],
                  mask[:, None, :])
    return res, ev


def engine_core(scn: Scenario, init_assign: torch.Tensor,
                mask: torch.Tensor, lam, cfg: sroa.SroaConfig,
                max_rounds: int, escape_iters: int, top_k: int = 0,
                gain_stack=None, switch_cost: float = 0.0, incumbent=None,
                ladder=None, init_comp=None) -> EngineResult:
    """The search loop for C cells at once (scenario batch shape (C,)).

    ``init_assign`` and ``mask`` are (C, N), ``lam`` is (C,).  Every leaf
    of the result carries the leading (C,) axis.
    """
    _check_snapshot(ladder, gain_stack, scn.edge_mask)
    C, N, M = init_assign.shape[0], scn.N, scn.M
    dev = init_assign.device
    T = int(max_rounds)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    lam = torch.broadcast_to(lam, (C,))
    mask = mask.to(torch.bool)
    i32 = dict(dtype=torch.int32, device=dev)
    current = init_assign.to(torch.int32)
    best_assign = current
    best_R = torch.full((C,), torch.inf, device=dev)
    rounds = torch.zeros(C, **i32)
    escapes = torch.zeros(C, **i32)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    visited = torch.full((C, T + 1, N), -1, **i32)
    visited[:, 0] = current
    R_best_tr = torch.full((C, T), torch.inf, device=dev)
    R_cur_tr = torch.full((C, T), torch.inf, device=dev)
    moves_tr = torch.zeros((C, T, 5), **i32)
    valid_tr = torch.zeros((C, T), dtype=torch.bool, device=dev)
    cells = torch.arange(C, device=dev)

    for r in range(T):
        # Every live cell has executed exactly r rounds; stopped cells
        # freeze (the vmapped while_loop's element-wise select).
        live = ~done
        if not bool(live.any()):
            break
        if top_k > 0:
            cands, valid = _pruned_candidates(scn, current, mask, top_k)
        else:
            cands, valid = candidate_assigns_device(current, M, mask)
        res, ev = _score_neighbourhood(scn, cands, mask, lam, cfg)
        Rv = torch.where(valid, ev.R, _BIG)
        j = torch.argmin(Rv, dim=1)                  # first minimum
        Rj = Rv[cells, j]
        R0 = Rv[:, 0]
        improving = Rj < R0

        new_best = Rj < best_R                       # Alg 5 lines 19-21
        cand_j = cands[cells, j]
        nb_R = torch.where(new_best, Rj, best_R)
        nb_assign = torch.where(new_best[:, None], cand_j, best_assign)

        # Decode the descending move (meaningful only when improving).
        d_user = torch.argmax((cand_j != current).to(torch.int32), dim=1)
        d_src = current[cells, d_user]
        d_dst = cand_j[cells, d_user]

        # Paper-style escape at a local optimum (Definitions 1/2).
        e_user, m_plus, m_minus, e_ok = escape_move(
            current, ev.R_m[:, 0], res.b[:, 0], mask, M)
        can_escape = ~improving & e_ok & (escapes < escape_iters)
        esc_assign = current.clone()
        esc_assign[cells, e_user.long()] = m_minus

        moved = improving | can_escape
        nxt = torch.where(improving[:, None], cand_j,
                          torch.where(can_escape[:, None], esc_assign,
                                      current))
        # Remark 1: a revisited pattern implies a cycle -> converged.
        revisit = moved & (visited == nxt[:, None, :]).all(dim=2).any(dim=1)
        stop = ~moved | revisit

        user = torch.where(improving, d_user.to(torch.int32), e_user)
        src = torch.where(improving, d_src, m_plus)
        dst = torch.where(improving, d_dst, m_minus)
        kind = torch.where(improving, KIND_DESCENT, KIND_ESCAPE)
        move_row = torch.stack([user, src, dst, kind.to(torch.int32),
                                moved.to(torch.int32)], dim=1)

        # Commit the round for live cells only.
        lv = live[:, None]
        visited[:, r + 1] = torch.where(lv & moved[:, None], nxt,
                                        visited[:, r + 1])
        visited[:, r + 1] = torch.where(lv & ~moved[:, None], -1,
                                        visited[:, r + 1])
        R_best_tr[:, r] = torch.where(live, nb_R, R_best_tr[:, r])
        R_cur_tr[:, r] = torch.where(live, R0, R_cur_tr[:, r])
        moves_tr[:, r] = torch.where(lv, move_row, moves_tr[:, r])
        valid_tr[:, r] = live
        best_R = torch.where(live, nb_R, best_R)
        best_assign = torch.where(lv, nb_assign, best_assign)
        current = torch.where(lv, nxt, current)
        escapes = escapes + (live & can_escape).to(torch.int32)
        rounds = rounds + live.to(torch.int32)
        done = done | (live & stop)

    # One final constants-space solve for the winning patterns (also covers
    # max_rounds == 0, where the loop never scored anything).
    consts = sroa_constants(scn, best_assign, mask)
    B = scn.B_open
    res = sroa.solve_constants_impl(consts, B, B, scn.f_max, scn.p_max,
                                    scn.N0, lam, cfg)
    ev = evaluate(scn, best_assign, res.b, res.f, res.p, lam, mask)
    return EngineResult(assign=best_assign, R=ev.R, sroa=res, rounds=rounds,
                        escapes=escapes, converged=done,
                        trace=EngineTrace(R_best_tr, R_cur_tr, moves_tr,
                                          valid_tr),
                        R_search=ev.R, comp=torch.zeros_like(best_assign))


def _start_patterns(scn: Scenario, init: torch.Tensor, mask: torch.Tensor,
                    n_starts: int) -> torch.Tensor:
    """(C, S, N) initial patterns: start 0 is the caller's pattern, start 1
    the best-gain greedy pattern.  Masked users keep their init value."""
    _check_snapshot(edge_mask=scn.edge_mask, n_starts=n_starts)
    inits = [init]
    if n_starts > 1:
        greedy = torch.argmax(scn.gain, dim=-1).to(torch.int32)
        inits.append(torch.where(mask, greedy, init))
    return torch.stack(inits, dim=1)


def _select_rows(tree, idx: torch.Tensor):
    """Pick row idx[c] along dim 1 of every leaf (C, S, ...) of a result."""
    if isinstance(tree, tuple):
        return type(tree)(*(_select_rows(x, idx) for x in tree))
    return _take(tree, idx)


def search_core(scn: Scenario, init_assign: torch.Tensor, mask: torch.Tensor,
                lam, cfg: sroa.SroaConfig, max_rounds: int,
                escape_iters: int, top_k: int = 0, n_starts: int = 1,
                gain_stack=None, switch_cost: float = 0.0, incumbent=None,
                ladder=None, init_comp=None, tail_init=None) -> EngineResult:
    """Multi-start wrapper around :func:`engine_core` for C cells.

    ``n_starts == 2`` runs both starts of every cell as one 2C-cell batch
    and keeps, per cell, the start whose final R is lowest (start 0 on
    ties), so it is never worse than the single-start search.
    """
    _check_snapshot(ladder, gain_stack, scn.edge_mask, n_starts, tail_init)
    if n_starts <= 1:
        return engine_core(scn, init_assign, mask, lam, cfg, max_rounds,
                           escape_iters, top_k)
    C = init_assign.shape[0]
    inits = _start_patterns(scn, init_assign.to(torch.int32),
                            mask.to(torch.bool), n_starts)
    S = inits.shape[1]
    lam = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=init_assign.device), (C,))
    rep = map_scenario(lambda x: x.repeat_interleave(S, dim=0), scn)
    res = engine_core(rep, inits.reshape(C * S, -1),
                      mask.repeat_interleave(S, dim=0),
                      lam.repeat_interleave(S), cfg, max_rounds,
                      escape_iters, top_k)
    res = _unflatten(res, C, S)
    return _select_rows(res, torch.argmin(res.R, dim=1))


def _unflatten(tree, C: int, S: int):
    if isinstance(tree, tuple):
        return type(tree)(*(_unflatten(x, C, S) for x in tree))
    return tree.reshape((C, S) + tree.shape[1:])


def _squeeze0(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_squeeze0(x) for x in tree))
    return tree[0]


def solve_assignment(scn: Scenario, init_assign=None, mask=None, lam=1.0,
                     cfg: sroa.SroaConfig = sroa.SroaConfig(),
                     max_rounds: int = 48, escape_iters: int = 6,
                     top_k: int = 0, n_starts: int = 1, gain_stack=None,
                     switch_cost: float = 0.0, incumbent=None, ladder=None,
                     init_comp=None, tail_init=None) -> EngineResult:
    """One cell's entire assignment search (a fleet of one).

    Args mirror the JAX engine: ``init_assign`` (N,) defaults to the
    nearest-edge pattern (Alg 5 line 5), ``mask`` (N,) to all-active;
    ``top_k > 0`` scores only the k kernel-nominated moves per round (D9);
    ``n_starts`` (<= 2) adds the best-gain greedy restart.
    """
    _check_snapshot(ladder, gain_stack, scn.edge_mask, n_starts, tail_init)
    dev = scn.device
    if mask is None:
        mask = torch.ones(scn.N, dtype=torch.bool, device=dev)
    if init_assign is None:
        init_assign = nearest_edge_assignment(scn)
    one = map_scenario(lambda x: x[None], scn)
    res = search_core(
        one, torch.as_tensor(init_assign, dtype=torch.int32,
                             device=dev)[None],
        torch.as_tensor(mask, dtype=torch.bool, device=dev)[None],
        lam, cfg, max_rounds, escape_iters, top_k, n_starts)
    return _squeeze0(res)


def solve_fleet_assignments(fleet: FleetScenario, init_assigns=None,
                            lam=1.0,
                            cfg: sroa.SroaConfig = sroa.SroaConfig(),
                            max_rounds: int = 48, escape_iters: int = 6,
                            top_k: int = 0, n_starts: int = 1,
                            gain_stacks=None, switch_cost: float = 0.0,
                            incumbents=None, ladder=None, init_comps=None,
                            tail_inits=None) -> EngineResult:
    """Full assignment searches for EVERY cell of a fleet at once.

    Every leaf of the returned :class:`EngineResult` carries a leading
    (C,) axis; ``lam`` may be scalar or (C,).  Each round scores all
    cells' candidates in one batched SROA solve.
    """
    _check_snapshot(ladder, gain_stacks, fleet.edge_mask, n_starts,
                    tail_inits)
    if init_assigns is None:
        init_assigns = fleet_assignments(fleet)
    init = torch.as_tensor(init_assigns, dtype=torch.int32,
                           device=fleet.device)
    return search_core(fleet.cells, init, fleet.mask, lam, cfg, max_rounds,
                       escape_iters, top_k, n_starts)


def difficulty_proxy(fleet: FleetScenario) -> torch.Tensor:
    """(C,) convergence-difficulty proxy for bucket scheduling: the active
    user count, with the normalized best-gain spread breaking ties."""
    m = fleet.mask.to(torch.float32)
    n_act = torch.sum(m, dim=1)
    g = torch.log(torch.clamp_min(fleet.cells.gain, 1e-30))
    g_best = torch.amax(g, dim=2)
    spread = torch.std(torch.where(fleet.mask, g_best, 0.0), dim=1,
                       correction=0)
    return n_act + spread / torch.clamp_min(torch.amax(spread), 1e-9)


def solve_fleet_assignments_bucketed(
        fleet: FleetScenario, init_assigns=None, lam=1.0,
        cfg: sroa.SroaConfig = sroa.SroaConfig(), max_rounds: int = 48,
        escape_iters: int = 6, top_k: int = 0, n_starts: int = 1,
        n_buckets: int = 2, ladder=None, init_comps=None) -> EngineResult:
    """Bucket-by-difficulty fleet scheduling: cells sorted by
    :func:`difficulty_proxy` and searched in ``n_buckets`` equal-size
    batches, so easy buckets stop at their own worst case.  Results come
    back in the caller's cell order — same searches, same answers."""
    _check_snapshot(ladder)
    C = fleet.C
    if n_buckets <= 1 or C < 2 * n_buckets:
        return solve_fleet_assignments(fleet, init_assigns, lam, cfg,
                                       max_rounds, escape_iters, top_k,
                                       n_starts, ladder=ladder,
                                       init_comps=init_comps)
    if init_assigns is None:
        init_assigns = fleet_assignments(fleet)
    init_assigns = torch.as_tensor(init_assigns, dtype=torch.int32,
                                   device=fleet.device)
    lam_v = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=fleet.device), (C,))
    order = torch.argsort(difficulty_proxy(fleet), stable=True)
    size = C // n_buckets
    parts, outs = [], []
    for i in range(n_buckets):
        lo = i * size
        hi = lo + size if i < n_buckets - 1 else C
        idx = order[lo:hi]
        parts.append(idx)
        outs.append(solve_fleet_assignments(
            fleet.index(idx), init_assigns[idx], lam_v[idx], cfg, max_rounds,
            escape_iters, top_k, n_starts))
    inv = torch.argsort(torch.cat(parts))
    return _concat_rows(outs, inv)


def _concat_rows(outs, inv):
    if isinstance(outs[0], tuple):
        return type(outs[0])(*(_concat_rows(xs, inv) for xs in zip(*outs)))
    return torch.cat(outs, dim=0)[inv]


def sroa_solve_flops(N: int, cfg: sroa.SroaConfig) -> int:
    """Analytic FLOP model of ONE constants-space SROA solve (worst-case
    trip counts): t_iters x (p_iters x (f_iters x (b_iters x N))) plus the
    `_auto_bounds` bracketing."""
    inv = 8 * cfg.b_iters * N
    alg2 = cfg.f_iters * (inv + 12 * N)
    alg3 = cfg.p_iters * (alg2 + 8 * N)
    bounds = cfg.t_iters * (inv + 10 * N)
    return bounds + cfg.t_iters * (alg3 + 20 * N)


def candidate_search_flops(N: int, M: int, rounds: int,
                           cfg: sroa.SroaConfig, top_k: int = 0) -> dict:
    """Candidate-scoring cost of one engine search (analytic, see D9)."""
    solve = sroa_solve_flops(N, cfg)
    if top_k > 0:
        cands = 1 + top_k
        proxy = (12 + top_k) * N * M        # score + k knockout reductions
    else:
        cands = 1 + N * (M - 1)
        proxy = 0
    return {"cands_per_round": cands,
            "score_flops": rounds * (cands * solve + proxy)}
