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

The extended decision space rides on the same loop:

* ``n_starts`` restarts (D9) and a receding-horizon ``tail_init`` become
  extra rows of the cell axis (C*S rows, still one K2 launch a round);
  restarts 2.. are ``jax.random``'s draws, reproduced bit for bit by
  :mod:`repro_torch.core.threefry`;
* a ``gain_stack`` (D10) scores every candidate against K predicted slots
  plus a switching charge; the slots join the flattened batch, so a round
  is still one K2 launch;
* a ``ladder`` of >= 2 rungs (D11) makes per-user compression a joint
  decision variable (assignment, compression level);
* ``Scenario.edge_mask`` (D12) excludes closed sites from every move, the
  escape and the starts; an all-open mask is bitwise the maskless path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import sroa
from repro_torch.core import threefry
from repro_torch.core.system_model import (evaluate, expand_scenario,
                                           ladder_factors, ladder_levels,
                                           sroa_constants)
from repro_torch.core.wireless import Scenario, nearest_edge_assignment
from repro_torch.fleet.batch import (FleetScenario, candidate_assigns_device,
                                     fleet_assignments, map_scenario)
from repro_torch.kernels import ops as kops

_BIG = 1e30

# Move-kind codes in EngineTrace.moves[:, 3].
KIND_DESCENT = 0
KIND_ESCAPE = 1
KIND_COMP = 2       # compression-level change (src/dst = old/new level)


def _comp_enabled(ladder) -> bool:
    """A ladder with >= 2 rungs makes compression a decision variable;
    None or a single-rung ladder keeps the plain search."""
    return ladder is not None and len(ladder) >= 2


class EngineTrace(NamedTuple):
    """Fixed-size search trace (one row per assigning round).

    Rows past the executed round count have ``rounds_valid == False``.
    ``moves`` rows are (user, src, dst, kind, moved); compression moves
    (``KIND_COMP``) carry the old and new level as src and dst.
    """

    R_best: torch.Tensor        # (T,) f32 best-ever objective after round
    R_current: torch.Tensor     # (T,) f32 objective of the round's pattern
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
    R_search: torch.Tensor   # () f32 objective the search minimized: R on
    #                          snapshot searches, the window's cost plus
    #                          switching charges on horizon searches (D10)
    comp: torch.Tensor       # (N,) i32 compression levels (zeros, ladder off)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[c, idx[c]] along dim 1 for every row c."""
    idx = idx.long()
    return torch.gather(x, 1, idx.view(idx.shape + (1,) * (x.dim() - 1))
                        .expand((x.shape[0], 1) + x.shape[2:])).squeeze(1)


def _first_open(edge_mask: torch.Tensor) -> torch.Tensor:
    """(..., 1) index of the first open site of each (..., M) mask."""
    return torch.argmax(edge_mask.to(torch.int32), dim=-1, keepdim=True)


def _rehome(assign: torch.Tensor, edge_mask) -> torch.Tensor:
    """Move entries sitting on a closed site to the first open one (D12);
    the identity under an all-open mask."""
    if edge_mask is None:
        return assign
    open_ = torch.gather(edge_mask, -1, assign.long())
    return torch.where(open_, assign, _first_open(edge_mask).to(assign.dtype))


def escape_move(assign: torch.Tensor, R_m: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor, M: int, edge_mask=None):
    """The paper's Definition 1/2 escape for (..., N) assignments.

    Costly edge m+ = argmax R_m over occupied edges (Definition 1),
    economic edge m- = argmin R_m (over OPEN sites under an ``edge_mask``,
    D12), costly user = argmax b_n among the movable members of m+
    (Definition 2).  Returns (user, m_plus, m_minus, ok); ``ok`` is False
    when the move is undefined.
    """
    mask = mask.to(torch.bool)
    psi = F.one_hot(assign.long(), M).to(torch.float32)
    psi = psi * mask.to(torch.float32)[..., None]
    counts = psi.sum(dim=-2)                                  # (..., M)
    R_m_occ = torch.where(counts > 0, R_m, -torch.inf)
    m_plus = torch.argmax(R_m_occ, dim=-1)
    R_m_open = (R_m if edge_mask is None
                else torch.where(edge_mask, R_m, torch.inf))
    m_minus = torch.argmin(R_m_open, dim=-1)
    member = (assign == m_plus[..., None]) & mask
    user = torch.argmax(torch.where(member, b, -torch.inf), dim=-1)
    occupied = torch.gather(counts, -1, m_plus[..., None])[..., 0] > 0
    ok = (m_plus != m_minus) & occupied & member.any(dim=-1)
    return (user.to(torch.int32), m_plus.to(torch.int32),
            m_minus.to(torch.int32), ok)


def _move_H(scn: Scenario, comp=None, ladder=None) -> torch.Tensor:
    """(..., N) per-user on-wire bits the move-score kernel prices: the tier
    size multipliers, and under a ladder the bytes factor of each user's
    current compression level (D11)."""
    H = scn.s_bits[..., None] * scn.size_mult
    if comp is not None and ladder is not None:
        _, bf = ladder_factors(ladder, H)
        H = H * bf[ladder_levels(comp, ladder)]
    return H


def _nominate(scn: Scenario, current: torch.Tensor, mask: torch.Tensor,
              top_k: int, H: torch.Tensor):
    """Kernel K3's k cheapest moves of every cell: (user, dst) (C, k) and
    ``move_ok`` (C, k), False on padding rows and on moves onto a closed
    site (D12)."""
    user, dst, score = kops.topk_move_scores(
        scn.gain, H, scn.p_max, current, mask, scn.N0, scn.B_open, k=top_k)
    move_ok = score < _BIG / 2
    if scn.edge_mask is not None:
        move_ok = move_ok & torch.gather(scn.edge_mask, 1, dst.long())
    return user, dst, move_ok


def _set_rows(base: torch.Tensor, user: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """(C, k, N) copies of ``base`` (C, N), row r with user[:, r] set to
    val[:, r]."""
    rows = base[:, None, :].repeat(1, user.shape[1], 1)
    rows.scatter_(2, user[..., None].long(), val[..., None].to(base.dtype))
    return rows


def _pruned_candidates(scn: Scenario, current: torch.Tensor,
                       mask: torch.Tensor, top_k: int):
    """The k+1 candidate patterns kernel K3 nominates, for every cell.

    Row 0 is the current pattern; rows 1..k apply the k cheapest moves by
    the kernel's marginal-cost estimate.  Padding rows (fewer than k valid
    moves) and moves onto a closed site are flagged invalid.  Returns
    cands (C, k+1, N) and valid (C, k+1).
    """
    user, dst, move_ok = _nominate(scn, current, mask, top_k, _move_H(scn))
    cands = torch.cat([current[:, None, :], _set_rows(current, user, dst)],
                      dim=1)
    valid = torch.cat([torch.ones_like(move_ok[:, :1]), move_ok], dim=1)
    return cands, valid


def _comp_candidates(current: torch.Tensor, comp: torch.Tensor, M: int,
                     n_levels: int, mask: torch.Tensor, edge_mask=None):
    """Full joint neighbourhood over (assignment, compression) moves.

    Assignment single-moves keep each user's level; the extra
    ``N * (n_levels - 1)`` rows change ONE user's level (cyclically, so
    every other rung is one move away) with the assignment unchanged.
    Masked users' rows and moves onto closed sites are flagged invalid.
    Returns cands, comps (C, A, N) and valid (C, A).
    """
    a_cands, a_valid = candidate_assigns_device(current, M, mask, edge_mask)
    C, N = current.shape
    dev = current.device
    users = torch.arange(N, device=dev).repeat_interleave(n_levels - 1)
    offs = torch.arange(1, n_levels, dtype=torch.int32,
                        device=dev).repeat(N)
    new_lv = (comp[:, users] + offs) % n_levels
    comps = torch.cat([comp[:, None, :].expand(a_cands.shape),
                       _set_rows(comp, users.expand(C, -1), new_lv)], dim=1)
    cands = torch.cat([a_cands, current[:, None, :].expand(
        C, users.numel(), N)], dim=1)
    valid = torch.cat([a_valid, mask[:, users]], dim=1)
    return cands, comps, valid


def _pruned_candidates_comp(scn: Scenario, current: torch.Tensor,
                            comp: torch.Tensor, mask: torch.Tensor,
                            top_k: int, ladder):
    """Kernel-nominated joint (move, compression) candidates: 1 + 5k rows.

    K3, fed the comp-aware upload bits, nominates k cheap reassignments;
    each composes with a compression bump/drop of the moved user, and the
    same user's bump/drop without moving also enters.  Rows whose level
    leaves the ladder, or whose kernel score is padding, are invalid.
    """
    n_levels = len(ladder)
    user, dst, move_ok = _nominate(scn, current, mask, top_k,
                                   _move_H(scn, comp, ladder))
    rows = _set_rows(current, user, dst)
    lv = torch.gather(comp, 1, user.long())
    bump = _set_rows(comp, user, lv + 1)
    drop = _set_rows(comp, user, lv - 1)
    same = current[:, None, :].expand(rows.shape)
    comp0 = comp[:, None, :].expand(rows.shape)
    movable = torch.gather(mask, 1, user.long())
    bump_ok = (lv + 1 < n_levels) & movable
    drop_ok = (lv - 1 >= 0) & movable
    cands = torch.cat([current[:, None, :], rows, rows, rows, same, same],
                      dim=1)
    comps = torch.cat([comp[:, None, :], comp0, bump, drop, bump, drop],
                      dim=1)
    valid = torch.cat([torch.ones_like(move_ok[:, :1]), move_ok,
                       move_ok & bump_ok, move_ok & drop_ok, bump_ok,
                       drop_ok], dim=1)
    return cands, comps, valid


def _score_neighbourhood(scn: Scenario, cands: torch.Tensor,
                         mask: torch.Tensor, lam, cfg: sroa.SroaConfig,
                         comps=None, ladder=None):
    """Batched SROA + cost model over every cell's candidates at once.

    ``scn`` has batch shape (C,), ``cands`` (and ``comps``, D11) are
    (C, A, N): the C*A problems flatten into ONE batched solve (one K2
    launch when fused).
    """
    cs = expand_scenario(scn, 1)                              # (C, 1, ...)
    consts = sroa_constants(cs, cands, mask[:, None, :], comps, ladder)
    B = cs.B_open
    res = sroa.solve_constants_impl(consts, B, B, cs.f_max, cs.p_max, cs.N0,
                                    lam[:, None], cfg)
    ev = evaluate(cs, cands, res.b, res.f, res.p, lam[:, None],
                  mask[:, None, :], comps, ladder)
    return res, ev


def switch_counts(cands: torch.Tensor, incumbent: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """(C, A) handovers each candidate costs against the incumbent plan:
    active users whose edge differs from the deployed assignment."""
    diff = (cands != incumbent[:, None, :]) & mask[:, None, :]
    return diff.sum(dim=-1).to(torch.float32)


def _score_horizon(scn: Scenario, gain_stack: torch.Tensor,
                   cands: torch.Tensor, mask: torch.Tensor, lam,
                   cfg: sroa.SroaConfig, incumbent: torch.Tensor,
                   switch_cost: float, comps=None, ladder=None):
    """Time-expanded scoring: every candidate against all K predicted slots.

    Per candidate ``R_h = sum_k R(cand; gain_k) + switch_cost *
    handovers(cand)``.  The K slots of every candidate of every cell
    flatten into ONE batched solve (C*K*A problems, one K2 launch); slot
    costs add slot by slot in index order.  Returns the slot-0 SROA and
    evaluation (the escape and the trace read them as on the snapshot
    path) and the (C, A) horizon objective.  K == 1 skips the slot axis,
    so a horizon-1 stack scores bitwise as the snapshot path.
    """
    K = gain_stack.shape[1]
    n_sw = switch_counts(cands, incumbent, mask)
    if K == 1:
        res, ev = _score_neighbourhood(scn._replace(gain=gain_stack[:, 0]),
                                       cands, mask, lam, cfg, comps, ladder)
        return res, ev, ev.R + switch_cost * n_sw
    C, A, N = cands.shape
    cs = expand_scenario(expand_scenario(scn, 1), 1)          # (C, 1, 1, ...)
    cs = cs._replace(gain=gain_stack[:, :, None])             # (C, K, 1, N, M)
    cands_k = cands[:, None].expand(C, K, A, N)
    comps_k = None if comps is None else comps[:, None].expand(C, K, A, N)
    mask_k = mask[:, None, None, :]
    lam_k = lam[:, None, None]
    consts = sroa_constants(cs, cands_k, mask_k, comps_k, ladder)
    B = cs.B_open
    res = sroa.solve_constants_impl(consts, B, B, cs.f_max, cs.p_max, cs.N0,
                                    lam_k, cfg)
    ev = evaluate(cs, cands_k, res.b, res.f, res.p, lam_k, mask_k, comps_k,
                  ladder)
    R_sum = ev.R[:, 0]
    for k in range(1, K):
        R_sum = R_sum + ev.R[:, k]
    slot0 = (lambda t: type(t)(*(x[:, 0] for x in t)))
    return slot0(res), slot0(ev), R_sum + switch_cost * n_sw


def engine_core(scn: Scenario, init_assign: torch.Tensor,
                mask: torch.Tensor, lam, cfg: sroa.SroaConfig,
                max_rounds: int, escape_iters: int, top_k: int = 0,
                gain_stack=None, switch_cost: float = 0.0, incumbent=None,
                ladder=None, init_comp=None) -> EngineResult:
    """The search loop for C cells at once (scenario batch shape (C,)).

    ``init_assign`` and ``mask`` are (C, N), ``lam`` is (C,).  Every leaf
    of the result carries the leading (C,) axis.

    ``top_k > 0`` scores only the k moves kernel K3 nominates (D9).
    ``gain_stack`` (C, K, N, M) switches to the horizon objective (D10):
    candidates are scored against every slot and charged ``switch_cost``
    per active user moved off ``incumbent`` (default: the init); move
    nomination and the escape stay on the current channel.  A ``ladder``
    of >= 2 rungs (D11) walks (assignment, compression) pairs from
    ``init_comp`` (default: every user uncompressed); revisits match on
    both halves and the escape keeps every level.  Under
    ``scn.edge_mask`` (D12) init entries on a closed site re-home to the
    first open one.
    """
    C, N, M = init_assign.shape[0], scn.N, scn.M
    dev = init_assign.device
    T = int(max_rounds)
    comp_on = _comp_enabled(ladder)
    if not comp_on:
        ladder = None
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    lam = torch.broadcast_to(lam, (C,))
    mask = mask.to(torch.bool)
    em = scn.edge_mask
    i32 = dict(dtype=torch.int32, device=dev)
    current = _rehome(init_assign.to(torch.int32), em)
    horizon = gain_stack is not None
    if horizon:
        incumbent = current if incumbent is None else incumbent
        switch_cost = float(switch_cost)
    comp = (torch.zeros_like(current) if init_comp is None or not comp_on
            else init_comp.to(torch.int32))
    best_assign, best_comp = current, comp
    best_R = torch.full((C,), torch.inf, device=dev)
    rounds = torch.zeros(C, **i32)
    escapes = torch.zeros(C, **i32)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    visited = torch.full((C, T + 1, N), -1, **i32)
    visited[:, 0] = current
    if comp_on:
        visited_comp = torch.full((C, T + 1, N), -1, **i32)
        visited_comp[:, 0] = comp
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
        comps = None
        if comp_on and top_k > 0:
            cands, comps, valid = _pruned_candidates_comp(
                scn, current, comp, mask, top_k, ladder)
        elif comp_on:
            cands, comps, valid = _comp_candidates(current, comp, M,
                                                   len(ladder), mask, em)
        elif top_k > 0:
            cands, valid = _pruned_candidates(scn, current, mask, top_k)
        else:
            cands, valid = candidate_assigns_device(current, M, mask, em)
        if horizon:
            res, ev, R_score = _score_horizon(scn, gain_stack, cands, mask,
                                              lam, cfg, incumbent,
                                              switch_cost, comps, ladder)
        else:
            res, ev = _score_neighbourhood(scn, cands, mask, lam, cfg, comps,
                                           ladder)
            R_score = ev.R
        Rv = torch.where(valid, R_score, _BIG)
        j = torch.argmin(Rv, dim=1)                  # first minimum
        Rj = Rv[cells, j]
        R0 = Rv[:, 0]
        improving = Rj < R0

        new_best = Rj < best_R                       # Alg 5 lines 19-21
        cand_j = cands[cells, j]
        nb_R = torch.where(new_best, Rj, best_R)
        nb_assign = torch.where(new_best[:, None], cand_j, best_assign)

        # Decode the descending move (meaningful only when improving): the
        # assignment half when the user moved edges, else the compression
        # half.
        a_diff = cand_j != current
        d_user = torch.argmax(a_diff.to(torch.int32), dim=1)
        d_src = current[cells, d_user]
        d_dst = cand_j[cells, d_user]
        d_kind = torch.full_like(d_src, KIND_DESCENT)
        if comp_on:
            comp_j = comps[cells, j]
            nb_comp = torch.where(new_best[:, None], comp_j, best_comp)
            a_moved = a_diff.any(dim=1)
            c_user = torch.argmax((comp_j != comp).to(torch.int32), dim=1)
            d_user = torch.where(a_moved, d_user, c_user)
            d_src = torch.where(a_moved, current[cells, d_user],
                                comp[cells, d_user])
            d_dst = torch.where(a_moved, cand_j[cells, d_user],
                                comp_j[cells, d_user])
            d_kind = torch.where(a_moved, d_kind, KIND_COMP)

        # Paper-style escape at a local optimum (Definitions 1/2).
        e_user, m_plus, m_minus, e_ok = escape_move(
            current, ev.R_m[:, 0], res.b[:, 0], mask, M, em)
        can_escape = ~improving & e_ok & (escapes < escape_iters)
        esc_assign = current.clone()
        esc_assign[cells, e_user.long()] = m_minus

        moved = improving | can_escape
        nxt = torch.where(improving[:, None], cand_j,
                          torch.where(can_escape[:, None], esc_assign,
                                      current))
        # Remark 1: a revisited pattern implies a cycle -> converged.
        seen = (visited == nxt[:, None, :]).all(dim=2)
        if comp_on:
            nxt_comp = torch.where(improving[:, None], comp_j, comp)
            seen = seen & (visited_comp == nxt_comp[:, None, :]).all(dim=2)
        revisit = moved & seen.any(dim=1)
        stop = ~moved | revisit

        user = torch.where(improving, d_user.to(torch.int32), e_user)
        src = torch.where(improving, d_src, m_plus)
        dst = torch.where(improving, d_dst, m_minus)
        kind = torch.where(improving, d_kind, KIND_ESCAPE)
        move_row = torch.stack([user, src, dst, kind.to(torch.int32),
                                moved.to(torch.int32)], dim=1)

        # Commit the round for live cells only.
        lv = live[:, None]
        visited[:, r + 1] = torch.where(lv & moved[:, None], nxt,
                                        visited[:, r + 1])
        visited[:, r + 1] = torch.where(lv & ~moved[:, None], -1,
                                        visited[:, r + 1])
        if comp_on:
            visited_comp[:, r + 1] = torch.where(
                lv, torch.where(moved[:, None], nxt_comp, -1),
                visited_comp[:, r + 1])
            best_comp = torch.where(lv, nb_comp, best_comp)
            comp = torch.where(lv, nxt_comp, comp)
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
    fc = best_comp if comp_on else None
    consts = sroa_constants(scn, best_assign, mask, fc, ladder)
    B = scn.B_open
    res = sroa.solve_constants_impl(consts, B, B, scn.f_max, scn.p_max,
                                    scn.N0, lam, cfg)
    ev = evaluate(scn, best_assign, res.b, res.f, res.p, lam, mask, fc,
                  ladder)
    # R is the current-slot cost of the winning pattern (what the data
    # plane reprices); R_search is what the descent minimized.
    return EngineResult(assign=best_assign, R=ev.R, sroa=res, rounds=rounds,
                        escapes=escapes, converged=done,
                        trace=EngineTrace(R_best_tr, R_cur_tr, moves_tr,
                                          valid_tr),
                        R_search=best_R if horizon else ev.R,
                        comp=best_comp)


def _start_patterns(scn: Scenario, init: torch.Tensor, mask: torch.Tensor,
                    n_starts: int, tail=None) -> torch.Tensor:
    """(C, S, N) initial patterns for multi-start search (D9).

    Start 0 is the caller's pattern, start 1 the best-gain greedy pattern
    and starts 2.. the JAX engine's pseudo-random draws
    (``randint(fold_in(PRNGKey(17), s), (N,), 0, M)``, reproduced by
    :mod:`repro_torch.core.threefry`).  Masked users keep their init
    value in every start.  Under an ``edge_mask`` (D12) the greedy start
    ranks open sites only and random draws on a closed site re-home to
    the first open one.  ``tail`` (C, N) appends one more start: the
    previous window's winner (the receding-horizon warm start, D10).
    """
    em = scn.edge_mask
    C, N = init.shape
    inits = [init]
    if n_starts > 1:
        g = (scn.gain if em is None
             else torch.where(em[:, None, :], scn.gain, -torch.inf))
        greedy = torch.argmax(g, dim=-1).to(torch.int32)
        inits.append(torch.where(mask, greedy, init))
    for s in range(2, n_starts):
        rnd = torch.as_tensor(threefry.restart_pattern(s, N, scn.M),
                              device=init.device).expand(C, N)
        inits.append(torch.where(mask, _rehome(rnd, em), init))
    if tail is not None:
        inits.append(torch.where(mask, tail.to(torch.int32), init))
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

    The S starts of every cell (:func:`_start_patterns`) run as one C*S-row
    search, and each cell keeps the start whose final objective is lowest
    (start 0 on ties): ``R_search`` on the horizon path, ``R`` otherwise.
    Start 0 is the caller's init, so the result is never worse than the
    single-start search.  Every start shares the cell's incumbent (the
    switching bill is against the deployed plan) and its ``init_comp``.
    """
    if gain_stack is not None and incumbent is None:
        incumbent = init_assign.to(torch.int32)
    if n_starts <= 1 and tail_init is None:
        return engine_core(scn, init_assign, mask, lam, cfg, max_rounds,
                           escape_iters, top_k, gain_stack, switch_cost,
                           incumbent, ladder, init_comp)
    C = init_assign.shape[0]
    inits = _start_patterns(scn, init_assign.to(torch.int32),
                            mask.to(torch.bool), n_starts, tail_init)
    S = inits.shape[1]
    lam = torch.broadcast_to(torch.as_tensor(
        lam, dtype=torch.float32, device=init_assign.device), (C,))

    def rep(x):
        return None if x is None else x.repeat_interleave(S, dim=0)

    res = engine_core(map_scenario(rep, scn), inits.reshape(C * S, -1),
                      rep(mask), rep(lam), cfg, max_rounds, escape_iters,
                      top_k, rep(gain_stack), switch_cost, rep(incumbent),
                      ladder, rep(init_comp))
    res = _unflatten(res, C, S)
    key = res.R_search if gain_stack is not None else res.R
    return _select_rows(res, torch.argmin(key, dim=1))


def _unflatten(tree, C: int, S: int):
    if isinstance(tree, tuple):
        return type(tree)(*(_unflatten(x, C, S) for x in tree))
    return tree.reshape((C, S) + tree.shape[1:])


def _squeeze0(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_squeeze0(x) for x in tree))
    return tree[0]


def _as(x, dtype, device, lead: bool = False):
    """An optional operand as a tensor on ``device`` (a leading axis of one
    added when ``lead``)."""
    if x is None:
        return None
    x = (x.to(device=device, dtype=dtype) if isinstance(x, torch.Tensor)
         else torch.tensor(np.asarray(x), dtype=dtype, device=device))
    return x[None] if lead else x


def solve_assignment(scn: Scenario, init_assign=None, mask=None, lam=1.0,
                     cfg: sroa.SroaConfig = sroa.SroaConfig(),
                     max_rounds: int = 48, escape_iters: int = 6,
                     top_k: int = 0, n_starts: int = 1, gain_stack=None,
                     switch_cost: float = 0.0, incumbent=None, ladder=None,
                     init_comp=None, tail_init=None) -> EngineResult:
    """One cell's entire assignment search (a fleet of one).

    Args mirror the JAX engine: ``init_assign`` (N,) defaults to the
    nearest-(open-)edge pattern (Alg 5 line 5), ``mask`` (N,) to
    all-active; ``top_k > 0`` scores only the k kernel-nominated moves per
    round and ``n_starts`` adds restarts (D9); ``gain_stack`` (K, N, M)
    with ``switch_cost``/``incumbent`` (N,) is the horizon objective
    (D10); ``ladder``/``init_comp`` (N,) the compression search (D11);
    ``tail_init`` (N,) one extra warm-start restart.  K == 1 with no
    switching charge is the snapshot search on slot 0's gain, bitwise.
    """
    dev = scn.device
    if mask is None:
        mask = torch.ones(scn.N, dtype=torch.bool, device=dev)
    if init_assign is None:
        init_assign = nearest_edge_assignment(scn)
    gain_stack = _as(gain_stack, torch.float32, dev)
    if gain_stack is not None and gain_stack.shape[0] == 1 \
            and switch_cost == 0.0:
        scn = scn._replace(gain=gain_stack[0])
        gain_stack = incumbent = None
    one = map_scenario(lambda x: x[None], scn)
    res = search_core(
        one, _as(init_assign, torch.int32, dev, True),
        _as(mask, torch.bool, dev, True), lam, cfg, max_rounds,
        escape_iters, top_k, n_starts,
        None if gain_stack is None else gain_stack[None], switch_cost,
        _as(incumbent, torch.int32, dev, True), ladder,
        _as(init_comp, torch.int32, dev, True),
        _as(tail_init, torch.int32, dev, True))
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
    cells' candidates in one batched SROA solve.  ``gain_stacks``
    (C, K, N, M) with ``switch_cost``/``incumbents`` (C, N) switch every
    cell to the horizon objective (D10), ``ladder``/``init_comps`` to the
    compression search (D11) and ``tail_inits`` (C, N) add each cell's
    receding-horizon warm start.
    """
    dev = fleet.device
    if init_assigns is None:
        init_assigns = fleet_assignments(fleet)
    init = _as(init_assigns, torch.int32, dev)
    gain_stacks = _as(gain_stacks, torch.float32, dev)
    if gain_stacks is not None and gain_stacks.shape[1] == 1 \
            and switch_cost == 0.0:
        # K=1 with no switching charge is snapshot planning: the snapshot
        # search on slot 0's gain, bitwise.
        fleet = fleet._replace(cells=fleet.cells._replace(
            gain=gain_stacks[:, 0]))
        gain_stacks = incumbents = None
    comps = None
    if _comp_enabled(ladder):
        comps = (torch.zeros_like(init) if init_comps is None
                 else _as(init_comps, torch.int32, dev))
    if gain_stacks is not None:
        incumbents = (init if incumbents is None
                      else _as(incumbents, torch.int32, dev))
    else:
        incumbents = None
    return search_core(fleet.cells, init, fleet.mask, lam, cfg, max_rounds,
                       escape_iters, top_k, n_starts, gain_stacks,
                       switch_cost, incumbents, ladder, comps,
                       _as(tail_inits, torch.int32, dev))


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
    init_comps = _as(init_comps, torch.int32, fleet.device)
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
            escape_iters, top_k, n_starts, ladder=ladder,
            init_comps=None if init_comps is None else init_comps[idx]))
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
