"""The plain reference of the fleet's assignment search (TSIA's rounds as
the planning service runs them, Algorithm 5 with move pruning).

A frozen copy of one round, repeated until each cell stops:

* the move scores: the airtime a single-user move adds, at an equal share
  of the cell's bandwidth, as the move-score kernel prices it, and the
  ``top_k`` cheapest moves in (score, user x edge) order;
* the candidates: the current pattern and the pattern of each nominated
  move, every one priced by the reference SROA (:mod:`reference.sroa`)
  and the cost model (eqs 4-15);
* the step: the cheapest valid candidate when it beats the current
  pattern; otherwise, while escapes remain, the paper's Definition 1/2
  escape (the costliest user of the costliest occupied edge to the
  cheapest edge); a cell stops when it cannot move or revisits a pattern
  (Remark 1), or after ``max_rounds``;
* the best pattern ever scored is the answer.

The judge prices one round from the program's answer (:func:`round_gap`);
the whole search (:func:`search`) holds these rounds to the program's
engine in the benchmark's tests.  Cells are independent: a cell's rounds do not depend on the others in the
batch, so any sample of cells can be replayed together.  Nothing here
imports the program.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import sroa as rsroa

BIG = rsroa.BIG


def move_scores(cells: dict, assign: np.ndarray,
                mask: np.ndarray) -> np.ndarray:
    """(C, N*M) score of moving user n to edge m (row-major (n, m)): the
    airtime the move adds at an equal bandwidth share, BIG for the user's
    own edge and for inactive users."""
    g = lambda k: np.asarray(cells[k], np.float64)  # noqa: E731
    gain = g("gain")
    C, N, M = gain.shape
    mk = np.asarray(mask, np.float64)
    n_act = np.maximum(mk.sum(1), 1.0)[:, None, None]
    b_ref = g("B_edges").sum(-1)[:, None, None] / n_act
    H = (g("s_bits")[:, None] * g("size_mult"))[..., None]
    se = np.log1p(gain * g("p_max")[..., None]
                  / np.maximum(g("N0")[:, None, None] * b_ref, 1e-30)
                  ) / rsroa.LN2
    a = H / np.maximum(se, 1e-9)
    cur = np.eye(M)[np.asarray(assign, np.int64)] * mk[..., None]
    c_m = cur.sum(1, keepdims=True)
    a_src = (a * cur).sum(2, keepdims=True)
    c_src = (c_m * cur).sum(2, keepdims=True)
    score = a * (1.0 + (c_m + 1.0) / n_act) - a_src * (1.0 + c_src / n_act)
    own = np.arange(M) == np.asarray(assign)[..., None]
    valid = (mk[..., None] > 0) & ~own
    return np.where(valid, score, BIG).reshape(C, N * M)


def candidates(cells: dict, current: np.ndarray, mask: np.ndarray,
               top_k: int) -> tuple[np.ndarray, np.ndarray]:
    """(C, k+1, N) patterns, the current one first, then one a nominated
    move, and (C, k+1) whether each is a legal move."""
    M = cells["gain"].shape[-1]
    score = move_scores(cells, current, mask)
    order = np.argsort(score, axis=1, kind="stable")[:, :top_k]
    ok = np.take_along_axis(score, order, 1) < BIG / 2
    user, dst = order // M, order % M
    rows = np.repeat(current[:, None, :], top_k, axis=1)
    np.put_along_axis(rows, user[..., None], dst[..., None], axis=2)
    cands = np.concatenate([current[:, None, :], rows], axis=1)
    valid = np.concatenate([np.ones_like(ok[:, :1]), ok], axis=1)
    return cands, valid


def escape_move(assign: np.ndarray, R_m: np.ndarray, b: np.ndarray,
                mask: np.ndarray, M: int):
    """Definitions 1/2: (user, m_plus, m_minus, ok) for each cell: the
    costliest occupied edge, the cheapest edge, and the member of the
    costliest edge with the most bandwidth."""
    mask = np.asarray(mask, bool)
    psi = np.eye(M)[assign] * mask[..., None]
    counts = psi.sum(-2)
    m_plus = np.argmax(np.where(counts > 0, R_m, -np.inf), axis=-1)
    m_minus = np.argmin(R_m, axis=-1)
    member = (assign == m_plus[:, None]) & mask
    user = np.argmax(np.where(member, b, -np.inf), axis=-1)
    occupied = np.take_along_axis(counts, m_plus[:, None], 1)[:, 0] > 0
    ok = (m_plus != m_minus) & occupied & member.any(-1)
    return user, m_plus, m_minus, ok


def price(cells: dict, patterns: np.ndarray, mask: np.ndarray, lam: float,
          caps: dict, dtype=torch.float64, device: str = "cpu") -> dict:
    """Price A patterns of each of C cells, (C, A, N), by the reference
    SROA and the cost model: ``R`` (C, A), and for each cell's first
    pattern its edges' costs ``R_m`` (C, M) and bandwidths ``b`` (C, N)."""
    C, A, N = patterns.shape
    M = cells["gain"].shape[-1]
    rep = {key: np.repeat(np.asarray(v), A, axis=0)
           for key, v in cells.items()}
    mask_rep = np.repeat(mask, A, axis=0)
    flat = patterns.reshape(C * A, N)
    plan = rsroa.solve_cells(rep, flat, mask_rep, lam, caps, dtype, device)
    R, R_m = rsroa.costs(rep, flat, mask_rep, plan["b"], plan["f"],
                         plan["p"], lam)
    return {"R": R.reshape(C, A), "R_m": R_m.reshape(C, A, M)[:, 0],
            "b": plan["b"].reshape(C, A, N)[:, 0]}


def search(cells: dict, init: np.ndarray, mask: np.ndarray, lam: float,
           caps: dict, solver: dict, dtype=torch.float64,
           device: str = "cpu") -> dict:
    """The search of C cells from ``init`` (C, N) under ``mask`` (C, N):
    the best pattern ``assign`` (C, N), its cost ``R`` (C,) by the cost
    model on the reference SROA's plan, and the ``rounds`` each cell ran.
    ``solver`` gives ``top_k``, ``max_rounds`` and ``escape_iters``."""
    init = np.asarray(init, np.int64)
    mask = np.asarray(mask, bool)
    C, N = init.shape
    M = cells["gain"].shape[-1]
    k, T = int(solver["top_k"]), int(solver["max_rounds"])
    rows = np.arange(C)
    current = init.copy()
    best_assign, best_R = current.copy(), np.full(C, np.inf)
    rounds = np.zeros(C, np.int64)
    escapes = np.zeros(C, np.int64)
    done = np.zeros(C, bool)
    visited = np.full((C, T + 1, N), -1, np.int64)
    visited[:, 0] = current
    for r in range(T):
        live = ~done
        if not live.any():
            break
        cands, valid = candidates(cells, current, mask, k)
        # Only the cells still searching are priced; a stopped cell's
        # numbers are never used.
        on = np.flatnonzero(live)
        got = price({key: np.asarray(v)[on] for key, v in cells.items()},
                    cands[on], mask[on], lam, caps, dtype, device)
        R = np.full(valid.shape, BIG)
        R[on] = got["R"]
        R_m = np.zeros((C, M))
        R_m[on] = got["R_m"]
        b0 = np.zeros((C, N))
        b0[on] = got["b"]
        Rv = np.where(valid, R, BIG)
        j = np.argmin(Rv, axis=1)
        Rj, R0 = Rv[rows, j], Rv[:, 0]
        improving = Rj < R0
        new_best = Rj < best_R
        cand_j = cands[rows, j]

        e_user, _, m_minus, e_ok = escape_move(current, R_m, b0, mask, M)
        can_escape = ~improving & e_ok & (escapes < solver["escape_iters"])
        esc = current.copy()
        esc[rows, e_user] = m_minus

        moved = improving | can_escape
        nxt = np.where(improving[:, None], cand_j,
                       np.where(can_escape[:, None], esc, current))
        revisit = moved & (visited == nxt[:, None, :]).all(2).any(1)
        stop = ~moved | revisit

        visited[:, r + 1] = np.where((live & moved)[:, None], nxt, -1)
        best_R = np.where(live & new_best, Rj, best_R)
        best_assign = np.where((live & new_best)[:, None], cand_j,
                               best_assign)
        current = np.where(live[:, None], nxt, current)
        escapes += live & can_escape
        rounds += live
        done |= live & stop
    return {"assign": best_assign, "R": best_R, "rounds": rounds}


def round_gap(cells: dict, answer: np.ndarray, start: np.ndarray,
              mask: np.ndarray, lam: float, caps: dict, top_k: int,
              dtype=torch.float64, device: str = "cpu") -> np.ndarray:
    """(C,) how much cheaper one more round finds a plan than a search's
    ``answer`` (C, N): the answer's cost over the cheapest of its
    ``top_k`` nominated moves and of the search's ``start``, less one, and
    0 where none is cheaper.  A search keeps the best pattern it priced,
    and it prices the moves of each pattern it reaches, so a whole search
    answers with a pattern that neither beats, unless its rounds ran out."""
    answer = np.asarray(answer, np.int64)
    mask = np.asarray(mask, bool)
    cands, valid = candidates(cells, answer, mask, top_k)
    cands = np.concatenate([cands, np.asarray(start, np.int64)[:, None]],
                           axis=1)
    valid = np.concatenate([valid, np.ones_like(valid[:, :1])], axis=1)
    R = np.where(valid, price(cells, cands, mask, lam, caps, dtype,
                              device)["R"], BIG)
    return np.maximum(R[:, 0] / R[:, 1:].min(1) - 1.0, 0.0)


__all__ = ["move_scores", "candidates", "escape_move", "price",
           "search", "round_gap"]
