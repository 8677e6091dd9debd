"""Whether what the window produced is correct: the window against the
plain reference (``bench/reference``).

The reference replays the fleet from the benchmark's inputs (the drawn
cells and the seeds the service was given), one dynamics step a tick, over
every tick of the run.  On every tick it holds:

* ``drift_mismatch``: the drift gate.  A cell that the rule asks to
  re-search and that was not: churn, channel drift against the replayed
  gains of the cell's last search, or objective drift, the published R
  (the cell's re-price, its plan unchanged) against the R the cell held at
  its last re-search; cells within 1e-6 of a threshold aside.  Where the
  objective signal is off, also a cell re-searched without a reason.
* ``assign_invalid``: active users assigned to no edge.
* ``answer_mismatch``: plan requests whose answer is not what the service
  published on the tick that answered them.

On the kept ticks it also judges the published plans:

* ``fleet_state``: the largest relative gap of the live leaves (gains,
  positions over the cell's side, cycles and samples a user) between the
  program's fleet and the replayed one; ``active_mismatch``: user slots
  whose activity differs.
* ``drift_mismatch`` (continued): a cell re-searched with neither churn
  nor channel drift has to show objective drift by the reference: its
  previous plan re-priced by the reference SROA on the replayed fleet,
  against the R it held, above the threshold less ``OBJECTIVE_MARGIN``.
* ``reprice_median``, ``reprice_p95``: the median and the 95th percentile
  over every cell of the kept ticks of the relative gap between the
  published R and the cost (eqs 4-15) of the reference SROA's plan for the
  same assignment on the replayed fleet.  SROA's bisections are a
  heuristic that rounding can steer to another plan, cheaper or dearer by
  a few percent, in about one cell of a hundred; the percentile passes
  that and still sees a fault on more than a few percent of the cells.
* ``reprice_consistency``: the gap between each cell's published objective
  R and the reference's cost of the published plan (b, f, p): the deadline
  t in R = E + lam t is the plan's own delay.
* ``reprice_overrun``: how far a published plan leaves its box: the
  bandwidth used over the cell's budget, f over f_max, p over p_max, less
  one (negative inside), or a negative b, f or p over its largest.
* ``search_gap_median``, ``search_gap_p95``: the search's answers.  For a
  sample of the kept ticks' re-searched cells, drawn from the seed, one
  round of the reference search (``reference/search.py``) from the
  program's answer: the moves the move scores nominate, and the search's
  start (the assignment before the tick, arrivals at their nearest edge),
  priced by the reference.  A whole search answers with the cheapest
  pattern it priced, and it prices the nominated moves of every pattern it
  reaches, so none of these is cheaper, unless its rounds ran out; the
  number is how much cheaper the cheapest of them is, relative, over the
  sample.  (The whole reference search from the start takes ~12 rounds of
  the reference SROA, two to three times the window; one round takes
  one.)

Each number has its limit in ``bench/limits/<cell>.json``.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import dynamics as rdyn
from reference import search as rsearch
from reference import sroa as rsroa

STATIC = ("edge_pos", "gain_cloud", "B_edges", "B_cloud", "p_edge",
          "f_max", "p_max", "s_bits", "alpha", "N0", "L", "K", "I",
          "cycle_mult", "size_mult")
MARGIN = 1e-6
# The reference re-price and the program's differ by ~5e-5 at the median
# and by a few percent in a rare cell: a re-searched cell's objective drift
# by the reference may fall short of the threshold by this much.
OBJECTIVE_MARGIN = 1e-3


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _rows(cells0: dict, frames: dict, rows: list) -> dict:
    """Cells dict of the (frame, cell) ``rows``: static leaves from the
    inputs, live leaves from each replayed frame."""
    out = {}
    for k in STATIC:
        out[k] = np.stack([cells0[k][i] for _, i in rows])
    for k in ("user_pos", "gain", "c", "D"):
        out[k] = np.stack([frames[f][k][i] for f, i in rows])
    return out


def replay(cfg: dict, traffic: dict, cells0: dict, mask0: np.ndarray,
           seed: int, log) -> dict:
    """Replay the dynamics over every tick the log holds: the numbers held
    on every tick, and, per kept tick, the replayed live leaves, activity,
    churn and the re-searched cells whose reason is left to the objective
    drift by the reference (``by_objective``, with the R each held)."""
    stream = rdyn.Stream(**traffic["stream"])
    draws = rdyn.Draws(c_range=tuple(cfg["c_range"]),
                       D_range=tuple(cfg["D_range"]),
                       shadow_std_db=cfg["shadow_std_db"])
    drift = traffic["drift"]
    ref = rdyn.Fleet(cells0, mask0, seed, stream)
    rng = np.random.default_rng(seed + 1)
    C, M = mask0.shape[0], cfg["edges"]
    gain_ref = ref.gain.astype(np.float64)
    R_held = log.R[-1].copy()
    side = float(cfg["side_m"])
    frames, nums = {}, dict(fleet_state=0.0, active_mismatch=0,
                            drift_mismatch=0, assign_invalid=0)
    for k in range(max(log.R) + 1):
        cm = rng.uniform(size=C) < traffic["event_rate"]
        ev = ref.step(rng, cm, stream, draws)
        gain_now = ref.gain.astype(np.float64)
        got = np.isin(np.arange(C), log.replanned[k])
        reason = ev["arrived"].any(axis=1) | ev["departed"].any(axis=1)
        near = np.zeros(C, bool)
        if drift["use_channel"]:
            thr = drift["channel_threshold"]
            ch = rdyn.channel_drift(gain_now, gain_ref, ref.active)
            reason |= ch > thr
            near |= np.abs(ch - thr) <= MARGIN * thr
        missed = reason & ~got & ~near
        if drift["use_objective"]:
            # A cell left alone publishes the re-price the gate scored.
            thr = drift["objective_threshold"]
            ob = (log.R[k] - R_held) / np.maximum(np.abs(R_held), 1e-12)
            missed |= ((ob > thr) & ~got
                       & ~(np.abs(ob - thr) <= MARGIN * thr))
            unexplained = 0
        else:
            unexplained = int((got & ~reason & ~near).sum())
        nums["drift_mismatch"] += int(missed.sum()) + unexplained
        a = log.assign[k][ref.active]
        nums["assign_invalid"] += int(((a < 0) | (a >= M)).sum())

        s = log.samples.get(k)
        if s is not None:
            nums["fleet_state"] = max(
                nums["fleet_state"], _rel(s["gain"], ref.gain),
                float(np.max(np.abs(s["user_pos"].astype(np.float64)
                                    - ref.pos) / side)),
                _rel(s["c"], ref.c), _rel(s["D"], ref.D))
            nums["active_mismatch"] += int((s["mask"] != ref.active).sum())
            by_ob = (np.flatnonzero(got & ~reason & ~near)
                     if drift["use_objective"] else np.zeros(0, int))
            frames[k] = dict(user_pos=ref.pos.copy(), gain=ref.gain.copy(),
                             c=ref.c.copy(), D=ref.D.copy(),
                             active=ref.active.copy(),
                             arrived=ev["arrived"].copy(),
                             by_objective=by_ob, R_held=R_held[by_ob])
        idx = np.asarray(log.replanned[k], int)
        gain_ref[idx] = gain_now[idx]
        R_held[idx] = log.R[k][idx]
    return {"frames": frames, "numbers": nums}


def answers(log) -> int:
    """Requests whose answer is not what the service published on the
    tick that answered them (an unanswered one is counted apart)."""
    bad = 0
    for r in log.requests:
        resp = r.response
        if resp is None:
            continue
        k = resp["tick"]
        if (k != r.key or k not in log.R
                or not np.array_equal(np.asarray(resp["R"]), log.R[k])
                or not np.array_equal(np.asarray(resp["assign"]),
                                      log.assign[k])):
            bad += 1
    return bad


def judge(cfg: dict, traffic: dict, cells0: dict, mask0: np.ndarray,
          seed: int, log, caps: dict, device: str) -> dict:
    """The numbers compared, by name."""
    rep = replay(cfg, traffic, cells0, mask0, seed, log)
    nums = dict(rep["numbers"])
    nums["answer_mismatch"] = answers(log)
    frames = rep["frames"]
    if not frames:
        return nums
    keys = sorted(frames)
    # Every cell of the kept ticks under its published assignment, then
    # the cells left to the objective drift under their previous one.
    rows = [(k, i) for k in keys
            for i in range(log.samples[k]["assign"].shape[0])]
    assign = [log.samples[k]["assign"][i] for k, i in rows]
    n_plan = len(rows)
    for k in keys:
        for i in frames[k]["by_objective"]:
            rows.append((k, i))
            assign.append(log.assign[k - 1][i])
    assign = np.stack(assign).astype(np.int64)
    mask = np.stack([frames[k]["active"][i] for k, i in rows])
    batch = _rows(cells0, frames, rows)
    ref = rsroa.solve_cells(batch, assign, mask, cfg["lam"], caps,
                            torch.float64, device)
    R_ref = rsroa.evaluate(batch, assign, mask, ref["b"], ref["f"],
                           ref["p"], cfg["lam"])

    plan = {v: np.stack([log.samples[k][v][i] for k, i in rows[:n_plan]])
            for v in ("b", "f", "p", "R")}
    m = mask[:n_plan]
    sub = {k: v[:n_plan] for k, v in batch.items()}
    R_plan = rsroa.evaluate(sub, assign[:n_plan], m, plan["b"], plan["f"],
                            plan["p"], cfg["lam"])
    gap = np.abs(plan["R"] - R_ref[:n_plan]) / np.abs(R_ref[:n_plan])
    nums["reprice_median"] = float(np.median(gap))
    nums["reprice_p95"] = float(np.quantile(gap, 0.95))
    nums["reprice_consistency"] = float(np.max(
        np.abs(plan["R"] - R_plan) / np.abs(R_plan)))
    B = sub["B_edges"].astype(np.float64).sum(-1)
    over = [np.where(m, plan["b"], 0.0).sum(-1) / B,
            np.max(np.where(m, plan["f"] / sub["f_max"], 0.0), -1),
            np.max(np.where(m, plan["p"] / sub["p_max"], 0.0), -1)]
    neg = [np.max(np.where(m, -plan[v], 0.0), -1)
           / np.maximum(np.max(np.abs(np.where(m, plan[v], 0.0)), -1),
                        1e-300) for v in ("b", "f", "p")]
    nums["reprice_overrun"] = float(max(np.max(np.max(over, 0) - 1.0),
                                        np.max(neg)))

    if len(rows) > n_plan:
        held = np.concatenate([frames[k]["R_held"] for k in keys])
        ob = (R_ref[n_plan:] - held) / np.maximum(np.abs(held), 1e-12)
        thr = traffic["drift"]["objective_threshold"]
        nums["drift_mismatch"] += int((ob <= thr - OBJECTIVE_MARGIN).sum())

    searched = [(k, int(i)) for k in keys
                for i in log.samples[k]["replanned"]]
    if searched:
        pick = np.random.default_rng([seed, 3]).permutation(len(searched))
        searched = [searched[j] for j in
                    sorted(pick[:traffic["search_cells"]])]
        nums.update(search_gaps(cfg, cells0, frames, log, searched, caps,
                                device))
    return nums


def search_gaps(cfg: dict, cells0: dict, frames: dict, log,
                searched: list, caps: dict, device: str) -> dict:
    """One reference round from the program's answer in each ``searched``
    (tick, cell) pair: the median and the 95th percentile over the cells
    of how much cheaper its nominated moves or the search's start price."""
    batch = _rows(cells0, frames, searched)
    near = rsroa.nearest_edge(batch["user_pos"], batch["edge_pos"])
    arrived = np.stack([frames[k]["arrived"][i] for k, i in searched])
    before = np.stack([log.assign[k - 1][i] for k, i in searched])
    answer = np.stack([log.samples[k]["assign"][i] for k, i in searched])
    mask = np.stack([frames[k]["active"][i] for k, i in searched])
    gap = rsearch.round_gap(batch, answer, np.where(arrived, near, before),
                            mask, cfg["lam"], caps, cfg["solver"]["top_k"],
                            torch.float64, device)
    return {"search_gap_median": float(np.median(gap)),
            "search_gap_p95": float(np.quantile(gap, 0.95))}


def control(cfg: dict, traffic: dict, cells0: dict, mask0: np.ndarray,
            seed: int, log, caps: dict, device: str,
            dtype=torch.bfloat16) -> None:
    """Put the reference, computed in ``dtype``, in the program's place:
    each kept tick's live leaves become the replayed ones rounded to
    ``dtype``, and its re-priced plan the reference's solve in ``dtype`` of
    the published assignments."""
    frames = replay(cfg, traffic, cells0, mask0, seed, log)["frames"]
    keys = sorted(frames)
    rows = [(k, i) for k in keys
            for i in range(log.samples[k]["assign"].shape[0])]
    out = rsroa.solve_cells(
        _rows(cells0, frames, rows),
        np.stack([log.samples[k]["assign"][i] for k, i in rows]),
        np.stack([frames[k]["active"][i] for k, i in rows]),
        cfg["lam"], caps, dtype, device)
    for k in keys:
        s = log.samples[k]
        for leaf in ("user_pos", "gain", "c", "D"):
            s[leaf] = torch.as_tensor(frames[k][leaf]).to(dtype).float(
            ).numpy()
        sel = [j for j, (kk, _) in enumerate(rows) if kk == k]
        for v in ("b", "f", "p", "t", "R"):
            s[v] = out[v][sel]


def verdict(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit; a number without a limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in nums.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
