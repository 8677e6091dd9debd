"""User-assignment baselines the paper compares TSIA against (Figs 4-6).

* ``hfel_ua``  [35] — random initial pattern, then 100 *device transferring*
  adjustments (move a random user to a random other edge, keep if the cost
  improves) followed by 300 *device exchanging* adjustments (swap two random
  users across edges, keep if the cost improves) — the iteration budget the
  paper grants HFEL in §VI-C.
* ``juara_ua`` [39] — Lagrangian-relaxation style assignment: each user goes
  to the edge with the best channel gain (the KKT rule reduces to max-gain
  association when bandwidth prices equalize).
* ``random_ua`` / ``nearest_ua`` / ``bestgain_ua`` — reference points.

Each baseline returns an int32 numpy assignment vector, drawn from numpy's
``default_rng`` in the JAX package's call order, so a seed gives the same
pattern in both packages.  Benchmarks pair it with the RA method the
original paper uses (HFEL-UA with ``hfel_ra``, JUARA-UA with ``juara_ra``).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.wireless import Scenario, nearest_edge_assignment


def _best_gain(scn: Scenario) -> np.ndarray:
    """Each user's best-gain edge (the first on a tie, as ``argmax``)."""
    return np.argmax(scn.gain.detach().cpu().numpy(), axis=1).astype(np.int32)


def random_ua(scn: Scenario, lam, score_fn, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, scn.M, size=scn.N).astype(np.int32)


def nearest_ua(scn: Scenario, lam, score_fn, seed: int = 0) -> np.ndarray:
    return nearest_edge_assignment(scn).cpu().numpy()


def bestgain_ua(scn: Scenario, lam, score_fn, seed: int = 0) -> np.ndarray:
    return _best_gain(scn)


def hfel_ua(scn: Scenario, lam, score_fn: Callable, seed: int = 0,
            transfer_iters: int = 100, exchange_iters: int = 300,
            trace: list | None = None) -> np.ndarray:
    """HFEL's random transfer + exchange local search (paper §VI-C budget)."""
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, scn.M, size=scn.N).astype(np.int32)
    best_R = score_fn(assign)
    if trace is not None:
        trace.append(best_R)

    for _ in range(transfer_iters):           # device transferring adjustment
        cand = assign.copy()
        n = rng.integers(scn.N)
        cand[n] = rng.integers(scn.M)
        if cand[n] == assign[n]:
            continue
        R = score_fn(cand)
        if R < best_R:
            best_R, assign = R, cand
        if trace is not None:
            trace.append(best_R)

    for _ in range(exchange_iters):           # device exchanging adjustment
        cand = assign.copy()
        i, j = rng.integers(scn.N, size=2)
        if assign[i] == assign[j]:
            continue
        cand[i], cand[j] = assign[j], assign[i]
        R = score_fn(cand)
        if R < best_R:
            best_R, assign = R, cand
        if trace is not None:
            trace.append(best_R)
    return assign


def juara_ua(scn: Scenario, lam, score_fn, seed: int = 0) -> np.ndarray:
    """Max-gain association (the KKT reduction of JUARA's relaxation)."""
    return _best_gain(scn)


UA_METHODS: Dict[str, Callable] = {
    "random": random_ua,
    "nearest": nearest_ua,
    "bestgain": bestgain_ua,
    "HFEL-UA": hfel_ua,
    "JUARA-UA": juara_ua,
}
