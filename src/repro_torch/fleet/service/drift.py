"""Drift detection: which cells' cached plans are stale enough to re-search.

Two complementary staleness signals, both computed for the WHOLE fleet in
batched array arithmetic (no per-cell Python):

* **channel drift** — relative mean ``|gain_now - gain_ref|`` over the
  cell's active links, where ``gain_ref`` is the channel the cached plan
  was searched under.  Cheap (pure host arithmetic), catches mobility and
  fading before they hurt.
* **objective drift** — the cached assignment re-priced under the new
  channel (one batched SROA call via ``FleetPlanner.allocate_fleet``,
  i.e. the engine's cheap data plane) versus its objective at plan time.
  Catches exactly the thing we care about: the plan got worse.

Cells whose score clears a threshold — plus any cell with churn arrivals,
whose slots have no searched assignment at all — pay for an engine
re-search; everyone else keeps the cached assignment with the freshly
re-priced b/f/p allocation.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Replan-threshold knobs (either signal can trigger a re-search)."""

    channel_threshold: float = 0.05    # relative mean |delta gain|
    objective_threshold: float = 0.02  # relative R degradation
    use_channel: bool = True
    use_objective: bool = True


class DriftReport(NamedTuple):
    channel: np.ndarray     # (C,) relative channel delta since last plan
    objective: np.ndarray   # (C,) relative objective degradation
    replan: np.ndarray      # (C,) bool — cell cleared a threshold


def channel_drift(gain_now: np.ndarray, gain_ref: np.ndarray,
                  active: np.ndarray) -> np.ndarray:
    """(C,) relative mean |delta gain| over each cell's active links."""
    w = np.asarray(active, np.float64)[..., None]
    now = np.asarray(gain_now, np.float64)
    ref = np.asarray(gain_ref, np.float64)
    num = (np.abs(now - ref) * w).sum(axis=(1, 2))
    den = np.maximum((np.abs(ref) * w).sum(axis=(1, 2)), _EPS)
    return num / den


def objective_drift(R_now: np.ndarray, R_ref: np.ndarray) -> np.ndarray:
    """(C,) relative degradation of the re-priced cached plan."""
    R_now = np.asarray(R_now, np.float64)
    R_ref = np.asarray(R_ref, np.float64)
    return (R_now - R_ref) / np.maximum(np.abs(R_ref), _EPS)


def score(gain_now: np.ndarray, gain_ref: np.ndarray, active: np.ndarray,
          R_now: np.ndarray, R_ref: np.ndarray,
          cfg: DriftConfig = DriftConfig()) -> DriftReport:
    """Score every cell's staleness and flag the ones worth re-searching."""
    C = np.asarray(active).shape[0]
    ch = (channel_drift(gain_now, gain_ref, active) if cfg.use_channel
          else np.zeros(C))
    ob = (objective_drift(R_now, R_ref) if cfg.use_objective
          else np.zeros(C))
    replan = np.zeros(C, bool)
    if cfg.use_channel:
        replan |= ch > cfg.channel_threshold
    if cfg.use_objective:
        replan |= ob > cfg.objective_threshold
    return DriftReport(channel=ch, objective=ob, replan=replan)
