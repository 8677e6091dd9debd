"""Serving telemetry: plans/sec, replan fraction, tail latency, drift.

One :class:`Telemetry` instance rides with a
:class:`~repro_torch.fleet.service.control.PlanningService`; the control loop
feeds it per-tick and per-request records and :meth:`snapshot` reduces
them to the JSON record `bench_serve` and `serve --mode plan` emit.

Throughput is counted two ways:

* ``plans_per_s``   — cell-plans kept fresh per wall second
  (``C x ticks / elapsed``): every tick re-prices every cell's plan under
  the new channel (cheap batched SROA) and selectively re-searches the
  drifted ones, so each tick delivers a valid, current plan for all C
  cells.  This is the control plane's capacity metric.
* ``requests_per_s`` — plan requests answered per wall second (requests
  coalesce per tick, so this tracks offered load, not capacity).
"""
from __future__ import annotations

import json
import time

import numpy as np

# Drift histogram bin edges.  The leading -inf edge is an underflow bin:
# objective drift is signed (a replanned cell can land BELOW its reference
# R, giving a negative score) and a histogram starting at 0.0 would silently
# drop those ticks — every recorded score must land in some bin, so the
# histogram total stays equal to the number of scores fed in.
DRIFT_BINS = (-np.inf, 0.0, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0,
              np.inf)


class Telemetry:
    """Rolling counters for the planning control plane."""

    def __init__(self, drift_bins: tuple = DRIFT_BINS):
        self.drift_bins = np.asarray(drift_bins, np.float64)
        self.reset()

    def reset(self) -> None:
        """Start a fresh measurement window (e.g. after warm-up)."""
        self.t0 = time.perf_counter()
        self.ticks = 0
        self.cells = 0                # C summed over ticks
        self.cells_replanned = 0
        self.cells_changed = 0
        self.engine_calls = 0         # assignment-search (engine) calls
        self.alloc_calls = 0          # batched SROA re-pricing calls
        self.requests = 0             # submitted
        self.served = 0               # answered
        self.coalesced_max = 0        # largest single-call request group
        self.objective_sum = 0.0      # repriced sum R accumulated over ticks
        self.handovers = 0            # active users whose edge changed
        self.latencies_ms: list[float] = []
        self.tick_ms: list[float] = []
        self.drift_hist = np.zeros(len(self.drift_bins) - 1, np.int64)
        self.objective_hist = np.zeros(len(self.drift_bins) - 1, np.int64)
        # D11 heterogeneity counters: users re-searched per device tier
        # (summed over ticks) and the deployed compression-level mix of
        # the LAST tick (a histogram of levels, not a rolling sum — the
        # mix is a state, not a rate).
        self.tier_replans: dict[int, int] = {}
        self.comp_hist: dict[int, int] = {}

    # ------------------------------------------------------------- recording
    def record_request(self, latency_ms: float) -> None:
        self.served += 1
        self.latencies_ms.append(float(latency_ms))

    def record_tick(self, n_cells: int, n_changed: int, n_replanned: int,
                    engine_calls: int, alloc_calls: int, sum_R: float,
                    tick_ms: float, drift_scores=None,
                    objective_scores=None, coalesced: int = 0,
                    handovers: int = 0, tier_replans=None,
                    comp_levels=None) -> None:
        self.ticks += 1
        self.cells += int(n_cells)
        self.cells_changed += int(n_changed)
        self.cells_replanned += int(n_replanned)
        self.engine_calls += int(engine_calls)
        self.alloc_calls += int(alloc_calls)
        self.objective_sum += float(sum_R)
        self.handovers += int(handovers)
        self.tick_ms.append(float(tick_ms))
        self.coalesced_max = max(self.coalesced_max, int(coalesced))
        if drift_scores is not None:
            hist, _ = np.histogram(np.asarray(drift_scores, np.float64),
                                   bins=self.drift_bins)
            self.drift_hist += hist
        if objective_scores is not None:
            hist, _ = np.histogram(np.asarray(objective_scores, np.float64),
                                   bins=self.drift_bins)
            self.objective_hist += hist
        if tier_replans is not None:
            # flat array of tier ids, one per re-searched user this tick
            tiers, counts = np.unique(
                np.asarray(tier_replans, np.int64), return_counts=True)
            for t, n in zip(tiers, counts):
                self.tier_replans[int(t)] = (self.tier_replans.get(int(t), 0)
                                             + int(n))
        if comp_levels is not None:
            # flat array of deployed levels over active users (replaces the
            # previous mix: the deployed state, not an accumulation)
            lvls, counts = np.unique(
                np.asarray(comp_levels, np.int64), return_counts=True)
            self.comp_hist = {int(lv): int(n)
                              for lv, n in zip(lvls, counts)}

    # ------------------------------------------------------------- reporting
    @staticmethod
    def _pct(xs: list[float], q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def _hist_dict(self, counts: np.ndarray) -> dict:
        return {f"<{hi:g}": int(n)
                for hi, n in zip(self.drift_bins[1:], counts)}

    def snapshot(self) -> dict:
        elapsed = max(time.perf_counter() - self.t0, 1e-9)
        lat = self.latencies_ms
        return {
            "elapsed_s": elapsed,
            "ticks": self.ticks,
            "plans_per_s": self.cells / elapsed,
            "requests_per_s": self.served / elapsed,
            "requests_served": self.served,
            "replan_fraction": (self.cells_replanned / self.cells
                                if self.cells else 0.0),
            "changed_fraction": (self.cells_changed / self.cells
                                 if self.cells else 0.0),
            "engine_calls": self.engine_calls,
            "alloc_calls": self.alloc_calls,
            "coalesced_max": self.coalesced_max,
            "objective_sum": self.objective_sum,
            "handovers": self.handovers,
            "latency_ms": {"p50": self._pct(lat, 50),
                           "p99": self._pct(lat, 99),
                           "max": max(lat) if lat else 0.0},
            "tick_ms": {"p50": self._pct(self.tick_ms, 50),
                        "p99": self._pct(self.tick_ms, 99)},
            "drift_hist": self._hist_dict(self.drift_hist),
            "objective_drift_hist": self._hist_dict(self.objective_hist),
            # string keys so the record JSON round-trips losslessly
            "per_tier_replans": {str(t): n for t, n
                                 in sorted(self.tier_replans.items())},
            "compression_hist": {str(lv): n for lv, n
                                 in sorted(self.comp_hist.items())},
        }

    def emit(self, fh=None) -> str:
        """The JSON telemetry record (optionally written to ``fh``)."""
        line = json.dumps(self.snapshot())
        if fh is not None:
            fh.write(line + "\n")
        return line
