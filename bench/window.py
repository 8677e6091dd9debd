"""The measured loop: ticks back to back under Poisson plan requests.

A copy of the planning service's load generator (``run_load``): before
each tick ``Poisson(requests_per_tick)`` plan requests are submitted, and
the tick answers them all.  The loop runs ticks until the window's seconds
are spent and times each on the host clock.

Every tick leaves the published objective R of each cell and the deployed
assignments (a host copy of C floats and C x N 16-bit integers), which the
judge holds the drift gate and every request's answer to.  Some ticks are
kept whole for the judge: a uniform sample of ``check_ticks`` of the
window's ticks (reservoir sampling, drawn from the seed), so the sample
needs no knowledge of how many ticks the window will hold.  A kept tick
costs a host copy of what the service publishes after it.
"""
from __future__ import annotations

import time

import numpy as np

import system


class Window:
    """What a run of ticks leaves for the metrics and the judge."""

    def __init__(self):
        self.tick_ms: list[float] = []
        self.replanned: dict[int, np.ndarray] = {}  # every tick's re-searches
        self.R: dict[int, np.ndarray] = {}          # every tick's published R
        self.assign: dict[int, np.ndarray] = {}     # and assignments
        self.samples: dict[int, dict] = {}          # the kept ticks
        self.requests: list = []
        self.seconds = 0.0


def publish(svc, tick: int, log: Window) -> None:
    """Keep what the service published after ``tick`` (-1: its bootstrap):
    each cell's objective R and the assignments."""
    log.R[tick] = np.asarray(svc.alloc.R, np.float64).copy()
    log.assign[tick] = np.asarray(svc.assigns).astype(np.int16)


def warm_up(svc, ticks: int, log: Window) -> None:
    """Unmeasured ticks, one request each, as ``run_load``'s warm-up."""
    publish(svc, -1, log)
    for _ in range(ticks):
        svc.submit()
        rec = svc.tick()
        log.replanned[rec.tick] = np.asarray(rec.replanned)
        publish(svc, rec.tick, log)


def run(svc, seconds: float, requests_per_tick: float,
        req_rng: np.random.Generator, pick_rng: np.random.Generator,
        keep: int, log: Window, max_ticks: int | None = None) -> Window:
    """Ticks back to back for ``seconds`` (or ``max_ticks``)."""
    svc.telemetry.reset()
    t0 = time.perf_counter()
    n = 0
    while True:
        # Reservoir sampling: tick n is kept with probability keep/(n+1).
        slot = n if n < keep else int(pick_rng.integers(0, n + 1))
        kept = slot < keep
        reqs = [svc.submit() for _ in range(int(req_rng.poisson(
            requests_per_tick)))]
        log.requests += reqs
        ts = time.perf_counter()
        rec = svc.tick()
        te = time.perf_counter()
        log.tick_ms.append((te - ts) * 1e3)
        log.replanned[rec.tick] = np.asarray(rec.replanned)
        publish(svc, rec.tick, log)
        if kept:
            if len(log.samples) >= keep:
                del log.samples[sorted(log.samples)[slot]]
            snap = system.snapshot(svc)
            snap.update(tick=rec.tick, replanned=np.asarray(rec.replanned))
            log.samples[rec.tick] = snap
        n += 1
        if (te - t0 >= seconds if max_ticks is None else n >= max_ticks):
            break
    log.seconds = time.perf_counter() - t0
    return log
