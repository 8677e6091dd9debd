"""One run of one cell: set-up, the measured window, the traced stretch,
the judge, and the run record the metric readers read.

Seeds: the fleet is drawn from ``[seed, 0]``, plan requests arrive from
``[seed, 1]``, the judge's kept ticks are picked from ``[seed, 2]`` and
its sample of re-searched cells from ``[seed, 3]``, and the service takes
``seed`` itself (its dynamics draw from it).
"""
from __future__ import annotations

import gc
import json
import time
from pathlib import Path

import numpy as np
import torch

import fleet
import judge
import system
import trace
import window
from reference import sroa as rsroa
from spans import Spans

BENCH = Path(__file__).resolve().parent


def peaks(kind: str) -> dict | None:
    """The data-sheet peaks of the card named ``kind`` (longest matching
    prefix in ``peaks.json``), or None for a card the table lacks."""
    table = json.loads((BENCH / "peaks.json").read_text())["cards"]
    keys = [k for k in table if kind.startswith(k)]
    return table[max(keys, key=len)] if keys else None


def work_of(kept: list, device: str) -> dict:
    """Operations and bytes the kept fused-solve calls need, counted by
    the reference nest in float32 on their own operands."""
    flops = nbytes = problems = 0
    by_shape: dict = {}
    for call in kept:
        key = (call["operands"]["A"].shape[1],
               tuple(sorted(call["settings"].items())))
        by_shape.setdefault(key, []).append(call["operands"])
    for (N, settings), calls in by_shape.items():
        ops = {k: torch.cat([c[k] for c in calls]).to(device)
               for k in calls[0]}
        work: dict = {}
        settings = dict(settings)
        rsroa.solve(*(ops[k] for k in ("A", "J", "H", "delta", "h", "f_max",
                                       "p_max", "B", "b_max", "N0", "lam",
                                       "E_cloud_total")),
                    work=work, **settings)
        P = ops["A"].shape[0]
        flops += rsroa.k2_flops(work, P, N, settings)
        nbytes += rsroa.k2_bytes(P, N)
        problems += P
    return {"flops": flops, "bytes": nbytes, "problems": problems,
            "calls": len(kept)}


def run(cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
        t_start: float | None = None, after_window=None,
        ticks: int | None = None, solver: dict | None = None,
        drift: dict | None = None) -> dict:
    """Run the cell once; returns the run record (``run``), the judge's
    numbers and verdict, and the device facts.  ``after_window``, when
    given, is called with the inputs and the window's log before the judge
    reads them; ``ticks`` ends the window after that many ticks instead of
    ``seconds``; ``solver`` and ``drift`` override the program's solver
    and drift-gate settings (a planted fault), while the judge keeps the
    configuration's and the traffic's."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg, tr = cell.config, cell.traffic
    caps = system.caps(cfg)
    spans = Spans() if traced else None

    cells0, mask0 = fleet.draw(cfg, [seed, 0])
    prog_cfg = cfg if solver is None else dict(
        cfg, solver=dict(cfg["solver"], **solver))
    prog_tr = tr if drift is None else dict(
        tr, drift=dict(tr["drift"], **drift))
    svc = system.build(prog_cfg, prog_tr, cells0, mask0, seed, device)
    log = window.Window()
    window.warm_up(svc, tr["warmup_ticks"], log)
    if device != "cpu":
        system.synchronize()
    setup_s = time.perf_counter() - t_start

    if spans is not None:
        spans.install()
    first = svc.tick_idx
    req_rng = np.random.default_rng([seed, 1])
    pick_rng = np.random.default_rng([seed, 2])
    window.run(svc, seconds, tr["requests_per_tick"], req_rng, pick_rng,
               tr["check_ticks"], log, max_ticks=ticks)
    ticks = list(range(first, svc.tick_idx))
    counters = system.counters(svc)

    traced_run = work = None
    if spans is not None:
        spans.keep = True
        extra = window.Window()
        traced_run = trace.profile(lambda: window.run(
            svc, 0.0, tr["requests_per_tick"], req_rng, pick_rng, 0, extra,
            max_ticks=tr["trace_ticks"]), device)
        spans.keep = False
        spans.remove()
    memory_peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                   else 0)
    unserved = sum(not r.ready() for r in log.requests)
    del svc
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    if spans is not None:
        work = work_of(spans.kept["k2"], device)
        spans.kept = {}

    if after_window is not None:
        after_window(cells0, mask0, log)
    nums = judge.judge(cfg, tr, cells0, mask0, seed, log, caps, device)
    nums["answer_missing"] = unserved
    correct, checks = judge.verdict(nums, cell.limits)

    record = {
        "cells": cfg["cells"], "tick_ms": log.tick_ms,
        "window_s": log.seconds, "setup_s": setup_s, "ticks": ticks,
        "counters": counters, "trace": traced_run, "work": work,
        "spans": spans,
        "peaks": (peaks(torch.cuda.get_device_name(0)) if device != "cpu"
                  else None),
    }
    return {"run": record, "numbers": nums, "correct": correct,
            "checks": checks, "attempted": len(log.requests),
            "failed": unserved, "memory_peak_bytes": memory_peak}
