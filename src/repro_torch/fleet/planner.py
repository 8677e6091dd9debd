"""FleetPlanner facade: cached assignment + resource planning per cell.

Callers hand it a :class:`~repro_torch.fleet.batch.FleetScenario` (or one
scenario) and get back complete plans (assignment + per-user b/f/p +
objective).  Identical planning problems are served from an LRU cache keyed
on a content digest of the scenario — the same digest the JAX package
computes for the same leaves — which keeps the re-planning loop cheap
between dynamics events: unchanged cells cost a hash, changed cells a
warm-started batched-TSIA polish (:func:`repro_torch.fleet.incremental
.replan`).

Not ported yet: rolling-horizon planning (``horizon > 1``,
:meth:`plan_fleet_horizon`, ``gain_stack``; DESIGN.md D10) and compression
ladders (``ladder``, ``warm_comp``; D11), which raise.
"""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.wireless import Scenario
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import engine as fengine
from repro_torch.fleet import incremental


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def scenario_digest(scn: Scenario, lam, mask=None, extra: bytes = b"") -> str:
    """Content hash of a planning problem (scenario + weight + mask).

    Leaves may be tensors or numpy arrays; shape and dtype are hashed with
    the bytes (int32 and float32 zeros are different problems).
    """
    h = hashlib.sha1()
    for leaf in scn:
        if leaf is None:
            continue
        a = _host(leaf)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(np.float64(lam).tobytes())
    if mask is not None:
        h.update(np.asarray(_host(mask), bool).tobytes())
    h.update(extra)
    return h.hexdigest()


class PlanResult(NamedTuple):
    assign: np.ndarray     # (N,) user -> edge
    b: np.ndarray          # (N,) Hz
    f: np.ndarray          # (N,) Hz
    p: np.ndarray          # (N,) W
    R: float               # objective (eq 15)
    t: float               # SROA deadline t*
    cached: bool           # served from the LRU cache
    solve_calls: int       # batched device calls spent on this plan
    plan_ms: float         # wall time spent planning (0.0 when cached)
    comp: np.ndarray | None = None  # compression levels (None: no ladder)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to repro_torch yet")


class FleetPlanner:
    """Planning endpoint with an LRU solve cache.

    Knobs as in the JAX planner: ``use_engine`` routes cold plans through
    the batched engine (False: the host loop,
    :func:`repro_torch.fleet.incremental.solve_host`); ``top_k`` and
    ``n_starts`` are the engine's search knobs (D9).  ``horizon > 1``
    (D10) and a ``ladder`` (D11) are not ported and raise.
    """

    def __init__(self, lam: float = 1.0,
                 cfg: sroa.SroaConfig = sroa.SroaConfig(),
                 cache_size: int = 256, max_rounds: int = 48,
                 escape_iters: int = 6, use_engine: bool = True,
                 top_k: int = 0, n_starts: int = 1, n_buckets: int = 1,
                 horizon: int = 1, switch_cost: float = 0.0, ladder=None):
        if horizon > 1:
            _not_ported("rolling-horizon planning (DESIGN.md D10)")
        if ladder is not None:
            _not_ported("compression ladders (DESIGN.md D11)")
        self.lam = float(lam)
        self.cfg = cfg
        self.cache_size = cache_size
        self.max_rounds = max_rounds
        self.escape_iters = escape_iters
        self.use_engine = use_engine
        self.top_k = int(top_k)
        self.n_starts = int(n_starts)
        self.n_buckets = int(n_buckets)
        self.horizon = int(horizon)
        self.switch_cost = float(switch_cost)
        self.ladder = ladder
        self._cache: OrderedDict[str, PlanResult] = OrderedDict()
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------- caching
    def _lookup(self, key: str) -> PlanResult | None:
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit._replace(cached=True, plan_ms=0.0)
        self.misses += 1
        return None

    def _insert(self, key: str, plan: PlanResult) -> None:
        self._cache[key] = plan
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._cache),
                "hit_rate": self.hits / total if total else 0.0}

    # ------------------------------------------------------------ planning
    def plan(self, scn: Scenario, warm_assign=None, new_users=None,
             mask=None, gain_stack=None, warm_comp=None) -> PlanResult:
        """Plan one cell: cache lookup, else (warm-started) batched TSIA.

        ``warm_assign`` (N,) warm-starts :func:`incremental.replan` with
        ``new_users`` seeded nearest-edge; without it the cold plan runs on
        the engine, or on the host loop when ``use_engine`` is False.
        ``gain_stack`` (D10) and ``warm_comp`` (D11) are not ported.
        """
        if gain_stack is not None:
            _not_ported("horizon plans (gain_stack, DESIGN.md D10)")
        if warm_comp is not None:
            _not_ported("compression ladders (DESIGN.md D11)")
        if mask is not None:
            mask = np.asarray(_host(mask), bool)
            if mask.all():
                mask = None              # all-active == unmasked plan
        key = scenario_digest(scn, self.lam, mask)
        hit = self._lookup(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        if warm_assign is not None:
            res = incremental.replan(scn, warm_assign, self.lam, self.cfg,
                                     new_users=new_users, mask=mask,
                                     max_rounds=self.max_rounds,
                                     escape_iters=self.escape_iters,
                                     use_engine=self.use_engine,
                                     top_k=self.top_k,
                                     n_starts=self.n_starts)
        elif self.use_engine:
            res = incremental.solve(scn, self.lam, self.cfg,
                                    max_rounds=self.max_rounds,
                                    escape_iters=self.escape_iters,
                                    mask=mask, top_k=self.top_k,
                                    n_starts=self.n_starts)
        else:
            res = incremental.solve_host(scn, self.lam, self.cfg,
                                         max_rounds=self.max_rounds,
                                         escape_iters=self.escape_iters,
                                         mask=mask)
        plan = PlanResult(
            assign=np.asarray(res.assign), b=np.asarray(res.sroa.b),
            f=np.asarray(res.sroa.f), p=np.asarray(res.sroa.p),
            R=float(res.R), t=float(res.sroa.t), cached=False,
            solve_calls=res.history.solve_calls,
            plan_ms=(time.perf_counter() - t0) * 1e3)
        self._insert(key, plan)
        return plan

    def plan_fleet_horizon(self, *args, **kwargs):
        _not_ported("FleetPlanner.plan_fleet_horizon (DESIGN.md D10)")

    def allocate(self, scn: Scenario, assign, comp=None) -> PlanResult:
        """Resource allocation only (fixed assignment), cached."""
        if comp is not None:
            _not_ported("compression ladders (DESIGN.md D11)")
        a = np.asarray(_host(assign), np.int32)
        key = scenario_digest(scn, self.lam, extra=a.tobytes())
        hit = self._lookup(key)
        if hit is not None:
            return hit
        t0 = time.perf_counter()
        res = sroa.solve(scn, torch.tensor(a, device=scn.device),
                         self.lam, self.cfg)
        plan = PlanResult(assign=a, b=_host(res.b), f=_host(res.f),
                          p=_host(res.p), R=float(res.R), t=float(res.t),
                          cached=False, solve_calls=1,
                          plan_ms=(time.perf_counter() - t0) * 1e3)
        self._insert(key, plan)
        return plan

    @staticmethod
    def _warm_assign(w) -> np.ndarray | None:
        """Normalize a warm start: PlanResult, array, or None."""
        if w is None:
            return None
        return np.asarray(_host(getattr(w, "assign", w)), np.int32)

    def plan_fleet(self, fleet: fbatch.FleetScenario,
                   warm: list | None = None) -> list[PlanResult]:
        """Plan every cell of a fleet (per-cell cache + warm starts).

        ``warm`` entries may be :class:`PlanResult`\\ s, raw assignment
        arrays or None.  With the engine enabled and no warm starts, the
        cold cells are planned through :meth:`plan_fleet_batched` — every
        cell's search in one batched run — instead of cell by cell.
        """
        warm = warm or [None] * fleet.C
        if self.use_engine and all(w is None for w in warm):
            return self.plan_fleet_batched(fleet)
        return [self.plan(fleet.cell(i),
                          warm_assign=self._warm_assign(warm[i]))
                for i in range(fleet.C)]

    def plan_fleet_batched(self,
                           fleet: fbatch.FleetScenario) -> list[PlanResult]:
        """Cold-plan a fleet via the engine (cache-aware): cache hits
        short-circuit per cell, the misses run as one batched search."""
        keys = [scenario_digest(fleet.cell(i), self.lam)
                for i in range(fleet.C)]
        plans: dict[int, PlanResult] = {}
        miss = []
        for i, k in enumerate(keys):
            hit = self._lookup(k)
            if hit is not None:
                plans[i] = hit
            else:
                miss.append(i)
        if miss:
            sub = fleet if len(miss) == fleet.C else fleet.index(miss)
            t0 = time.perf_counter()
            solver = (fengine.solve_fleet_assignments_bucketed
                      if self.n_buckets > 1
                      else fengine.solve_fleet_assignments)
            kw = ({"n_buckets": self.n_buckets}
                  if self.n_buckets > 1 else {})
            out = solver(sub, lam=self.lam, cfg=self.cfg,
                         max_rounds=self.max_rounds,
                         escape_iters=self.escape_iters, top_k=self.top_k,
                         n_starts=self.n_starts, **kw)
            assign, R = _host(out.assign), _host(out.R)
            b, f, p, t = (_host(x) for x in (out.sroa.b, out.sroa.f,
                                             out.sroa.p, out.sroa.t))
            ms = (time.perf_counter() - t0) * 1e3 / len(miss)
            n_users = _host(fleet.n_users)
            for row, i in enumerate(miss):
                n = int(n_users[i])
                # ONE batched search covers every miss cell: charge it to
                # the first plan so summed telemetry stays exact.
                plan = PlanResult(
                    assign=assign[row][:n], b=b[row][:n], f=f[row][:n],
                    p=p[row][:n], R=float(R[row]), t=float(t[row]),
                    cached=False, solve_calls=1 if row == 0 else 0,
                    plan_ms=ms)
                self._insert(keys[i], plan)
                plans[i] = plan
        return [plans[i] for i in range(fleet.C)]

    def allocate_fleet(self, fleet: fbatch.FleetScenario, assigns=None,
                       comps=None) -> sroa.SroaResult:
        """Fast path: batched SROA for the whole fleet in one solve."""
        return fbatch.solve_batch(fleet, assigns, self.lam, self.cfg, comps,
                                  self.ladder)
