"""The planning control plane: a clocked loop that owns a live fleet.

:class:`PlanningService` turns the batched engine into a streaming system.
Each :meth:`~PlanningService.tick`:

1. **advances dynamics** for the whole fleet in one batched step
   (:func:`repro_torch.fleet.dynamics.fleet_step`; unchanged cells stay
   bit-identical);
2. **re-prices** every cell's cached assignment under the new channel with
   ONE batched SROA solve (``FleetPlanner.allocate_fleet``), so every
   response carries a current b/f/p allocation;
3. **scores drift** (:mod:`repro_torch.fleet.service.drift`) and re-searches
   assignments only for cells past a replan threshold (plus churn), warm
   started from the cached plans, as one batched engine call over exactly
   the drifted cells, split over devices only when the caller lists more
   than one (:mod:`repro_torch.fleet.service.shard`).  The JAX service pads
   replan sets to power-of-two buckets to bound recompiles; eager torch
   compiles nothing, so the port searches no padding cells;
4. **serves** every queued request with the tick's plan snapshot.

The searches take the planner's whole decision space: restarts
(``n_starts``, D9), the rolling horizon (``horizon``/``switch_cost``,
D10, with the previous window's winner as a warm-start restart),
compression ladders (``ladder``, D11) and, every ``topology_period``
ticks, a redesign of the open edge sites (D12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import sroa
from repro_torch.core.wireless import Scenario, ScenarioSpec
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import dynamics
from repro_torch.fleet import engine as fengine
from repro_torch.fleet.planner import FleetPlanner, PlanResult, scenario_digest
from repro_torch.fleet.service import drift as fdrift
from repro_torch.fleet.service import shard as fshard
from repro_torch.fleet.service.queue import CoalescingQueue, PlanRequest
from repro_torch.fleet.service.telemetry import Telemetry


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Control-plane knobs (solver knobs live on the FleetPlanner)."""

    drift: fdrift.DriftConfig = fdrift.DriftConfig()
    stream: dynamics.StreamConfig = dynamics.StreamConfig()
    event_rate: float = 1.0    # fraction of cells advanced per tick
    replan_all: bool = False   # baseline: re-search every cell every tick
    max_rounds: int = 12       # engine budget per re-search
    escape_iters: int = 2
    warm_start: bool = True    # seed re-searches from the cached plans
    shard: bool = True         # split the cell axis over several devices
    top_k: int = 0             # engine move pruning (0 = full nbhd; D9)
    n_starts: int = 1          # engine restarts (D9)
    horizon: int = 1           # predicted slots per plan (1 = snapshot; D10)
    switch_cost: float = 0.0   # weighted-cost charge per handover (D10)
    ladder: object = None      # CompressionLadder: >= 2 rungs makes
    #                            per-user compression a decision var (D11)
    topology_period: int = 0   # redesign the edge topology every P ticks
    #                            (0 = off; needs a fleet with an edge_mask,
    #                            D12)
    topology: object = None    # TopologyConfig of the redesign (None =
    #                            defaults; edge_cost lives here)


class TickRecord(NamedTuple):
    tick: int
    changed: int               # cells that saw dynamics this tick
    replanned: np.ndarray      # cell indices re-searched this tick
    engine_calls: int          # assignment-search calls spent (0 or 1)
    sum_R: float               # repriced objective summed over cells
    served: int                # requests answered this tick
    coalesced: int             # largest request group sharing the call
    tick_ms: float
    drift: fdrift.DriftReport | None
    handovers: int = 0         # active users whose edge changed this tick
    topo_moves: int = 0        # topology moves accepted this tick (D12)


class PlanningService:
    """Streaming planning endpoint over one live fleet.

    The fleet moves to ``device`` (default ``"cuda"``); ``devices``, when
    given, lists at least two devices the replan searches split over
    (default: none, every search runs on ``device``).
    """

    def __init__(self, fleet: fbatch.FleetScenario, lam: float = 1.0,
                 sroa_cfg: sroa.SroaConfig | None = None,
                 cfg: ServiceConfig = ServiceConfig(),
                 planner: FleetPlanner | None = None,
                 spec: ScenarioSpec | None = None, seed: int = 0,
                 devices=None, device="cuda"):
        self.cfg = cfg
        self.spec = spec or ScenarioSpec()
        self.device = torch.device(device)
        self.planner = planner or FleetPlanner(
            lam=lam, cfg=sroa_cfg or sroa.SroaConfig(),
            max_rounds=cfg.max_rounds, escape_iters=cfg.escape_iters,
            top_k=cfg.top_k, n_starts=cfg.n_starts, ladder=cfg.ladder)
        self.lam = self.planner.lam
        self.sroa_cfg = self.planner.cfg
        # An explicit planner wins: its ladder is the one every solve uses.
        self.ladder = self.planner.ladder
        self._comp_on = fengine._comp_enabled(self.ladder)
        self.devices = fshard.cell_mesh(devices) if cfg.shard else None
        fleet = fleet.to(self.device)
        self.state = dynamics.init_fleet_state(
            fleet, seed=seed, mean_speed=cfg.stream.mean_speed)
        self.fleet = fleet._replace(
            mask=torch.tensor(self.state.active, device=self.device))
        self.rng = np.random.default_rng(seed + 1)
        self.queue = CoalescingQueue()
        self.telemetry = Telemetry()
        self.tick_idx = 0
        self._bootstrap()

    # -------------------------------------------------------------- engine
    def _horizon_mode(self) -> bool:
        return self.cfg.horizon > 1 or self.cfg.switch_cost != 0.0

    def _engine(self, fleet, init_assigns, rows=None, init_comps=None,
                tail_inits=None):
        gs = inc = None
        sc = 0.0
        if self._horizon_mode():
            # MPC mode (D10): score candidates against the K-slot predicted
            # channel and bill handovers off the deployed assignment.
            # ``rows`` maps a sub-fleet back to its rows of the full
            # dynamics state so the rollout extrapolates the right users.
            gs = torch.as_tensor(dynamics.predict_fleet_rollout(
                fleet, self.state, self.cfg.horizon, cfg=self.cfg.stream,
                rows=rows), device=self.device)
            if init_assigns is not None:
                # A cold bootstrap has nothing deployed: no switching cost.
                inc = init_assigns
                sc = float(self.cfg.switch_cost)
        return fshard.solve_fleet_sharded(
            fleet, init_assigns, self.lam, self.sroa_cfg,
            self.cfg.max_rounds, self.cfg.escape_iters,
            devices=self.devices, top_k=self.cfg.top_k,
            n_starts=self.cfg.n_starts, gain_stacks=gs, switch_cost=sc,
            incumbents=inc, ladder=self.ladder, init_comps=init_comps,
            tail_inits=tail_inits)

    def _reprice(self) -> sroa.SroaResult:
        """Batched SROA of the current assignments under the live channel."""
        res = self.planner.allocate_fleet(
            self.fleet, torch.as_tensor(self.assigns, device=self.device),
            torch.as_tensor(self.comps, device=self.device)
            if self._comp_on else None)
        return sroa.SroaResult(*(_host(x) for x in res))

    def _bootstrap(self) -> None:
        out = self._engine(self.fleet, None)
        self.assigns = _host(out.assign).copy()
        # Deployed compression levels ride with the assignments (level 0,
        # uncompressed, when the ladder is off).
        self.comps = _host(out.comp).copy()
        # Receding-horizon warm-start stash (D10): each cell's previous
        # winning window pattern, fed to the next replan as one extra
        # engine restart (so warm search never loses to cold).
        self._tail = (self.assigns.copy()
                      if self._horizon_mode() and self.cfg.warm_start
                      else None)
        self.alloc = self._reprice()
        self.gain_ref = _host(self.fleet.cells.gain).astype(np.float64)
        self.R_ref = np.asarray(self.alloc.R, np.float64).copy()
        self._install_cache(np.arange(self.fleet.C))

    # --------------------------------------------------------------- cache
    def _install_cache(self, idx: np.ndarray) -> None:
        """Publish fresh plans into the FleetPlanner's LRU cache."""
        cells = Scenario(*(None if x is None else _host(x)
                           for x in self.fleet.cells))
        for i in np.asarray(idx, int):
            mask = self.state.active[i]
            row = Scenario(*(None if x is None else x[i] for x in cells))
            key = scenario_digest(row, self.lam,
                                  None if mask.all() else mask,
                                  extra=self.planner._ladder_extra)
            plan = PlanResult(
                assign=self.assigns[i].copy(), b=self.alloc.b[i],
                f=self.alloc.f[i], p=self.alloc.p[i],
                R=float(self.alloc.R[i]), t=float(self.alloc.t[i]),
                cached=False, solve_calls=0, plan_ms=0.0,
                comp=self.comps[i].copy() if self._comp_on else None)
            self.planner._insert(key, plan)

    # -------------------------------------------------------------- replan
    def _replan(self, idx: np.ndarray,
                ev: dynamics.FleetEvents | None) -> None:
        """One engine call re-searching exactly the drifted cells."""
        sub = self.fleet.index(idx)
        init = icomp = None
        if self.cfg.warm_start:
            init = self.assigns[idx].copy()
            if ev is not None and ev.arrived[idx].any():
                # Churn arrivals have no searched assignment yet: seed them
                # at their nearest edge (Alg 5 line 5) before the polish.
                ne = _host(fbatch.fleet_assignments(sub))
                init = np.where(ev.arrived[idx], ne, init)
            init = torch.as_tensor(init, dtype=torch.int32,
                                   device=self.device)
            if self._comp_on:
                # Arrivals start uncompressed; survivors keep their level.
                ic = self.comps[idx].copy()
                if ev is not None:
                    ic = np.where(ev.arrived[idx], 0, ic)
                icomp = torch.as_tensor(ic, dtype=torch.int32,
                                        device=self.device)
        # Receding-horizon warm start (D10): the previous window's winner
        # rides as one extra restart row (the engine re-homes it off closed
        # edges), so warm MPC search never loses to a cold one.
        tails = (torch.as_tensor(self._tail[idx], device=self.device)
                 if self._tail is not None else None)
        out = self._engine(sub, init, rows=idx, init_comps=icomp,
                           tail_inits=tails)
        self.assigns[idx] = _host(out.assign)
        self.comps[idx] = _host(out.comp)
        if self._tail is not None:
            self._tail[idx] = self.assigns[idx]

    # ------------------------------------------------------------- topology
    def _redesign_topology(self) -> int:
        """Slow-timescale edge redesign (D12): rerun the bilevel search.

        Runs :func:`repro_torch.fleet.topology.design_topology` from the
        current mask and assignments (a warm bilevel restart), installs the
        winning mask on the live fleet and refreshes plans and caches for
        every cell whose topology changed.  Returns the accepted moves.
        """
        from repro_torch.fleet import topology as ftopo
        tcfg = self.cfg.topology or ftopo.TopologyConfig()
        old = _host(self.fleet.cells.edge_mask).astype(bool)
        res = ftopo.design_topology(
            self.fleet, self.lam, self.sroa_cfg, tcfg,
            init_assigns=self.assigns, max_rounds=self.cfg.max_rounds,
            escape_iters=self.cfg.escape_iters, top_k=self.cfg.top_k,
            n_starts=self.cfg.n_starts)
        moved = np.flatnonzero((res.edge_mask != old).any(axis=1))
        if moved.size:
            self.fleet = res.fleet
            self.assigns[moved] = res.assigns[moved]
            if self._tail is not None:
                self._tail[moved] = res.assigns[moved]
            # New sites mean new geometry references: reset the drift
            # baseline so the redesign itself does not read as drift.
            self.alloc = self._reprice()
            self.gain_ref[moved] = _host(self.fleet.cells.gain).astype(
                np.float64)[moved]
            self.R_ref[moved] = np.asarray(self.alloc.R, np.float64)[moved]
            self._install_cache(moved)
        return len(res.history)

    # ---------------------------------------------------------------- serve
    def submit(self) -> PlanRequest:
        """Enqueue a plan request; the next tick resolves it."""
        self.telemetry.requests += 1
        return self.queue.submit(key=self.tick_idx)

    def tick(self, advance: bool = True) -> TickRecord:
        """One control-plane tick: dynamics, drift, replan, serve."""
        t0 = time.perf_counter()
        C = self.fleet.C
        prev_assigns = self.assigns.copy()
        prev_active = np.asarray(self.state.active, bool).copy()
        ev = None
        if advance:
            cm = self.rng.uniform(size=C) < self.cfg.event_rate
            self.fleet, self.state, ev = dynamics.fleet_step(
                self.fleet, self.state, self.rng, cfg=self.cfg.stream,
                spec=self.spec, cell_mask=cm)

        # Slow-timescale topology redesign (D12): every P ticks, reopen the
        # edge placement question under the drifted geometry.
        topo_moves = 0
        if (self.cfg.topology_period and self.tick_idx > 0
                and self.tick_idx % self.cfg.topology_period == 0
                and self.fleet.cells.edge_mask is not None):
            topo_moves = self._redesign_topology()

        gain_now = _host(self.fleet.cells.gain).astype(np.float64)
        alloc = self._reprice()
        alloc_calls = 1
        report = fdrift.score(gain_now, self.gain_ref, self.state.active,
                              np.asarray(alloc.R), self.R_ref,
                              self.cfg.drift)
        # Churn forces a re-search both ways: arrivals need a first
        # assignment, and departures shift the survivors' optimum.
        forced = (ev.arrived.any(axis=1) | ev.departed.any(axis=1)
                  if ev is not None else np.zeros(C, bool))
        if self.cfg.replan_all:
            idx = np.arange(C)
        else:
            idx = np.flatnonzero(report.replan | forced)

        engine_calls = 0
        if idx.size:
            self._replan(idx, ev)
            engine_calls = 1
            alloc = self._reprice()
            alloc_calls += 1
            self.gain_ref[idx] = gain_now[idx]
        self.alloc = alloc
        R_now = np.asarray(alloc.R, np.float64)
        if idx.size:
            self.R_ref[idx] = R_now[idx]
            self._install_cache(idx)
        sum_R = float(R_now.sum())

        groups = self.queue.drain()
        tick_ms = (time.perf_counter() - t0) * 1e3
        replanned = set(int(i) for i in idx)
        base = {
            "tick": self.tick_idx,
            "objective": sum_R,
            "R": R_now.tolist(),
            "assign": self.assigns.tolist(),
            "replanned": sorted(replanned),
            "comp": self.comps.tolist() if self._comp_on else None,
            "cached": [i not in replanned for i in range(C)],
            "drift_channel": report.channel.tolist(),
            "plan_ms": tick_ms,
        }
        served = 0
        coalesced = 0
        for reqs in groups.values():
            resp = dict(base, coalesced=len(reqs))
            coalesced = max(coalesced, len(reqs))
            for r in reqs:
                self.telemetry.record_request(r.resolve(resp))
                served += 1
        changed = int(ev.changed.sum()) if ev is not None else 0
        # A handover is an edge change for a user active in BOTH plans.
        active = np.asarray(self.state.active, bool)
        handovers = int(((prev_assigns != self.assigns) & prev_active
                         & active).sum())
        tiers = _host(self.fleet.cells.tier)
        tier_replans = (tiers[idx][active[idx]] if idx.size else None)
        comp_levels = self.comps[active] if self._comp_on else None
        self.telemetry.record_tick(
            n_cells=C, n_changed=changed, n_replanned=idx.size,
            engine_calls=engine_calls, alloc_calls=alloc_calls,
            sum_R=sum_R, tick_ms=tick_ms, drift_scores=report.channel,
            objective_scores=report.objective, coalesced=coalesced,
            handovers=handovers, tier_replans=tier_replans,
            comp_levels=comp_levels)
        rec = TickRecord(tick=self.tick_idx, changed=changed,
                         replanned=np.asarray(idx),
                         engine_calls=engine_calls, sum_R=sum_R,
                         served=served, coalesced=coalesced,
                         tick_ms=tick_ms, drift=report,
                         handovers=handovers, topo_moves=topo_moves)
        self.tick_idx += 1
        return rec

    def run(self, ticks: int) -> list[TickRecord]:
        """Advance the control plane ``ticks`` times (no request load)."""
        return [self.tick() for _ in range(ticks)]
