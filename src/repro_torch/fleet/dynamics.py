"""Time-varying fleet streams: mobility, block fading, user churn.

Host-side numpy, as in the JAX package (scenario generation has always
been numpy): :func:`fleet_step` advances Gauss-Markov mobility, the
block-fading shadowing redraw and Poisson churn over a fixed slot pool for
every cell at once, consuming the same ``numpy.random.Generator`` stream
call for call, so a seeded trace is bitwise the JAX one.  The advanced
fleet goes back to the fleet's device.  Cells outside ``cell_mask`` keep
every leaf bit-identical (DESIGN.md D8).

Ported: the fleet-level step.  The per-cell generators (``mobility_step``,
``fading_step``, ``churn_step``, ``stream``) and the horizon rollouts
(``predict_rollout``, ``predict_fleet_rollout``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.wireless import ScenarioSpec, path_loss_db


def _tier_probs(spec: ScenarioSpec) -> np.ndarray:
    p = np.array([t.prob for t in spec.tiers], np.float64)
    return p / p.sum()


def _draw_tier(rng: np.random.Generator, spec: ScenarioSpec,
               probs: np.ndarray):
    ti = int(rng.choice(len(spec.tiers), p=probs))
    return ti, spec.tiers[ti]


def _np(x, dtype=np.float64) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, dtype)


class DynamicsState(NamedTuple):
    """Host-side latent state of one cell the Scenario does not carry."""

    velocity: np.ndarray      # (N, 2) m/s Gauss-Markov velocities
    shadow_ue_db: np.ndarray  # (N, M) log-normal shadowing user -> edge
    active: np.ndarray        # (N,) bool — slot currently holds a live user
    t: float                  # simulation clock (s)


class FleetDynamicsState(NamedTuple):
    """Stacked host-side dynamics state for a whole fleet (leading C axis)."""

    velocity: np.ndarray      # (C, N, 2) m/s Gauss-Markov velocities
    shadow_ue_db: np.ndarray  # (C, N, M) log-normal shadowing user -> edge
    active: np.ndarray        # (C, N) bool — slot currently holds a live user
    t: float                  # simulation clock (s)
    step: int                 # ticks executed (drives the fading cadence)


class FleetEvents(NamedTuple):
    """What one :func:`fleet_step` tick did to each cell."""

    changed: np.ndarray   # (C,) bool — any scenario leaf of the cell changed
    arrived: np.ndarray   # (C, N) bool — slot (re)occupied this tick
    departed: np.ndarray  # (C, N) bool — slot freed this tick
    dropped: np.ndarray   # (C,) int — arrivals lost (no free slot)
    faded: bool           # this tick crossed a block-fading boundary


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Cadence knobs for the dynamics (all rates per simulated second)."""

    dt: float = 1.0
    mean_speed: float = 1.5          # pedestrian
    memory: float = 0.85             # Gauss-Markov alpha
    fading_every: int = 5            # block length in steps
    arrival_rate: float = 0.5
    departure_rate: float = 0.01
    side_m: float = 500.0


def _draw_slots(rng: np.random.Generator, free: np.ndarray,
                n_arr: int) -> np.ndarray:
    """Uniform draw of arrival slots from the free pool (no replacement)."""
    n_take = min(n_arr, free.size)
    if n_take == 0:
        return free[:0]
    return rng.choice(free, size=n_take, replace=False)


def _fleet_gains(pos: np.ndarray, edge_pos: np.ndarray,
                 shadow_db: np.ndarray) -> np.ndarray:
    """(C, N, M) linear gains from stacked geometry + shadowing."""
    d = np.linalg.norm(pos[:, :, None, :] - edge_pos[:, None, :, :], axis=-1)
    return 10.0 ** (-(path_loss_db(d / 1000.0) + shadow_db) / 10.0)


def recover_fleet_shadowing(fleet) -> np.ndarray:
    """Back out the (C, N, M) shadowing draw of every cell at once."""
    pos = _np(fleet.cells.user_pos)
    ep = _np(fleet.cells.edge_pos)
    d = np.linalg.norm(pos[:, :, None, :] - ep[:, None, :, :], axis=-1)
    pl_db = path_loss_db(d / 1000.0)
    gain_db = 10.0 * np.log10(np.maximum(_np(fleet.cells.gain), 1e-300))
    return -gain_db - pl_db


def init_fleet_state(fleet, seed: int = 0,
                     mean_speed: float = 1.5) -> FleetDynamicsState:
    """Initial stacked dynamics state consistent with the drawn fleet."""
    rng = np.random.default_rng(seed)
    C, N = fleet.C, fleet.N_max
    vel = rng.normal(0.0, mean_speed / np.sqrt(2.0), size=(C, N, 2))
    return FleetDynamicsState(velocity=vel,
                              shadow_ue_db=recover_fleet_shadowing(fleet),
                              active=_np(fleet.mask, bool).copy(),
                              t=0.0, step=0)


def fleet_step(fleet, state: FleetDynamicsState, rng: np.random.Generator,
               cfg: StreamConfig | None = None,
               spec: ScenarioSpec | None = None,
               cell_mask: np.ndarray | None = None):
    """Advance mobility + fading + churn for EVERY cell in one batched step.

    ``cell_mask`` selects which cells see dynamics this tick (None = all);
    the others keep every scenario leaf bit-identical.  Randomness is
    consumed for all cells regardless of ``cell_mask``.

    Returns the advanced fleet (on the fleet's device; mask/n_users follow
    the churned activity), the new state, and a :class:`FleetEvents`.
    """
    cfg = cfg or StreamConfig()
    spec = spec or ScenarioSpec()
    C, N, M = fleet.C, fleet.N_max, fleet.M
    dev = fleet.device
    cm = (np.ones(C, bool) if cell_mask is None
          else np.asarray(cell_mask, bool))
    cells = fleet.cells
    edge_pos = _np(cells.edge_pos)
    pos0 = _np(cells.user_pos)
    gain0 = _np(cells.gain)

    # Mobility (Gauss-Markov, reflected walls) — every cell at once.
    sigma = cfg.mean_speed / np.sqrt(2.0)
    noise = rng.normal(0.0, sigma, size=(C, N, 2))
    vel = cfg.memory * state.velocity + np.sqrt(
        1.0 - cfg.memory ** 2) * noise
    raw = pos0 + vel * cfg.dt
    pos = np.abs(raw)
    pos = cfg.side_m - np.abs(cfg.side_m - pos)
    vel = np.where((raw < 0.0) | (raw > cfg.side_m), -vel, vel)
    sel = cm[:, None, None]
    pos = np.where(sel, pos, pos0)
    vel = np.where(sel, vel, state.velocity)

    # Block fading boundary: redraw shadowing for the selected cells.
    step = state.step + 1
    faded = bool(cfg.fading_every) and step % cfg.fading_every == 0
    shadow_draw = rng.normal(0.0, spec.shadow_std_db, size=(C, N, M))
    shadow = (np.where(cm[:, None, None], shadow_draw, state.shadow_ue_db)
              if faded else state.shadow_ue_db.copy())

    # Churn: vectorized departures, per-slot arrival redraws (rare events).
    tiered = bool(spec.tiers)
    active = state.active.copy()
    c = _np(cells.c).copy()
    D = _np(cells.D).copy()
    if tiered:
        probs = _tier_probs(spec)
        tier = _np(cells.tier, np.int32).copy()
        cyc = _np(cells.cycle_mult).copy()
        siz = _np(cells.size_mult).copy()
        f_max = _np(cells.f_max).copy()
    leave_p = 1.0 - np.exp(-cfg.departure_rate * cfg.dt)
    departed = (active & (rng.uniform(size=(C, N)) < leave_p)
                & cm[:, None])
    active &= ~departed
    n_arr = rng.poisson(cfg.arrival_rate * cfg.dt, size=C) * cm
    arrived = np.zeros((C, N), bool)
    dropped = np.zeros(C, np.int64)
    for i in np.flatnonzero(n_arr):
        free = np.flatnonzero(~active[i])
        take = _draw_slots(rng, free, int(n_arr[i]))
        dropped[i] = max(0, int(n_arr[i]) - free.size)
        for slot in take:
            active[i, slot] = True
            arrived[i, slot] = True
            pos[i, slot] = rng.uniform(0.0, cfg.side_m, size=2)
            c[i, slot] = rng.uniform(*spec.c_range)
            D[i, slot] = rng.uniform(spec.D_range[0], spec.D_range[1])
            shadow[i, slot] = rng.normal(0.0, spec.shadow_std_db, size=M)
            vel[i, slot] = rng.normal(0.0, cfg.mean_speed / np.sqrt(2.0),
                                      size=2)
            if tiered:
                # Last in the slot's draw order (homogeneous specs keep
                # their exact rng stream).
                ti, t = _draw_tier(rng, spec, probs)
                tier[i, slot] = ti
                cyc[i, slot], siz[i, slot] = t.cycle_mult, t.size_mult
                f_max[i, slot] = spec.f_max_hz * t.f_scale

    changed = cm | arrived.any(axis=1) | departed.any(axis=1)
    gain = _fleet_gains(pos, edge_pos, shadow)
    # Unchanged cells keep their exact previous leaves (bit-identity).
    keep = ~changed[:, None]
    gain = np.where(keep[..., None], gain0, gain)
    pos = np.where(keep[..., None], pos0, pos)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    new = dict(user_pos=f32(pos), gain=f32(gain), c=f32(c), D=f32(D))
    if tiered:
        new.update(tier=torch.as_tensor(np.asarray(tier, np.int32),
                                        device=dev),
                   cycle_mult=f32(cyc), size_mult=f32(siz), f_max=f32(f_max))
    fleet2 = fleet._replace(
        cells=cells._replace(**new),
        mask=torch.tensor(active, device=dev),
        n_users=torch.as_tensor(active.sum(axis=1).astype(np.int32),
                                device=dev))
    state2 = FleetDynamicsState(velocity=vel, shadow_ue_db=shadow,
                                active=active, t=state.t + cfg.dt,
                                step=step)
    return fleet2, state2, FleetEvents(changed=changed, arrived=arrived,
                                       departed=departed, dropped=dropped,
                                       faded=faded)
