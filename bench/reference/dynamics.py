"""The plain reference of the live fleet: mobility, block fading, churn and
the drift gate, in numpy float64.

A frozen copy of the dynamics the planning service applies each tick, as
the paper's §VI-A channel model defines the gains (path loss 128.1 + 37.6
log10 d(km), log-normal shadowing): every cell's users move by a
Gauss-Markov step and reflect at the walls, the shadowing is redrawn at
block-fading boundaries, users leave with a constant hazard and arrive as
a Poisson stream into free slots.  The draws follow one
``numpy.random.Generator`` in a fixed order, so a seed fixes the stream;
cells outside the tick's mask keep every leaf.

The gains come back as float32, as the scenario's leaves are stored.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def path_loss_db(d_km: np.ndarray) -> np.ndarray:
    return 128.1 + 37.6 * np.log10(np.maximum(d_km, 1e-4))


def gains(pos: np.ndarray, edge_pos: np.ndarray,
          shadow_db: np.ndarray) -> np.ndarray:
    """(C, N, M) linear gains from positions (C, N, 2), edges (C, M, 2)."""
    d = np.linalg.norm(pos[:, :, None, :] - edge_pos[:, None, :, :], axis=-1)
    return 10.0 ** (-(path_loss_db(d / 1000.0) + shadow_db) / 10.0)


def recover_shadowing(pos32, edge_pos32, gain32) -> np.ndarray:
    """(C, N, M) shadowing (dB) backed out of float32 gains and geometry."""
    pos = np.asarray(pos32, np.float64)
    ep = np.asarray(edge_pos32, np.float64)
    d = np.linalg.norm(pos[:, :, None, :] - ep[:, None, :, :], axis=-1)
    gain_db = 10.0 * np.log10(np.maximum(np.asarray(gain32, np.float64),
                                         1e-300))
    return -gain_db - path_loss_db(d / 1000.0)


@dataclasses.dataclass(frozen=True)
class Stream:
    """Cadence of the dynamics (rates per simulated second)."""

    dt: float = 1.0
    mean_speed: float = 1.5
    memory: float = 0.85
    fading_every: int = 5
    arrival_rate: float = 0.5
    departure_rate: float = 0.01
    side_m: float = 500.0


@dataclasses.dataclass(frozen=True)
class Draws:
    """The per-user distributions of an arriving user (§VI-A)."""

    c_range: tuple = (1e4, 1e5)
    D_range: tuple = (150.0, 220.0)
    shadow_std_db: float = 8.0


class Fleet:
    """The live state of C cells: the leaves that move, as float32 (what the
    scenario stores) beside the float64 latent state (velocities,
    shadowing, activity)."""

    def __init__(self, cells: dict, mask: np.ndarray, seed: int,
                 stream: Stream):
        C, N = mask.shape
        self.edge_pos = np.asarray(cells["edge_pos"], np.float32)
        self.pos = np.asarray(cells["user_pos"], np.float32)
        self.gain = np.asarray(cells["gain"], np.float32)
        self.c = np.asarray(cells["c"], np.float32)
        self.D = np.asarray(cells["D"], np.float32)
        rng = np.random.default_rng(seed)
        self.velocity = rng.normal(0.0, stream.mean_speed / np.sqrt(2.0),
                                   size=(C, N, 2))
        self.shadow = recover_shadowing(self.pos, self.edge_pos, self.gain)
        self.active = np.asarray(mask, bool).copy()
        self.step_count = 0

    def step(self, rng: np.random.Generator, cell_mask: np.ndarray,
             stream: Stream, draws: Draws) -> dict:
        """Advance every cell in ``cell_mask`` one tick; returns the tick's
        events (``changed`` (C,), ``arrived`` and ``departed`` (C, N))."""
        C, N, M = self.gain.shape
        cm = np.asarray(cell_mask, bool)
        ep = self.edge_pos.astype(np.float64)
        pos0 = self.pos.astype(np.float64)

        sigma = stream.mean_speed / np.sqrt(2.0)
        noise = rng.normal(0.0, sigma, size=(C, N, 2))
        vel = (stream.memory * self.velocity
               + np.sqrt(1.0 - stream.memory ** 2) * noise)
        raw = pos0 + vel * stream.dt
        pos = stream.side_m - np.abs(stream.side_m - np.abs(raw))
        vel = np.where((raw < 0.0) | (raw > stream.side_m), -vel, vel)
        sel = cm[:, None, None]
        pos = np.where(sel, pos, pos0)
        vel = np.where(sel, vel, self.velocity)

        self.step_count += 1
        faded = (bool(stream.fading_every)
                 and self.step_count % stream.fading_every == 0)
        shadow_draw = rng.normal(0.0, draws.shadow_std_db, size=(C, N, M))
        shadow = (np.where(sel, shadow_draw, self.shadow) if faded
                  else self.shadow.copy())

        active = self.active.copy()
        c = self.c.astype(np.float64)
        D = self.D.astype(np.float64)
        leave_p = 1.0 - np.exp(-stream.departure_rate * stream.dt)
        departed = (active & (rng.uniform(size=(C, N)) < leave_p)
                    & cm[:, None])
        active &= ~departed
        n_arr = rng.poisson(stream.arrival_rate * stream.dt, size=C) * cm
        arrived = np.zeros((C, N), bool)
        for i in np.flatnonzero(n_arr):
            free = np.flatnonzero(~active[i])
            n_take = min(int(n_arr[i]), free.size)
            take = (rng.choice(free, size=n_take, replace=False)
                    if n_take else free[:0])
            for slot in take:
                active[i, slot] = True
                arrived[i, slot] = True
                pos[i, slot] = rng.uniform(0.0, stream.side_m, size=2)
                c[i, slot] = rng.uniform(*draws.c_range)
                D[i, slot] = rng.uniform(*draws.D_range)
                shadow[i, slot] = rng.normal(0.0, draws.shadow_std_db,
                                             size=M)
                vel[i, slot] = rng.normal(0.0, sigma, size=2)

        changed = cm | arrived.any(axis=1) | departed.any(axis=1)
        g = gains(pos, ep, shadow)
        keep = ~changed[:, None]
        self.gain = np.where(keep[..., None], self.gain,
                             g.astype(np.float32))
        self.pos = np.where(keep[..., None], self.pos,
                            pos.astype(np.float32))
        self.c = c.astype(np.float32)
        self.D = D.astype(np.float32)
        self.velocity, self.shadow, self.active = vel, shadow, active
        return dict(changed=changed, arrived=arrived, departed=departed)


def channel_drift(gain_now, gain_ref, active) -> np.ndarray:
    """(C,) mean |gain_now - gain_ref| over each cell's active links,
    relative to the mean |gain_ref| there."""
    w = np.asarray(active, np.float64)[..., None]
    now = np.asarray(gain_now, np.float64)
    ref = np.asarray(gain_ref, np.float64)
    num = (np.abs(now - ref) * w).sum(axis=(1, 2))
    den = np.maximum((np.abs(ref) * w).sum(axis=(1, 2)), 1e-12)
    return num / den
