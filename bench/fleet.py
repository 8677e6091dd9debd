"""The benchmark's fleet: C cells drawn from a seed at a configuration's
settings (paper §VI-A, per cell).

Each cell holds up to ``users_max`` users and ``edges`` edge servers in a
``side_m`` square with the cloud at its centre; gains follow the path loss
128.1 + 37.6 log10 d(km) with log-normal shadowing.  The fleet's spread
(users a cell, the bandwidth and model-size scales) is one fixed set of
values, evenly spaced over the configuration's ranges and dealt to the
cells in an order drawn from the seed: every seed plans the same sizes,
over other geometry and channels.  Every leaf is drawn in one call for the
whole fleet.
"""
from __future__ import annotations

import numpy as np


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** ((dbm - 30.0) / 10.0)


def path_loss_db(d_km: np.ndarray) -> np.ndarray:
    return 128.1 + 37.6 * np.log10(np.maximum(d_km, 1e-4))


def spread(rng: np.random.Generator, lo: float, hi: float, n: int,
           integer: bool = False) -> np.ndarray:
    """n values evenly spaced over [lo, hi], in an order drawn from rng."""
    v = np.linspace(lo, hi, n)
    if integer:
        v = np.round(v).astype(np.int64)
    return v[rng.permutation(n)]


def draw(cfg: dict, seed: int) -> tuple[dict, np.ndarray]:
    """(cells, mask): the scenario's leaves stacked over cells (float32, a
    leading C axis, users padded to ``users_max``) and the (C, N) mask of
    real users."""
    rng = np.random.default_rng(seed)
    C, N, M = cfg["cells"], cfg["users_max"], cfg["edges"]
    side = float(cfg["side_m"])
    n_users = spread(rng, cfg["users_min"], N, C, integer=True)
    k_b = spread(rng, *cfg["bandwidth_scale"], C)
    k_s = spread(rng, *cfg["model_scale"], C)

    user_pos = rng.uniform(0.0, side, size=(C, N, 2))
    edge_pos = rng.uniform(0.0, side, size=(C, M, 2))
    shadow_ue = rng.normal(0.0, cfg["shadow_std_db"], size=(C, N, M))
    shadow_ec = rng.normal(0.0, cfg["shadow_std_db"], size=(C, M))
    B_lo, B_hi = cfg["bandwidth_hz_per_edge"]
    B_edges = rng.uniform(B_lo, B_hi, size=(C, M)) * k_b[:, None]
    c = rng.uniform(*cfg["c_range"], size=(C, N))
    D = rng.uniform(*cfg["D_range"], size=(C, N))

    cloud = np.array([side / 2.0, side / 2.0])
    d_ue = np.linalg.norm(user_pos[:, :, None, :] - edge_pos[:, None, :, :],
                          axis=-1)
    d_ec = np.linalg.norm(edge_pos - cloud, axis=-1)
    gain = 10.0 ** (-(path_loss_db(d_ue / 1000.0) + shadow_ue) / 10.0)
    gain_cloud = 10.0 ** (-(path_loss_db(d_ec / 1000.0) + shadow_ec) / 10.0)

    f32 = lambda x: np.ascontiguousarray(x, np.float32)  # noqa: E731
    full = lambda v, shape: np.full(shape, v, np.float32)  # noqa: E731
    cells = dict(
        user_pos=f32(user_pos), edge_pos=f32(edge_pos), gain=f32(gain),
        gain_cloud=f32(gain_cloud), B_edges=f32(B_edges),
        B_cloud=full(cfg["B_cloud_hz"], (C, M)),
        p_edge=full(dbm_to_watt(cfg["p_edge_dbm"]), (C, M)),
        c=f32(c), D=f32(D), f_max=full(cfg["f_max_hz"], (C, N)),
        p_max=full(dbm_to_watt(cfg["p_max_dbm"]), (C, N)),
        s_bits=f32(cfg["model_bytes"] * 8.0 * k_s),
        alpha=full(cfg["alpha"], C),
        N0=full(dbm_to_watt(cfg["noise_dbm_per_hz"]), C),
        L=full(cfg["L"], C), K=full(cfg["K"], C), I=full(cfg["I"], C),
        tier=np.zeros((C, N), np.int32), cycle_mult=full(1.0, (C, N)),
        size_mult=full(1.0, (C, N)))
    mask = np.arange(N)[None, :] < n_users[:, None]
    return cells, mask
