"""Wireless scenario model for HFL (paper §III & §VI-A), as torch tensors.

N mobile users and M edge servers uniformly placed in a 500 m square with
the cloud at the centre; path loss ``128.1 + 37.6 log10 d(km)`` with 8 dB
log-normal shadowing; thermal noise N0 = -174 dBm/Hz; per-edge bandwidth
drawn from [10, 1000] kHz; f_max = 5 GHz; p_max = 23 dBm;
c_n ~ U[1,10]x1e4 cycles/sample; alpha = 2e-28; L = K = 5; I = 80.

The draw runs in float64 numpy on the host and casts to float32 at the end,
so a seed gives the same bits as the JAX package's ``draw_scenario``.  All
quantities are SI (Hz, W, s, bits, cycles).

Batch convention: every function here and in :mod:`repro_torch.core.
system_model` accepts a scenario whose leaves carry a leading batch shape S
(scalars ``S``, per-user ``S + (N,)``, per-edge ``S + (M,)``, gain
``S + (N, M)``) — a fleet of cells is just a scenario with S = (C,).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

LN2 = float(np.log(2.0))

# Scenario fields with a user axis (everything else is per-edge or scalar).
PER_USER_FIELDS = ("user_pos", "gain", "c", "D", "f_max", "p_max",
                   "tier", "cycle_mult", "size_mult")


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** ((dbm - 30.0) / 10.0)


def path_loss_db(d_km: np.ndarray) -> np.ndarray:
    """Paper path-loss model: 128.1 + 37.6 log10 d(km)."""
    return 128.1 + 37.6 * np.log10(np.maximum(d_km, 1e-4))


class Scenario(NamedTuple):
    """Wireless HFL scenario: a NamedTuple of tensors."""

    user_pos: torch.Tensor    # (N, 2) metres
    edge_pos: torch.Tensor    # (M, 2) metres
    gain: torch.Tensor        # (N, M) linear channel gain user n -> edge m
    gain_cloud: torch.Tensor  # (M,) linear gain edge m -> cloud
    B_edges: torch.Tensor     # (M,) Hz   per-edge bandwidth budget
    B_cloud: torch.Tensor     # (M,) Hz   edge->cloud bandwidth
    p_edge: torch.Tensor      # (M,) W    edge transmit power
    c: torch.Tensor           # (N,) cycles / sample (tier-neutral base draw)
    D: torch.Tensor           # (N,) samples in local dataset
    f_max: torch.Tensor       # (N,) Hz (tier f_scale already applied)
    p_max: torch.Tensor       # (N,) W
    s_bits: torch.Tensor      # () model size in bits
    alpha: torch.Tensor       # () effective capacitance
    N0: torch.Tensor          # () W/Hz noise PSD
    L: torch.Tensor           # () local iterations per edge iteration
    K: torch.Tensor           # () edge iterations per global iteration
    I: torch.Tensor           # () global iterations
    tier: torch.Tensor        # (N,) i32 device-tier index (D11)
    cycle_mult: torch.Tensor  # (N,) cycles/sample multiplier
    size_mult: torch.Tensor   # (N,) model-size multiplier
    # Topology activation mask (DESIGN.md D12).  ``None`` means every edge
    # site is live (the fixed-M scenario).  A (M,) bool tensor marks which
    # candidate sites are open; closed sites are excluded from assignment
    # and contribute no bandwidth.
    edge_mask: torch.Tensor | None = None

    @property
    def N(self) -> int:
        return self.user_pos.shape[-2]

    @property
    def M(self) -> int:
        return self.edge_pos.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.gain.device

    @property
    def B_total(self) -> torch.Tensor:
        """Total bandwidth (constraint 15b merged as in problem (17))."""
        return torch.sum(self.B_edges, dim=-1)

    @property
    def B_open(self) -> torch.Tensor:
        """Total bandwidth over OPEN edges (== ``B_total`` when unmasked).

        An all-True ``edge_mask`` selects ``B_edges`` exactly, so the sum
        is bitwise ``B_total`` (the D12 parity invariant)."""
        if self.edge_mask is None:
            return torch.sum(self.B_edges, dim=-1)
        return torch.sum(torch.where(self.edge_mask, self.B_edges, 0.0),
                         dim=-1)

    # ---- edge -> cloud terms (eqs 11-12); constants given the topology ----
    def rate_cloud(self) -> torch.Tensor:
        snr = self.gain_cloud * self.p_edge / (self.N0[..., None]
                                               * self.B_cloud)
        return self.B_cloud * torch.log2(1.0 + snr)

    def T_cloud(self) -> torch.Tensor:      # (M,) seconds per global iteration
        return self.s_bits[..., None] / self.rate_cloud()

    def E_cloud(self) -> torch.Tensor:      # (M,) joules per global iteration
        return self.p_edge * self.T_cloud()


@dataclasses.dataclass(frozen=True)
class DeviceTier:
    """One device class in a heterogeneous fleet (DESIGN.md D11)."""

    name: str
    cycle_mult: float = 1.0
    size_mult: float = 1.0
    f_scale: float = 1.0
    prob: float = 1.0


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Knobs for drawing a Scenario (defaults = paper §VI-A, ImageNette)."""

    N: int = 50
    M: int = 5
    side_m: float = 500.0
    B_edge_range_hz: tuple = (10e3, 1000e3)
    shadow_std_db: float = 8.0
    noise_dbm_per_hz: float = -174.0
    f_max_hz: float = 5e9
    p_max_dbm: float = 23.0
    c_range: tuple = (1e4, 1e5)
    D_range: tuple = (150, 220)
    s_bytes: float = 881e3
    alpha: float = 2e-28
    L: int = 5
    K: int = 5
    I: int = 80
    B_cloud_hz: float = 1e6
    p_edge_dbm: float = 27.0
    tiers: tuple = ()

    def __post_init__(self):
        def _positive(name, v):
            if not v > 0:
                raise ValueError(f"ScenarioSpec.{name} must be > 0, got {v}")
        for name in ("N", "M", "side_m", "f_max_hz", "s_bytes", "alpha", "L",
                     "K", "I", "B_cloud_hz"):
            _positive(name, getattr(self, name))
        for name in ("B_edge_range_hz", "c_range", "D_range"):
            lo, hi = getattr(self, name)
            if not (0 < lo <= hi):
                raise ValueError(
                    f"ScenarioSpec.{name} must satisfy 0 < lo <= hi, "
                    f"got ({lo}, {hi})")
        for t in self.tiers:
            if not isinstance(t, DeviceTier):
                raise ValueError(f"ScenarioSpec.tiers entries must be "
                                 f"DeviceTier, got {type(t).__name__}")
            for fname in ("cycle_mult", "size_mult", "f_scale", "prob"):
                if not getattr(t, fname) > 0:
                    raise ValueError(
                        f"DeviceTier {t.name!r}: {fname} must be > 0, "
                        f"got {getattr(t, fname)}")


def draw_scenario_numpy(seed: int, spec: ScenarioSpec = ScenarioSpec()
                        ) -> dict:
    """The paper's random scenario as a dict of numpy leaves (f32 / i32).

    The float64 draw and its final float32 cast follow the JAX package's
    ``draw_scenario`` call for call, so the leaves are bitwise equal.
    """
    rng = np.random.default_rng(seed)
    side = spec.side_m
    user_pos = rng.uniform(0.0, side, size=(spec.N, 2))
    edge_pos = rng.uniform(0.0, side, size=(spec.M, 2))
    cloud_pos = np.array([side / 2.0, side / 2.0])

    d_ue = np.linalg.norm(user_pos[:, None, :] - edge_pos[None, :, :], axis=-1)
    d_ec = np.linalg.norm(edge_pos - cloud_pos[None, :], axis=-1)

    pl_ue = path_loss_db(d_ue / 1000.0)
    pl_ec = path_loss_db(d_ec / 1000.0)
    shadow_ue = rng.normal(0.0, spec.shadow_std_db, size=pl_ue.shape)
    shadow_ec = rng.normal(0.0, spec.shadow_std_db, size=pl_ec.shape)
    gain = 10.0 ** (-(pl_ue + shadow_ue) / 10.0)
    gain_cloud = 10.0 ** (-(pl_ec + shadow_ec) / 10.0)

    B_edges = rng.uniform(*spec.B_edge_range_hz, size=spec.M)
    c = rng.uniform(*spec.c_range, size=spec.N)
    D = rng.uniform(spec.D_range[0], spec.D_range[1], size=spec.N)

    # Tier draw comes after every legacy draw (homogeneous specs consume
    # the same rng stream as before tiers existed).
    f_max = np.full(spec.N, spec.f_max_hz)
    tier = np.zeros(spec.N, dtype=np.int32)
    cycle_mult = np.ones(spec.N)
    size_mult = np.ones(spec.N)
    if spec.tiers:
        probs = np.array([t.prob for t in spec.tiers], dtype=np.float64)
        tier = rng.choice(len(spec.tiers), size=spec.N,
                          p=probs / probs.sum()).astype(np.int32)
        cycle_mult = np.array([t.cycle_mult for t in spec.tiers])[tier]
        size_mult = np.array([t.size_mult for t in spec.tiers])[tier]
        f_max = f_max * np.array([t.f_scale for t in spec.tiers])[tier]

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(
        user_pos=f32(user_pos), edge_pos=f32(edge_pos), gain=f32(gain),
        gain_cloud=f32(gain_cloud), B_edges=f32(B_edges),
        B_cloud=f32(np.full(spec.M, spec.B_cloud_hz)),
        p_edge=f32(np.full(spec.M, dbm_to_watt(spec.p_edge_dbm))),
        c=f32(c), D=f32(D), f_max=f32(f_max),
        p_max=f32(np.full(spec.N, dbm_to_watt(spec.p_max_dbm))),
        s_bits=f32(spec.s_bytes * 8.0), alpha=f32(spec.alpha),
        N0=f32(dbm_to_watt(spec.noise_dbm_per_hz)),
        L=f32(float(spec.L)), K=f32(float(spec.K)), I=f32(float(spec.I)),
        tier=np.asarray(tier, np.int32), cycle_mult=f32(cycle_mult),
        size_mult=f32(size_mult))


def scenario_from_numpy(d: dict, device="cuda") -> Scenario:
    """Build a Scenario from numpy leaves (e.g. a JAX scenario's arrays).

    Dtypes are kept as given (float32 leaves, int32 ``tier``, bool
    ``edge_mask`` when the dict has one), so a JAX scenario carried across
    through numpy arrives bit for bit.
    """
    leaves = {name: torch.tensor(np.asarray(d[name]), device=device)
              for name in Scenario._fields if d.get(name) is not None}
    return Scenario(**leaves)


def draw_scenario(seed: int, spec: ScenarioSpec = ScenarioSpec(),
                  device="cuda") -> Scenario:
    """Draw a random scenario per the paper's experimental setup."""
    return scenario_from_numpy(draw_scenario_numpy(seed, spec), device)


def validate_scenario(scn: Scenario) -> None:
    """Shape/sign sanity checks for hand-built scenarios (one cell)."""
    n, m = scn.N, scn.M
    per_user = {"gain": (scn.gain, (n, m)), "c": (scn.c, (n,)),
                "D": (scn.D, (n,)), "f_max": (scn.f_max, (n,)),
                "p_max": (scn.p_max, (n,)), "tier": (scn.tier, (n,)),
                "cycle_mult": (scn.cycle_mult, (n,)),
                "size_mult": (scn.size_mult, (n,))}
    per_edge = {"B_edges": (scn.B_edges, (m,)), "B_cloud": (scn.B_cloud, (m,)),
                "p_edge": (scn.p_edge, (m,)), "gain_cloud": (scn.gain_cloud, (m,))}
    for name, (arr, shape) in {**per_user, **per_edge}.items():
        if tuple(arr.shape) != shape:
            raise ValueError(f"Scenario.{name} has shape {tuple(arr.shape)}, "
                             f"expected {shape} for N={n}, M={m}")
    for name in ("f_max", "p_max", "c", "D", "B_edges", "cycle_mult",
                 "size_mult"):
        if bool(torch.any(getattr(scn, name) <= 0)):
            raise ValueError(f"Scenario.{name} must be strictly positive")
    for name in ("s_bits", "alpha", "N0", "L", "K", "I"):
        v = float(getattr(scn, name))
        if not v > 0 or math.isnan(v):
            raise ValueError(f"Scenario.{name} must be > 0, got {v}")
    if scn.edge_mask is not None:
        if tuple(scn.edge_mask.shape) != (m,):
            raise ValueError(
                f"Scenario.edge_mask has shape {tuple(scn.edge_mask.shape)}, "
                f"expected ({m},)")
        if not bool(torch.any(scn.edge_mask)):
            raise ValueError("Scenario.edge_mask must keep >= 1 edge open")


def nearest_edge_assignment(scn: Scenario) -> torch.Tensor:
    """Geographical-distance initialization used by TSIA (Alg 5, line 5).

    Closed candidate sites (D12) are excluded: users seed onto the nearest
    OPEN edge (all-open masks leave the distances untouched).  Works on
    any leading batch shape: (..., N) int32.
    """
    diff = scn.user_pos[..., :, None, :] - scn.edge_pos[..., None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    if scn.edge_mask is not None:
        d = torch.where(scn.edge_mask[..., None, :], d, torch.inf)
    return torch.argmin(d, dim=-1).to(torch.int32)
