"""The plain reference of SROA (paper §IV, Algorithms 2-4) and of the cost
model it prices (eqs 4-15), in plain PyTorch of any float type.

A frozen copy of the fused nest as the paper and the planner define it:
Algorithm 4's value-guided bisection on the deadline t, Algorithm 3's
bisection on the power p above Lemma 2's bound, Algorithm 2's lockstep
bisection on the CPU frequency f with the Lemma-1 bandwidth inversion
inside, and the automatic t bracket.  Each problem freezes once its own
interval closes, so a problem's trajectory does not depend on its batch.

The same function serves three uses, by its ``dtype``:

* float64: the reference the benchmark judges the program's re-prices by;
* bfloat16: the control, the reference one precision below the float32
  the configurations state, which the judge has to refuse;
* float32, with ``work``: the count of the work these operands need
  (Lemma-1 inversions and f, p and t steps), from which the kernels'
  roofline and the tick's share of the peak are computed.  In float32 the
  steps are taken in the order the planner's fused kernel takes them, so
  the count is the kernel's.

Nothing here imports the program: every constant is worked out again from
the scenario's leaves.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

LN2 = float(np.log(2.0))
BIG = 1e30
GRID_BITS = 6            # halvings a grid step of the inversion takes


_CONSTS: dict = {}


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of ``like``'s type: dividing by it is a true division
    on every device (a divide by a Python scalar may become a multiply by
    its reciprocal).  Made once for each type, device and value."""
    key = (like.dtype, like.device, value)
    if key not in _CONSTS:
        _CONSTS[key] = torch.full((), value, dtype=like.dtype,
                                  device=like.device)
    return _CONSTS[key]


def _fractions(n: int, like: torch.Tensor) -> torch.Tensor:
    """The n - 1 interior points 1/n, ..., (n-1)/n of a grid of n cells,
    in ``like``'s type, made once for each."""
    key = ("grid", like.dtype, like.device, n)
    if key not in _CONSTS:
        _CONSTS[key] = torch.arange(1, n, dtype=like.dtype,
                                    device=like.device) / n
    return _CONSTS[key]


def rate(b: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """b log2(1 + G/b): the FDMA rate at SNR coefficient G (Lemma 1)."""
    b_safe = torch.clamp_min(b, 1e-12)
    return b_safe * torch.log1p(G / b_safe) / _const(b_safe, LN2)


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (P, N), (P, 1).  In float32 the users are added as 32
    lanes add them (lane l adds users l, l + 32, ... in turn, then five
    butterfly steps), the fused kernel's order; other types sum plainly."""
    if x.dtype != torch.float32:
        return x.sum(dim=1, keepdim=True)
    P, N = x.shape
    K = -(-N // 32)
    lanes = F.pad(x, (0, K * 32 - N)).reshape(P, K, 32)
    v = lanes[:, 0]
    for k in range(1, K):
        v = v + lanes[:, k]
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    return v[:, :1]


def invert_rate(G: torch.Tensor, target: torch.Tensor, bm: torch.Tensor,
                iters: int) -> torch.Tensor:
    """Smallest b in [0, bm] with rate(b) >= target, to ``iters`` halvings
    of [0, bm]; bm where even bm falls short.

    In float32 it bisects step by step, as the fused kernel does.  Other
    types take the same dyadic bracket ``GRID_BITS`` halvings at a time:
    the rate at every point of a grid of 2^GRID_BITS cells across the
    bracket at once, and the cell where it first reaches the target (the
    bracket bisection reaches, in fewer launches)."""
    bmf = torch.broadcast_to(bm, G.shape)
    lo = torch.zeros_like(G)
    hi = bmf.clone()
    if G.dtype == torch.float32:
        half = _const(G, 0.5)
        for _ in range(iters):
            mid = (lo + hi) * half
            ok = rate(mid, G) >= target
            lo = torch.where(ok, lo, mid)
            hi = torch.where(ok, mid, hi)
    else:
        left = iters
        while left > 0:
            bits = min(GRID_BITS, left)
            n = 1 << bits
            frac = _fractions(n, G)
            pts = lo[..., None] + (hi - lo)[..., None] * frac
            below = (rate(pts, G[..., None]) < target[..., None]).sum(-1)
            ends = torch.cat([lo[..., None], pts, hi[..., None]], dim=-1)
            lo = torch.gather(ends, -1, below[..., None])[..., 0]
            hi = torch.gather(ends, -1, below[..., None] + 1)[..., 0]
            left -= bits
    return torch.where(rate(bmf, G) >= target, hi, bmf)


def solve(A, J, H, delta, h, f_max, p_max, B, b_max, N0, lam, E_cloud_total,
          *, b_iters: int, f_iters: int, p_iters: int, t_iters: int,
          eps0: float = 1e-4, eps1: float = 1e-4, eps2: float = 1e-4,
          t_low: float = 1.0, t_up: float = 3e7, work: dict | None = None):
    """SROA for P problems: per-user operands (P, N), per-problem (P,), all
    of one float type.  Returns (b, f, p) as (P, N) and (t, R, b_sum) as
    (P,).  ``work``, when given, receives the steps the problems take:
    ``inversions`` (N-user inversions), ``f_steps``, ``p_steps`` and
    ``t_steps``, summed over problems (a frozen problem takes none)."""
    P = A.shape[0]
    B, bmax, N0, lam, ect = (x.reshape(P, 1) for x in
                             (B, b_max, N0, lam, E_cloud_total))
    tally = {k: torch.zeros((), dtype=torch.int64, device=A.device)
             for k in ("inversions", "f_steps", "p_steps", "t_steps")}

    def count(name, live):
        if work is not None:
            tally[name] += live.sum()

    def inv(G, tgt, bm):
        return invert_rate(G, tgt, bm, b_iters)

    def alg2(p, t, live):
        G = p * h / N0
        denom = t - delta - LN2 * H / torch.clamp_min(G, 1e-30)
        f_lo = torch.where(denom > 0, J / torch.clamp_min(denom, 1e-30),
                           f_max)
        f_lo = torch.minimum(torch.clamp_min(f_lo, 0.0), f_max)
        f_hi = f_max

        def b_of_f(f):
            tau = t - delta - J / torch.clamp_min(f, 1.0)
            tgt = torch.where(tau > 0, H / torch.clamp_min(tau, 1e-30), BIG)
            return inv(G, tgt, bmax)

        for _ in range(f_iters):
            gap = torch.amax((f_hi - f_lo) / torch.clamp_min(f_hi, 1.0),
                             dim=1, keepdim=True)
            act = gap > eps0
            if not bool(act.any()):
                break
            count("f_steps", live & act)
            count("inversions", live & act)
            f = 0.5 * (f_lo + f_hi)
            spare = lane_sum(b_of_f(f)) < B
            f_lo = torch.where(act & ~spare, f, f_lo)
            f_hi = torch.where(act & spare, f, f_hi)
        count("inversions", live)
        b = b_of_f(f_hi)
        return b, f_hi, lane_sum(b)

    def alg3(t, live):
        gamma = H / bmax
        eta = t - delta - J / f_max
        zeta = N0 * bmax / h
        expo = torch.clamp(gamma / torch.clamp_min(eta, 1e-30), 0.0, 60.0)
        p_lo = torch.where(eta > 0, zeta * (torch.exp2(expo) - 1.0), p_max)
        p_lo = torch.minimum(torch.clamp_min(p_lo, 0.0), p_max)
        p_hi = p_max
        for _ in range(p_iters):
            gap = torch.amax((p_hi - p_lo) / torch.clamp_min(p_hi, 1e-12),
                             dim=1, keepdim=True)
            act = gap > eps1
            if not bool(act.any()):
                break
            count("p_steps", live & act)
            p = 0.5 * (p_lo + p_hi)
            spare = alg2(p, t, live & act)[2] < B
            p_lo = torch.where(act & ~spare, p, p_lo)
            p_hi = torch.where(act & spare, p, p_hi)
        b, f, b_sum = alg2(p_hi, t, live)
        return b, f, p_hi, b_sum

    def eval_t(t, live):
        b, f, p, b_sum = alg3(t, live)
        G = p * h / N0
        T_com = torch.where(b > 0, H / torch.clamp_min(rate(b, G), 1e-30),
                            BIG)
        E = lane_sum(p * T_com + A * (f * f)) + ect
        return b, f, p, b_sum, E + lam * t

    # The t bracket from the scenario itself.
    G_ab = p_max * h / N0
    lo = torch.full_like(B, t_low)
    hi = torch.full_like(B, t_up)
    every = torch.ones_like(B, dtype=torch.bool)
    for _ in range(t_iters):
        count("inversions", every)
        mid = 0.5 * (lo + hi)
        tau = mid - delta - J / f_max
        tgt = torch.where(tau > 0, H / torch.clamp_min(tau, 1e-30), BIG)
        ok = lane_sum(inv(G_ab, tgt, B)) < B
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    n_eff = torch.clamp_min(torch.sum((H > 0).to(H.dtype), dim=1,
                                      keepdim=True), 1.0)
    T_eq = H / torch.clamp_min(rate(B / n_eff, G_ab), 1e-30)
    t_naive = torch.amax(T_eq + J / f_max + delta, dim=1, keepdim=True)
    t_lo = 0.95 * hi
    factor = torch.clamp(_const(lam, 8.0) / torch.clamp_min(lam, 1e-30),
                         8.0, 2e4)
    t_up = torch.maximum(factor * t_naive, 2.0 * t_lo)

    # Algorithm 4: value-guided bisection on t, tracking the best R.
    b_tol = B * (1.0 + 1e-3)
    bb, fb, pb, bsb, Rb = eval_t(t_up, every)
    tb = t_up
    R_star = torch.where(bsb > b_tol, BIG, Rb)
    for _ in range(t_iters):
        act = (t_up - t_lo) / t_up > eps2
        if not bool(act.any()):
            break
        count("t_steps", act)
        t = 0.5 * (t_lo + t_up)
        b, f, p, bs, R = eval_t(t, act)
        infeasible = bs > b_tol
        upd = act & ~infeasible & (R <= R_star)
        t_lo = torch.where(act & (infeasible | (R > R_star)), t, t_lo)
        t_up = torch.where(upd, t, t_up)
        R_star = torch.where(upd, R, R_star)
        bb, fb, pb = (torch.where(upd, new, old)
                      for new, old in ((b, bb), (f, fb), (p, pb)))
        tb, Rb, bsb = (torch.where(upd, new, old)
                       for new, old in ((t, tb), (R, Rb), (bs, bsb)))
    if work is not None:
        work.update({k: int(v) for k, v in tally.items()})
    return bb, fb, pb, tb[:, 0], Rb[:, 0], bsb[:, 0]


# ------------------------------------------------------------ cost model
def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def cloud_terms(cells: dict, dtype, device):
    """(P, M) edge -> cloud delay and energy a global iteration (eqs 11-12)."""
    t = lambda k: _t(cells[k], dtype, device)  # noqa: E731
    N0 = t("N0")[:, None]
    snr = t("gain_cloud") * t("p_edge") / (N0 * t("B_cloud"))
    r = t("B_cloud") * torch.log2(1.0 + snr)
    T_cloud = t("s_bits")[:, None] / r
    return T_cloud, t("p_edge") * T_cloud


def constants(cells: dict, assign: np.ndarray, mask: np.ndarray, dtype,
              device) -> dict:
    """Problem (17)'s per-user constants (eqs 18-20) for P cells and their
    assignments: the operands of :func:`solve`.  Inactive users get
    A = J = H = delta = 0 and h = 1, so they take ~no bandwidth."""
    t = lambda k: _t(cells[k], dtype, device)  # noqa: E731
    M = cells["gain"].shape[-1]
    a = torch.as_tensor(np.asarray(assign, np.int64), device=device)
    m = torch.as_tensor(np.asarray(mask, bool), device=device)
    psi = F.one_hot(a.clamp(0, M - 1), M).to(dtype) * m[..., None].to(dtype)
    I, K, L, alpha = t("I"), t("K"), t("L"), t("alpha")
    IKL = (I * K * L)[:, None]
    c_eff = t("c") * t("cycle_mult")
    s_eff = t("s_bits")[:, None] * t("size_mult")
    occupied = psi.sum(dim=-2) > 0
    T_cl, E_cl = cloud_terms(cells, dtype, device)
    T_cl = torch.where(occupied, T_cl, 0.0)
    E_cl = torch.where(occupied, E_cl, 0.0)
    A = 0.5 * alpha[:, None] * IKL * c_eff * t("D")
    J = IKL * c_eff * t("D")
    H = (I * K)[:, None] * s_eff
    delta = I[:, None] * torch.sum(psi * T_cl[:, None, :], dim=-1)
    h = torch.sum(psi * t("gain"), dim=-1)
    B = torch.sum(t("B_edges"), dim=-1)
    return dict(A=torch.where(m, A, 0.0), J=torch.where(m, J, 0.0),
                H=torch.where(m, H, 0.0), delta=torch.where(m, delta, 0.0),
                h=torch.where(m, h, 1.0), f_max=t("f_max"), p_max=t("p_max"),
                B=B, b_max=B, N0=t("N0"), E_cloud_total=I * E_cl.sum(-1))


def solve_cells(cells: dict, assign, mask, lam: float, caps: dict, dtype,
                device="cpu", work: dict | None = None) -> dict:
    """SROA of P cells under their assignments; numpy float64 results
    b, f, p (P, N) and t, R, b_sum (P,)."""
    c = constants(cells, assign, mask, dtype, device)
    lam_t = torch.full((c["B"].shape[0],), lam, dtype=dtype, device=device)
    out = solve(c["A"], c["J"], c["H"], c["delta"], c["h"], c["f_max"],
                c["p_max"], c["B"], c["b_max"], c["N0"], lam_t,
                c["E_cloud_total"], work=work, **caps)
    names = ("b", "f", "p", "t", "R", "b_sum")
    return {k: v.detach().to("cpu", torch.float64).numpy()
            for k, v in zip(names, out)}


def costs(cells: dict, assign, mask, b, f, p,
          lam: float) -> tuple[np.ndarray, np.ndarray]:
    """The objective R = E_sum + lam T_sum of eqs (4)-(15), (P,), and each
    edge's share of it, R_m (P, M): I ((E_cloud + E_m) + lam (T_cloud +
    T_m)), 0 on an edge nobody uses; in float64, for P cells' plans
    (assignment and b, f, p)."""
    g = lambda k: np.asarray(cells[k], np.float64)  # noqa: E731
    assign = np.asarray(assign, np.int64)
    mask = np.asarray(mask, bool)
    P, N, M = cells["gain"].shape
    psi = (np.eye(M)[np.clip(assign, 0, M - 1)] * mask[..., None])
    gain_n = (psi * g("gain")).sum(-1)
    c_eff = g("c") * g("cycle_mult")
    s_eff = g("s_bits")[:, None] * g("size_mult")
    col = lambda k: g(k)[:, None]  # noqa: E731
    f_safe = np.maximum(f, 1.0)
    T_cmp = col("L") * c_eff * g("D") / f_safe
    E_cmp = 0.5 * col("alpha") * col("L") * f * f * c_eff * g("D")
    b_safe = np.maximum(b, 1e-9)
    r = np.where(b > 0, b_safe * np.log1p(gain_n * p / (col("N0") * b_safe))
                 / LN2, 0.0)
    T_com = np.where(r > 0, s_eff / np.maximum(r, 1e-9), BIG)
    E_com = p * T_com
    occupied = psi.sum(-2) > 0
    T_m = col("K") * np.max(np.where(psi > 0, (T_cmp + T_com)[..., None],
                                     -BIG), axis=-2)
    T_m = np.where(occupied, T_m, 0.0)
    E_m = col("K") * (psi * (E_cmp + E_com)[..., None]).sum(-2)
    T_cl, E_cl = (x.numpy() for x in cloud_terms(cells, torch.float64,
                                                  "cpu"))
    T_cl = np.where(occupied, T_cl, 0.0)
    E_cl = np.where(occupied, E_cl, 0.0)
    T = np.max(T_cl + T_m, axis=-1)
    E = np.sum(E_cl + E_m, axis=-1)
    R_m = col("I") * ((E_cl + E_m) + lam * (T_cl + T_m))
    return g("I") * E + lam * g("I") * T, R_m


def evaluate(cells: dict, assign, mask, b, f, p, lam: float) -> np.ndarray:
    """(P,) objective R = E_sum + lam T_sum of eqs (4)-(15), in float64,
    for P cells' plans (assignment and b, f, p)."""
    return costs(cells, assign, mask, b, f, p, lam)[0]


def nearest_edge(user_pos: np.ndarray, edge_pos: np.ndarray) -> np.ndarray:
    """(P, N) index of each user's nearest edge (Algorithm 5, line 5)."""
    d = np.linalg.norm(np.asarray(user_pos, np.float32)[:, :, None, :]
                       - np.asarray(edge_pos, np.float32)[:, None, :, :],
                       axis=-1)
    return np.argmin(d, axis=-1)


def k2_flops(work: dict, n_problems: int, N: int, caps: dict) -> int:
    """Operations of the fused solve for the counted work: 8 a rate step of
    each inversion's bisection, 12 an f step, 8 a p step and 20 a t step a
    user, and 10 a user for each step of the t bracket."""
    return N * (8 * caps["b_iters"] * work["inversions"]
                + 12 * work["f_steps"] + 8 * work["p_steps"]
                + 20 * work["t_steps"] + 10 * caps["t_iters"] * n_problems)


def k2_bytes(n_problems: int, N: int) -> int:
    """Bytes the solve has to move: 7 per-user operands read and 3 written,
    5 per-problem operands read and 3 written (4 bytes each), and one flag
    a problem."""
    return n_problems * (N * 4 * (7 + 3) + 4 * (5 + 3) + 1)


__all__ = ["solve", "solve_cells", "constants", "costs", "evaluate",
           "nearest_edge", "invert_rate", "rate", "lane_sum", "k2_flops",
           "k2_bytes", "cloud_terms"]
