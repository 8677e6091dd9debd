"""Plain PyTorch versions of the CUDA kernels (the correctness ground truth).

Each function repeats its kernel's arithmetic operation for operation, on
batched tensors, so the CPU path and the on-card comparison use the same
numbers:

* :func:`invert_rate_plain` — K1 (``csrc/sroa_bisect.cu::sroa_invert_rate``).
* :func:`sroa_solve_plain`  — K2 (``csrc/sroa_bisect.cu::sroa_solve``): the
  fused Algorithm 2-4 nest over a (P, N) batch.  Converged problems freeze
  (``torch.where``) exactly as the TPU kernel's fixed-trip loops freeze
  them; once every problem of the batch is frozen the remaining trips are
  no-ops, so the loop stops there.
* :func:`topk_moves_plain`  — K3 (``csrc/topk_moves.cu``, both kernels):
  the score tile (:func:`move_scores_plain`) and k rounds of argmin and
  knock-out.  :func:`topk_select_lanes_plain` models the warp kernel's
  selection (lanes, slots, cached minima, owner knock-outs) and
  :func:`topk_select_slices_plain` the cluster kernel's (slice lists, one
  merge, the padding rule); the CPU tests hold both to the twin's bitwise.
* :func:`attention_plain`   — K4 (``csrc/flash_attention_sm90.cu``,
  ``csrc/flash_attention_sm90_f32.cu`` and ``csrc/flash_attention.cu``):
  the TPU kernel's blockwise online softmax in f32, with its finite
  ``NEG_INF``, its key-padding mask and its causal skip of key blocks.
  :func:`attention_tf32x3_plain` is the same algorithm with both products
  taken as the f32 kernel takes them, three TF32 passes over operands
  split by :func:`tf32_round`: a model of that kernel's precision.
* :func:`rmsnorm_plain`     — K5 (``csrc/rmsnorm.cu``): the sum of squares
  in the kernel's chunk-and-warp order (:func:`chunk_sum_plain`; bitwise
  up to ``rsqrt``).
* :func:`mamba2_recurrence_plain`, :func:`mlstm_recurrence_plain` and
  :func:`slstm_recurrence_plain` — S1, S2 and S3 (``csrc/ssm_scan.cu``):
  the time loops of ``models/ssm.py``, from the first state-dependent
  operation to the last, one step at a time in float32.  They have no
  Pallas counterpart: each replaces a ``lax.scan`` of the JAX package's
  ``models/ssm.py``.  The kernels take each state update in the twin's
  rounding order; the read-outs and the sLSTM's recurrence product are
  sums in other orders.
* :func:`mamba2_recurrence_bwd_plain`, :func:`mlstm_recurrence_bwd_plain`
  and :func:`slstm_recurrence_bwd_plain` — S1b, S2b and S3b
  (``csrc/ssm_scan_bwd.cu``): the same loops' gradients, an explicit
  reverse-time loop each (not autograd), with JAX's rules at the ties
  of ``max`` and ``abs`` (:func:`max_grad_split`).
* :func:`mamba2_chunked_plain` and :func:`mamba2_chunked_bwd_plain` — S1's
  and S1b's chunked kernels (``csrc/ssd_chunked.cu``): the chunked SSD
  form's arithmetic, chunks of ``S1_CHUNK`` steps, the decay products as
  running products (:func:`ssd_segments`), the products by the 3xTF32
  split (:func:`matmul_tf32x3`).  Tests and ``chip_smoke.py`` hold the
  kernels to them; no path runs them.
* :func:`mlstm_chunked_plain` and :func:`mlstm_chunked_bwd_plain` — S2's
  and S2b's chunked kernels (``csrc/mlstm_chunked.cu``): given the
  stabiliser (:func:`mlstm_gates_plain`), mLSTM as Mamba2's recurrence with
  n as an extra value column, chunks of ``S2_CHUNK`` steps; the forward
  S1's chunk products with q . n and y = num / den from the chunk form
  (and, on request, C, n and m before every chunk: the checkpoints its
  saving variant writes), the backward each chunk, from those checkpoints,
  through the same chunk backward as S1b's (``_ssd_chunk_bwd``), then the
  stabiliser's backward (:func:`mlstm_gates_bwd_plain`).  Held to the
  kernels as the chunked S1 models are.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN2 = float(np.log(2.0))
_BIG = 1e30
NEG_INF = -1e30          # K4's finite mask value (flash_attention.py:23)
FLASH_BLOCK_Q = 64       # K4's query rows per block
FLASH_BLOCK_K = 64       # K4's keys per staged tile


def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d tensor of ``like``'s type and device.  Dividing by it is a
    true division on every device: PyTorch's CUDA kernels turn a divide by
    a Python scalar into a multiply by its reciprocal, which the kernels
    (and the JAX package) do not do."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def rate_plain(b: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    b_safe = torch.clamp_min(b, 1e-12)
    return b_safe * torch.log1p(G / b_safe) / _const(b_safe, LN2)


def warp_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Row sums of (P, N) in the order of K2's warp reduction, (P, 1).

    Lane ``l`` of the warp adds users ``l, l + 32, ...`` in turn, then five
    butterfly steps add lane ``l ^ off`` for off = 16, 8, 4, 2, 1, so the
    sum is bitwise the kernel's (``torch.sum`` adds in another order)."""
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


def bisect_rate_plain(G: torch.Tensor, target: torch.Tensor,
                      bm: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` bisection steps of rate(b) >= target on [0, bm]; returns
    the upper end.  Each step is ``mid = 0.5 (lo + hi)``, then ``hi = mid``
    where the rate reaches the target and ``lo = mid`` elsewhere.

    The steps run in place on preallocated buffers: at the planner's sizes
    the loop is bound by per-operation overhead, not by arithmetic.
    """
    lo = torch.zeros_like(G)
    hi = bm.clone()
    mid, b_safe, r = (torch.empty_like(G) for _ in range(3))
    ok = torch.empty(G.shape, dtype=torch.bool, device=G.device)
    # 0-d operands of G's type: a Python scalar would be wrapped and cast
    # on every call (the same float32 values either way).
    half, ln2 = (torch.full((), v, dtype=G.dtype, device=G.device)
                 for v in (0.5, LN2))
    for _ in range(iters):
        torch.add(lo, hi, out=mid).mul_(half)
        torch.clamp_min(mid, 1e-12, out=b_safe)
        torch.div(G, b_safe, out=r).log1p_().mul_(b_safe).div_(ln2)
        torch.ge(r, target, out=ok)
        torch.where(ok, lo, mid, out=lo)
        torch.where(ok, mid, hi, out=hi)
    return hi


def invert_rate_plain(G: torch.Tensor, target: torch.Tensor, b_max,
                      iters: int = 42) -> torch.Tensor:
    """Smallest b in [0, b_max] with rate(b) >= target; b_max if infeasible.

    ``b_max`` broadcasts against ``G`` (scalar, per problem or per element).
    """
    bm = torch.broadcast_to(torch.as_tensor(b_max, dtype=G.dtype,
                                            device=G.device), G.shape)
    hi = bisect_rate_plain(G, target, bm, iters)
    return torch.where(rate_plain(bm, G) >= target, hi, bm)


def sroa_solve_plain(A, J, H, delta, h, f_max, p_max, B, b_max, N0, lam,
                     E_cloud_total, *, b_iters: int = 42, f_iters: int = 40,
                     p_iters: int = 36, t_iters: int = 48,
                     eps0: float = 1e-4, eps1: float = 1e-4,
                     eps2: float = 1e-4, t_low: float = 1.0,
                     t_up: float = 3e7, work: dict | None = None):
    """Fused SROA solve of P problems: per-user (P, N), per-problem (P,).

    Returns (b, f, p) as (P, N) and (t, R, b_sum, feasible) as (P,).

    ``work``, when given, receives the work this data needs on the kernel,
    whose converged problems stop where this batched version only freezes
    them: ``inversions`` (N-user Lemma-1 inversions), ``f_steps``,
    ``p_steps`` and ``t_steps`` (bisection steps), summed over problems.
    """
    P = A.shape[0]
    B, bmax, N0, lam, ect = (x.reshape(P, 1) for x in
                             (B, b_max, N0, lam, E_cloud_total))
    tally = {name: torch.zeros((), dtype=torch.int64, device=A.device)
             for name in ("inversions", "f_steps", "p_steps", "t_steps")}

    def count(name, live):
        # live: (P, 1) problems that really take this step.
        if work is not None:
            tally[name] += live.sum()

    def inv(G, tgt, bm):
        return invert_rate_plain(G, tgt, bm, b_iters)

    def alg2(p, t, live):
        """Lockstep f bisection + inner b inversion (paper Alg 2)."""
        G = p * h / N0
        denom = t - delta - LN2 * H / torch.clamp_min(G, 1e-30)
        f_lo = torch.where(denom > 0, J / torch.clamp_min(denom, 1e-30),
                           f_max)
        f_lo = torch.minimum(torch.clamp_min(f_lo, 0.0), f_max)
        f_hi = f_max

        def b_of_f(f):
            tau = t - delta - J / torch.clamp_min(f, 1.0)
            tgt = torch.where(tau > 0, H / torch.clamp_min(tau, 1e-30), _BIG)
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
            spare = warp_sum_plain(b_of_f(f)) < B
            f_lo = torch.where(act & ~spare, f, f_lo)
            f_hi = torch.where(act & spare, f, f_hi)
        count("inversions", live)
        b = b_of_f(f_hi)
        return b, f_hi, warp_sum_plain(b)

    def alg3(t, live):
        """p bisection (paper Alg 3) with the Lemma-2 lower bound."""
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
        T_com = torch.where(b > 0, H / torch.clamp_min(rate_plain(b, G),
                                                       1e-30), _BIG)
        E = warp_sum_plain(p * T_com + A * (f * f)) + ect
        return b, f, p, b_sum, E + lam * t

    # ---- `_auto_bounds`: bracket t from the scenario itself --------------
    G_ab = p_max * h / N0
    lo = torch.full_like(B, t_low)
    hi = torch.full_like(B, t_up)
    every = torch.ones_like(B, dtype=torch.bool)
    for _ in range(t_iters):
        count("inversions", every)
        mid = 0.5 * (lo + hi)
        tau = mid - delta - J / f_max
        tgt = torch.where(tau > 0, H / torch.clamp_min(tau, 1e-30), _BIG)
        ok = warp_sum_plain(inv(G_ab, tgt, B)) < B
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    n_eff = torch.clamp_min(torch.sum((H > 0).to(H.dtype), dim=1,
                                      keepdim=True), 1.0)
    T_eq = H / torch.clamp_min(rate_plain(B / n_eff, G_ab), 1e-30)
    t_naive = torch.amax(T_eq + J / f_max + delta, dim=1, keepdim=True)
    t_lo = 0.95 * hi
    factor = torch.clamp(_const(lam, 8.0) / torch.clamp_min(lam, 1e-30),
                         8.0, 2e4)
    t_up = torch.maximum(factor * t_naive, 2.0 * t_lo)

    # ---- Algorithm 4: value-guided bisection on t ------------------------
    b_tol = B * (1.0 + 1e-3)
    bb, fb, pb, bsb, Rb = eval_t(t_up, every)
    tb = t_up
    R_star = torch.where(bsb > b_tol, _BIG, Rb)
    for _ in range(t_iters):
        act = (t_up - t_lo) / t_up > eps2
        if not bool(act.any()):
            break
        count("t_steps", act)
        t = 0.5 * (t_lo + t_up)
        b, f, p, bs, R = eval_t(t, act)
        infeasible = bs > b_tol
        improved = ~infeasible & (R <= R_star)
        upd = act & improved
        t_lo = torch.where(act & (infeasible | (R > R_star)), t, t_lo)
        t_up = torch.where(upd, t, t_up)
        R_star = torch.where(upd, R, R_star)
        bb, fb, pb = (torch.where(upd, new, old)
                      for new, old in ((b, bb), (f, fb), (p, pb)))
        tb, Rb, bsb = (torch.where(upd, new, old)
                       for new, old in ((t, tb), (R, Rb), (bs, bsb)))
    if work is not None:
        work.update({name: int(v) for name, v in tally.items()})
    return (bb, fb, pb, tb[:, 0], Rb[:, 0], bsb[:, 0],
            (bsb <= b_tol)[:, 0])


def move_scores_plain(gain, H, p_max, assign, mask, N0, B) -> torch.Tensor:
    """K3's (P, N*M) move-score tile (row-major (user, edge)): the airtime a
    move adds, 1e30 for the own edge and for masked users."""
    P, N, M = gain.shape
    mk = mask.to(torch.float32)
    n_act = torch.clamp_min(torch.sum(mk, dim=1), 1.0)[:, None, None]
    b_ref = B[:, None, None] / n_act
    se = torch.log1p(gain * p_max[..., None]
                     / torch.clamp_min(N0[:, None, None] * b_ref, 1e-30)
                     ) / _const(gain, LN2)
    a = H[..., None] / torch.clamp_min(se, 1e-9)                # (P, N, M)
    cur = F.one_hot(assign.long(), M).to(torch.float32) * mk[..., None]
    c_m = torch.sum(cur, dim=1, keepdim=True)                    # (P, 1, M)
    a_src = torch.sum(a * cur, dim=2, keepdim=True)              # a(n, s)
    c_src = torch.sum(c_m * cur, dim=2, keepdim=True)            # c_s
    score = (a * (1.0 + (c_m + 1.0) / n_act)
             - a_src * (1.0 + c_src / n_act))
    col = torch.arange(M, device=gain.device)
    valid = (mk[..., None] > 0) & (col != assign[..., None])
    return torch.where(valid, score, _BIG).reshape(P, N * M)


def topk_moves_plain(gain, H, p_max, assign, mask, N0, B, *, k: int):
    """Top-k single-user moves of P cells: gain (P, N, M); H, p_max,
    assign, mask (P, N); N0, B (P,).  Returns (user, dst, score), (P, k).
    """
    P, N, M = gain.shape
    score = move_scores_plain(gain, H, p_max, assign, mask, N0, B)

    flat = torch.arange(N * M, device=gain.device).expand(P, N * M)
    rows = torch.arange(P, device=gain.device)
    idx, val = [], []
    for _ in range(k):
        mn = torch.amin(score, dim=1)
        pos = torch.amin(torch.where(score == mn[:, None], flat, 2 ** 30),
                         dim=1)
        idx.append(pos)
        val.append(mn)
        score = score.index_put((rows, pos),
                                torch.full_like(mn, _BIG))
    idx = torch.stack(idx, dim=1)
    return ((idx // M).to(torch.int32), (idx % M).to(torch.int32),
            torch.stack(val, dim=1))


def topk_select_lanes_plain(tile: torch.Tensor, k: int, S: int):
    """The selection of K3's warp kernel (``topk_moves_warp_kernel<S>``)
    over a (P, E) score tile, E <= 32 S: (flat index (P, k) int64, score
    (P, k)).

    Lane l holds entries l + 32 j in its slot j (+inf past E) and caches
    the first of its smallest slots as (score, entry).  A round takes the
    smallest cached score over the lanes, then the smallest entry among
    the lanes that cache it (the kernel's two ``redux.sync`` minima, on
    keys with the scores' order); lane r % 32 keeps round r's winner, the
    lane that owns it (entry % 32) sets its slot entry // 32 to 1e30, and
    every lane takes its minimum anew (only the owner's can change)."""
    P, E = tile.shape
    if E > 32 * S:
        raise ValueError(f"{E} entries do not fit 32 lanes of {S} slots")
    dev = tile.device
    slots = torch.full((P, 32 * S), math.inf, dtype=tile.dtype, device=dev)
    slots[:, :E] = tile
    slots = slots.reshape(P, S, 32).transpose(1, 2)     # (P, lane, slot)
    lane = torch.arange(32, device=dev)
    slot = torch.arange(S, device=dev)

    def lane_min(x):
        v = torch.amin(x, dim=2)
        j = torch.argmax((x == v[..., None]).to(torch.uint8), dim=2)
        return v, lane + 32 * j

    lv, le = lane_min(slots)
    idx, val = [], []
    for r in range(k):
        wv = torch.amin(lv, dim=1, keepdim=True)
        we = torch.amin(torch.where(lv == wv, le, 2 ** 31), dim=1,
                        keepdim=True)
        idx.append(we[:, 0])
        val.append(wv[:, 0])
        own = lane == (we & 31)                              # (P, lane)
        hit = own[..., None] & (slot == (we >> 5)[..., None])
        slots = torch.where(hit, _BIG, slots)
        lv, le = lane_min(slots)
    return torch.stack(idx, dim=1), torch.stack(val, dim=1)


def topk_select_slices_plain(tile: torch.Tensor, k: int,
                             slice_entries: int = 512):
    """The selection of K3's cluster kernel (``topk_moves_cluster_kernel``)
    over a (P, E) score tile: (flat index (P, k) int64, score (P, k)).

    The tile splits into slices of ``slice_entries`` (+inf past E).  Each
    slice keeps its legal moves (score < 1e30) in (score, entry) order, at
    most L = min(k, slice_entries) of them, its smallest (score, entry) and
    its lowest entry of score <= 1e30.  The merge takes the smallest head
    of the lists, (score, entry), round by round, until k moves or until
    every list is spent; each later round takes the cell's lowest entry of
    score <= 1e30 with score 1e30, or, where no score is <= 1e30, the
    cell's smallest (score, entry) in round 0 and that entry with 1e30
    after.  The twin's sequential knock-outs give the same: once the legal
    moves run out, the lowest entry equal to 1e30 (a knocked-out pick or an
    original 1e30) wins every round and stays 1e30."""
    P, E = tile.shape
    dev = tile.device
    NS = -(-E // slice_entries)
    L = min(k, slice_entries)
    pad = torch.full((P, NS * slice_entries), math.inf, dtype=tile.dtype,
                     device=dev)
    pad[:, :E] = tile
    sl = pad.reshape(P, NS, slice_entries)
    base = slice_entries * torch.arange(NS, device=dev)[:, None]
    vals, pos = torch.sort(sl, dim=2, stable=True)      # (score, entry)
    ents = pos + base
    lens = torch.clamp((vals < _BIG).sum(2), max=L)     # (P, NS)
    first_v, first_e = vals[..., 0], ents[..., 0]
    entry = torch.arange(NS * slice_entries, device=dev).reshape(NS, -1)
    none = NS * slice_entries
    i0 = torch.where(sl <= _BIG, entry, none).amin(2).amin(1)      # (P,)
    mv = first_v.amin(1, keepdim=True)
    me = torch.where(first_v == mv, first_e, none).amin(1)
    mv = mv[:, 0]
    pad_e = torch.where(i0 < none, i0, me)
    hpos = torch.zeros((P, NS), dtype=torch.long, device=dev)
    spent = torch.zeros(P, dtype=torch.bool, device=dev)
    idx, val = [], []
    for r in range(k):
        live = hpos < lens
        at = torch.clamp(hpos, max=slice_entries - 1)[..., None]
        hv = torch.where(live, vals.gather(2, at)[..., 0], math.inf)
        he = torch.where(live, ents.gather(2, at)[..., 0], none)
        wv = hv.amin(1, keepdim=True)
        we = torch.where(hv == wv, he, none).amin(1, keepdim=True)
        spent = spent | ~(wv[:, 0] < _BIG)
        pv = torch.where((i0 == none) & (r == 0), mv,
                         torch.full_like(mv, _BIG))
        idx.append(torch.where(spent, pad_e, we[:, 0]))
        val.append(torch.where(spent, pv, wv[:, 0]))
        hpos = hpos + ((he == we) & ~spent[:, None]).long()
    return torch.stack(idx, dim=1), torch.stack(val, dim=1)


def attention_plain(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window=None, block_q: int = FLASH_BLOCK_Q,
                    block_k: int = FLASH_BLOCK_K) -> torch.Tensor:
    """Blockwise online-softmax attention, q (..., Tq, hd), k/v (..., Tk,
    hd) -> (..., Tq, hd) in q's dtype.

    The TPU kernel's algorithm (``flash_attention.py:26-79``) on every
    query block at once: q is scaled by 1/sqrt(hd) in f32, masked scores
    are the finite -1e30 (so a fully masked first key block adds exp(0)
    terms that the next real block's alpha = exp(-1e30 - m) wipes), keys
    past Tk are masked, and key blocks past a query block's causal limit
    ``last`` leave its running (m, denom, acc) untouched.
    """
    return _attention_blocks(q, k, v, causal, q_offset, window, block_q,
                             block_k, torch.matmul)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (a 10-bit mantissa) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: half a TF32 unit (bit 12) added
    to the magnitude's bits, the low 13 bits cleared.  Infinities and NaNs
    pass unchanged."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """x = hi + lo (to about 2^-22 |x|): hi = x to TF32, lo = the rest to
    TF32 (x - hi is exact in f32)."""
    x = x.float()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 tensor-core kernel takes it: hi.hi + hi.lo + lo.hi
    over split operands (lo.lo dropped), summed exactly (in f64) and
    rounded to f32 once."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    return (ah @ bh + (ah @ bl + al @ bh)).float()


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass (operands rounded once), summed in f64."""
    return (tf32_round(a).double() @ tf32_round(b).double()).float()


def attention_tf32x3_plain(q, k, v, *, causal: bool = True,
                           q_offset: int = 0, window=None,
                           mm=matmul_tf32x3) -> torch.Tensor:
    """:func:`attention_plain` with both products (S = q k^T and P V) taken
    by ``mm``: the 3xTF32 split (:func:`matmul_tf32x3`) by default, or
    one TF32 pass (:func:`matmul_tf32`), to show that one pass misses K4's
    f32 tolerance where the split meets it."""
    return _attention_blocks(q, k, v, causal, q_offset, window,
                             FLASH_BLOCK_Q, FLASH_BLOCK_K, mm)


def _attention_blocks(q, k, v, causal, q_offset, window, block_q, block_k,
                      mm) -> torch.Tensor:
    """The blockwise online softmax of :func:`attention_plain`, its two
    products taken by ``mm``."""
    *lead, Tq, hd = q.shape
    Tk = k.shape[-2]
    nqb, nkb = -(-Tq // block_q), -(-Tk // block_k)
    dev = q.device
    qf = F.pad(q.float() * (1.0 / math.sqrt(hd)),
               (0, 0, 0, nqb * block_q - Tq))
    qf = qf.reshape(*lead, nqb, block_q, hd)
    kf = F.pad(k.float(), (0, 0, 0, nkb * block_k - Tk))
    vf = F.pad(v.float(), (0, 0, 0, nkb * block_k - Tk))
    q_pos = q_offset + torch.arange(nqb * block_q, device=dev).reshape(
        nqb, block_q, 1)
    if causal:
        last = torch.clamp(
            (q_offset + (torch.arange(nqb, device=dev) + 1) * block_q
             + block_k - 1) // block_k, max=nkb)
    else:
        last = torch.full((nqb,), nkb, device=dev)
    acc = torch.zeros(*lead, nqb, block_q, hd, device=dev)
    m = torch.full((*lead, nqb, block_q), NEG_INF, device=dev)
    denom = torch.zeros_like(m)
    for kb in range(int(last.max())):
        sl = slice(kb * block_k, (kb + 1) * block_k)
        kblk, vblk = kf[..., None, sl, :], vf[..., None, sl, :]
        s = mm(qf, kblk.transpose(-1, -2))         # (..., nqb, bq, bk)
        k_pos = kb * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos < Tk).expand(nqb, block_q, block_k)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        live = (kb < last)[:, None]                 # (nqb, 1)
        denom = torch.where(live, denom * alpha + p.sum(-1), denom)
        acc = torch.where(live[..., None],
                          acc * alpha[..., None] + mm(p, vblk), acc)
        m = torch.where(live, m_new, m)
    out = acc / torch.clamp_min(denom, 1e-30)[..., None]
    return out.reshape(*lead, nqb * block_q, hd)[..., :Tq, :].to(q.dtype)


def chunk_sum_plain(x: torch.Tensor, vec: int) -> torch.Tensor:
    """Row sums of (P, N) in K5's order, (P, 1).

    The row splits into chunks of ``vec`` consecutive elements; lane ``l``
    of the warp adds chunks ``l, l + 32, ...`` in turn and the elements of
    each chunk in order, then five butterfly steps add lane ``l ^ off`` for
    off = 16, 8, 4, 2, 1.  ``vec = 1`` is K5's scalar path.  Past the row's
    end the lanes add +0, which changes no sum of non-negative terms (K5
    sums squares)."""
    P, N = x.shape
    K = -(-N // (32 * vec))
    lanes = F.pad(x, (0, K * 32 * vec - N)).reshape(P, K, 32, vec)
    v = torch.zeros((P, 32), dtype=x.dtype, device=x.device)
    for k in range(K):
        for e in range(vec):
            v = v + lanes[:, k, :, e]
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, idx ^ off]
    return v[:, :1]


def rmsnorm_vec(d: int, dtype: torch.dtype) -> int:
    """K5's chunk width for rows of ``d`` values of ``dtype``: one 16-byte
    vector (8 bf16 or 4 f32 values) when it divides d, else 1 (the scalar
    path)."""
    vec = 16 // dtype.itemsize
    return vec if d % vec == 0 else 1


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in f32,
    cast to x's dtype last (``rmsnorm.py:15-19``).  The sum of squares adds
    in K5's order (:func:`chunk_sum_plain` with K5's chunk width), so it is
    bitwise the kernel's up to ``rsqrt``; the mean is a true division by
    d."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    var = chunk_sum_plain(xf * xf, rmsnorm_vec(d, x.dtype)) / _const(
        xf, float(d))
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype).reshape(x.shape)


# ------------------------------------------------ the recurrences (S1-S3)
def softplus(x):
    """``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def mamba2_recurrence_plain(decay, Bm, Cm, dtx, s0):
    """The Mamba2 time loop (S1): decay (B, T, H), Bm and Cm (B, T, ds),
    dtx (B, T, H, hd) and s0 (B, H, ds, hd), all float32 ->
    (y (B, T, H, hd), s_T).  A step: s = s * decay + B_t * (dt x)_t, then
    y_t = C_t . s, a (1, ds) @ (ds, hd) product a head."""
    s = s0
    ys = []
    for dec, Bt, Ct, ut in zip(decay.unbind(1), Bm.unbind(1), Cm.unbind(1),
                               dtx.unbind(1)):
        s = s * dec[:, :, None, None] + Bt[:, None, :, None] * ut[:, :, None]
        # einsum("bs,bhsd->bhd", C_t, s) as a (1, ds) @ (ds, hd) product
        # a head.
        ys.append(torch.matmul(Ct[:, None, None, :], s))          # (B,H,1,hd)
    y = torch.cat(ys, dim=2).transpose(1, 2)                      # (B,T,H,hd)
    return y, s


def mlstm_recurrence_plain(q, k, v, log_i, log_f, C0, n0, m0):
    """The mLSTM time loop (S2): q, k, v (B, T, H, hd) (q and k already
    scaled), log_i, log_f (B, T, H), C0 (B, H, hd, hd), n0 (B, H, hd), m0
    (B, H), all float32 -> (y = num / den (B, T, H, hd), C, n, m)."""
    C, n, m = C0, n0, m0
    ys = []
    for qt, kt, vt, li, lf in zip(q.unbind(1), k.unbind(1), v.unbind(1),
                                  log_i.unbind(1), log_f.unbind(1)):
        lfm = lf + m
        m_new = torch.maximum(lfm, li)                            # (B,H)
        f_ = torch.exp(lfm - m_new)
        i_ = torch.exp(li - m_new)
        C = C * f_[..., None, None] + i_[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * f_[..., None] + i_[..., None] * kt
        num = torch.matmul(qt[..., None, :], C)[..., 0, :]        # bhk,bhkv
        den = torch.clamp_min(torch.abs((qt * n).sum(-1)), 1.0)
        ys.append(num / den[..., None])
        m = m_new
    return torch.stack(ys, dim=1), C, n, m


def slstm_recurrence_plain(zx, ix, fx, ox, R, c0, n0, m0, h0):
    """The sLSTM time loop (S3): the gates' input terms zx, ix, fx, ox
    (B, T, H, hd), the four recurrences R = [rz | ri | rf | ro] (H, hd,
    4 hd) and c0, n0, m0, h0 (B, H, hd), all float32 -> (y (B, T, H, hd),
    c, n, m, h); y holds h after each step."""
    hd = zx.shape[-1]
    c, n, m, h = c0, n0, m0, h0
    ys = []
    for zt, it, ft, ot in zip(zx.unbind(1), ix.unbind(1), fx.unbind(1),
                              ox.unbind(1)):
        # The four recurrences h @ r (einsum "bhd,hde->bhe") in one product.
        rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", h, R).split(hd, -1)
        z = torch.tanh(zt + rz)
        li = it + ri
        lf = log_sigmoid(ft + rf)
        o = torch.sigmoid(ot + ro)
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        f_, i_ = torch.exp(lfm - m_new), torch.exp(li - m_new)
        c = c * f_ + i_ * z
        n = n * f_ + i_
        h = o * c / torch.clamp_min(torch.abs(n), 1.0)
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), c, n, m, h


# ---------------------------------------------- the recurrences' backward
def max_grad_split(a, b):
    """The shares of the gradient of ``max(a, b)`` that reach ``a`` and
    ``b``, as JAX's autodiff splits them: all to the larger, half each at
    a tie (``torch.clamp_min`` and ``torch.maximum`` give it otherwise)."""
    wa = torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))
    wb = torch.where(b > a, 1.0, torch.where(a == b, 0.5, 0.0))
    return wa, wb


def _den_grad(x):
    """d max(|x|, 1) / dx with JAX's rules: half the gradient at |x| = 1,
    and ``sign(0) = 0`` for ``abs``."""
    return max_grad_split(x.abs(), torch.ones_like(x))[0] * torch.sign(x)


def _zeros_if_none(g, like):
    return torch.zeros_like(like) if g is None else g


def mamba2_recurrence_bwd_plain(decay, Bm, Cm, dtx, s0, dy=None, dsT=None):
    """S1's backward: the operands of :func:`mamba2_recurrence_plain` and
    the upstream gradients of y and s_T (None counts as zeros) -> the
    gradients of (decay, Bm, Cm, dtx, s0).

    The states are recomputed first.  Then for t = T ... 1, with G the
    adjoint of s_t: G += C_t (x) dy_t; dC_t = s_t . dy_t, dB_t = G . u_t
    (both summed over the heads), du_t = B_t . G, d decay_t = <G, s_{t-1}>;
    G *= decay_t.  d s0 is the last G."""
    T = decay.shape[1]
    states = [s0]
    for dec, Bt, ut in zip(decay.unbind(1), Bm.unbind(1), dtx.unbind(1)):
        states.append(states[-1] * dec[:, :, None, None]
                      + Bt[:, None, :, None] * ut[:, :, None])
    dy = _zeros_if_none(dy, dtx)
    G = _zeros_if_none(dsT, s0)
    ddec, dB, dC, du = [], [], [], []
    for t in range(T - 1, -1, -1):
        dyt, Bt, Ct, ut = dy[:, t], Bm[:, t], Cm[:, t], dtx[:, t]
        G = G + Ct[:, None, :, None] * dyt[:, :, None, :]
        dC.append(torch.einsum("bhij,bhj->bi", states[t + 1], dyt))
        dB.append(torch.einsum("bhij,bhj->bi", G, ut))
        du.append(torch.einsum("bi,bhij->bhj", Bt, G))
        ddec.append(torch.einsum("bhij,bhij->bh", G, states[t]))
        G = G * decay[:, t, :, None, None]
    back = lambda xs: torch.stack(xs[::-1], dim=1)  # noqa: E731
    return back(ddec), back(dB), back(dC), back(du), G


def mlstm_recurrence_bwd_plain(q, k, v, log_i, log_f, C0, n0, m0, y,
                               dy=None, dC=None, dn=None, dm=None):
    """S2's backward: the operands of :func:`mlstm_recurrence_plain`, its
    y, and the upstream gradients of (y, C, n, m) (None counts as zeros)
    -> the gradients of (q, k, v, log_i, log_f, C0, n0, m0).

    The states, gates and denominators are recomputed first.  A reverse
    step, with G_C, G_n, G_m the adjoints of C_t, n_t, m_t: d num = dy /
    den, d den = -<dy, y> / den, through max(|q . n|, 1) to q . n; G_C +=
    q (x) d num, G_n += q d(q . n); dq = C_t d num + n_t d(q . n); dv =
    i k . G_C, dk = i (G_C v + G_n); d i = <k . G_C, v> + <G_n, k>, d f =
    <G_C, C_{t-1}> + <G_n, n_{t-1}>; G_C, G_n *= f; then the stabiliser
    m_t = max(log_f + m_{t-1}, log_i), f = exp(log_f + m_{t-1} - m_t),
    i = exp(log_i - m_t) gives d log_i, d log_f and G_m."""
    C, n, m = C0, n0, m0
    Cs, ns, gates = [C0], [n0], []
    for kt, vt, qt, li, lf in zip(k.unbind(1), v.unbind(1), q.unbind(1),
                                  log_i.unbind(1), log_f.unbind(1)):
        lfm = lf + m
        m_new = torch.maximum(lfm, li)
        f_ = torch.exp(lfm - m_new)
        i_ = torch.exp(li - m_new)
        C = C * f_[..., None, None] + i_[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * f_[..., None] + i_[..., None] * kt
        qn = (qt * n).sum(-1)
        gates.append((lfm, li, f_, i_, qn, torch.clamp_min(qn.abs(), 1.0)))
        Cs.append(C)
        ns.append(n)
        m = m_new
    dy = _zeros_if_none(dy, q)
    GC, Gn, Gm = (_zeros_if_none(dC, C0), _zeros_if_none(dn, n0),
                  _zeros_if_none(dm, m0))
    dq, dk, dv, dli, dlf = [], [], [], [], []
    for t in range(q.shape[1] - 1, -1, -1):
        qt, kt, vt, dyt = q[:, t], k[:, t], v[:, t], dy[:, t]
        lfm, li, f_, i_, qn, den = gates[t]
        dnum = dyt / den[..., None]
        dqn = -(dyt * y[:, t]).sum(-1) / den * _den_grad(qn)
        GC = GC + qt[..., :, None] * dnum[..., None, :]
        Gn = Gn + qt * dqn[..., None]
        dq.append(torch.matmul(Cs[t + 1], dnum[..., None])[..., 0]
                  + ns[t + 1] * dqn[..., None])
        GCv = torch.matmul(kt[..., None, :], GC)[..., 0, :]     # k . G_C
        GCk = torch.matmul(GC, vt[..., None])[..., 0]           # G_C v
        dv.append(i_[..., None] * GCv)
        dk.append(i_[..., None] * (GCk + Gn))
        d_i = (GCv * vt).sum(-1) + (Gn * kt).sum(-1)
        d_f = torch.einsum("bhkv,bhkv->bh", GC, Cs[t]) + (Gn * ns[t]).sum(-1)
        GC = GC * f_[..., None, None]
        Gn = Gn * f_[..., None]
        a, c = d_f * f_, d_i * i_       # d(lfm - m_t), d(li - m_t)
        dmn = Gm - a - c
        wl, wi = max_grad_split(lfm, li)
        Gm = a + dmn * wl               # d lfm: d log_f_t and d m_{t-1}
        dlf.append(Gm)
        dli.append(c + dmn * wi)
    back = lambda xs: torch.stack(xs[::-1], dim=1)  # noqa: E731
    return (back(dq), back(dk), back(dv), back(dli), back(dlf), GC, Gn, Gm)


def slstm_recurrence_bwd_plain(zx, ix, fx, ox, R, c0, n0, m0, h0, y,
                               dy=None, dc=None, dn=None, dm=None, dh=None):
    """S3's backward: the operands of :func:`slstm_recurrence_plain`, its
    y (h_{t-1} is y's step t - 1, or h0), and the upstream gradients of
    (y, c, n, m, h) (None counts as zeros) -> the gradients of (zx, ix,
    fx, ox, R, c0, n0, m0, h0).

    The pre-activations and states are recomputed first.  A reverse step,
    with G_c, G_n, G_m, G_h the adjoints of c_t, n_t, m_t, h_t (G_h plus
    dy_t): through h = o c / max(|n|, 1), c = c f + i z, n = n f + i and
    the stabiliser to the four pre-activations' adjoints dpre_t (B, H,
    4 hd); dR += h_{t-1} (x) dpre_t, G_h = dpre_t . R^T."""
    hd = zx.shape[-1]
    c, n, m = c0, n0, m0
    saved = []
    for t, (zt, it, ft, ot) in enumerate(zip(zx.unbind(1), ix.unbind(1),
                                             fx.unbind(1), ox.unbind(1))):
        hp = h0 if t == 0 else y[:, t - 1]
        rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", hp, R).split(hd, -1)
        zp, li, fp, op = zt + rz, it + ri, ft + rf, ot + ro
        lfm = log_sigmoid(fp) + m
        m_new = torch.maximum(lfm, li)
        f_, i_ = torch.exp(lfm - m_new), torch.exp(li - m_new)
        z = torch.tanh(zp)
        c_new = c * f_ + i_ * z
        n_new = n * f_ + i_
        saved.append((hp, z, li, fp, torch.sigmoid(op), lfm, f_, i_, c, n,
                      c_new, n_new))
        c, n, m = c_new, n_new, m_new
    dy = _zeros_if_none(dy, zx)
    Gc, Gn, Gm, Gh = (_zeros_if_none(g, x) for g, x in
                      ((dc, c0), (dn, n0), (dm, m0), (dh, h0)))
    dR = torch.zeros_like(R)
    dpres = []
    for t in range(zx.shape[1] - 1, -1, -1):
        hp, z, li, fp, o, lfm, f_, i_, cp, np_, c, n = saved[t]
        g = dy[:, t] + Gh
        den = torch.clamp_min(n.abs(), 1.0)
        x = o * c
        dx = g / den                     # h = x / den
        Gc = Gc + dx * o
        Gn = Gn + (-g * x) / (den * den) * _den_grad(n)
        d_f = Gc * cp + Gn * np_
        d_i = Gc * z + Gn
        dz = Gc * i_
        Gc = Gc * f_
        Gn = Gn * f_
        a, cc = d_f * f_, d_i * i_
        dmn = Gm - a - cc
        wl, wi = max_grad_split(lfm, li)
        Gm = a + dmn * wl                # d lfm: d log_sigmoid and d m_{t-1}
        dpre = torch.cat([dz * (1 - z * z), cc + dmn * wi,
                          Gm * torch.sigmoid(-fp),
                          dx * c * o * (1 - o)], dim=-1)      # (B, H, 4 hd)
        dR = dR + torch.einsum("bhd,bhe->hde", hp, dpre)
        Gh = torch.einsum("bhe,hde->bhd", dpre, R)
        dpres.append(dpre)
    dpre = torch.stack(dpres[::-1], dim=1)
    dzx, dix, dfx, dox = dpre.split(hd, -1)
    return (dzx, dix, dfx, dox, dR, Gc, Gn, Gm, Gh)


# ------------------------------------- S1 and S1b in the chunked SSD form
# Time steps a chunk of the chunked S1 and S1b kernels: the wrappers pass it
# to csrc/ssd_chunked.cu, whose entries refuse any L but their kL.
S1_CHUNK = 32


def ssd_segments(dec: torch.Tensor):
    """The decay products of a chunk, from its decays dec (..., L) (a tail
    chunk padded with ones), as running products in linear space (a decay
    may be exactly 0, so no log-space sums and no division):

    * seg (..., L, L): seg[t, s] = dec_{s+1} ... dec_t for s <= t (1 on the
      diagonal), 0 above it, column s built down from its diagonal as
      seg[t, s] = seg[t - 1, s] * dec_t;
    * p (..., L): p_t = p_{t-1} * dec_t from p_{-1} = 1 (the decay from the
      chunk's start state to step t);
    * w (..., L): w_s = seg[L - 1, s] (from step s to the chunk's end);
    * pm (..., L): pm_r = p_{r-1}, pm_0 = 1."""
    L = dec.shape[-1]
    s = torch.arange(L, device=dec.device)
    rows, row = [], torch.zeros_like(dec)
    for t in range(L):
        row = torch.where(s < t, row * dec[..., t:t + 1],
                          (s == t).to(dec.dtype))
        rows.append(row)
    seg = torch.stack(rows, dim=-2)
    ps, p = [], torch.ones_like(dec[..., 0])
    for t in range(L):
        p = p * dec[..., t]
        ps.append(p)
    p = torch.stack(ps, dim=-1)
    pm = torch.cat([torch.ones_like(p[..., :1]), p[..., :-1]], dim=-1)
    return seg, p, seg[..., L - 1, :], pm


def _ssd_chunks(decay, Bm, Cm, dtx, L):
    """The operands cut into chunks of L steps, the tail padded (decay with
    ones, the rest with zeros): dec (B, H, nC, L), Bc and Cc (B, 1, nC, L,
    ds), U (B, H, nC, L, hd); and n, the real steps of the last chunk."""
    B, T, H, hd = dtx.shape
    nC = -(-T // L)
    pad = nC * L - T
    dec = F.pad(decay, (0, 0, 0, pad), value=1.0)
    dec = dec.reshape(B, nC, L, H).permute(0, 3, 1, 2)
    Bc, Cc = (F.pad(x, (0, 0, 0, pad)).reshape(B, 1, nC, L, -1)
              for x in (Bm, Cm))
    U = F.pad(dtx, (0, 0, 0, 0, 0, pad)).reshape(B, nC, L, H, hd)
    return dec, Bc, Cc, U.permute(0, 3, 1, 2, 4), L - pad


def _unchunk(x, T):
    """(B, H, nC, L, k) -> (B, T, H, k); (B, H, nC, L) -> (B, T, H)."""
    B, H, nC, L = x.shape[:4]
    x = x.reshape(B, H, nC * L, *x.shape[4:])[:, :, :T]
    return x.transpose(1, 2)


def mamba2_chunked_plain(decay, Bm, Cm, dtx, s0, *, L: int = S1_CHUNK,
                         mm=matmul_tf32x3, starts: bool = False):
    """S1 in the chunked SSD form, as the chunked kernel computes it: the
    operands of :func:`mamba2_recurrence_plain` -> (y, s_T), and with
    ``starts`` also every chunk's start state (B, H, nC, ds, hd), what the
    kernel's saving variant writes for S1b.

    Within a chunk with start state S, with seg, p, w of
    :func:`ssd_segments`: G = C B^T (one (L, L) product a batch row, shared
    by the heads), Y = (G * seg) U + diag(p) C S (one product over the
    concatenated depth L + ds), S_next = p_{L-1} S + B^T diag(w) U.  The
    products are taken by ``mm``: three TF32 passes over split operands
    (:func:`matmul_tf32x3`, the kernel's precision) by default, one pass
    (:func:`matmul_tf32`) or ``torch.matmul``."""
    B, T, H, hd = dtx.shape
    dec, Bc, Cc, U, _ = _ssd_chunks(decay, Bm, Cm, dtx, L)
    seg, p, w, _ = ssd_segments(dec)
    G = mm(Cc, Bc.transpose(-1, -2))                  # (B, 1, nC, L, L)
    M = G * seg
    S, ys, saved = s0, [], []
    for c in range(dec.shape[2]):
        saved.append(S)
        Cp = p[:, :, c, :, None] * Cc[:, :, c]
        ys.append(mm(torch.cat([M[:, :, c], Cp], -1),
                     torch.cat([U[:, :, c], S], -2)))
        S = (p[:, :, c, L - 1, None, None] * S
             + mm(Bc[:, :, c].transpose(-1, -2), w[:, :, c, :, None]
                  * U[:, :, c]))
    y = _unchunk(torch.stack(ys, 2), T)
    if starts:
        return y, S, torch.stack(saved, 2)
    return y, S


def mamba2_chunked_bwd_plain(decay, Bm, Cm, dtx, s0, dy=None, dsT=None, *,
                             L: int = S1_CHUNK, mm=matmul_tf32x3):
    """S1b in the chunked SSD form, as the chunked backward kernel computes
    it: the operands and upstream gradients of
    :func:`mamba2_recurrence_bwd_plain` -> the gradients of (decay, Bm, Cm,
    dtx, s0).

    The chunk start states S_c come from the forward (:func:`
    mamba2_chunked_plain` with ``starts``).  The chunks are walked last
    first, with A the adjoint of the chunk's end state (dsT for the last),
    G = C B^T and D = dY U^T:

    * dU = (G * seg)^T dY + diag(w) B A;
    * dB = (D * seg)^T C + diag(w) U A^T; dC = (D * seg) B + diag(p) dY S^T
      (per head; summed over the heads last);
    * d decay_r = <A_r, s_{r-1}>, A_r the adjoint of the state after step
      r, without dividing by a decay: with E = G * D, q_t = <C_t, (dY
      S^T)_t>, v_s = <u_s, (B A)_s>, and <A, S> added to E's last row (v)
      and q's last entry, F = E Sg^T + q pm^T, Sg[r, s] = seg[r - 1, s]
      (the term that skips dec_r's own factor), and d decay_r = sum_t
      seg[t, r] F[t, r];
    * the previous chunk's A = p_{L-1} A + C^T diag(p) dY; d s0 is the A
      that reaches the first chunk."""
    B, T, H, hd = dtx.shape
    dy = _zeros_if_none(dy, dtx)
    A = _zeros_if_none(dsT, s0)
    starts = mamba2_chunked_plain(decay, Bm, Cm, dtx, s0, L=L, mm=mm,
                                  starts=True)[2]
    dec, Bc, Cc, U, _ = _ssd_chunks(decay, Bm, Cm, dtx, L)
    dY = _ssd_chunks(decay, Bm, Cm, dy, L)[3]
    seg, p, w, pm = ssd_segments(dec)
    nC = dec.shape[2]
    dU, dBh, dCh, ddec = [None] * nC, [None] * nC, [None] * nC, [None] * nC
    for c in range(nC - 1, -1, -1):
        dU[c], dBh[c], dCh[c], ddec[c], A = _ssd_chunk_bwd(
            starts[:, :, c], A, Cc[:, :, c], Bc[:, :, c], U[:, :, c],
            dY[:, :, c], seg[:, :, c], p[:, :, c], w[:, :, c], pm[:, :, c],
            mm)
    stack = lambda xs: torch.stack(xs, 2)  # noqa: E731
    return (_unchunk(stack(ddec), T), _unchunk(stack(dBh), T).sum(2),
            _unchunk(stack(dCh), T).sum(2), _unchunk(stack(dU), T), A)


def _ssd_chunk_bwd(S, A, Cc, Bc, U, dY, sg, p, w, pm, mm):
    """One chunk of the chunked SSD backward (the formulas of
    :func:`mamba2_chunked_bwd_plain`): its start state S (..., ds, hd), the
    adjoint A of its end state, C and B (..., L, ds; Mamba2's shared by the
    heads), U and dY (..., L, hd), and its segment products -> (dU, dB,
    dC, d decay, the adjoint of its start state); dB and dC per head."""
    L = sg.shape[-1]
    p_, w_ = p[..., None], w[..., None]
    G = mm(Cc, Bc.transpose(-1, -2))
    D = mm(dY, U.transpose(-1, -2))
    Md = D * sg
    BA = mm(Bc, A)
    dU = mm((G * sg).transpose(-1, -2), dY) + w_ * BA
    dB = mm(torch.cat([Md.transpose(-1, -2), w_ * U], -1),
            torch.cat([Cc.expand(A.shape[:-2] + Cc.shape[-2:]),
                       A.transpose(-1, -2)], -2))
    dYS = mm(dY, S.transpose(-1, -2))
    dC = mm(Md, Bc) + p_ * dYS
    E = G * D
    q = (Cc * dYS).sum(-1)
    v = (U * BA).sum(-1)
    AS = (A * S).sum((-1, -2))
    E = torch.cat([E[..., :-1, :], E[..., -1:, :] + v[..., None, :]], -2)
    q = torch.cat([q[..., :-1], q[..., -1:] + AS[..., None]], -1)
    Sg = torch.cat([torch.zeros_like(sg[..., :1, :]), sg[..., :-1, :]], -2)
    Fm = mm(E, Sg.transpose(-1, -2)) + q[..., :, None] * pm[..., None, :]
    ddec = (sg * Fm).sum(-2)
    A = p[..., L - 1, None, None] * A + mm(Cc.transpose(-1, -2), p_ * dY)
    return dU, dB, dC, ddec, A


# ------------------------------------------------ S2b in the chunked form
# Time steps a chunk of the chunked S2b kernel (csrc/mlstm_chunked.cu): a
# multiple of the saving forward's checkpoint interval (S2B_CKPT, 16); 32
# beat 16 (chip_smoke.py's phase s (g), NVIDIA H100 80GB HBM3, 700 W: the
# op 2.367 against 2.564 ms at xlstm-125m's (4, 1024, 4, 192)).
S2_CHUNK = 32


def mlstm_gates_plain(log_i, log_f, m0):
    """The mLSTM stabiliser step by step, as the forward computes it:
    log_i, log_f (B, T, H), m0 (B, H) -> (lfm, m, f, i), each (B, T, H):
    lfm_t = log_f_t + m_{t-1}, m_t = max(lfm_t, log_i_t), f_t =
    exp(lfm_t - m_t) and i_t = exp(log_i_t - m_t), both in [0, 1]."""
    m, out = m0, []
    for li, lf in zip(log_i.unbind(1), log_f.unbind(1)):
        lfm = lf + m
        m = torch.maximum(lfm, li)
        out.append((lfm, m, torch.exp(lfm - m), torch.exp(li - m)))
    return tuple(torch.stack(x, 1) for x in zip(*out))


def mlstm_gates_bwd_plain(lfm, log_i, f, i, d_f, d_i, dm=None):
    """The stabiliser's backward: the gates of :func:`mlstm_gates_plain`
    and the gradients of f and i (B, T, H) -> (d log_i, d log_f, d m0),
    the reverse loop of :func:`mlstm_recurrence_bwd_plain`'s last lines."""
    Gm = _zeros_if_none(dm, lfm[:, 0])
    dli, dlf = [], []
    for t in range(lfm.shape[1] - 1, -1, -1):
        a, c = d_f[:, t] * f[:, t], d_i[:, t] * i[:, t]
        dmn = Gm - a - c
        wl, wi = max_grad_split(lfm[:, t], log_i[:, t])
        Gm = a + dmn * wl
        dlf.append(Gm)
        dli.append(c + dmn * wi)
    back = lambda xs: torch.stack(xs[::-1], dim=1)  # noqa: E731
    return back(dli), back(dlf), Gm


def _time_chunks(x, L, fill=0.0):
    """(B, T, H, ...) -> (B, H, nC, L, ...), the tail padded with fill."""
    B, T, H = x.shape[:3]
    nC = -(-T // L)
    pad = [0, 0] * (x.dim() - 3) + [0, 0, 0, nC * L - T]
    x = F.pad(x, pad, value=fill).reshape(B, nC, L, H, *x.shape[3:])
    return x.transpose(1, 3).transpose(2, 3)


def mlstm_chunked_plain(q, k, v, log_i, log_f, C0, n0, m0, *,
                        L: int = S2_CHUNK, mm=matmul_tf32x3,
                        starts: bool = False):
    """S2 in the chunked form, as the chunked forward kernel computes it:
    the operands of :func:`mlstm_recurrence_plain` -> (y, C, n, m), and
    with ``starts`` also C, n and m before every chunk ((B, H, nC, hd,
    hd), (B, H, nC, hd), (B, H, nC)), what the kernel's saving variant
    writes for S2b.

    Given the stabiliser (:func:`mlstm_gates_plain`, step by step), a
    chunk with start state (S, n_s) and seg, p, w of :func:`ssd_segments`
    over its forget gates f: G = q k^T, M = G * seg, U = i v; the
    numerator (M U + diag(p) q S: one product over the concatenated depth
    L + hd, as Mamba2's read-out), q . n_t = sum_s M[t, s] i_s + p_t q_t
    . n_s (the chunk form of the denominator's dot product, on the CUDA
    cores), y = num / max(|q . n|, 1); the next chunk's S = p_{L-1} S +
    k^T diag(w) U and n_s = p_{L-1} n_s + sum_s w_s i_s k_s.  The
    products are taken by ``mm`` (three TF32 passes over split operands by
    default, the kernel's precision); the rest in float32."""
    B, T, H, hd = q.shape
    lfm, m, f, i = mlstm_gates_plain(log_i, log_f, m0)
    Qc, Kc, Vc = (_time_chunks(x, L) for x in (q, k, v))
    dec, ic = _time_chunks(f, L, 1.0), _time_chunks(i, L)
    seg, p, w, _ = ssd_segments(dec)
    M = mm(Qc, Kc.transpose(-1, -2)) * seg
    U = ic[..., None] * Vc
    nC = dec.shape[2]
    m_starts = torch.cat([m0[:, None], m[:, L - 1::L]], 1)[:, :nC]
    C, n, ys, saved = C0, n0, [], []
    for c in range(nC):
        saved.append((C, n))
        Q_, M_, p_, i_ = Qc[:, :, c], M[:, :, c], p[:, :, c], ic[:, :, c]
        qn = (M_ * i_[..., None, :]).sum(-1) + p_ * (
            Q_ * n[..., None, :]).sum(-1)
        num = mm(torch.cat([M_, p_[..., None] * Q_], -1),
                 torch.cat([U[:, :, c], C], -2))
        ys.append(num / torch.clamp_min(qn.abs(), 1.0)[..., None])
        pL, wi = p_[..., L - 1], w[:, :, c] * i_
        C = pL[..., None, None] * C + mm(
            Kc[:, :, c].transpose(-1, -2), w[:, :, c, :, None] * U[:, :, c])
        n = pL[..., None] * n + (wi[..., None] * Kc[:, :, c]).sum(-2)
    y = _unchunk(torch.stack(ys, 2), T)
    out = (y, C, n, m[:, -1])
    if starts:
        out += (torch.stack([s[0] for s in saved], 2),
                torch.stack([s[1] for s in saved], 2),
                m_starts.transpose(1, 2))
    return out


def mlstm_chunked_bwd_plain(q, k, v, log_i, log_f, C0, n0, m0, y, dy=None,
                            dC=None, dn=None, dm=None, *, L: int = S2_CHUNK,
                            mm=matmul_tf32x3, starts=None):
    """S2b in the chunked form, as the chunked kernel computes it: the
    operands and upstream gradients of :func:`mlstm_recurrence_bwd_plain`
    -> the gradients of (q, k, v, log_i, log_f, C0, n0, m0).

    Given the stabiliser (:func:`mlstm_gates_plain`), C_t = f_t C_{t-1} +
    k_t (i_t v_t)^T and n_t = f_t n_{t-1} + i_t k_t are one Mamba2
    recurrence with an extra value column for n: decay f, B = k, C = q, u
    = [i v | i], state [C | n], read-out [num | q . n].  The chunk start
    states are ``starts`` (C and n before every chunk, as
    :func:`mlstm_chunked_plain` returns them), by default the chunked
    forward's own: what the chunked forward kernel's saving variant
    writes.  A chunk's q . n, and so den = max(|q . n|,
    1), comes from the chunk form (q . n_t = sum_s (G * seg)[t, s] i_s +
    p_t q_t . n_start); the read-out's adjoint is [dy / den | d(q . n)],
    d(q . n) = -<dy, y> / den through max(|.|, 1).  Each chunk then takes
    Mamba2's chunked backward (:func:`_ssd_chunk_bwd`): dq = dC, dk = dB,
    d f = d decay, dv = i du[:hd], d i = <du[:hd], v> + du[hd]; the
    stabiliser's backward (:func:`mlstm_gates_bwd_plain`) gives d log_i,
    d log_f and d m0."""
    B, T, H, hd = q.shape
    dy = _zeros_if_none(dy, q)
    lfm, m, f, i = mlstm_gates_plain(log_i, log_f, m0)
    if starts is None:
        starts = mlstm_chunked_plain(q, k, v, log_i, log_f, C0, n0, m0, L=L,
                                     mm=mm, starts=True)[4:6]
    starts = [torch.cat([Cs, ns[..., None]], -1)
              for Cs, ns in zip(starts[0].unbind(2), starts[1].unbind(2))]
    U = torch.cat([i[..., None] * v, i[..., None]], -1)
    Qc, Kc, Uc, dyc, yc = (_time_chunks(x, L) for x in (q, k, U, dy, y))
    dec = _time_chunks(f, L, 1.0)
    ic = _time_chunks(i, L)
    seg, p, w, pm = ssd_segments(dec)
    A = torch.cat([_zeros_if_none(dC, C0), _zeros_if_none(dn, n0)[..., None]],
                  -1)
    nC = dec.shape[2]
    dU, dK, dQ, dF = [None] * nC, [None] * nC, [None] * nC, [None] * nC
    for c in range(nC - 1, -1, -1):
        S, Q_, K_ = starts[c], Qc[:, :, c], Kc[:, :, c]
        sg, p_ = seg[:, :, c], p[:, :, c]
        G = mm(Q_, K_.transpose(-1, -2))
        qn = ((G * sg) * ic[:, :, c, None, :]).sum(-1) + p_ * (
            Q_ * S[..., hd][..., None, :]).sum(-1)
        den = torch.clamp_min(qn.abs(), 1.0)
        dqn = -(dyc[:, :, c] * yc[:, :, c]).sum(-1) / den * _den_grad(qn)
        dY = torch.cat([dyc[:, :, c] / den[..., None], dqn[..., None]], -1)
        dU[c], dK[c], dQ[c], dF[c], A = _ssd_chunk_bwd(
            S, A, Q_, K_, Uc[:, :, c], dY, sg, p_, w[:, :, c], pm[:, :, c],
            mm)
    stack = lambda xs: _unchunk(torch.stack(xs, 2), T)  # noqa: E731
    dU = stack(dU)
    dv = i[..., None] * dU[..., :hd]
    d_i = (dU[..., :hd] * v).sum(-1) + dU[..., hd]
    dli, dlf, dm0 = mlstm_gates_bwd_plain(lfm, log_i, f, i, stack(dF), d_i,
                                          dm)
    return (stack(dQ), stack(dK), dv, dli, dlf, A[..., :hd], A[..., hd],
            dm0)
