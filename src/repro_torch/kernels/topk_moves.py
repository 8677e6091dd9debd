"""Launchers for K3 (``csrc/topk_moves.cu``) on CUDA tensors.

K3 replaces ``repro/kernels/topk_moves.py`` ``_topk_kernel``: the engine's
move nominator (DESIGN.md D9).  For every cell it scores each single-user
move by the airtime it adds at the equal-split reference bandwidth and
keeps the k cheapest, ties to the lowest row-major (user, edge) index;
entries with score >= 1e29 are padding (fewer than k legal moves).

Three kernels compute it bit for bit; :func:`topk_route` picks one of two
from the cell's shape: ``"warp"`` (``topk_moves_warp_kernel<S>``: one warp
a cell, the score tile in registers, S entries a lane, no block barrier)
up to N*M = 512, and ``"cluster"`` (``topk_moves_cluster_kernel``: one cell a
thread block cluster of up to 8 blocks of 8 warps, each warp's slices of
512 entries in registers, one merge) above it.  The ``"block"``
(``topk_moves_kernel``: one block a cell, the tile in shared memory) runs
only when forced, as the yardstick.  All are bound by the launch and one
cell's dependent chain, not by bytes (see the source note).  The launcher
checks dtype, shape, contiguity, device and the kernel's cap once,
allocates the three outputs as one buffer, launches on the current stream
and raises on a launch error; it never synchronizes.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _call, _stream

# S instances of the warp kernel: 9 for the engine's 56 x 5 cells (smaller
# cells take it too, with +inf padding slots), 16 up to the cap.  The warp
# kernel runs one cell a block: on an H100, 2 and 4 cells a block ran the
# planning shape within 1% of one and 8 ran 14% slower (PERF.md).
WARP_SLOTS = (9, 16)
WARP_MAX_ENTRIES = 32 * WARP_SLOTS[-1]   # 512 moves a cell
SMEM_MAX = 232_448                       # 227 KB of shared memory a block
# The cluster kernel (csrc/topk_moves.cu, `topk_cluster`): slices of 512
# entries, blocks of 8 warps, at most 8 blocks a cluster, the first 4 moves
# of every slice's list in the merging block, 16 static bytes a block.
SLICE_ENTRIES = 512
CLUSTER_WARPS = 8
CLUSTER_BLOCKS = 8
HEAD_CACHE = 4


def cluster_shape(N: int, M: int, k: int) -> tuple[int, int, int, int]:
    """The cluster kernel's (slices, blocks a cluster, passes, list length)
    for cells of N x M and k moves."""
    NS = math.ceil(N * M / SLICE_ENTRIES)
    C = min(math.ceil(NS / CLUSTER_WARPS), CLUSTER_BLOCKS)
    passes = math.ceil(NS / (C * CLUSTER_WARPS))
    return NS, C, passes, min(k, SLICE_ENTRIES)


def cluster_smem_bytes(N: int, M: int, k: int) -> int:
    """The cluster kernel's shared bytes a block, as its launcher counts
    them: each warp's slice lists (8-byte moves), the merge's head cache and
    current heads, the edge counts, the list lengths and positions, and 16
    static bytes."""
    NS, _, passes, L = cluster_shape(N, M, k)
    return (8 * (passes * CLUSTER_WARPS * L + NS * (HEAD_CACHE + 1))
            + 4 * (M + passes * CLUSTER_WARPS + 2 * NS) + 16)


def block_smem_bytes(N: int, M: int) -> int:
    """The block kernel's shared bytes: the cell's (N*M + M) floats and
    its 36 static bytes (the active count and four warps' minima)."""
    return (N * M + M) * 4 + 36


def _check_block(N: int, M: int) -> None:
    smem = block_smem_bytes(N, M)
    if smem > SMEM_MAX:
        raise ValueError(f"K3's block kernel holds a cell's (N*M + M) "
                         f"floats and 36 static bytes in shared memory, at "
                         f"most {SMEM_MAX} bytes (227 KB); N = {N}, M = {M} "
                         f"need {smem}")


def _check_cluster(N: int, M: int, k: int) -> None:
    smem = cluster_smem_bytes(N, M, k)
    if smem > SMEM_MAX:
        raise ValueError(f"K3's cluster kernel holds a block's slice lists, "
                         f"the merge's heads and the M edge counts in "
                         f"shared memory, at most {SMEM_MAX} bytes (227 "
                         f"KB); N = {N}, M = {M}, k = {k} need {smem}")


def topk_route(N: int, M: int, k: int) -> str:
    """K3's kernel for cells of N users and M edges: ``"warp"`` when the
    N*M moves fit 16 registers a lane (N*M <= 512), else ``"cluster"``.
    Raises ValueError, before any launch, when the cluster kernel's shared
    memory (:func:`cluster_smem_bytes`) exceeds 227 KB: past 196,608
    moves a cell at k >= 512, about 1.8 million at k = 16.  A pure
    function: no card."""
    if N < 1 or M < 1 or k < 1:
        raise ValueError(f"K3 takes N, M, k >= 1, got {N}, {M}, {k}")
    if N * M <= WARP_MAX_ENTRIES:
        return "warp"
    _check_cluster(N, M, k)
    return "cluster"


def warp_slots(N: int, M: int) -> int:
    """The warp kernel's entries a lane for N*M moves: the smallest instance
    in ``WARP_SLOTS`` with 32 S >= N*M."""
    for S in WARP_SLOTS:
        if N * M <= 32 * S:
            return S
    raise ValueError(f"the warp K3 takes N*M <= {WARP_MAX_ENTRIES}, got "
                     f"{N} x {M}")


def topk_moves_cuda(gain: torch.Tensor, H: torch.Tensor, p_max: torch.Tensor,
                    assign: torch.Tensor, mask: torch.Tensor,
                    N0: torch.Tensor, B: torch.Tensor, k: int,
                    _route: str | None = None):
    """K3 on gain (P, N, M) f32; H, p_max (P, N) f32; assign (P, N) i32;
    mask (P, N) bool; N0, B (P,) f32, all contiguous on one card.  Returns
    (user, dst, score) (P, k) and the route that ran.

    ``_route`` overrides :func:`topk_route` ("warp", "cluster" or "block";
    each raises past its cap), for timing the kernels on the same
    tensors."""
    P, N, M = gain.shape
    f32 = torch.float32
    for name, x, shape, dtype in (
            ("gain", gain, (P, N, M), f32), ("H", H, (P, N), f32),
            ("p_max", p_max, (P, N), f32),
            ("assign", assign, (P, N), torch.int32),
            ("mask", mask, (P, N), torch.bool), ("N0", N0, (P,), f32),
            ("B", B, (P,), f32)):
        if x.dtype != dtype or x.shape != shape or not x.is_contiguous():
            raise ValueError(f"K3 takes {name} as a contiguous {dtype} "
                             f"tensor of shape {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    dev = gain.device
    if dev.type != "cuda" or any(x.device != dev for x in
                                 (H, p_max, assign, mask, N0, B)):
        raise ValueError("K3 operands must lie on one CUDA device")
    return _launch(gain, H, p_max, assign, mask, N0, B, k, _route)


@functools.lru_cache(maxsize=None)
def _plan(N: int, M: int, k: int, route: str | None) -> tuple[str, int]:
    """(kernel, slots) for cells of N x M and k moves: ``route`` or
    :func:`topk_route`'s pick, checked against the kernel's limits (slots
    0 for the cluster and block kernels)."""
    route = topk_route(N, M, k) if route is None else route
    if route == "warp":
        return route, warp_slots(N, M)      # raises past the cap
    if route == "cluster":
        _check_cluster(N, M, k)
        return route, 0
    if route == "block":
        _check_block(N, M)
        return route, 0
    raise ValueError(f"no K3 kernel {route!r}")


def _launch(gain, H, p_max, assign, mask, N0, B, k, route=None):
    """The launch alone, on operands the caller has checked (as
    :func:`topk_moves_cuda` and ``ops.topk_move_scores`` do)."""
    P, N, M = gain.shape
    k = int(k)
    if k < 1:
        raise ValueError(f"K3 takes k >= 1, got {k}")
    route, S = _plan(N, M, k, route)
    dev = gain.device
    out = torch.empty((3, P, k), dtype=torch.int32, device=dev)
    base, plane = out.data_ptr(), 4 * P * k
    ptrs = (gain.data_ptr(), H.data_ptr(), p_max.data_ptr(),
            assign.data_ptr(), mask.data_ptr(), N0.data_ptr(), B.data_ptr(),
            base, base + plane, base + 2 * plane)
    lib = build.load()
    if route == "warp":
        err = _call(dev, lib.topk_moves_warp, *ptrs, P, N, M, k, S,
                    _stream(gain))
    else:
        fn = lib.topk_moves_cluster if route == "cluster" else lib.topk_moves
        err = _call(dev, fn, *ptrs, P, N, M, k, _stream(gain))
    build.check(err, f"topk_moves ({route})")
    user, dst, score = out.unbind(0)
    return (user, dst, score.view(torch.float32)), route
