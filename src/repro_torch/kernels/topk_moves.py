"""Launchers for K3 (``csrc/topk_moves.cu``) on CUDA tensors.

K3 replaces ``repro/kernels/topk_moves.py`` ``_topk_kernel``: the engine's
move nominator (DESIGN.md D9).  For every cell it scores each single-user
move by the airtime it adds at the equal-split reference bandwidth and
keeps the k cheapest, ties to the lowest row-major (user, edge) index;
entries with score >= 1e29 are padding (fewer than k legal moves).

Two kernels compute it bit for bit, picked by :func:`topk_route` from the
cell's shape: ``"warp"`` (``topk_moves_warp_kernel<S>``: one warp a cell,
the score tile in registers, S entries a lane, no block barrier) up to
N*M = 512, and ``"block"`` (``topk_moves_kernel``: one block a cell,
the tile in shared memory) above it.  Both are bound by the launch and one
cell's dependent chain, not by bytes (see the source note).  The launcher
checks dtype, shape, contiguity and device once, allocates the three
outputs as one buffer, launches on the current stream and raises on a
launch error; it never synchronizes.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _call, _stream

# S instances of the warp kernel: 9 for the engine's 56 x 5 cells (smaller
# cells take it too, with +inf padding slots), 16 up to the cap.  The warp
# kernel runs one cell a block: on an H100, 2 and 4 cells a block ran the
# planning shape within 1% of one and 8 ran 14% slower (PERF.md).
WARP_SLOTS = (9, 16)
WARP_MAX_ENTRIES = 32 * WARP_SLOTS[-1]   # 512 moves a cell
BLOCK_SMEM_MAX = 232_448                 # 227 KB of shared memory a block


def _check_block(N: int, M: int) -> None:
    smem = (N * M + M) * 4
    if smem > BLOCK_SMEM_MAX:
        raise ValueError(f"K3's block kernel holds a cell's (N*M + M) "
                         f"floats in shared memory, at most {BLOCK_SMEM_MAX} "
                         f"bytes (227 KB); N = {N}, M = {M} need {smem}")


def topk_route(N: int, M: int, k: int) -> str:
    """K3's kernel for cells of N users and M edges: ``"warp"`` when the
    N*M moves fit 16 registers a lane (N*M <= 512), else ``"block"``.  Any
    k >= 1 runs on either.  Raises ValueError when the block kernel's tile,
    (N*M + M) floats, exceeds 227 KB of shared memory.  A pure function: no
    card."""
    if N < 1 or M < 1 or k < 1:
        raise ValueError(f"K3 takes N, M, k >= 1, got {N}, {M}, {k}")
    if N * M <= WARP_MAX_ENTRIES:
        return "warp"
    _check_block(N, M)
    return "block"


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

    ``_route`` overrides :func:`topk_route` ("warp" raises past its cap),
    for timing the two kernels on the same tensors."""
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
def _plan(N: int, M: int, route: str | None) -> tuple[str, int]:
    """(kernel, slots) for cells of N x M: ``route`` or :func:`topk_route`'s
    pick, checked against the kernel's limits (slots 0 for the block
    kernel)."""
    route = topk_route(N, M, 1) if route is None else route
    if route == "warp":
        return route, warp_slots(N, M)      # raises past the cap
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
    route, S = _plan(N, M, route)
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
        err = _call(dev, lib.topk_moves, *ptrs, P, N, M, k, _stream(gain))
    build.check(err, f"topk_moves ({route})")
    user, dst, score = out.unbind(0)
    return (user, dst, score.view(torch.float32)), route
