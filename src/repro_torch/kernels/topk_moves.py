"""Launcher for K3 (``csrc/topk_moves.cu``) on CUDA tensors.

K3 replaces ``repro/kernels/topk_moves.py`` ``_topk_kernel``: the engine's
move nominator (DESIGN.md D9).  For every cell it scores each single-user
move by the airtime it adds at the equal-split reference bandwidth and
keeps the k cheapest, ties to the lowest row-major (user, edge) index;
entries with score >= 1e29 are padding (fewer than k legal moves).  One
block per cell with the score tile in shared memory; bound by launch and
barrier latency at the engine's shapes (see the source note).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _call, _check, _ptr, _stream


def topk_moves_cuda(gain: torch.Tensor, H: torch.Tensor, p_max: torch.Tensor,
                    assign: torch.Tensor, mask: torch.Tensor,
                    N0: torch.Tensor, B: torch.Tensor, k: int):
    """K3 on gain (P, N, M) f32; H, p_max (P, N) f32; assign (P, N) i32;
    mask (P, N) bool; N0, B (P,) f32.  Returns (user, dst, score) (P, k)."""
    P, N, M = gain.shape
    _check("gain", gain, (P, N, M))
    _check("H", H, (P, N))
    _check("p_max", p_max, (P, N))
    _check("assign", assign, (P, N), torch.int32)
    _check("mask", mask, (P, N), torch.bool)
    _check("N0", N0, (P,))
    _check("B", B, (P,))
    dev = gain.device
    if any(x.device != dev for x in (H, p_max, assign, mask, N0, B)):
        raise ValueError("K3 operands must share one device")
    user = torch.empty((P, k), dtype=torch.int32, device=dev)
    dst = torch.empty((P, k), dtype=torch.int32, device=dev)
    score = torch.empty((P, k), dtype=torch.float32, device=dev)
    err = _call(dev, build.load().topk_moves,
                *map(_ptr, (gain, H, p_max, assign, mask, N0, B, user, dst,
                            score)),
                P, N, M, int(k), _stream(gain))
    build.check(err, "topk_moves")
    return user, dst, score
