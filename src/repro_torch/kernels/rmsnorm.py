"""Launcher for K5 (``csrc/rmsnorm.cu``) on CUDA tensors.

K5 replaces ``repro/kernels/rmsnorm.py`` ``_rmsnorm_kernel``: per row,
``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast to x's type last.  One
warp per row; the sum of squares adds in a fixed order, which the plain
twin ``ref.rmsnorm_plain`` repeats.  No model calls it: the models'
``layers.rms_norm`` rounds to x's type before the scale multiply.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _check, _ptr, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """K5 on a contiguous (rows, d) CUDA tensor (f32 or bf16) and a
    contiguous (d,) f32 scale.  Returns a new (rows, d) tensor."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (rows, d) tensor")
    rows, d = x.shape
    _check("scale", scale, (d,))
    if scale.device != x.device:
        raise ValueError("K5 operands must share one device")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = build.load().rmsnorm(
            _ptr(x), _ptr(scale), _ptr(out), _DTYPES[x.dtype],
            ctypes.c_longlong(rows), d, float(eps), _stream(x))
    build.check(err, "rmsnorm")
    return out
