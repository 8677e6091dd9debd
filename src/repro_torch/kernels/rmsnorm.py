"""Launcher for K5 (``csrc/rmsnorm.cu``) on CUDA tensors.

K5 replaces ``repro/kernels/rmsnorm.py`` ``_rmsnorm_kernel``: per row,
``x * rsqrt(mean(x^2) + eps) * scale`` in f32, cast to x's type last.  One
warp per row, 16-byte loads and stores, the row read once; the sum of
squares adds in a fixed order, which the plain twin ``ref.rmsnorm_plain``
repeats.  No model calls it: the models' ``layers.rms_norm`` rounds to x's
type before the scale multiply.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _call, _check, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh copy of it when its base is not 16-byte aligned (the
    kernel's vector loads need it; the copy changes no value or order)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    x, scale = _aligned(x), _aligned(scale)
    out = torch.empty_like(x)
    err = _call(x.device, build.load().rmsnorm, x.data_ptr(),
                scale.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], rows, d,
                float(eps), _stream(x))
    build.check(err, "rmsnorm")
    return out
