"""Launcher for K4 (``csrc/flash_attention.cu``) on CUDA tensors.

K4 replaces ``repro/kernels/flash_attention.py`` ``_flash_kernel``: the
online-softmax attention forward pass with causal masking, a query offset
and a sliding window, f32 statistics, and the output in the input's type.
One block per (batch x head, 64 query rows); K/V tiles of 64 keys staged
in shared memory; q, k, v and the output are addressed in the model layout
(B, T, H, hd) through their strides.  Any hd up to 256, without padding;
the scale is 1/sqrt(hd) of the true hd.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _ptr, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int,
                         window) -> torch.Tensor:
    """K4 on q (B, Tq, H, hd), k/v (B, Tk, H, hd) CUDA tensors of one
    dtype (f32 or bf16), each with a unit head-dim stride.  Returns a new
    contiguous (B, Tq, H, hd) tensor in that dtype."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    for name, x, shape in (("q", q, (B, Tq, H, hd)), ("k", k, (B, Tk, H, hd)),
                           ("v", v, (B, Tk, H, hd))):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != q.device:
            raise ValueError("K4 operands must share one device")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{shape}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a unit head-dim stride")
    if q.dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"K4 takes head dims up to {MAX_HEAD_DIM}, got {hd}")
    if Tk == 0:
        raise ValueError("K4 needs at least one key")
    out = torch.empty((B, Tq, H, hd), dtype=q.dtype, device=q.device)
    strides = [ctypes.c_longlong(x.stride(i))
               for x in (q, k, v, out) for i in (0, 1, 2)]
    with torch.cuda.device(q.device):
        err = build.load().flash_attention(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _DTYPES[q.dtype], B, H,
            Tq, Tk, hd, *strides, int(bool(causal)), int(q_offset),
            int(window is not None), int(window or 0),
            1.0 / math.sqrt(hd), _stream(q))
    build.check(err, "flash_attention")
    return out
