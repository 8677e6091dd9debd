"""Launcher for K4 (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_sm90_f32.cu`` and ``csrc/flash_attention.cu``) on
CUDA tensors.

K4 replaces ``repro/kernels/flash_attention.py`` ``_flash_kernel``: the
online-softmax attention forward pass with causal masking, a query offset
and a sliding window, f32 statistics, and the output in the input's type.
q, k, v and the output are addressed in the model layout (B, T, H, hd)
through their strides; the scale is 1/sqrt(hd) of the true hd.

Three kernels compute it, and one rule picks among them from the
operands' dtype, head dim, strides and addresses alone (:func:`route`):

* ``flash_attention_sm90`` ("wgmma": bf16 on the tensor cores, wgmma for
  both products, TMA copies through a two-stage K/V ring) takes bf16 with
  0 < hd <= 256 when every stride but the head dim's, of q, k, v and the
  output, is a positive multiple of 16 bytes and every base address is
  16-byte aligned;
* ``flash_attention_sm90_f32`` ("tf32": f32 on the TF32 tensor cores, each
  product as three passes over operands split as hi + lo) takes f32 with
  0 < hd <= 128 under the same 16-byte rule (4 elements);
* ``flash_attention`` ("simt": f32 CUDA cores, any hd up to 256, any
  strides) takes everything else: f32 with hd in (128, 256], and layouts
  TMA does not address.

The choice never depends on a failure: a build or launch error raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sroa_bisect import _call, _stream

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
WGMMA_MAX_HEAD_DIM = 256
TF32_MAX_HEAD_DIM = 128
ROUTES = ("wgmma", "tf32", "simt")


def route(dtype: torch.dtype, hd: int, strides, ptrs) -> str:
    """The routing rule: "wgmma", "tf32" or "simt".

    ``strides`` are the element strides of every axis but the head dim of
    q, k, v and the output; ``ptrs`` their base addresses.  A tensor-core
    kernel takes its dtype (bf16 up to hd 256, f32 up to hd 128) when
    every stride is a positive multiple of 16 bytes (TMA's stride unit)
    and every address is 16-byte aligned; the SIMT kernel takes the rest."""
    tma = (min(strides) > 0 and math.gcd(*strides) * dtype.itemsize % 16 == 0
           and math.gcd(*ptrs) % 16 == 0)
    if tma and dtype == torch.bfloat16 and 0 < hd <= WGMMA_MAX_HEAD_DIM:
        return "wgmma"
    if tma and dtype == torch.float32 and 0 < hd <= TF32_MAX_HEAD_DIM:
        return "tf32"
    return "simt"


def _refuse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise the error that says why K4 does not take these operands."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    for name, x, T in (("q", q, Tq), ("k", k, Tk), ("v", v, Tk)):
        if x.device != q.device or not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, "
                             f"got {x.device}")
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.shape != (B, T, H, hd):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{(B, T, H, hd)}")
        if x.stride(3) != 1:
            raise ValueError(f"{name} must have a unit head-dim stride")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"K4 takes head dims up to {MAX_HEAD_DIM}, got {hd}")
    raise ValueError("K4 needs at least one key")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, q_offset: int, window,
                         _route: str | None = None):
    """K4 on q (B, Tq, H, hd), k/v (B, Tk, H, hd) CUDA tensors of one
    dtype (f32 or bf16), each with a unit head-dim stride.  Returns a new
    contiguous (B, Tq, H, hd) tensor in that dtype, and the route that
    computed it (one of :data:`ROUTES`).

    ``_route`` overrides the rule, for timing the kernels on the same
    tensors: "simt" takes anything, a tensor-core route raises where the
    rule does not pick it."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    dev, dt = q.device, q.dtype
    # One expression on the hot path; _refuse names what failed.
    if not (q.is_cuda and dt in _DTYPES and k.dtype == dt and v.dtype == dt
            and k.shape == v.shape == (B, Tk, H, hd) and Tk > 0
            and 0 < hd <= MAX_HEAD_DIM
            and q.stride(3) == k.stride(3) == v.stride(3) == 1
            and k.device == dev and v.device == dev):
        _refuse(q, k, v)
    out = torch.empty((B, Tq, H, hd), dtype=dt, device=dev)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               Tq * H * hd, H * hd, hd)
    picked = route(dt, hd, strides, ptrs)
    if _route is not None:
        if _route not in ROUTES:
            raise ValueError(f"no K4 route {_route!r}")
        if _route != "simt" and _route != picked:
            raise ValueError(f"the {_route} K4 kernel does not take these "
                             f"operands (the tensor-core kernels take bf16 "
                             f"up to hd {WGMMA_MAX_HEAD_DIM} and f32 up to "
                             f"hd {TF32_MAX_HEAD_DIM} with 16-byte strides "
                             f"and bases)")
        picked = _route
    lib = build.load()
    common = (int(bool(causal)), int(q_offset), int(window is not None),
              int(window or 0), 1.0 / math.sqrt(hd), _stream(q))
    if picked == "simt":
        name = "flash_attention"
        err = _call(dev, lib.flash_attention, *ptrs, _DTYPES[dt], B, H, Tq,
                    Tk, hd, *strides, *common)
    else:
        name = "flash_attention_sm90" + ("_f32" if picked == "tf32" else "")
        err = _call(dev, getattr(lib, name), *ptrs, B, H, Tq, Tk, hd,
                    *strides, *common)
    build.check(err, name)
    return out, picked
