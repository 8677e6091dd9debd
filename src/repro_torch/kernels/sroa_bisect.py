"""Launchers for K1 and K2 (``csrc/sroa_bisect.cu``) on CUDA tensors.

* K1 ``sroa_invert_rate`` replaces ``repro/kernels/sroa_bisect.py``
  ``_bisect_kernel`` and ``_bisect_kernel_vec`` (the Lemma-1 bandwidth
  inversion): one thread per element; a stride-0 ``b_max`` covers the
  scalar-budget form, a per-element one the fleet-batched form.
* K2 ``sroa_solve`` replaces ``_solve_kernel``: the whole Algorithm 2-4
  nest for P problems, one warp per problem.

Both are bound by the latency of their dependent bisection chains, not by
memory: see the source notes in ``csrc/sroa_bisect.cu``.  These launchers
check device, dtype, contiguity and shape, allocate the outputs, launch on
the current stream and raise on a launch error; they never synchronize.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _check(name: str, x: torch.Tensor, shape: tuple, dtype=torch.float32):
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x: torch.Tensor) -> int:
    return x.data_ptr()           # argtypes turn ints into pointers


def _stream(x: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on x's device."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def _call(dev: torch.device, fn, *args) -> int:
    """``fn(*args)`` with ``dev`` as the current device; the switch is
    skipped when it already is (a device context costs microseconds)."""
    if dev.index == torch._C._cuda_getDevice():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def invert_rate_cuda(G: torch.Tensor, target: torch.Tensor,
                     b_max: torch.Tensor, iters: int) -> torch.Tensor:
    """K1 on flat (n,) float32 tensors; ``b_max`` has 1 or n elements."""
    n = G.numel()
    _check("G", G, (n,))
    _check("target", target, (n,))
    if b_max.numel() not in (1, n):
        raise ValueError(f"b_max must have 1 or {n} elements")
    _check("b_max", b_max, (b_max.numel(),))
    for x in (target, b_max):
        if x.device != G.device:
            raise ValueError("K1 operands must share one device")
    out = torch.empty_like(G)
    err = _call(G.device, build.load().sroa_invert_rate, _ptr(G),
                _ptr(target), _ptr(b_max),
                1 if b_max.numel() == n and n > 1 else 0, _ptr(out), n,
                int(iters), _stream(G))
    build.check(err, "sroa_invert_rate")
    return out


def solve_cuda(per_user: tuple, per_problem: tuple, *, b_iters: int,
               f_iters: int, p_iters: int, t_iters: int, eps0: float,
               eps1: float, eps2: float, t_low: float, t_up: float):
    """K2 on (A, J, H, delta, h, f_max, p_max) (P, N) and
    (B, b_max, N0, lam, E_cloud_total) (P,) float32 tensors."""
    P, N = per_user[0].shape
    dev = per_user[0].device
    for name, x in zip(("A", "J", "H", "delta", "h", "f_max", "p_max"),
                       per_user):
        _check(name, x, (P, N))
    for name, x in zip(("B", "b_max", "N0", "lam", "E_cloud_total"),
                       per_problem):
        _check(name, x, (P,))
    if any(x.device != dev for x in per_user + per_problem):
        raise ValueError("K2 operands must share one device")
    b, f, p = (torch.empty((P, N), dtype=torch.float32, device=dev)
               for _ in range(3))
    t, R, b_sum = (torch.empty((P,), dtype=torch.float32, device=dev)
                   for _ in range(3))
    feas = torch.empty((P,), dtype=torch.bool, device=dev)
    err = _call(dev, build.load().sroa_solve,
                *map(_ptr, per_user + per_problem),
                *map(_ptr, (b, f, p, t, R, b_sum, feas)),
                P, N, int(b_iters), int(f_iters), int(p_iters), int(t_iters),
                float(eps0), float(eps1), float(eps2), float(t_low),
                float(t_up), _stream(b))
    build.check(err, "sroa_solve")
    return b, f, p, t, R, b_sum, feas
