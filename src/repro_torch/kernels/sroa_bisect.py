"""Launchers for K1 and K2 (``csrc/sroa_bisect.cu``) on CUDA tensors.

* K1 ``sroa_invert_rate`` replaces ``repro/kernels/sroa_bisect.py``
  ``_bisect_kernel`` and ``_bisect_kernel_vec`` (the Lemma-1 bandwidth
  inversion): one thread per element; a stride-0 ``b_max`` covers the
  scalar-budget form, a per-element one the fleet-batched form.
* K2 replaces ``_solve_kernel``: the whole Algorithm 2-4 nest for P
  problems, on one of two kernels that :func:`solve_route` picks from
  (P, N) alone, both one thread per user: ``sroa_solve_lanes`` (a problem
  a block, N <= 512) and ``sroa_solve_cluster`` (a problem a thread block
  cluster of up to 8 blocks, N <= 4096).  The one-warp ``sroa_solve`` (one
  warp per problem, N <= 3632) is taken only when forced, as the
  yardstick.

All are bound by the latency of their dependent bisection chains, not by
memory: see the source notes in ``csrc/sroa_bisect.cu``.  K1 and the two
one-thread-per-user K2 kernels evaluate 2^D - 1 bisection midpoints at once
(speculation depth D, 1 or 2); every depth gives the same bits, and
:func:`spec_depth` picks it from how many warps each SM scheduler would
hold.  These launchers check device,
dtype, contiguity, shape and each kernel's cap, then allocate the outputs,
launch on the current stream and raise on a launch error; they never
synchronize.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

LANES_MAX_N = 512        # 16 warps a problem: 512 threads at 96 registers
CLUSTER_MAX_N = 4096     # 8 blocks of 16 warps: the portable cluster size
WARP_MAX_N = 232_448 // 64   # the one-warp kernel's 64 bytes a user: 3632
SCHEDULERS_PER_SM = 4    # warp schedulers of a Hopper SM
DEPTHS = (1, 2)


def spec_depth(warps: int, sms: int) -> int:
    """The speculation depth for a launch of ``warps`` warps on ``sms`` SMs.

    A deeper round shortens each thread's dependent chain but issues more
    instructions (2^D - 1 predicate evaluations for D steps), so it pays
    only where the SM schedulers hold few warps to interleave: depth 2 up
    to two warps a scheduler, else 1 (on an H100, depth 2 won at 0.5 and
    1.9 warps a scheduler and lost at 2.9; ``PERF.md``)."""
    per_scheduler = warps / (SCHEDULERS_PER_SM * sms)
    return 2 if per_scheduler <= 2.0 else 1


def solve_route(P: int, N: int, sms: int) -> tuple[str, int]:
    """K2's kernel and speculation depth for P problems of N users on a
    card of ``sms`` SMs: ("lanes", depth) for N <= 512, ("cluster", depth)
    up to 4096.  Raises ValueError past that, before any launch.  A pure
    function: no card."""
    if N > CLUSTER_MAX_N:
        raise ValueError(
            f"the fused SROA solve (K2) takes N <= {CLUSTER_MAX_N} users a "
            f"problem (one thread a user over a cluster of 8 blocks), got "
            f"N = {N}; SroaConfig(fused=False) runs the un-fused nest, "
            f"which has no cap")
    kernel = "lanes" if N <= LANES_MAX_N else "cluster"
    return kernel, spec_depth(P * math.ceil(N / 32), sms)


def _check_route(kernel: str, depth: int, N: int) -> None:
    """Raise unless K2's kernel ``kernel`` takes N users at ``depth``."""
    caps = {"lanes": LANES_MAX_N, "cluster": CLUSTER_MAX_N,
            "warp": WARP_MAX_N}
    if kernel not in caps:
        raise ValueError(f"no K2 kernel {kernel!r}")
    if N > caps[kernel]:
        raise ValueError(f"the {kernel} K2 takes N <= {caps[kernel]}, got "
                         f"N = {N}")
    if depth not in (DEPTHS if kernel != "warp" else (0,)):
        raise ValueError(f"the {kernel} K2 has no speculation depth "
                         f"{depth}")


def cluster_shape(N: int) -> tuple[int, int]:
    """The cluster K2's (blocks a cluster, warps a block) for N users, as
    its launcher computes them: ceil(W / 8) blocks, at most 8, share the W =
    ceil(N/32) warps evenly."""
    W = math.ceil(N / 32)
    C = min(math.ceil(W / 8), 8)
    return C, math.ceil(W / C)


def invert_depth(n: int, sms: int) -> int:
    """K1's speculation depth for n elements, one thread each."""
    return spec_depth(math.ceil(n / 32), sms)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def math_check(device, pairs: int = 1 << 32) -> tuple[int, int]:
    """The branch-free arithmetic of K1 and K2 against the toolkit's on
    ``device``: (log1pf mismatches over every float of [+0, FLT_MAX],
    division mismatches over ``pairs`` hashed operand pairs).
    Synchronizes."""
    bad = torch.zeros(2, dtype=torch.int64, device=device)
    err = _call(bad.device, build.load().sroa_math_check, _ptr(bad),
                int(pairs), _stream(bad))
    build.check(err, "sroa_math_check")
    return tuple(int(x) for x in bad.cpu())


def invert_rate_cuda(G: torch.Tensor, target: torch.Tensor,
                     b_max: torch.Tensor, iters: int,
                     _depth: int | None = None) -> torch.Tensor:
    """K1 on flat (n,) float32 tensors; ``b_max`` has 1 or n elements.

    ``_depth`` overrides :func:`invert_depth`, for holding and timing every
    depth on the same tensors."""
    n = G.numel()
    _check("G", G, (n,))
    _check("target", target, (n,))
    if b_max.numel() not in (1, n):
        raise ValueError(f"b_max must have 1 or {n} elements")
    _check("b_max", b_max, (b_max.numel(),))
    for x in (target, b_max):
        if x.device != G.device:
            raise ValueError("K1 operands must share one device")
    sms = _sms(G.device.index)
    depth = invert_depth(n, sms) if _depth is None else _depth
    if depth not in DEPTHS:
        raise ValueError(f"no speculation depth {depth}")
    out = torch.empty_like(G)
    err = _call(G.device, build.load().sroa_invert_rate, _ptr(G),
                _ptr(target), _ptr(b_max),
                1 if b_max.numel() == n and n > 1 else 0, _ptr(out), n,
                int(iters), depth, sms, _stream(G))
    build.check(err, "sroa_invert_rate")
    return out


def solve_cuda(per_user: tuple, per_problem: tuple, *, b_iters: int,
               f_iters: int, p_iters: int, t_iters: int, eps0: float,
               eps1: float, eps2: float, t_low: float, t_up: float,
               _route: tuple[str, int] | None = None):
    """K2 on (A, J, H, delta, h, f_max, p_max) (P, N) and
    (B, b_max, N0, lam, E_cloud_total) (P,) float32 tensors.  Returns
    (b, f, p, t, R, b_sum, feasible) and the (kernel, depth) that ran.

    ``_route`` overrides :func:`solve_route` (("warp", 0), ("lanes", D) or
    ("cluster", D)), for timing the kernels and every depth on the same
    tensors.  Each kernel's cap (N <= 512, 4096 and 3632) raises
    ValueError before anything is allocated."""
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
    sms = _sms(dev.index)
    kernel, depth = solve_route(P, N, sms) if _route is None else _route
    _check_route(kernel, depth, N)
    b, f, p = (torch.empty((P, N), dtype=torch.float32, device=dev)
               for _ in range(3))
    t, R, b_sum = (torch.empty((P,), dtype=torch.float32, device=dev)
                   for _ in range(3))
    feas = torch.empty((P,), dtype=torch.bool, device=dev)
    args = (*map(_ptr, per_user + per_problem),
            *map(_ptr, (b, f, p, t, R, b_sum, feas)),
            P, N, int(b_iters), int(f_iters), int(p_iters), int(t_iters),
            float(eps0), float(eps1), float(eps2), float(t_low),
            float(t_up))
    lib = build.load()
    if kernel == "warp":
        err = _call(dev, lib.sroa_solve, *args, _stream(b))
    else:
        fn = lib.sroa_solve_lanes if kernel == "lanes" else \
            lib.sroa_solve_cluster
        err = _call(dev, fn, *args, depth, _stream(b))
    build.check(err, f"sroa_solve ({kernel})")
    return (b, f, p, t, R, b_sum, feas), (kernel, depth)
