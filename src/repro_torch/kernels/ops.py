"""Public wrappers for the kernels: flatten, dispatch by device, count.

Each wrapper flattens every leading axis into its kernel's problem axis
(one launch per call, as ``repro/kernels/ops.py`` does) and dispatches on
the device of its tensors: CPU tensors run the plain PyTorch version in
:mod:`repro_torch.kernels.ref`; CUDA tensors launch the hand-written
kernel, or raise.  Every tensor operand of a call must lie on one device
(Python scalars broadcast onto it); a call that mixes devices raises.
``LAUNCHES`` counts kernel launches (only launches: the plain version never
counts) under ``sroa_invert`` (K1), ``sroa_solve`` (K2, either of its
kernels), ``topk_moves`` (K3), ``flash_attention`` (K4, either of its
kernels) and ``rmsnorm`` (K5); ``sroa_solve_lanes`` and
``sroa_solve_cluster`` count the K2 launches that took the one-block and the
one-cluster one-thread-per-user kernels, ``topk_moves_warp`` and
``topk_moves_cluster`` the K3 launches that took the one-warp-per-cell and
the one-cluster-per-cell kernels, and ``flash_attention_sm90`` and
``flash_attention_sm90_f32`` the K4 launches that took the bf16 and the
f32 tensor-core kernels.  K4 refuses to run under autograd
(:func:`flash_attention`).  The recurrences' ops (:mod:`ssm_scan`: S1-S3,
no Pallas counterpart) count under ``ssm_scan`` (any of the six) and
under ``mamba2_scan``, ``mlstm_scan`` and ``slstm_scan`` and their
backward ops' ``mamba2_scan_bwd``, ``mlstm_scan_bwd`` and
``slstm_scan_bwd`` (one count a call of an op, whatever kernels it runs);
``mamba2_scan_chunked`` and ``mamba2_scan_bwd_chunked`` count the S1 and
S1b calls that took the chunked kernels (``ssm_scan.mamba2_route``),
``mlstm_scan_chunked`` and ``mlstm_scan_bwd_chunked`` the S2 and S2b
calls that took the chunked kernels (``ssm_scan.mlstm_route``), and
``slstm_scan_short`` and ``slstm_scan_bwd_short`` the S3 and S3b calls
that took the short step (every call but a forced one).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref

LAUNCHES = {"sroa_invert": 0, "sroa_solve": 0, "sroa_solve_lanes": 0,
            "sroa_solve_cluster": 0, "topk_moves": 0, "topk_moves_warp": 0,
            "topk_moves_cluster": 0, "flash_attention": 0,
            "flash_attention_sm90": 0, "flash_attention_sm90_f32": 0,
            "rmsnorm": 0, "ssm_scan": 0, "mamba2_scan": 0, "mlstm_scan": 0,
            "slstm_scan": 0, "mamba2_scan_bwd": 0, "mlstm_scan_bwd": 0,
            "slstm_scan_bwd": 0, "mamba2_scan_chunked": 0,
            "mamba2_scan_bwd_chunked": 0, "mlstm_scan_bwd_chunked": 0,
            "slstm_scan_bwd_short": 0, "mlstm_scan_chunked": 0,
            "slstm_scan_short": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(*operands) -> bool:
    """The route of a call: True for a kernel launch, False for the plain
    version.  Raises unless every tensor operand lies on one CPU or CUDA
    device."""
    devs = {x.device for x in operands if isinstance(x, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError("kernel operands must lie on one device, got "
                         f"{sorted(str(d) for d in devs)}")
    (dev,) = devs
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel route for tensors on {dev}")


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def sroa_invert_rate(G, target, b_max, iters: int = 42) -> torch.Tensor:
    """(N,) Lemma-1 inversion with one bandwidth cap ``b_max`` (K1)."""
    cuda = _on_cuda(G, target, b_max)
    G = _f32(G, G)
    target = _f32(target, G).contiguous()
    bm = _f32(b_max, G).reshape(1)
    if not cuda:
        return ref.invert_rate_plain(G, target, bm, iters)
    from repro_torch.kernels import sroa_bisect
    out = sroa_bisect.invert_rate_cuda(G.contiguous(), target, bm, iters)
    LAUNCHES["sroa_invert"] += 1
    return out


def sroa_invert_rate_batched(G, target, b_max,
                             iters: int = 42) -> torch.Tensor:
    """Fleet-batched inversion: G, target (..., N); b_max (...) or scalar.

    Every leading axis flattens into one launch of K1 with a per-element
    cap.
    """
    cuda = _on_cuda(G, target, b_max)
    G = _f32(G, G)
    shape = G.shape
    target = _f32(target, G)
    bm = torch.broadcast_to(_f32(b_max, G)[..., None], shape)
    if not cuda:
        return ref.invert_rate_plain(G, target, bm, iters)
    from repro_torch.kernels import sroa_bisect
    out = sroa_bisect.invert_rate_cuda(
        G.reshape(-1).contiguous(), target.reshape(-1).contiguous(),
        bm.reshape(-1).contiguous(), iters)
    LAUNCHES["sroa_invert"] += 1
    return out.reshape(shape)


def sroa_solve_batched(A, J, H, delta, h, f_max, p_max, B, b_max, N0, lam,
                       E_cloud_total, *, b_iters: int = 42,
                       f_iters: int = 40, p_iters: int = 36,
                       t_iters: int = 48, eps0: float = 1e-4,
                       eps1: float = 1e-4, eps2: float = 1e-4,
                       t_low: float = 1.0, t_up: float = 3e7):
    """Fused full-SROA solve (K2): every (..., N)-leading axis in one launch.
    On CUDA, ``sroa_bisect.solve_route`` picks the kernel and its depth.

    Per-user operands are (..., N); per-problem operands are (...) or
    scalar.  Returns (b, f, p) shaped (..., N) and (t, R, b_sum, feasible)
    shaped (...).
    """
    cuda = _on_cuda(A, J, H, delta, h, f_max, p_max, B, b_max, N0, lam,
                    E_cloud_total)
    A = _f32(A, A)
    shape = torch.broadcast_shapes(*(torch.as_tensor(x).shape for x in
                                     (A, J, H, delta, h, f_max, p_max)))
    lead, N = shape[:-1], shape[-1]
    P = math.prod(lead)

    def fu(x):
        return torch.broadcast_to(_f32(x, A), lead + (N,)).reshape(P, N)

    def fs(x):
        return torch.broadcast_to(_f32(x, A), lead).reshape(P)

    per_user = tuple(fu(x) for x in (A, J, H, delta, h, f_max, p_max))
    per_problem = tuple(fs(x) for x in (B, b_max, N0, lam, E_cloud_total))
    kw = dict(b_iters=b_iters, f_iters=f_iters, p_iters=p_iters,
              t_iters=t_iters, eps0=eps0, eps1=eps1, eps2=eps2, t_low=t_low,
              t_up=t_up)
    if cuda:
        from repro_torch.kernels import sroa_bisect
        out, (kernel, _) = sroa_bisect.solve_cuda(
            tuple(x.contiguous() for x in per_user),
            tuple(x.contiguous() for x in per_problem), **kw)
        LAUNCHES["sroa_solve"] += 1
        if kernel != "warp":
            LAUNCHES[f"sroa_solve_{kernel}"] += 1
    else:
        out = ref.sroa_solve_plain(*per_user, *per_problem, **kw)
    b, f, p, t, R, b_sum, feas = out
    return (b.reshape(lead + (N,)), f.reshape(lead + (N,)),
            p.reshape(lead + (N,)), t.reshape(lead), R.reshape(lead),
            b_sum.reshape(lead), feas.reshape(lead))


_K3_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
              torch.bool, torch.float32, torch.float32)


def _k3_final(operands) -> bool:
    """Every K3 operand already a contiguous tensor of its final dtype and
    shape (gain (P, N, M); H, p_max, assign, mask (P, N); N0, B (P,)) on
    gain's device: the check of one pass, with no copy."""
    gain = operands[0]
    if not isinstance(gain, torch.Tensor) or gain.dim() != 3:
        return False
    P, N, _ = gain.shape
    dev = gain.device
    shapes = (gain.shape, (P, N), (P, N), (P, N), (P, N), (P,), (P,))
    return all(isinstance(x, torch.Tensor) and x.dtype is dtype
               and x.device == dev and x.shape == shape
               and x.is_contiguous()
               for x, dtype, shape in zip(operands, _K3_DTYPES, shapes))


def topk_move_scores(gain, H, p_max, assign, mask, N0, B, *, k: int):
    """Top-k move pruning (K3): the cheapest k (user, dst) moves per cell.

    gain is (..., N, M); H/p_max/assign/mask are (..., N); N0/B are (...)
    or scalar.  Returns (user, dst, score), each (..., k); entries with
    ``score >= 1e29`` are padding (fewer than k valid moves).  On CUDA,
    ``topk_moves.topk_route`` picks the kernel.  Operands already in their
    final dtype, shape and layout pass through untouched.
    """
    operands = (gain, H, p_max, assign, mask, N0, B)
    lead = gain.shape[:-2]
    if _k3_final(operands):
        cuda = _on_cuda(gain)
        args = operands
    else:
        cuda = _on_cuda(*operands)
        N, M = gain.shape[-2:]
        P = math.prod(lead)
        shapes = ((P, N, M), (P, N), (P, N), (P, N), (P, N), (P,), (P,))
        args = tuple(
            torch.broadcast_to(torch.as_tensor(x, dtype=dtype,
                                               device=gain.device),
                               lead + shape[1:]).reshape(shape).contiguous()
            for x, dtype, shape in zip(operands, _K3_DTYPES, shapes))
    if cuda:
        from repro_torch.kernels import topk_moves
        out, route = topk_moves._launch(*args, k)
        LAUNCHES["topk_moves"] += 1
        if route != "block":
            LAUNCHES[f"topk_moves_{route}"] += 1
    else:
        out = ref.topk_moves_plain(*args, k=k)
    if len(lead) == 1:
        return out
    return tuple(x.reshape(lead + (k,)) for x in out)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    window=None) -> torch.Tensor:
    """Flash attention (K4) in the model layout: q (B, Tq, H, hd), k/v
    (B, Tk, H, hd) -> (B, Tq, H, hd) in q's dtype, scaled by 1/sqrt(hd).

    Heads are not repeated here: k and v carry q's head count (the model's
    ``attention`` repeats grouped heads first, as the JAX package does).
    On CUDA, ``flash_attention.route`` picks the kernel.

    K4 has no backward: the kernel fills its output through ctypes, so a
    gradient would stop at it.  Under autograd (grad mode on and any of
    q, k, v requiring grad) the call raises on every device, the CPU's
    plain version included, so that the CPU shows what the card would do.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention (K4) has no backward; train on the chunked "
            "route (ArchConfig(attn_impl='chunked')), as the JAX package "
            "does")
    cuda = _on_cuda(q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention takes q (B, Tq, H, hd) and k/v "
                         f"(B, Tk, H, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not cuda:
        return ref.attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, q_offset=q_offset, window=window).transpose(1, 2)
    from repro_torch.kernels import flash_attention as fa
    out, route = fa.flash_attention_cuda(q, k, v, causal=causal,
                                         q_offset=q_offset, window=window)
    LAUNCHES["flash_attention"] += 1
    if route != "simt":
        LAUNCHES["flash_attention_sm90" + ("_f32" if route == "tf32"
                                           else "")] += 1
    return out


def fused_rmsnorm(x, scale, eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm (K5): x (..., d), scale (d,) -> x's shape and dtype."""
    cuda = _on_cuda(x, scale)
    if not cuda:
        return ref.rmsnorm_plain(x, scale, eps)
    from repro_torch.kernels import rmsnorm
    d = x.shape[-1]
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    flat = x if x.dim() == 2 else x.reshape(-1, d)
    out = rmsnorm.rmsnorm_cuda(flat.contiguous(), scale, eps)
    LAUNCHES["rmsnorm"] += 1
    return out if x.dim() == 2 else out.reshape(x.shape)
