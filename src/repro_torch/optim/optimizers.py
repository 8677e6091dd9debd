"""Functional optimizers over nested dicts of tensors: SGD with momentum,
AdamW and Adafactor (the JAX package's ``optim/optimizers.py``).

Interface: ``opt = sgd(lr=...)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params, lr_scale=1.0)``.
``update`` builds new tensors and never writes into ``params`` or
``state``.  The state mirrors the parameters, with ``state["step"]`` a
0-d int32 tensor on their device.

``torch.optim`` is not used: its AdamW keeps ``m`` and ``v`` in the
parameter's dtype, where the reference keeps them in float32 (bfloat16
parameters at full size).  The reference's SGD keeps ``mu`` in the
parameter's dtype, and so does this one.

SGD follows JAX's type promotion on bfloat16 leaves, where PyTorch's
differs: a Python number takes the leaf's dtype before the product (JAX's
weak type; PyTorch multiplies by the float32 number, which moves the
rounded result), and ``lr_scale`` given as a 0-d float32 tensor (a
schedule's value) promotes the step to float32 (PyTorch would keep
bfloat16).  AdamW and Adafactor step in float32 either way.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.models.cnn import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _weak(c, x: torch.Tensor):
    """The Python number ``c`` as JAX multiplies it into ``x``: rounded to
    ``x``'s dtype first (the same as PyTorch's product for float32)."""
    if x.dtype == torch.float32:
        return c
    return torch.full((), c, dtype=x.dtype, device=x.device)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    The squared norms are summed in float32 in the reference's order
    (sorted keys); each leaf is scaled in float32 and cast back."""
    norm = torch.sqrt(sum(torch.sum(torch.square(_f32(g)))
                          for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (_f32(g) * scale).to(g.dtype), grads), norm


def sgd(lr=1e-2, momentum=0.9, nesterov=False) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "step": _step0(params)}

    def update(grads, state, params, lr_scale=1.0):
        def decay(m, g):
            return _weak(momentum, m) * m + g

        mu = tree_map(decay, state["mu"], grads)
        upd = tree_map(decay, mu, grads) if nesterov else mu
        step_lr = lr * lr_scale

        def new(p, u):
            if isinstance(step_lr, torch.Tensor):      # float32 promotion
                return (_f32(p) - step_lr * _f32(u)).to(p.dtype)
            return (p - _weak(step_lr, u) * u).to(p.dtype)

        return (tree_map(new, params, upd),
                {"mu": mu, "step": state["step"] + 1})

    return Optimizer(init, update)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step0(params)}

    def update(grads, state, params, lr_scale=1.0):
        step = state["step"] + 1
        bc1 = 1.0 - b1 ** _f32(step)
        bc2 = 1.0 - b2 ** _f32(step)
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * _f32(g), state["m"],
                     grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(_f32(g)),
                     state["v"], grads)
        step_lr = lr * lr_scale

        def upd(p, mi, vi):
            mhat, vhat = mi / bc1, vi / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * _f32(p)
            return (_f32(p) - step_lr * delta).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_threshold=1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern, 2018),
    simplified as in the reference: a leaf of two or more axes keeps float32
    row and column moments over its last two axes, any other leaf a full
    float32 moment."""

    def init(params):
        def make(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}

        return {"mom": tree_map(make, params), "step": _step0(params)}

    def update(grads, state, params, lr_scale=1.0):
        step = state["step"] + 1
        beta = 1.0 - (_f32(step) + 1.0) ** -decay
        step_lr = lr * lr_scale

        def upd(p, g, s):
            g32 = _f32(g)
            g2 = torch.square(g32) + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp_min(vr.mean(-1)[..., None, None], eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                denom = torch.sqrt(v)
                new_s = {"v": v}
            u = g32 / torch.clamp_min(denom, eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return (_f32(p) - step_lr * u).to(p.dtype), new_s

        def walk(p, g, s):
            if isinstance(p, dict):
                out = {k: walk(p[k], g[k], s[k]) for k in p}
                return ({k: o[0] for k, o in out.items()},
                        {k: o[1] for k, o in out.items()})
            return upd(p, g, s)

        new_params, new_mom = walk(params, grads, state["mom"])
        return new_params, {"mom": new_mom, "step": step}

    return Optimizer(init, update)


_REGISTRY = {"sgd": sgd, "adamw": adamw, "adafactor": adafactor}


def get(name: str, **kw) -> Optimizer:
    return _REGISTRY[name](**kw)
