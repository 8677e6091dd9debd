"""HFL training loop — the paper's Algorithm 1, batched over users.

One global iteration = K edge iterations x L local full-batch GD steps
(eq 1), edge aggregation (eq 2), then cloud aggregation (eq 3).  Traditional
single-server FL is the M=1, K=1 special case (used by Figs 7-8).

Users are a leading axis of stacked parameters, every leaf (N, ...).  A
local step is one forward of all N models (grouped convolutions and
batched matmuls, :func:`repro_torch.models.cnn.forward_users`), the sum
of the N per-user losses, and one ``torch.autograd.grad`` of that sum:
the users' parameters are disjoint, so each gets exactly its own
gradient.  This design was taken over ``torch.func.vmap`` of
``functional_call`` because it is plain eager PyTorch with one op per
layer for all users (vmap lowers a batched convolution to the same
grouped call) and leaves nothing to batching rules.  On a card cuDNN
still runs a grouped convolution's weight gradient one group at a time,
so a local step at N users launches O(N) kernels.  The K edge iterations
and the L steps are host loops (the reference scans both in one jit).
Edges are one-hot segment reductions, as in the reference.

The aggregation keeps the reference's floors, ``max(wsum, 1e-9)`` and
``max(sum, 1e-9)``, and so its behaviour when every user of an edge drops
out: that edge averages to zeros, broadcasts the zeros to its users for
the rest of the K loop, and carries weight 0 in the cloud average.

On a card the trainer's convolutions and matmuls run in float32, as the
reference computes: TF32 is switched off for cuDNN and cuBLAS inside
:func:`global_iteration` only (:func:`f32_math`), never process-wide.
cuDNN may still pick weight-gradient algorithms that add in a run-
dependent order, so a card run is held to a tolerance, not bitwise, even
against itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fed import compression as comp_lib
from repro_torch.models import cnn
from repro_torch.models.cnn import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class HflConfig:
    L: int = 5                   # local iterations per edge iteration
    K: int = 5                   # edge iterations per global iteration
    I: int = 40                  # global iterations
    lr: float = 0.05
    topk_frac: Optional[float] = None    # uplink compression (None = off)
    int8: bool = False
    seed: int = 0


@contextlib.contextmanager
def f32_math():
    """cuDNN convolutions and cuBLAS matmuls in float32 (no TF32) inside
    the block; the previous settings come back after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def _compress_update(cfg: HflConfig, upd):
    """Lossy-compress every user's uplink update per the config (leaves
    (N, ...), one update a user).

    Simulates the wire: top-k sparsification then int8
    quantize/dequantize, so the aggregated model sees exactly what a
    compressed upload would deliver.  Both knobs off returns the update
    untouched (the literal uncompressed program).
    """
    if cfg.topk_frac is not None:
        upd = tree_map(lambda u: u * comp_lib.topk_mask(u, cfg.topk_frac, 1),
                       upd)
    if cfg.int8:
        q, scales = comp_lib.int8_quantize(upd, batch_dims=1)
        upd = comp_lib.int8_dequantize(q, scales)
    return upd


def broadcast_tree(tree, n: int):
    return tree_map(lambda leaf: leaf.expand((n,) + tuple(leaf.shape)), tree)


def weighted_edge_average(user_params, onehot, weights):
    """eq (2): w_m = sum_{n in m} D_n w_n / D_m  for every edge at once."""
    wsum = torch.einsum("n,nm->m", weights, onehot)            # (M,)

    def agg(leaf):  # leaf: (N, ...)
        num = torch.einsum("n,nm,n...->m...", weights, onehot, leaf)
        return num / torch.clamp_min(wsum, 1e-9).reshape(
            (-1,) + (1,) * (leaf.ndim - 1))

    return tree_map(agg, user_params), wsum


def cloud_average(edge_params, edge_weight):
    """eq (3): w = sum_m D_m w_m / D."""
    tot = torch.clamp_min(edge_weight.sum(), 1e-9)
    return tree_map(lambda leaf: torch.einsum("m,m...->...", edge_weight,
                                              leaf) / tot, edge_params)


def _local_train(cnn_cfg, cfg: HflConfig, params, x_u, y_u, mask_u):
    """L full-batch GD steps of every user at once (eq 1)."""
    for _ in range(cfg.L):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = cnn.loss_users(cnn_cfg, tree_unflatten(params, leaves),
                                  x_u, y_u, mask_u).sum()
            grads = torch.autograd.grad(loss, leaves)
        params = tree_unflatten(params, [p.detach() - cfg.lr * g
                                         for p, g in zip(leaves, grads)])
    return params


def global_iteration(cnn_cfg: cnn.CnnConfig, cfg: HflConfig, w_global,
                     x_u, y_u, mask_u, sizes, onehot, participate):
    """One HFL global iteration (Algorithm 1).  participate: (N,) 0/1 mask
    (straggler dropping / failures); dropped users keep training but are
    excluded from aggregation weights.  Every tensor lies on one device."""
    N = x_u.shape[0]
    weights = sizes * participate
    compress = cfg.topk_frac is not None or cfg.int8
    with torch.no_grad(), f32_math():
        user_params = broadcast_tree(w_global, N)
        for _ in range(cfg.K):
            trained = _local_train(cnn_cfg, cfg, user_params, x_u, y_u,
                                   mask_u)
            if compress:
                # Compress the user -> edge uplink: the edge aggregates the
                # broadcast reference plus each user's compressed update.
                upd = tree_map(lambda a, b: a - b, trained, user_params)
                upd = _compress_update(cfg, upd)
                trained = tree_map(lambda b, u: b + u, user_params, upd)
            edge_params, _ = weighted_edge_average(trained, onehot, weights)
            # edge broadcasts back to its users (next edge iteration)
            user_params = tree_map(
                lambda em: torch.einsum("nm,m...->n...", onehot, em),
                edge_params)
        edge_params, _ = weighted_edge_average(user_params, onehot, weights)
        edge_weight = torch.einsum("n,nm->m", weights, onehot)
        return cloud_average(edge_params, edge_weight)


def _on(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=dtype, device=device)


def run_hfl(cnn_cfg: cnn.CnnConfig, w0, x_u, y_u, mask_u, sizes, assign,
            cfg: HflConfig, *, x_test=None, y_test=None, M: int | None = None,
            participate_fn: Callable[[int], np.ndarray] | None = None,
            eval_every: int = 1, ckpt_manager=None, start_iter: int = 0,
            device="cuda"):
    """Run I global iterations on ``device``; returns (w, history dict).

    Arrays may be numpy or tensors; each is moved to ``device`` once.  A
    checkpoint of the global model is saved after every iteration (step
    i + 1) when ``ckpt_manager`` is given.
    """
    dev = torch.device(device)
    assign = np.asarray(assign.cpu() if isinstance(assign, torch.Tensor)
                        else assign)
    M = M if M is not None else int(np.max(assign)) + 1
    onehot = F.one_hot(torch.as_tensor(assign, dtype=torch.long,
                                       device=dev), M).to(torch.float32)
    sizes = _on(sizes, dev, torch.float32)
    x_u, y_u = _on(x_u, dev), _on(y_u, dev)
    mask_u = _on(mask_u, dev, torch.float32)
    if x_test is not None:
        x_test, y_test = _on(x_test, dev), _on(y_test, dev)
    hist = {"acc": [], "iter": []}
    w = tree_map(lambda leaf: _on(leaf, dev, torch.float32), w0)
    for i in range(start_iter, cfg.I):
        part = (_on(participate_fn(i), dev, torch.float32) if participate_fn
                else torch.ones(x_u.shape[0], device=dev))
        w = global_iteration(cnn_cfg, cfg, w, x_u, y_u, mask_u, sizes,
                             onehot, part)
        if x_test is not None and (i % eval_every == 0 or i == cfg.I - 1):
            with torch.no_grad():
                acc = float(cnn.accuracy(cnn_cfg, w, x_test, y_test))
            hist["acc"].append(acc)
            hist["iter"].append(i)
        if ckpt_manager is not None:
            ckpt_manager.save(step=i + 1, tree=w)
    return w, hist


def run_fl(cnn_cfg, w0, x_u, y_u, mask_u, sizes, cfg: HflConfig, **kw):
    """Traditional FL: one server (M=1), K=1; same code path (Figs 7-8)."""
    assign = np.zeros(x_u.shape[0], np.int32)
    fl_cfg = dataclasses.replace(cfg, K=1)
    return run_hfl(cnn_cfg, w0, x_u, y_u, mask_u, sizes, assign, fl_cfg,
                   M=1, **kw)
