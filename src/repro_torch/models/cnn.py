"""The paper's three HFL CNNs (§VI-A) in PyTorch.

* FashionMNIST: 2x conv5x5 (10, 12 ch) + 2x2 maxpool + linear head.
* CIFAR-10:     2x conv5x5 (10, 20 ch) + 2x2 maxpool + 2 linear layers.
* ImageNette:   2x conv5x5 (15, 28 ch) + 2x2 maxpool + linear(300) + linear(10).

Parameters keep the JAX package's layout: a dict of layers
(``conv0``, ``conv1``, ``fc0``, ..., ``head``), each ``{"w", "b"}``, with
conv kernels HWIO (5, 5, c_in, c_out) and linear weights (in, out).
Inputs are NHWC (B, H, W, C), and the features are flattened in (h, w, c)
order before the first linear layer, as ``repro.models.cnn`` flattens
them, so ``fc0``'s rows mean the same in both packages.  A parameter dict
therefore crosses between the packages as a plain copy
(:func:`params_from_numpy`, ``ckpt``); :func:`forward_users` permutes to
PyTorch's NCHW/OIHW inside.

Users are a batched axis: :func:`forward_users` runs N models (every leaf
with a leading (N,) axis) on N batches (N, B, H, W, C) as one grouped
convolution per conv layer (``groups=N``: user n's channels see only
user n's kernels) and one batched matmul per linear layer.  The users'
parameters are disjoint, so one ``torch.autograd.grad`` of the summed
per-user losses (:func:`loss_users`) gives every user exactly the
gradient of its own loss.  :func:`forward` and :func:`loss_fn` are the
N = 1 case.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CnnConfig:
    name: str
    in_shape: Tuple[int, int, int]      # (H, W, C)
    conv_channels: Tuple[int, ...]
    hidden: Tuple[int, ...]             # linear hidden dims ((): direct head)
    n_classes: int = 10


PAPER_CNNS = {
    "fashionmnist": CnnConfig("fashionmnist", (28, 28, 1), (10, 12), ()),
    "cifar10": CnnConfig("cifar10", (32, 32, 3), (10, 20), (100,)),
    "imagenette": CnnConfig("imagenette", (32, 32, 3), (15, 28), (300,)),
}


def _out_hw(h: int, n_convs: int) -> int:
    for _ in range(n_convs):
        h = (h - 4) // 2                # valid conv5 then 2x2 maxpool
    return h


def param_shapes(cfg: CnnConfig) -> dict:
    """``{layer: {"w": shape, "b": shape}}`` in the JAX package's draw
    order (convs, hidden linears, head)."""
    shapes = {}
    c_in = cfg.in_shape[2]
    for i, c_out in enumerate(cfg.conv_channels):
        shapes[f"conv{i}"] = {"w": (5, 5, c_in, c_out), "b": (c_out,)}
        c_in = c_out
    hw = _out_hw(cfg.in_shape[0], len(cfg.conv_channels))
    dim = hw * hw * c_in
    for i, h in enumerate(cfg.hidden):
        shapes[f"fc{i}"] = {"w": (dim, h), "b": (h,)}
        dim = h
    shapes["head"] = {"w": (dim, cfg.n_classes), "b": (cfg.n_classes,)}
    return shapes


def tree_map(fn, *trees):
    """``fn`` over the leaves of parameter dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves in the JAX package's order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves) -> dict:
    """Inverse of :func:`tree_leaves` for ``like``'s structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


def init_params(cfg: CnnConfig, generator: torch.Generator, device="cuda"):
    """Random parameters with the JAX package's distribution: weights
    normal / sqrt(fan_in) (25 c_in for a conv), biases zero, drawn from
    ``generator`` (on ``device``) layer by layer.  The draws are not the
    JAX package's bits: carry its weights across with
    :func:`params_from_numpy`."""
    params = {}
    for name, s in param_shapes(cfg).items():
        w = s["w"]
        fan_in = 25 * w[2] if len(w) == 4 else w[0]
        params[name] = {
            "w": torch.randn(w, generator=generator, device=device)
            / np.sqrt(fan_in),
            "b": torch.zeros(s["b"], device=device)}
    return params


def params_from_numpy(tree, cfg: CnnConfig, device="cuda"):
    """A parameter dict with numpy (or JAX) leaves, in the JAX package's
    layout, as float32 tensors on ``device``; shapes are checked."""
    out = {}
    for name, s in param_shapes(cfg).items():
        if name not in tree:
            raise KeyError(f"parameter {name} is missing")
        out[name] = {}
        for k, shape in s.items():
            x = np.asarray(tree[name][k], np.float32)
            if x.shape != shape:
                raise ValueError(f"parameter {name}/{k} has shape {x.shape}, "
                                 f"expected {shape}")
            out[name][k] = torch.tensor(x, device=device)
    return out


def param_bytes(cfg: CnnConfig) -> int:
    return sum(int(np.prod(shape)) * 4 for s in param_shapes(cfg).values()
               for shape in s.values())


def forward_users(cfg: CnnConfig, params, x: torch.Tensor) -> torch.Tensor:
    """N models on N batches: leaves (N, ...), x (N, B, H, W, C) float32 ->
    logits (N, B, n_classes)."""
    N, B = x.shape[:2]
    # (B, N*C, H, W): user n's channels are the n-th group of C.
    h = x.permute(1, 0, 4, 2, 3).reshape(B, N * x.shape[4], *x.shape[2:4])
    for i in range(len(cfg.conv_channels)):
        w, b = params[f"conv{i}"]["w"], params[f"conv{i}"]["b"]
        c_in, c_out = w.shape[3], w.shape[4]
        # HWIO -> OIHW, users' kernels stacked along O.
        w = w.permute(0, 4, 3, 1, 2).reshape(N * c_out, c_in, 5, 5)
        h = F.conv2d(h, w, groups=N) + b.reshape(1, N * c_out, 1, 1)
        h = F.max_pool2d(torch.relu(h), 2)          # 2x2, stride 2, VALID
    c = h.shape[1] // N
    # Flatten each user's features in (h, w, c) order, as NHWC does.
    h = h.reshape(B, N, c, h.shape[2], h.shape[3]).permute(1, 0, 3, 4, 2)
    h = h.reshape(N, B, -1)
    for i in range(len(cfg.hidden)):
        p = params[f"fc{i}"]
        h = torch.relu(torch.bmm(h, p["w"]) + p["b"][:, None, :])
    return torch.bmm(h, params["head"]["w"]) + params["head"]["b"][:, None, :]


def forward(cfg: CnnConfig, params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) float32 -> logits (B, n_classes)."""
    users = tree_map(lambda leaf: leaf[None], params)
    return forward_users(cfg, users, x[None])[0]


def loss_users(cfg: CnnConfig, params, x, y, mask=None) -> torch.Tensor:
    """(N,) mean cross-entropy of each user's model on its own batch
    (y: (N, B) int; mask: (N, B), 0 for padded rows)."""
    logp = torch.log_softmax(forward_users(cfg, params, x), dim=-1)
    ce = -torch.gather(logp, -1, y[..., None].long())[..., 0]
    if mask is not None:
        return ((ce * mask).sum(dim=-1)
                / torch.clamp_min(mask.sum(dim=-1), 1.0))
    return ce.mean(dim=-1)


def loss_fn(cfg: CnnConfig, params, x, y, mask=None) -> torch.Tensor:
    users = tree_map(lambda leaf: leaf[None], params)
    return loss_users(cfg, users, x[None], y[None],
                      None if mask is None else mask[None])[0]


def accuracy(cfg: CnnConfig, params, x, y) -> torch.Tensor:
    return (torch.argmax(forward(cfg, params, x), -1) == y).float().mean()
