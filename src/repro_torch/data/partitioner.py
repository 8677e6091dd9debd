"""Federated data partitioners: IID and Dirichlet non-IID splits.

``partition_to_users`` produces the padded per-user tensors the batched HFL
loop consumes: x (N, D_max, ...), y (N, D_max), mask (N, D_max), sizes (N,).
Per-user dataset sizes follow the paper's D_n ~ U[d_lo, d_hi].

numpy only, with the JAX package's ``default_rng`` call order, so every
split is bitwise the one ``repro.data.partitioner`` makes.  When
:func:`iid_partition` runs out of samples, a user's part is shorter than
its size: :func:`partition_to_users` still returns the given ``sizes`` (the
aggregation weights), and the mask says which rows are real.
"""
from __future__ import annotations

import numpy as np


def iid_partition(n_samples: int, sizes: np.ndarray, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    out, ofs = [], 0
    for s in sizes:
        out.append(idx[ofs:ofs + s])
        ofs += s
    return out


def dirichlet_partition(labels: np.ndarray, sizes: np.ndarray,
                        alpha: float = 0.5, seed: int = 0):
    """Non-IID: each user's class mix ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.flatnonzero(labels == c) for c in range(n_classes)]
    for c in range(n_classes):
        rng.shuffle(by_class[c])
    ptr = np.zeros(n_classes, int)
    out = []
    for s in sizes:
        mix = rng.dirichlet(np.ones(n_classes) * alpha)
        counts = rng.multinomial(s, mix)
        take = []
        for c, k in enumerate(counts):
            avail = len(by_class[c]) - ptr[c]
            k = min(k, avail)
            take.append(by_class[c][ptr[c]:ptr[c] + k])
            ptr[c] += k
        idx = np.concatenate(take) if take else np.empty(0, int)
        # top up from the global pool if a class ran dry
        if len(idx) < s:
            pool = rng.integers(0, len(labels), size=s - len(idx))
            idx = np.concatenate([idx, pool])
        out.append(idx.astype(int))
    return out


def partition_to_users(x: np.ndarray, y: np.ndarray, sizes: np.ndarray,
                       alpha: float | None = None, seed: int = 0):
    """Returns padded (x_u, y_u, mask, sizes) stacked over users."""
    sizes = np.asarray(sizes, int)
    if alpha is None:
        parts = iid_partition(len(x), sizes, seed)
    else:
        parts = dirichlet_partition(y, sizes, alpha, seed)
    D = int(sizes.max())
    N = len(sizes)
    x_u = np.zeros((N, D) + x.shape[1:], x.dtype)
    y_u = np.zeros((N, D), np.int32)
    mask = np.zeros((N, D), np.float32)
    for i, idx in enumerate(parts):
        k = len(idx)
        x_u[i, :k] = x[idx]
        y_u[i, :k] = y[idx]
        mask[i, :k] = 1.0
    return x_u, y_u, mask, sizes
