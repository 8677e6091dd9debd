"""Synthetic stand-ins for the paper's datasets (DESIGN.md A1).

Class-conditional Gaussian images: every class has a random smooth template;
samples = template + noise.  Linearly separable enough that FL/HFL training
curves are meaningful, while needing no downloads in the offline container.
Also provides deterministic token streams for the LM substrate tests.

numpy only, with the JAX package's ``default_rng`` call order: every array
is bitwise the one ``repro.data.synthetic`` draws for the same arguments.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    name: str
    x_train: np.ndarray      # (N, H, W, C) float32 in [0, 1]
    y_train: np.ndarray      # (N,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int = 10


def make_dataset(name: str, n_train: int = 12000, n_test: int = 2000,
                 shape=(28, 28, 1), n_classes: int = 10, seed: int = 0,
                 noise: float = 0.35) -> SyntheticImageDataset:
    rng = np.random.default_rng(seed)
    H, W, C = shape
    # Smooth class templates: low-frequency random fields.
    base = rng.normal(0, 1, size=(n_classes, 8, 8, C))
    templates = np.stack([
        np.stack([np.kron(base[c, :, :, ch], np.ones((H // 8 + 1, W // 8 + 1))
                          )[:H, :W] for ch in range(C)], -1)
        for c in range(n_classes)])
    templates = (templates - templates.min()) / \
        (templates.max() - templates.min() + 1e-9)

    def sample(n):
        y = rng.integers(0, n_classes, size=n).astype(np.int32)
        x = templates[y] + rng.normal(0, noise, size=(n, H, W, C))
        # centred inputs ([-0.5, 0.5]) — plain GD converges far faster
        return (np.clip(x, 0, 1) - 0.5).astype(np.float32), y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return SyntheticImageDataset(name, x_tr, y_tr, x_te, y_te, n_classes)


DATASET_SHAPES = {
    "fashionmnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "imagenette": (32, 32, 3),
}


def token_stream(vocab: int, n_tokens: int, seed: int = 0,
                 order: int = 2) -> np.ndarray:
    """Deterministic Markov token stream (learnable structure for LM tests)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.ones(vocab) * 0.05, size=vocab)
    out = np.empty(n_tokens, np.int32)
    s = 0
    for i in range(n_tokens):
        s = rng.choice(vocab, p=trans[s])
        out[i] = s
    return out
