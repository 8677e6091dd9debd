"""Fault-tolerant checkpointing: atomic npz + JSON metadata, retention.

* Atomic: write to a temp file in the same directory, fsync, rename — a
  crash mid-save never corrupts the latest checkpoint.
* Self-describing: the tree structure is stored as key paths, so restore
  needs no template (but can validate against one).
* Retention: keep the newest `keep` checkpoints, delete older ones.
* Resume: ``latest_step()`` + ``restore()`` -> training continues where the
  failed run stopped.

The file format is the JAX package's (``repro.ckpt.checkpoint``): an
``.npz`` whose ``__meta__`` entry is a JSON blob, and one array per leaf
under its "/"-joined key path.  The port's trees are nested dicts.  Tensor
leaves are stored as numpy from ``.cpu()``, so a checkpoint written by
either package restores in the other, bit for bit.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def _items(tree, prefix: str = ""):
    """(key path, leaf) pairs of a nested dict, keys sorted as the JAX
    package orders them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str | Path, tree, step: int | None = None,
              extra: dict | None = None):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: _numpy(leaf) for k, leaf in _items(tree)}
    meta = {"step": step, "time": time.time(), "extra": extra or {},
            "keys": sorted(arrays)}
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)                      # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _rebuild(template, arrays: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(v, arrays, f"{prefix}{k}/")
                for k, v in template.items()}
    arr = arrays[prefix[:-1]]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(arr).to(device=template.device,
                                        dtype=template.dtype)
    if hasattr(template, "dtype"):
        return arr.astype(template.dtype)
    return arr


def restore_tree(path: str | Path, template=None):
    """Returns (tree_or_dict, meta).  With a template, rebuilds its
    structure, each leaf in the template leaf's dtype (and, for a tensor,
    on its device)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if template is None:
        return arrays, meta
    return _rebuild(template, arrays), meta


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 prefix: str = "ckpt"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.prefix = prefix

    def _path(self, step: int) -> Path:
        return self.dir / f"{self.prefix}_{step:08d}.npz"

    def steps(self):
        out = []
        for p in self.dir.glob(f"{self.prefix}_*.npz"):
            try:
                out.append(int(p.stem.split("_")[-1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, extra: dict | None = None):
        save_tree(self._path(step), tree, step=step, extra=extra)
        for old in self.steps()[:-self.keep]:
            self._path(old).unlink(missing_ok=True)

    def restore(self, template=None, step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return restore_tree(self._path(step), template)
