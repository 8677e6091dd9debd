"""Assigned input-shape sets and abstract input specs for every step kind
(the JAX package's ``configs/shapes.py``).

LM transformer shapes are seq_len x global_batch.  ``decode_*`` / ``long_*``
run ``serve_step`` (one new token against a KV cache of seq_len), NOT
``train_step``; ``prefill_*`` runs the full-sequence prefill;
``long_500k`` requires a sub-quadratic arch (cfg.subquadratic).  The
abstract inputs are ``meta`` tensors: shapes and dtypes, no storage.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as tf


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def applicable(cfg: tf.ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable cell; else the skip reason."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch; 500k ctx needs sub-quadratic"
    return True, ""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: tf.ArchConfig, shape: ShapeSpec):
    """Abstract (``meta``) inputs for the step of `shape.kind`."""
    B, T = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            batch = {"tokens": _meta((B, T), i32)}
        elif cfg.input_mode == "embeds":
            batch = {"embeds": _meta((B, T, cfg.d_model), bf16)}
            if shape.kind == "train":
                batch["labels"] = _meta((B, T), i32)
        else:  # mixed (VLM): patch prefix + text
            batch = {"tokens": _meta((B, T - cfg.n_patches), i32),
                     "patches": _meta((B, cfg.n_patches, cfg.d_model),
                                      bf16)}
        if shape.kind == "train" and cfg.family == "encoder" \
                and "labels" not in batch:
            batch["labels"] = _meta((B, T), i32)
        return batch
    # decode
    return {"cache": tf.abstract_cache(cfg, B, T),
            "tokens": _meta((B, 1), i32)}


def batch_logical_axes(cfg: tf.ArchConfig, shape: ShapeSpec):
    """Logical sharding axes mirroring batch_specs."""
    if shape.kind in ("train", "prefill"):
        axes = {}
        if cfg.input_mode == "tokens":
            axes["tokens"] = ("batch", "seq")
        elif cfg.input_mode == "embeds":
            axes["embeds"] = ("batch", "seq", None)
            if shape.kind == "train":
                axes["labels"] = ("batch", "seq")
        else:
            axes["tokens"] = ("batch", "seq")
            axes["patches"] = ("batch", None, None)
        if shape.kind == "train" and cfg.family == "encoder" \
                and "labels" not in axes:
            axes["labels"] = ("batch", "seq")
        return axes
    return {"cache": tf.cache_logical_axes(cfg),
            "tokens": ("kv_batch", None)}
