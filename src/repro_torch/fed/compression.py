"""Upload compression as a planning variable: the compression ladder.

The paper's model-size knob s (eqs 7, 11) is what compression shrinks:
compressing the client -> edge upload lowers the effective s, which the
cost model rewards with lower T_com/E_com.  :func:`compressed_bytes` gives
the on-wire size of an upload under a compression setting, and a
:class:`CompressionLadder` turns a few such settings into the per-user
levels the engine searches over jointly with the assignment (DESIGN.md
D11).

The uplink transforms themselves are here too: top-k sparsification with
error feedback (:func:`topk_compress`) and symmetric int8 quantization
(:func:`int8_quantize`, :func:`int8_dequantize`).  An update is a (nested)
dict of tensors; each leaf is compressed on its own.  ``batch_dims``
leading axes of every leaf (the users, in :mod:`repro_torch.fed.hfl`) are
independent updates, each with its own top-k threshold or int8 scale, as
the JAX package's ``vmap`` over users gives.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.cnn import tree_map as _tree_map


def _per_update(x: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """``x`` as (updates, entries): the leading ``batch_dims`` axes are
    the updates."""
    return x.reshape(int(np.prod(x.shape[:batch_dims])), -1)


def topk_mask(u: torch.Tensor, frac: float, batch_dims: int = 0):
    """1 where ``|u| >= sort(|u|)[-k]``, k = max(1, ceil(size * frac)), per
    update; ties at the threshold keep more than k entries."""
    flat = _per_update(u, batch_dims).abs()
    k = max(1, int(np.ceil(flat.shape[1] * frac)))
    thresh = torch.sort(flat, dim=-1).values[:, -k]
    thresh = thresh.reshape(u.shape[:batch_dims] + (1,) * (u.ndim
                                                           - batch_dims))
    return (u.abs() >= thresh).to(u.dtype)


class TopKState(NamedTuple):
    error: dict          # per-leaf error-feedback residual


def topk_init(params) -> TopKState:
    return TopKState(error=_tree_map(torch.zeros_like, params))


def topk_compress(update, state: TopKState, frac: float = 0.05):
    """Keep the top `frac` fraction of entries per leaf (error feedback)."""
    def one(u, e):
        u = u + e
        kept = u * topk_mask(u, frac)
        return kept, u - kept

    pairs = _tree_map(one, update, state.error)
    return (_tree_map(lambda pair: pair[0], pairs),
            TopKState(error=_tree_map(lambda pair: pair[1], pairs)))


def int8_quantize(update, batch_dims: int = 0):
    """Symmetric int8 quantization per leaf (and per update); returns
    (q, scales).  The scale is ``max(max|u|, 1e-12) / 127``; u / scale
    rounds half to even and is clipped to +-127."""
    def scale(u):
        amax = _per_update(u, batch_dims).abs().amax(dim=-1)
        # A tensor divisor: CUDA divides by a Python scalar as a multiply
        # by its reciprocal, which can miss the quotient's last bit.
        s = torch.clamp_min(amax, 1e-12) / amax.new_tensor(127.0)
        return s.reshape(u.shape[:batch_dims])

    scales = _tree_map(scale, update)
    q = _tree_map(
        lambda u, s: torch.clamp(torch.round(u / _bcast(s, u)), -127,
                                 127).to(torch.int8), update, scales)
    return q, scales


def int8_dequantize(q, scales):
    return _tree_map(lambda qi, s: qi.to(torch.float32) * _bcast(s, qi),
                     q, scales)


def _bcast(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return s.reshape(s.shape + (1,) * (like.ndim - s.ndim))


def _leaves(params) -> list:
    """The arrays of an update: one array or tensor, or a (nested) list,
    tuple or dict of them."""
    if isinstance(params, dict):
        return [x for v in params.values() for x in _leaves(v)]
    if isinstance(params, (list, tuple)):
        return [x for v in params for x in _leaves(v)]
    return [params]


def compressed_bytes(params, *, topk_frac: float | None = None,
                     int8: bool = False) -> int:
    """On-wire bytes of one model/update upload under a compression config.

    Top-k is accounted per leaf with the kept count ``max(1, ceil(size *
    frac))`` that top-k compression transmits, so the bill matches the
    wire even at ``topk_frac`` 0.0 (one entry a leaf) and 1.0 (every
    entry).
    """
    if topk_frac is not None and not 0.0 <= topk_frac <= 1.0:
        raise ValueError(f"topk_frac must be in [0, 1], got {topk_frac}")
    sizes = [int(np.prod(tuple(leaf.shape))) for leaf in _leaves(params)]
    if topk_frac is not None:
        # value (1 B with int8, else 4 B) + index (4 B) per kept entry
        per = (1 if int8 else 4) + 4
        return sum(max(1, int(np.ceil(n * topk_frac))) for n in sizes) * per
    return sum(sizes) * (1 if int8 else 4)


@dataclasses.dataclass(frozen=True)
class CompressionLevel:
    """One rung of the upload-compression ladder (DESIGN.md D11).

    ``bytes_factor`` scales the on-wire upload size (s_bits in eq 7);
    ``epoch_factor`` scales the compute bill (c_n in eqs 4-5) for the
    extra local epochs a lossier update needs to reach the same accuracy.
    Level 0 of any ladder must be the identity (1.0, 1.0).
    """

    name: str
    bytes_factor: float
    epoch_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class CompressionLadder:
    """Hashable, ordered set of compression levels."""

    levels: tuple = (CompressionLevel("none", 1.0, 1.0),)

    def __post_init__(self):
        if not self.levels:
            raise ValueError("CompressionLadder needs at least one level")
        lv0 = self.levels[0]
        if lv0.bytes_factor != 1.0 or lv0.epoch_factor != 1.0:
            raise ValueError("ladder level 0 must be the identity "
                             "(bytes_factor == epoch_factor == 1.0)")
        for lv in self.levels:
            if not 0.0 < lv.bytes_factor <= 1.0:
                raise ValueError(f"level {lv.name!r}: bytes_factor must be "
                                 f"in (0, 1], got {lv.bytes_factor}")
            if not lv.epoch_factor >= 1.0:
                raise ValueError(f"level {lv.name!r}: epoch_factor must be "
                                 f">= 1.0, got {lv.epoch_factor}")

    def __len__(self) -> int:
        return len(self.levels)

    def bytes_factors(self) -> tuple:
        return tuple(lv.bytes_factor for lv in self.levels)

    def epoch_factors(self) -> tuple:
        return tuple(lv.epoch_factor for lv in self.levels)


def _bytes_factor(topk_frac, int8, n: int = 1_000_000) -> float:
    """Exact on-wire shrink factor per :func:`compressed_bytes`."""
    ref = np.zeros(n, dtype=np.float32)
    return (compressed_bytes(ref, topk_frac=topk_frac, int8=int8)
            / compressed_bytes(ref))


def default_ladder(topk_frac: float = 0.05) -> CompressionLadder:
    """none -> int8 -> top-k+int8, factors priced by `compressed_bytes`.

    Epoch factors follow the error-feedback convergence penalty reported
    for these schemes: int8 is near-lossless (~5% extra epochs), aggressive
    top-k costs ~30% extra local work to reach the same accuracy.
    """
    return CompressionLadder(levels=(
        CompressionLevel("none", 1.0, 1.0),
        CompressionLevel("int8", _bytes_factor(None, True), 1.05),
        CompressionLevel(f"topk{topk_frac:g}+int8",
                         _bytes_factor(topk_frac, True), 1.3),
    ))
