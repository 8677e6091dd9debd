"""The architecture zoo: config, parameters, forward pass, decode caches,
the loss and the serving and training steps (the JAX package's
``models/transformer.py``).

``ArchConfig`` describes every architecture of the registry, and every
family and input mode runs here: ``dense``, ``moe``, ``mamba_hybrid``,
``xlstm`` and ``encoder`` (layer-norm blocks with biases, a GELU MLP,
non-causal attention; no decode), on ``tokens``, ``embeds`` (frame
embeddings through ``in_proj``) or ``mixed`` input (patch embeddings
prepended to the token embeddings, with a loss mask that is False on the
patches).  Parameters are nested dicts of tensors whose layer weights are
stacked along a leading axis, as in the JAX package; the layer stack is a
Python loop over that axis.  A moe block's FFN is
:func:`repro_torch.models.moe.moe_ffn`; ``forward`` returns its
load-balance loss summed over the layers.  The hybrid family (zamba2) runs
groups of ``attn_every`` Mamba2 layers, each group followed by one shared
attention block (sliding window ``cfg.window``) and one shared SwiGLU, then
the tail's Mamba2 layers; the xlstm family runs mLSTM/sLSTM pairs
(:mod:`repro_torch.models.ssm`).

``loss_fn`` and ``make_train_step`` train every family on
``torch.autograd``.  In a training forward with grad mode on and
``cfg.remat``, each layer (each group for the hybrid, each pair for xlstm)
runs under ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``:
less memory, the same numbers.  K4 has no backward, so a training step on
``attn_impl="pallas"`` raises (:func:`repro_torch.kernels.ops.
flash_attention`); the reference trains on the chunked route.

``forward(mode="prefill")`` returns the reference's prefill cache, whose
layout the reference's ``decode_step`` cannot read for the hybrid and
xlstm families; :func:`prefill_cache_to_decode` re-lays it, and
``make_prefill_step`` returns the decode layout (ROADMAP queue 3).

``decode_step`` writes the new key and value into the cache's ring buffer
in place, and the recurrent states into theirs, and returns the same
tensors with ``pos + 1``: the JAX package's update is functional, and
copying a cache of L x B x S x Hkv x hd per token would buy nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_lib
from repro_torch.runtime import sharding as sh
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.cnn import tree_leaves, tree_unflatten
from repro_torch.models.layers import (apply_rope, attention, gelu_mlp,
                                       layer_norm, rms_norm, swiglu)


# ============================================================== config
@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | mamba_hybrid | xlstm | encoder
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch_groups: int = 1
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    attn_every: int = 6
    window: Optional[int] = None
    # modality frontends (audio/vlm): inputs are precomputed embeddings
    input_mode: str = "tokens"     # tokens | embeds | mixed
    n_patches: int = 256
    causal: bool = True
    has_decode: bool = True
    subquadratic: bool = False
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    attn_impl: str = "chunked"     # chunked | dense | pallas (K4)
    kv_chunk: int = 1024
    remat: bool = True
    optimizer: str = "adamw"
    # bookkeeping
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def reduced(self, n_layers=2, d_model=128, n_heads=4, n_kv_heads=None,
                d_ff=256, vocab=512, n_experts=None, ssm_state=None):
        """Tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads or max(1, n_heads // 2), d_ff=d_ff,
            vocab=vocab,
            n_experts=(min(self.n_experts, 8) if n_experts is None
                       else n_experts),
            top_k=min(self.top_k, 2) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=(min(self.ssm_state, 16) if ssm_state is None
                       else ssm_state),
            ssm_headdim=16, n_patches=min(self.n_patches, 8), attn_every=2,
            window=min(self.window, 64) if self.window else None,
            dtype=torch.float32, kv_chunk=64)


class ParamDef(NamedTuple):
    shape: tuple
    axes: tuple                    # logical axis names (len == len(shape))
    dtype: Any = None              # None -> cfg.dtype
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)


def _attn_defs(cfg: ArchConfig, L: Optional[int]):
    """Attention block defs; L=None means unstacked (the hybrid's shared
    block)."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if L:
        st = lambda s, a: ParamDef((L,) + s, ("layers",) + a)  # noqa: E731
    else:
        st = lambda s, a: ParamDef(s, a)  # noqa: E731
    defs = {
        "ln": st((d,), ("d_model",)),
        "wq": st((d, H * hd), ("d_model", "qkv")),
        "wk": st((d, Hkv * hd), ("d_model", "qkv")),
        "wv": st((d, Hkv * hd), ("d_model", "qkv")),
        "wo": st((H * hd, d), ("qkv", "d_model")),
    }
    if cfg.family == "encoder":
        defs["ln_b"] = st((d,), ("d_model",))
    if cfg.qkv_bias:
        defs["bq"] = st((H * hd,), ("qkv",))
        defs["bk"] = st((Hkv * hd,), ("qkv",))
        defs["bv"] = st((Hkv * hd,), ("qkv",))
    return defs


def _mlp_defs(cfg: ArchConfig, L: int):
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.family == "encoder":             # GELU MLP with biases
        return {
            "ln": ParamDef((L, d), ("layers", "d_model")),
            "ln_b": ParamDef((L, d), ("layers", "d_model")),
            "w_in": ParamDef((L, d, ff), ("layers", "d_model", "ff")),
            "b_in": ParamDef((L, ff), ("layers", "ff")),
            "w_out": ParamDef((L, ff, d), ("layers", "ff", "d_model")),
            "b_out": ParamDef((L, d), ("layers", "d_model")),
        }
    return {
        "ln": ParamDef((L, d), ("layers", "d_model")),
        "w_gate": ParamDef((L, d, ff), ("layers", "d_model", "ff")),
        "w_up": ParamDef((L, d, ff), ("layers", "d_model", "ff")),
        "w_down": ParamDef((L, ff, d), ("layers", "ff", "d_model")),
    }


def _moe_defs(cfg: ArchConfig, L: int):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    defs = {
        "ln": ParamDef((L, d), ("layers", "d_model")),
        "router": ParamDef((L, d, E), ("layers", "d_model", None)),
        "w_gate": ParamDef((L, E, d, ff), ("layers", "expert", "d_model",
                                           None)),
        "w_up": ParamDef((L, E, d, ff), ("layers", "expert", "d_model",
                                         None)),
        "w_down": ParamDef((L, E, ff, d), ("layers", "expert", None,
                                           "d_model")),
    }
    if cfg.n_shared_experts:
        fs = ff * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((L, d, fs), ("layers", "d_model", "ff")),
            "w_up": ParamDef((L, d, fs), ("layers", "d_model", "ff")),
            "w_down": ParamDef((L, fs, d), ("layers", "ff", "d_model")),
        }
    return defs


def _mamba_defs(cfg: ArchConfig, L: int):
    d, ds = cfg.d_model, cfg.ssm_state
    d_inner, n_heads = ssm_lib.mamba2_dims(d, ds, cfg.ssm_headdim)
    d_in_proj = 2 * d_inner + 2 * ds + n_heads
    f32 = torch.float32
    return {
        "ln": ParamDef((L, d), ("layers", "d_model")),
        "in_proj": ParamDef((L, d, d_in_proj), ("layers", "d_model", None)),
        "conv_w": ParamDef((L, ssm_lib.CONV_W, d_inner + 2 * ds),
                           ("layers", None, "ff"), scale=0.5),
        "A_log": ParamDef((L, n_heads), ("layers", None), f32),
        "D": ParamDef((L, n_heads), ("layers", None), f32),
        "dt_bias": ParamDef((L, n_heads), ("layers", None), f32),
        "out_proj": ParamDef((L, d_inner, d), ("layers", "ff", "d_model")),
    }


def _xlstm_defs(cfg: ArchConfig, L: int):
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    mk = lambda: ParamDef((L, d, d), ("layers", "d_model", "qkv"))  # noqa
    rk = lambda: ParamDef((L, H, hd, hd),  # noqa: E731
                          ("layers", "heads", None, None))
    return {
        "m": {  # mLSTM blocks
            "ln": ParamDef((L, d), ("layers", "d_model")),
            "wq": mk(), "wk": mk(), "wv": mk(), "wo": mk(),
            "wi": ParamDef((L, d, H), ("layers", "d_model", None)),
            "wf": ParamDef((L, d, H), ("layers", "d_model", None)),
        },
        "s": {  # sLSTM blocks
            "ln": ParamDef((L, d), ("layers", "d_model")),
            "wz": mk(), "wi": mk(), "wf": mk(), "wo": mk(),
            "rz": rk(), "ri": rk(), "rf": rk(), "ro": rk(),
            "w_out": mk(),
        },
    }


def _ffn_key(cfg: ArchConfig) -> str:
    return "moe" if cfg.family == "moe" else "mlp"


def param_defs(cfg: ArchConfig):
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    defs: dict = {"final_ln": ParamDef((d,), ("d_model",))}
    if cfg.input_mode in ("tokens", "mixed"):
        defs["embed"] = ParamDef((V, d), ("vocab", "d_model"),
                                 scale=d ** -0.5)
    if cfg.input_mode == "embeds":
        defs["in_proj"] = ParamDef((d, d), ("d_model", None))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("d_model", "vocab"))
    if cfg.family == "encoder":
        defs["final_ln_b"] = ParamDef((d,), ("d_model",))
    if cfg.family == "mamba_hybrid":
        defs["blocks"] = {"mamba": _mamba_defs(cfg, L)}
        defs["shared_attn"] = _attn_defs(cfg, None)      # one shared block
        if cfg.d_ff:                                     # zamba2 shared MLP
            defs["shared_mlp"] = {
                "ln": ParamDef((d,), ("d_model",)),
                "w_gate": ParamDef((d, cfg.d_ff), ("d_model", "ff")),
                "w_up": ParamDef((d, cfg.d_ff), ("d_model", "ff")),
                "w_down": ParamDef((cfg.d_ff, d), ("ff", "d_model")),
            }
    elif cfg.family == "xlstm":
        if L % 2:
            raise ValueError(f"the xlstm family stacks m/s pairs: n_layers "
                             f"must be even, got {L}")
        defs["blocks"] = _xlstm_defs(cfg, L // 2)
    elif cfg.family in ("dense", "moe", "encoder"):
        ffn = _moe_defs(cfg, L) if cfg.family == "moe" else _mlp_defs(cfg, L)
        defs["blocks"] = {"attn": _attn_defs(cfg, L), _ffn_key(cfg): ffn}
    else:
        raise ValueError(cfg.family)
    return defs


# -------------------------------------------------- materializations
_ONES_NAMES = {"ln", "final_ln", "D"}          # norm scales / skip gains
_ZEROS_NAMES = {"ln_b", "final_ln_b", "A_log", "dt_bias",
                "bq", "bk", "bv", "b_in", "b_out"}


def _map_defs(defs, fn, name=""):
    """``fn(name, leaf)`` over a nested dict, keys in sorted order (the
    JAX package's pytree order)."""
    if isinstance(defs, dict):
        return {k: _map_defs(defs[k], fn, k) for k in sorted(defs)}
    return fn(name, defs)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda"):
    """Random parameters with the JAX package's distribution: ones for norm
    scales, zeros for biases, else normal x 1/sqrt(fan_in) (or the def's
    scale), drawn from ``generator`` (on ``device``) in pytree order.  The
    draws are not the JAX package's bits.  Each leaf is drawn in place in
    its own type, so a bfloat16 stack (llama4-scout's experts: 16 GB at
    12 layers) never has a float32 copy."""
    def draw(name, d):
        dtype = d.dtype or cfg.dtype
        if name in _ONES_NAMES:
            return torch.ones(d.shape, dtype=dtype, device=device)
        if name in _ZEROS_NAMES:
            return torch.zeros(d.shape, dtype=dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else 1.0 / np.sqrt(fan_in)
        return torch.empty(d.shape, dtype=dtype, device=device).normal_(
            0.0, float(scale), generator=generator)

    return _map_defs(param_defs(cfg), draw)


def params_from_numpy(tree, cfg: ArchConfig, device="cuda"):
    """The JAX package's parameter dict, with numpy leaves, as the port's
    tensors in ``cfg.dtype`` (bfloat16 numpy leaves are widened to f32
    first, which is exact).  Shapes are checked against ``param_defs``;
    tied embeddings stay one tensor."""
    def walk(defs, node, where):
        out = {}
        for k in sorted(defs):
            if k not in node:
                raise KeyError(f"parameter {where}{k} is missing")
            if isinstance(defs[k], dict):
                out[k] = walk(defs[k], node[k], f"{where}{k}/")
                continue
            x = np.asarray(node[k])
            if x.shape != tuple(defs[k].shape):
                raise ValueError(f"parameter {where}{k} has shape {x.shape}, "
                                 f"expected {defs[k].shape}")
            if x.dtype.name == "bfloat16":
                x = x.astype(np.float32)
            out[k] = torch.tensor(x, device=device).to(
                defs[k].dtype or cfg.dtype)
        return out

    return walk(param_defs(cfg), tree, "")


def _meta(d, dtype):
    return torch.empty(d.shape, dtype=d.dtype or dtype, device="meta")


def abstract_params(cfg: ArchConfig):
    """The parameters as ``meta`` tensors: shapes and dtypes, no storage."""
    return _map_defs(param_defs(cfg), lambda _, d: _meta(d, cfg.dtype))


def logical_axes(cfg: ArchConfig):
    """The parameters' logical sharding axes, one tuple a leaf."""
    return _map_defs(param_defs(cfg), lambda _, d: d.axes)


# ================================================================ sharding
# The identity sharder (no mesh); :func:`repro_torch.runtime.sharding.
# make_sharder` gives one of a mesh.
_identity_shard = sh.IDENTITY

# The logical axes of one layer's K/V decode cache (``cache_defs``): the
# dense and moe caches and the hybrid's shared-attention ring.
_KV_AXES = ("kv_batch", "kv_seq", None, None)
_RING_AXES = ("kv_batch", None, None, None)


def _split_heads(shard, x, n: int, hd: int, *axes):
    """(B, T, n * hd) -> (B, T, n, hd) placed by the logical ``axes`` (the
    reference reshapes, then constrains).  On a mesh the flat dim is placed
    first, by the head axis when its mesh axes divide the n heads and
    replicated otherwise: DTensor cannot unflatten a dim whose shards do
    not fall on head boundaries."""
    B, T = x.shape[:2]
    if shard.mesh is None:
        return x.reshape(B, T, n, hd)
    x = shard(x, axes[0], axes[1], _head_axis(shard, axes[2], n))
    return shard(x.reshape(B, T, n, hd), *axes)


def _cache_attention(q, k_buf, v_buf, n_valid):
    """Decode attention of q (B, T, H, hd) over a ring buffer (B, S, Hkv,
    hd) holding ``n_valid`` entries: GQA-aware grouped einsums, no head
    repeat over the cache."""
    B, T, H, hd = q.shape
    S, Hkv = k_buf.shape[1], k_buf.shape[2]
    mask = torch.arange(S, device=q.device) < n_valid          # (S,)
    scale = hd ** -0.5
    qg = q.reshape(B, T, Hkv, H // Hkv, hd)
    s = torch.einsum("bqgrd,bsgd->bgrqs", qg, k_buf.to(qg.dtype)) * scale
    s = torch.where(mask, s.float(), -1e30)
    w = torch.softmax(s, dim=-1).to(qg.dtype)
    out = torch.einsum("bgrqs,bsgd->bqgrd", w, v_buf.to(qg.dtype))
    return out.reshape(B, T, H, hd)


def _per_cache_shard(shard, q, k_buf, v_buf, n_valid, kv_axes):
    """:func:`_cache_attention`; on a mesh whose cache (placed by
    ``kv_axes``) keeps its sequence whole, each device runs it on its
    batch shard (q placed like the cache); with the sequence split
    (``kv_seq``), on DTensors, q's heads first placed so that DTensor can
    regroup them."""
    if shard.mesh is None:
        return _cache_attention(q, k_buf, v_buf, n_valid)
    if shard.rules.spec(kv_axes[1:2], shard.mesh, k_buf.shape[1:2])[0]:
        q = shard(q, "batch", None, _head_axis(shard, "heads",
                                               k_buf.shape[2]), None)
        return _cache_attention(q, k_buf, v_buf, n_valid)
    qa = kv_axes[:1] + (None,) * 3
    return shard.local(lambda *a: _cache_attention(*a).contiguous(),
                       (qa, kv_axes, kv_axes, ()), (qa,))(
        q, k_buf, v_buf, n_valid)


def _ring_write(shard, buf, idx, new, kv_axes):
    """``buf[:, idx] = new`` in place (the decode cache's ring buffer).  On
    a mesh each device writes into its own shard of ``buf`` (DTensor has
    no rule for ``index_copy_``; ``decode_step`` has placed the cache by
    ``kv_axes``, so the local shard is the cache's own): ``new`` placed
    like ``buf`` but whole along the sequence; where the sequence is split
    (``kv_seq``), a position outside this device's slice writes its old
    value back."""
    if shard.mesh is None:
        buf.index_copy_(1, idx, new.to(buf.dtype))
        return
    part, _ = shard.index(kv_axes, buf.shape, 1)

    def write(loc, src, idx):
        S = loc.shape[1]
        at = idx - part * S
        inside = ((at >= 0) & (at < S))[None, :, None, None]
        at = torch.clamp(at, 0, S - 1)
        loc.index_copy_(1, at, torch.where(inside, src.to(loc.dtype),
                                           loc.index_select(1, at)))

    whole = kv_axes[:1] + (None,) + kv_axes[2:]
    shard.local(write, (kv_axes, whole, ()), ())(buf, new, idx)


def _per_head(shard, fn, q, k, v):
    """``fn(q, k, v)`` for (B, T, H, hd) operands with H heads alike; on a
    mesh each device runs it on its (batch, heads) block of plain tensors:
    attention is independent across both, and its chunk loop then runs on
    plain tensors (DTensor's sharding propagation of the 4-D einsums costs
    seconds a shape).  The heads split over their mesh axes even when
    those do not divide them (at 40 heads over 16, three a device, as JAX
    pads them)."""
    if shard.mesh is None:
        return fn(q, k, v)
    ax = ("batch", None, "heads", None)
    out = shard.local(lambda *a: fn(*a).contiguous(), (ax,) * 3, (ax,),
                      uneven=("heads",))(q, k, v)
    # back to an even layout: DTensor flattens no uneven shard
    return shard(out, "batch", None, _head_axis(shard, "heads", q.shape[2]),
                 None)


def _head_axis(shard, axis, n: int):
    """The logical ``axis`` when its mesh axes divide ``n`` heads (or there
    is no mesh), else None."""
    if axis is None or shard.mesh is None:
        return axis
    return axis if shard.rules.spec((axis,), shard.mesh, (n,))[0] else None


# ================================================================ forward
def _attn_apply(cfg: ArchConfig, p, x, *, positions, kv_cache=None,
                cache_pos=None, window=None, causal=True,
                shard=_identity_shard, kv_axes=_KV_AXES):
    """One attention application; ``p`` holds one layer's weights.

    Train/prefill: kv_cache is None -> attends within x, returns (out, (k, v)).
    Decode: kv_cache = (k_buf (B,S,Hkv,hd), v_buf) ring buffer, written in
    place, its logical axes ``kv_axes``; cache_pos (a 0-d tensor) is the
    number of tokens already in context; returns (out, (k_buf, v_buf)).
    """
    B, T, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln"]) if "ln_b" not in p else \
        layer_norm(x, p["ln"], p["ln_b"])
    q = h @ p["wq"] + (p["bq"] if "bq" in p else 0.0)
    k = h @ p["wk"] + (p["bk"] if "bk" in p else 0.0)
    v = h @ p["wv"] + (p["bv"] if "bv" in p else 0.0)
    q = _split_heads(shard, q, H, hd, "batch", "seq", "heads", None)
    # kv heads (often < TP degree) are pinned batch-sharded/replicated, as
    # in the reference.
    k = _split_heads(shard, k, Hkv, hd, "batch", None, None, None)
    v = _split_heads(shard, v, Hkv, hd, "batch", None, None, None)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ka, va = k, v
    if shard.mesh is not None and Hkv != H and kv_cache is None:
        # On a mesh the GQA repeat comes first, placed like q: the
        # backward of the repeat must meet its gradient with the kv heads
        # whole, and DTensor cannot regroup heads sharded over the mesh.
        heads = _head_axis(shard, "heads", H)
        ka, va = (shard(torch.repeat_interleave(t, H // Hkv, dim=2),
                        "batch", None, heads, None) for t in (k, v))

    if kv_cache is None:
        out = _per_head(shard, lambda q, k, v: attention(
            q, k, v, causal=causal, q_offset=0, window=window,
            impl=cfg.attn_impl, kv_chunk=cfg.kv_chunk), q, ka, va)
        new_kv = (k, v)
    else:
        k_buf, v_buf = kv_cache
        S = k_buf.shape[1]
        # lax.dynamic_update_slice clamps the start so the update fits.
        start = torch.clamp(cache_pos % S, max=S - T)
        idx = start + torch.arange(T, device=x.device)
        _ring_write(shard, k_buf, idx, k, kv_axes)
        _ring_write(shard, v_buf, idx, v, kv_axes)
        # Validity: ring buffer holds min(cache_pos+1, S) entries.
        n_valid = torch.clamp(cache_pos + 1, max=S)
        out = _per_cache_shard(shard, q, k_buf, v_buf, n_valid, kv_axes)
        new_kv = (k_buf, v_buf)
    # placed as attention left it, so that the reshape's backward meets
    # its gradient in the same layout (the identity off a mesh)
    out = shard(out.reshape(B, T, H * hd), "batch", "seq",
                _head_axis(shard, "heads", H))
    # the constraint sits on the row-parallel product (Megatron-SP when
    # resid_seq is sharded), as in the reference
    return x + shard(out @ p["wo"], "batch", "resid_seq", None), new_kv


def _ffn_apply(cfg: ArchConfig, p, x, shard=_identity_shard):
    """Dense (SwiGLU / GELU) or MoE FFN with residual; returns (x, aux)."""
    aux = 0.0
    if "b_in" in p:                                   # encoder GELU MLP
        h = layer_norm(x, p["ln"], p["ln_b"])
        y = gelu_mlp(h, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
    elif "router" in p:
        y, aux = moe_lib.moe_ffn(p, rms_norm(x, p["ln"]), top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dispatch_groups=cfg.moe_dispatch_groups,
                                 shard=shard)
    else:
        h = rms_norm(x, p["ln"])
        y = swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
    return x + shard(y, "batch", "resid_seq", None), aux


def _layers(stacked: dict) -> list:
    """Every layer of a stacked block (nested dicts such as moe's
    ``shared`` included), from one ``unbind`` a leaf: under autograd each
    leaf's gradient is then one stack, where indexing layer by layer would
    add a zero-filled gradient of the whole stack for every layer."""
    parts = {k: _layers(t) if isinstance(t, dict) else t.unbind(0)
             for k, t in stacked.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


# ---------------------------------------------------------------- embed
def embed_inputs(cfg: ArchConfig, params, batch, shard=_identity_shard):
    """Returns (x (B,T,d), positions (B,T), loss_mask (B,T) or None).

    ``tokens``: ``batch["tokens"]`` (B, T) through the embedding.
    ``embeds``: ``batch["embeds"]`` (B, T, d) @ ``in_proj``.  ``mixed``:
    ``batch["patches"]`` (B, P, d) followed by the embedded
    ``batch["tokens"]`` (B, T - P); the loss mask is False on the patches
    (the only mode with a mask).  On a mesh the positions are placed like
    the tokens (batch, seq), so the RoPE tables split with the heads'
    batch."""
    mask = None
    if cfg.input_mode == "tokens":
        x = _embed(params, batch["tokens"], shard).to(cfg.dtype)
    elif cfg.input_mode == "embeds":                  # audio frontend stub
        x = batch["embeds"].to(cfg.dtype) @ params["in_proj"]
    else:                                             # mixed: VLM stub
        tok = _embed(params, batch["tokens"], shard).to(cfg.dtype)
        patches = batch["patches"].to(cfg.dtype)
        x = torch.cat([patches, tok], 1)
        mask = torch.arange(x.shape[1], device=x.device) >= patches.shape[1]
        mask = mask.expand(x.shape[0], -1)
    B, T = x.shape[:2]
    pos = shard(torch.arange(T, device=x.device).expand(B, T), "batch", "seq")
    return shard(x, "batch", "seq", None), pos, mask


def _embed(params, tokens, shard=_identity_shard):
    """The embedding rows of ``tokens``.  On a mesh the table is gathered
    over the vocab first (``F.embedding`` of a vocab-sharded DTensor leaves
    a masked partial sum that DTensor cannot reduce on ``meta`` shards)."""
    if shard.mesh is None:
        return params["embed"][tokens]
    return F.embedding(tokens, shard(params["embed"], None, "d_model"))


def unembed(cfg: ArchConfig, params, x, shard=_identity_shard):
    x = rms_norm(x, params["final_ln"]) if "final_ln_b" not in params else \
        layer_norm(x, params["final_ln"], params["final_ln_b"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return shard(x @ head.to(x.dtype), "batch", "seq", "vocab")


# ------------------------------------------------------------ stacks
def _remat(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``on`` (the
    reference's ``jax.checkpoint`` of a training block): its activations
    are recomputed in the backward pass instead of kept."""
    return checkpoint(fn, *args, use_reentrant=False) if on else fn(*args)


def _backbone(cfg: ArchConfig, params, batch, want_cache: bool,
              train: bool = False, shard=_identity_shard):
    """(x, cache, loss_mask, aux); ``train`` remats each layer when grad
    mode is on and ``cfg.remat``."""
    x, positions, loss_mask = embed_inputs(cfg, params, batch, shard)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = train and cfg.remat and torch.is_grad_enabled()
    if cfg.family == "mamba_hybrid":
        x, cache = _hybrid_forward(cfg, params, x, positions, want_cache,
                                   remat, shard)
        return x, cache, loss_mask, aux
    if cfg.family == "xlstm":
        x, cache = _xlstm_forward(cfg, params, x, want_cache, remat, shard)
        return x, cache, loss_mask, aux
    blocks, ffn = params["blocks"], _ffn_key(cfg)
    ks, vs = [], []

    def block(x, pa, pf):
        x, kv = _attn_apply(cfg, pa, x, positions=positions,
                            causal=cfg.causal, window=cfg.window,
                            shard=shard)
        # the residual stream: with resid_seq=('model',) this is
        # Megatron-SP, as in the reference
        x = shard(x, "batch", "resid_seq", None)
        x, a = _ffn_apply(cfg, pf, x, shard)
        return shard(x, "batch", "resid_seq", None), a, kv

    for pa, pf in zip(_layers(blocks["attn"]), _layers(blocks[ffn])):
        x, a, (k, v) = _remat(remat, block, x, pa, pf)
        aux = aux + a
        if want_cache:
            ks.append(k)
            vs.append(v)
    cache = None
    if want_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": _pos(x.shape[1], x.device)}
    return x, cache, loss_mask, aux


def _pos(n: int, device) -> torch.Tensor:
    return torch.full((), n, dtype=torch.int32, device=device)


def _per_batch(shard, scan, p, x, state, n_state: int):
    """``scan(p, x, state) -> (y, state)``; on a mesh each device runs it
    on its shard of the batch, the weights gathered whole: the recurrences
    are independent across the batch, their time loops then run on plain
    tensors, and DTensor has no sharding rule for the causal conv's
    ``unfold``.  ``state`` is None or a tuple of ``n_state`` tensors,
    batch first."""
    if shard.mesh is None:
        return scan(p, x, state)
    names = sorted(p)
    state = tuple(state or ())

    def fn(*a):
        y, new = scan(dict(zip(names, a[:len(names)])), a[len(names)],
                      a[len(names) + 1:] or None)
        return (y, *new)

    b = ("batch",)
    out = shard.local(fn, ((),) * len(names) + (b,) * (1 + len(state)),
                      (b,) * (1 + n_state))(*(p[k] for k in names), x,
                                            *state)
    return out[0], tuple(out[1:])


def _mamba_apply(cfg: ArchConfig, p, x, state=None, conv_state=None,
                 shard=_identity_shard):
    """One Mamba2 layer with its residual; ``p`` holds one layer's weights.
    Returns (x, (ssm, conv))."""
    def scan(q, h, st):
        s, cs = st or (state, conv_state)
        return ssm_lib.mamba2_scan(q, h, cfg.ssm_state, cfg.ssm_headdim,
                                   state=s, conv_state=cs)

    with record_function("hybrid.mamba"):
        st = None if state is None else (state, conv_state)
        y, st = _per_batch(shard, scan, p, rms_norm(x, p["ln"]), st, 2)
        return x + y, st


def _shared_apply(cfg: ArchConfig, params, x, *, positions, kv_cache=None,
                  cache_pos=None, shard=_identity_shard):
    """The hybrid's shared attention block (window ``cfg.window``) and
    shared SwiGLU, ending a group.  Returns (x, (k, v))."""
    with record_function("hybrid.shared"):
        x, kv = _attn_apply(cfg, params["shared_attn"], x,
                            positions=positions, kv_cache=kv_cache,
                            cache_pos=cache_pos, window=cfg.window,
                            shard=shard, kv_axes=_RING_AXES)
        if "shared_mlp" in params:
            x, _ = _ffn_apply(cfg, params["shared_mlp"], x, shard)
        return x, kv


def _group_ends(cfg: ArchConfig) -> dict:
    """{layer index: group} for the Mamba2 layers that the shared block
    follows: the last of each of the L // attn_every full groups."""
    every = cfg.attn_every
    return {g * every + every - 1: g for g in range(cfg.n_layers // every)}


def _hybrid_forward(cfg: ArchConfig, params, x, positions, want_cache,
                    remat=False, shard=_identity_shard):
    """Groups of ``attn_every`` Mamba2 layers, each followed by the shared
    block, then the tail.  The cache is the reference's prefill layout:
    ``groups`` (ssm, conv) stacked (G, attn_every, ...), ``attn_k``/
    ``attn_v`` (G, B, T, Hkv, hd), ``tail`` (ssm, conv) stacked (tail, ...)
    or None, ``pos``.  ``remat`` checkpoints each group and each tail
    layer."""
    mm, ends = _layers(params["blocks"]["mamba"]), _group_ends(cfg)
    every = cfg.attn_every
    ssm, conv, ks, vs = [], [], [], []

    def segment(x, first, last):
        """Layers first..last, then the shared block if ``last`` ends a
        group: (x, [(ssm, conv)], (k, v) or None)."""
        states, kv = [], None
        for i in range(first, last + 1):
            x, st = _mamba_apply(cfg, mm[i], x, shard=shard)
            states.append(st)
        if last in ends:
            x, kv = _shared_apply(cfg, params, x, positions=positions,
                                  shard=shard)
        return x, states, kv

    head = len(ends) * every
    spans = [(g * every, g * every + every - 1) for g in range(len(ends))]
    spans += [(i, i) for i in range(head, cfg.n_layers)]
    for first, last in spans:
        x, states, kv = _remat(remat, segment, x, first, last)
        if want_cache:
            if kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
            ssm.extend(s for s, _ in states)
            conv.extend(cs for _, cs in states)
    if not want_cache:
        return x, None
    G = len(ends)
    ssm, conv = torch.stack(ssm), torch.stack(conv)

    def grouped(a):
        return a[:head].reshape((G, every) + a.shape[1:])

    cache = {"groups": (grouped(ssm), grouped(conv)),
             "attn_k": torch.stack(ks), "attn_v": torch.stack(vs),
             "tail": ((ssm[head:], conv[head:]) if cfg.n_layers > head
                      else None),
             "pos": _pos(x.shape[1], x.device)}
    return x, cache


_M_KEYS = ("m_C", "m_n", "m_m")
_S_KEYS = ("s_c", "s_n", "s_m", "s_h")


def _xlstm_pair(cfg: ArchConfig, blk, x, m_state=None, s_state=None,
                shard=_identity_shard):
    """One mLSTM/sLSTM pair with their residuals: (x, m_state, s_state)."""
    bm, bs = blk["m"], blk["s"]
    y, m_state = _per_batch(
        shard, lambda q, h, st: ssm_lib.mlstm_scan(q, h, cfg.n_heads,
                                                   state=st),
        bm, rms_norm(x, bm["ln"]), m_state, 3)
    x = x + y
    y, s_state = _per_batch(
        shard, lambda q, h, st: ssm_lib.slstm_scan(q, h, cfg.n_heads,
                                                   state=st),
        bs, rms_norm(x, bs["ln"]), s_state, 4)
    return x + y, m_state, s_state


def _xlstm_forward(cfg: ArchConfig, params, x, want_cache, remat=False,
                   shard=_identity_shard):
    """The m/s pairs; the cache is the reference's prefill layout:
    ``states`` ((C, n, m), (c, n, m, h)), each stacked over the pairs, and
    ``pos``.  ``remat`` checkpoints each pair."""
    ms, ss = [], []
    for blk in _layers(params["blocks"]):
        x, m_state, s_state = _remat(
            remat, lambda x, blk: _xlstm_pair(cfg, blk, x, shard=shard), x,
            blk)
        ms.append(m_state)
        ss.append(s_state)
    if not want_cache:
        return x, None
    stack = lambda states: tuple(torch.stack(t) for t in zip(*states))  # noqa
    return x, {"states": (stack(ms), stack(ss)),
               "pos": _pos(x.shape[1], x.device)}


def forward(cfg: ArchConfig, params, batch, *, shard=_identity_shard,
            mode="train"):
    """Full-sequence forward. Returns (logits, aux, cache_out, loss_mask).

    cache_out is the prefill cache when mode='prefill' (the reference's
    layout for each family), else None; aux is the moe family's
    load-balance loss summed over the layers (0 for the other families).
    ``shard`` places activations by logical axes
    (:func:`repro_torch.runtime.sharding.make_sharder`; the identity by
    default).
    """
    with shard.spmd():
        x, cache, loss_mask, aux = _backbone(
            cfg, params, batch, mode == "prefill", mode == "train", shard)
        return unembed(cfg, params, x, shard), aux, cache, loss_mask


# ============================================================ decode
def cache_defs(cfg: ArchConfig, batch: int, context: int):
    """Decode-cache structure (shapes + logical axes) per family."""
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.family} has no decode cache")
    B, S, L = batch, context, cfg.n_layers
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    f32 = torch.float32
    if cfg.family == "mamba_hybrid":
        d_inner, H = ssm_lib.mamba2_dims(cfg.d_model, cfg.ssm_state,
                                         cfg.ssm_headdim)
        G = cfg.n_layers // cfg.attn_every
        W = min(cfg.window or S, S)
        return {
            "ssm": ParamDef((L, B, H, cfg.ssm_state, cfg.ssm_headdim),
                            ("layers", "kv_batch", "heads", None, None), f32),
            "conv": ParamDef((L, B, ssm_lib.CONV_W - 1,
                              d_inner + 2 * cfg.ssm_state),
                             ("layers", "kv_batch", None, "ff")),
            "attn_k": ParamDef((G, B, W, Hkv, hd), ("layers",) + _RING_AXES),
            "attn_v": ParamDef((G, B, W, Hkv, hd), ("layers",) + _RING_AXES),
            "pos": ParamDef((), (), torch.int32),
        }
    if cfg.family == "xlstm":
        L2, H = cfg.n_layers // 2, cfg.n_heads
        hd2 = cfg.d_model // H
        axes = ("layers", "kv_batch", "heads", None, None)
        return {
            "m_C": ParamDef((L2, B, H, hd2, hd2), axes, f32),
            "m_n": ParamDef((L2, B, H, hd2), axes[:4], f32),
            "m_m": ParamDef((L2, B, H), axes[:3], f32),
            **{k: ParamDef((L2, B, H, hd2), axes[:4], f32)
               for k in _S_KEYS},
            "pos": ParamDef((), (), torch.int32),
        }
    return {
        "k": ParamDef((L, B, S, Hkv, hd), ("layers",) + _KV_AXES),
        "v": ParamDef((L, B, S, Hkv, hd), ("layers",) + _KV_AXES),
        "pos": ParamDef((), (), torch.int32),
    }


def abstract_cache(cfg: ArchConfig, batch: int, context: int):
    """The decode cache as ``meta`` tensors (the layout of
    :func:`cache_defs`)."""
    return _map_defs(cache_defs(cfg, batch, context),
                     lambda _, d: _meta(d, cfg.dtype))


def cache_logical_axes(cfg: ArchConfig, batch: int = 1, context: int = 8):
    return _map_defs(cache_defs(cfg, batch, context), lambda _, d: d.axes)


def init_cache(cfg: ArchConfig, batch: int, context: int, filled=True,
               device="cuda"):
    """Zero cache with pos=context (mimics a fully prefilled context)."""
    c = _map_defs(cache_defs(cfg, batch, context),
                  lambda _, d: torch.zeros(d.shape, dtype=d.dtype or cfg.dtype,
                                           device=device))
    c["pos"] = torch.full((), context if filled else 0, dtype=torch.int32,
                          device=device)
    return c


def prefill_cache_to_decode(cfg: ArchConfig, cache, context=None):
    """The prefill cache of ``forward(mode="prefill")`` in the decode
    layout of :func:`cache_defs` for ``context`` positions (default: the
    prefill's T, so the first decode step evicts the oldest token of a
    ring buffer).  The dense and moe caches already have the decode
    layout; their K/V are zero-padded to ``context`` positions.

    The reference's two functions do not meet: its prefill returns
    {groups, attn_k, attn_v, tail, pos} (hybrid) and {states, pos}
    (xlstm), and its ``decode_step`` reads {ssm, conv, attn_k, attn_v,
    pos} and {m_C, m_n, m_m, s_c, s_n, s_m, s_h, pos}, so ``python -m
    repro.launch.serve --arch zamba2-7b`` stops at its first decode step
    with ``KeyError: 'ssm'`` (xlstm-125m: ``KeyError: 'm_C'``; ROADMAP
    queue 3).  The same tensors re-laid repair it: the groups' and the
    tail's Mamba2 states stack into (L, ...); the shared attention's K/V
    of the last W = min(window, context) tokens go into a ring buffer of W
    slots, token t at slot t % W, where decode writes token t next; the
    xLSTM state tuples go under the decode names.
    """
    if cfg.family == "xlstm":
        (mC, mn, mm), (sc, sn, sm, sh) = cache["states"]
        return dict(zip(_M_KEYS + _S_KEYS, (mC, mn, mm, sc, sn, sm, sh)),
                    pos=cache["pos"])
    if cfg.family != "mamba_hybrid":
        pad = 0 if context is None else context - cache["k"].shape[2]
        if pad > 0:
            cache = dict(cache, **{key: F.pad(cache[key],
                                              (0, 0, 0, 0, 0, pad))
                                   for key in ("k", "v")})
        return cache
    ssm, conv = (t.flatten(0, 1) for t in cache["groups"])
    if cache["tail"] is not None:
        ssm = torch.cat([ssm, cache["tail"][0]])
        conv = torch.cat([conv, cache["tail"][1]])
    G, B, T = cache["attn_k"].shape[:3]
    S = T if context is None else context
    W = min(cfg.window or S, S)
    out = {"ssm": ssm, "conv": conv, "pos": cache["pos"]}
    for key in ("attn_k", "attn_v"):
        # Token t to slot t % W: the last min(T, W) tokens, zero-padded
        # when fewer than W, else rotated by (T - W) % W.  Slices and a
        # cat, not an indexed write: DTensor has no sharding rule for
        # index_put_ in some PyTorch releases (2.11).
        last = cache[key][:, :, max(0, T - W):]
        s = (T - W) % W if T >= W else 0
        if T < W:
            ring = torch.cat([last, last.new_zeros(
                (G, B, W - T) + last.shape[3:])], 2)
        elif s == 0:
            ring = last.clone()
        else:
            ring = torch.cat([last[:, :, W - s:], last[:, :, :W - s]], 2)
        out[key] = ring
    return out


def decode_step(cfg: ArchConfig, params, cache, tokens, *,
                shard=_identity_shard):
    """One decode step: tokens (B, 1) int -> (logits (B,1,V), new cache).

    The cache's tensors are updated in place (see the module note).  On a
    mesh the cache is first placed by :func:`cache_logical_axes` (a no-op
    for a cache placed so, as the dry-run's; a prefill's cache leaves
    with the batch's placements), so the in-place writes land in the
    returned cache."""
    if cfg.family == "encoder":
        raise ValueError(f"{cfg.family} does not decode")
    if shard.mesh is not None:
        axes = cache_logical_axes(cfg)
        cache = {k: shard(v, *axes[k]) for k, v in cache.items()}
    with shard.spmd():
        B = tokens.shape[0]
        x = _embed(params, tokens, shard).to(cfg.dtype)
        pos = cache["pos"]
        positions = pos.expand(B, 1)
        if cfg.family == "mamba_hybrid":
            x = _hybrid_decode(cfg, params, x, positions, cache, shard)
        elif cfg.family == "xlstm":
            x = _xlstm_decode(cfg, params, x, cache, shard)
        else:
            blocks = params["blocks"]
            for i, (pa, pf) in enumerate(zip(_layers(blocks["attn"]),
                                             _layers(blocks[_ffn_key(cfg)]))):
                x, _ = _attn_apply(cfg, pa, x, positions=positions,
                                   kv_cache=(cache["k"][i], cache["v"][i]),
                                   cache_pos=pos, shard=shard)
                x, _ = _ffn_apply(cfg, pf, x, shard)
        logits = unembed(cfg, params, x, shard)
        return logits, dict(cache, pos=pos + 1)


def _hybrid_decode(cfg: ArchConfig, params, x, positions, cache,
                   shard=_identity_shard):
    ends, pos = _group_ends(cfg), cache["pos"]
    for i, p in enumerate(_layers(params["blocks"]["mamba"])):
        x, (s, cs) = _mamba_apply(cfg, p, x, cache["ssm"][i],
                                  cache["conv"][i], shard)
        cache["ssm"][i].copy_(s)
        cache["conv"][i].copy_(cs)
        if i in ends:
            g = ends[i]
            x, _ = _shared_apply(cfg, params, x, positions=positions,
                                 kv_cache=(cache["attn_k"][g],
                                           cache["attn_v"][g]),
                                 cache_pos=pos, shard=shard)
    return x


def _xlstm_decode(cfg: ArchConfig, params, x, cache, shard=_identity_shard):
    for i, blk in enumerate(_layers(params["blocks"])):
        m_state = tuple(cache[k][i] for k in _M_KEYS)
        s_state = tuple(cache[k][i] for k in _S_KEYS)
        x, m_new, s_new = _xlstm_pair(cfg, blk, x, m_state, s_state,
                                      shard)
        for key, new in zip(_M_KEYS + _S_KEYS, m_new + s_new):
            cache[key][i].copy_(new)
    return x


# ============================================================== loss/steps
def loss_fn(cfg: ArchConfig, params, batch, *, shard=_identity_shard):
    """The training loss and its parts: (loss, {"ce", "aux"}).

    Cross-entropy in float32 (the logits are cast before the logsumexp):
    against ``batch["labels"]`` at every position for the encoder and any
    non-causal model, else next-token on ``batch["tokens"]`` (for ``mixed``
    input the patches' logits are dropped first).  The moe load-balance
    loss is added with weight 0.01."""
    logits, aux, _, _ = forward(cfg, params, batch, shard=shard,
                                mode="train")
    with shard.spmd():
        logits = logits.float()
        if cfg.family == "encoder" or not cfg.causal:
            pred, gold_ids = logits, batch["labels"]
        else:
            if cfg.input_mode == "mixed":
                logits = logits[:, cfg.n_patches:]
            pred, gold_ids = logits[:, :-1], batch["tokens"][:, 1:]
        gold = _gold(pred, gold_ids, shard)
        ce = shard(_logsumexp(pred, shard) - gold, "batch", "seq").mean()
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _logsumexp(pred, shard):
    """``logsumexp`` over the vocab.  On a mesh it is written out (a max,
    then a sum of exponentials: two reductions a vocab split turns into
    all-reduces of (B, T)); DTensor's own gathers the whole vocab first."""
    if shard.mesh is None:
        return torch.logsumexp(pred, -1)
    # the placements pinned so that the backward pass meets its gradients
    # in the forward's layout (DTensor would gather the vocab for them)
    m = pred.amax(-1).detach()
    e = shard(torch.exp(pred - m[..., None]), "batch", "seq", "vocab")
    return m + torch.log(shard(e.sum(-1), "batch", "seq"))


def _gold(pred, ids, shard):
    """``pred[..., ids]``: the logit of each target.  On a mesh whose mesh
    axes split the vocab, each device gathers from its own slice of the
    vocab, zeroes the targets that lie outside it, and the result is a
    partial sum over those axes (DTensor's own masked gather fails on
    ``meta`` shards and on more than two dims)."""
    if shard.mesh is None:
        return torch.gather(pred, -1, ids[..., None].long())[..., 0]
    ax = ("batch", "seq", "vocab")
    part, _ = shard.index(ax, pred.shape, 2)

    def local(p, t):
        t = t.long() - part * p.shape[-1]
        inside = (t >= 0) & (t < p.shape[-1])
        g = torch.gather(p, -1, torch.clamp(t, 0, p.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], 0.0)

    return shard.local(local, (ax, ax[:2]), (sh.Summed(ax[:2], "vocab"),))(
        pred, ids)


def value_and_grad(cfg: ArchConfig, params, batch, *, shard=_identity_shard):
    """(loss, metrics, grads) of :func:`loss_fn`: the gradient of every
    leaf of ``params`` by ``torch.autograd.grad``, in ``params``'
    structure.  ``params`` are not modified; grad mode is on inside
    whatever the caller's mode."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad(), shard.spmd():
        loss, metrics = loss_fn(cfg, tree_unflatten(params, leaves), batch,
                                shard=shard)
        grads = torch.autograd.grad(loss, leaves)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def make_train_step(cfg: ArchConfig, optimizer, *, shard=_identity_shard,
                    lr_schedule=None, clip_norm: float = 1.0):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the gradients of :func:`loss_fn`, clipped to ``clip_norm`` by their
    global norm, then ``optimizer.update`` scaled by ``lr_schedule`` at
    ``opt_state["step"]`` (read before the update).  Returns new parameter
    dicts (the caller's stay as they were) and metrics ``loss``, ``ce``,
    ``aux`` and ``grad_norm``.  ``attn_impl="pallas"`` raises: K4 has no
    backward."""
    from repro_torch.optim import clip_by_global_norm

    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(cfg, params, batch,
                                              shard=shard)
        with shard.spmd():
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
            scale = (lr_schedule(opt_state["step"])
                     if lr_schedule is not None else 1.0)
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr_scale=scale)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


def make_prefill_step(cfg: ArchConfig, *, shard=_identity_shard,
                      pad_to: Optional[int] = None):
    """pad_to: allocate KV-cache headroom for subsequent decode steps
    (ring-buffer semantics mean an unpadded cache evicts the oldest
    context token on the first decode).  Only the last position is
    unembedded: the step returns (logits (B, 1, V), cache), the cache in
    the decode layout for ``pad_to`` positions
    (:func:`prefill_cache_to_decode`)."""

    def prefill_step(params, batch):
        with shard.spmd():
            x, cache, _, _ = _backbone(cfg, params, batch, True, shard=shard)
            cache = prefill_cache_to_decode(cfg, cache, pad_to)
            return unembed(cfg, params, x[:, -1:], shard), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, shard=_identity_shard):
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens, shard=shard)

    return serve_step
