"""The architecture zoo's dense and moe families: config, parameters,
forward pass, KV-cache decode and the serving steps (the JAX package's
``models/transformer.py``).

``ArchConfig`` describes every architecture of the registry, but only the
``dense`` and ``moe`` families with token inputs run here:
``mamba_hybrid``, ``xlstm``, ``encoder`` and the embedding frontends raise
``NotImplementedError`` (ROADMAP queue 1).  Parameters are nested dicts of
tensors whose layer weights are stacked along a leading axis, as in the JAX
package; the layer stack is a Python loop over that axis (no scan, no
remat: this module serves, it does not train).  A moe block's FFN is
:func:`repro_torch.models.moe.moe_ffn`; ``forward`` returns its load-balance
loss summed over the layers.

``decode_step`` writes the new key and value into the cache's ring buffer
in place and returns the same tensors with ``pos + 1``: the JAX package's
update is functional, and copying a cache of L x B x S x Hkv x hd per token
would buy nothing here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_rope, attention, rms_norm, swiglu

_PORTED_FAMILIES = ("dense", "moe")
_NOT_PORTED = ("the port runs only the dense and moe families with token "
               "inputs; {} is not ported yet (ROADMAP queue 1)")


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


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(_NOT_PORTED.format(
            f"the {cfg.family} family ({cfg.name})"))
    if cfg.input_mode != "tokens":
        raise NotImplementedError(_NOT_PORTED.format(
            f"input_mode={cfg.input_mode!r} ({cfg.name})"))


def _attn_defs(cfg: ArchConfig, L: int):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    st = lambda s, a: ParamDef((L,) + s, ("layers",) + a)  # noqa: E731
    defs = {
        "ln": st((d,), ("d_model",)),
        "wq": st((d, H * hd), ("d_model", "qkv")),
        "wk": st((d, Hkv * hd), ("d_model", "qkv")),
        "wv": st((d, Hkv * hd), ("d_model", "qkv")),
        "wo": st((H * hd, d), ("qkv", "d_model")),
    }
    if cfg.qkv_bias:
        defs["bq"] = st((H * hd,), ("qkv",))
        defs["bk"] = st((Hkv * hd,), ("qkv",))
        defs["bv"] = st((Hkv * hd,), ("qkv",))
    return defs


def _mlp_defs(cfg: ArchConfig, L: int):
    d, ff = cfg.d_model, cfg.d_ff
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


def _ffn_key(cfg: ArchConfig) -> str:
    return "moe" if cfg.family == "moe" else "mlp"


def param_defs(cfg: ArchConfig):
    _require_ported(cfg)
    d, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    defs: dict = {"final_ln": ParamDef((d,), ("d_model",)),
                  "embed": ParamDef((V, d), ("vocab", "d_model"),
                                    scale=d ** -0.5)}
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, V), ("d_model", "vocab"))
    ffn = _moe_defs(cfg, L) if cfg.family == "moe" else _mlp_defs(cfg, L)
    defs["blocks"] = {"attn": _attn_defs(cfg, L), _ffn_key(cfg): ffn}
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


# ================================================================ forward
def _attn_apply(cfg: ArchConfig, p, x, *, positions, kv_cache=None,
                cache_pos=None, window=None, causal=True):
    """One attention application; ``p`` holds one layer's weights.

    Train/prefill: kv_cache is None -> attends within x, returns (out, (k, v)).
    Decode: kv_cache = (k_buf (B,S,Hkv,hd), v_buf) ring buffer, written in
    place; cache_pos (a 0-d tensor) is the number of tokens already in
    context; returns (out, (k_buf, v_buf)).
    """
    B, T, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln"])
    q = h @ p["wq"] + (p["bq"] if "bq" in p else 0.0)
    k = h @ p["wk"] + (p["bk"] if "bk" in p else 0.0)
    v = h @ p["wv"] + (p["bv"] if "bv" in p else 0.0)
    q = apply_rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, T, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, T, Hkv, hd)

    if kv_cache is None:
        out = attention(q, k, v, causal=causal, q_offset=0, window=window,
                        impl=cfg.attn_impl, kv_chunk=cfg.kv_chunk)
        new_kv = (k, v)
    else:
        k_buf, v_buf = kv_cache
        S = k_buf.shape[1]
        # lax.dynamic_update_slice clamps the start so the update fits.
        start = torch.clamp(cache_pos % S, max=S - T)
        idx = start + torch.arange(T, device=x.device)
        k_buf.index_copy_(1, idx, k.to(k_buf.dtype))
        v_buf.index_copy_(1, idx, v.to(v_buf.dtype))
        # Validity: ring buffer holds min(cache_pos+1, S) entries.
        n_valid = torch.clamp(cache_pos + 1, max=S)
        mask = torch.arange(S, device=x.device) < n_valid          # (S,)
        scale = hd ** -0.5
        # GQA-aware grouped attention: no head repeat over the cache.
        rep = H // Hkv
        qg = q.reshape(B, T, Hkv, rep, hd)
        s = torch.einsum("bqgrd,bsgd->bgrqs", qg,
                         k_buf.to(qg.dtype)) * scale
        s = torch.where(mask, s.float(), -1e30)
        w = torch.softmax(s, dim=-1).to(qg.dtype)
        out = torch.einsum("bgrqs,bsgd->bqgrd", w, v_buf.to(qg.dtype))
        out = out.reshape(B, T, H, hd)
        new_kv = (k_buf, v_buf)
    out = out.reshape(B, T, H * hd)
    return x + out @ p["wo"], new_kv


def _ffn_apply(cfg: ArchConfig, p, x):
    """Dense SwiGLU or MoE FFN with residual; returns (x, aux)."""
    h = rms_norm(x, p["ln"])
    if "router" in p:
        y, aux = moe_lib.moe_ffn(p, h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dispatch_groups=cfg.moe_dispatch_groups)
        return x + y, aux
    return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), 0.0


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked block (nested dicts such as moe's
    ``shared`` included)."""
    return {k: _layer(t, i) if isinstance(t, dict) else t[i]
            for k, t in stacked.items()}


# ---------------------------------------------------------------- embed
def embed_inputs(cfg: ArchConfig, params, batch):
    """Returns (x (B,T,d), positions (B,T), loss_mask None): tokens mode."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens].to(cfg.dtype)
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device).expand(B, T)
    return x, pos, None


def unembed(cfg: ArchConfig, params, x):
    x = rms_norm(x, params["final_ln"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


# ------------------------------------------------------------ stacks
def _backbone(cfg: ArchConfig, params, batch, want_cache: bool):
    x, positions, loss_mask = embed_inputs(cfg, params, batch)
    blocks, ffn = params["blocks"], _ffn_key(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, (k, v) = _attn_apply(cfg, _layer(blocks["attn"], i), x,
                                positions=positions, causal=cfg.causal,
                                window=cfg.window)
        x, a = _ffn_apply(cfg, _layer(blocks[ffn], i), x)
        aux = aux + a
        if want_cache:
            ks.append(k)
            vs.append(v)
    cache = None
    if want_cache:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs),
                 "pos": torch.full((), x.shape[1], dtype=torch.int32,
                                   device=x.device)}
    return x, cache, loss_mask, aux


def forward(cfg: ArchConfig, params, batch, *, mode="train"):
    """Full-sequence forward. Returns (logits, aux, cache_out, loss_mask).

    cache_out is the prefill cache when mode='prefill', else None; aux is
    the moe family's load-balance loss summed over the layers (0 for the
    dense family).
    """
    x, cache, loss_mask, aux = _backbone(cfg, params, batch,
                                         mode == "prefill")
    return unembed(cfg, params, x), aux, cache, loss_mask


# ============================================================ decode
def cache_defs(cfg: ArchConfig, batch: int, context: int):
    """Decode-cache structure (shapes + logical axes)."""
    _require_ported(cfg)
    B, S, L = batch, context, cfg.n_layers
    Hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": ParamDef((L, B, S, Hkv, hd),
                      ("layers", "kv_batch", "kv_seq", None, None)),
        "v": ParamDef((L, B, S, Hkv, hd),
                      ("layers", "kv_batch", "kv_seq", None, None)),
        "pos": ParamDef((), (), torch.int32),
    }


def init_cache(cfg: ArchConfig, batch: int, context: int, filled=True,
               device="cuda"):
    """Zero cache with pos=context (mimics a fully prefilled context)."""
    c = _map_defs(cache_defs(cfg, batch, context),
                  lambda _, d: torch.zeros(d.shape, dtype=d.dtype or cfg.dtype,
                                           device=device))
    c["pos"] = torch.full((), context if filled else 0, dtype=torch.int32,
                          device=device)
    return c


def decode_step(cfg: ArchConfig, params, cache, tokens):
    """One decode step: tokens (B, 1) int -> (logits (B,1,V), new cache).

    The cache's k/v tensors are updated in place (see the module note)."""
    _require_ported(cfg)
    B = tokens.shape[0]
    x = params["embed"][tokens].to(cfg.dtype)
    pos = cache["pos"]
    positions = pos.expand(B, 1)
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        x, _ = _attn_apply(cfg, _layer(blocks["attn"], i), x,
                           positions=positions,
                           kv_cache=(cache["k"][i], cache["v"][i]),
                           cache_pos=pos)
        x, _ = _ffn_apply(cfg, _layer(blocks[_ffn_key(cfg)], i), x)
    logits = unembed(cfg, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


# ============================================================== steps
def make_prefill_step(cfg: ArchConfig, *, pad_to: Optional[int] = None):
    """pad_to: allocate KV-cache headroom for subsequent decode steps
    (ring-buffer semantics mean an unpadded cache evicts the oldest
    context token on the first decode).  Only the last position is
    unembedded: the step returns (logits (B, 1, V), cache)."""

    def prefill_step(params, batch):
        x, cache, _, _ = _backbone(cfg, params, batch, True)
        if pad_to is not None:
            for key in ("k", "v"):
                pad = pad_to - cache[key].shape[2]
                if pad > 0:
                    cache[key] = F.pad(cache[key], (0, 0, 0, 0, 0, pad))
        return unembed(cfg, params, x[:, -1:]), cache

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens):
        return decode_step(cfg, params, cache, tokens)

    return serve_step
