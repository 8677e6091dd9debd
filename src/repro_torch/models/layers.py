"""Core transformer layers: plain functions over tensors (the JAX package's
``models/layers.py``).

Every cast sits where the JAX code has it, so a float32 model computes the
same function and a bfloat16 one rounds at the same places:

* ``rms_norm`` rounds to x's type before the scale multiply;
* ``apply_rope`` casts the frequencies to x's type, the angles are f32, and
  cos/sin round to x's type;
* ``_chunked_attention`` rounds the probabilities to q's type before the
  PV product;
* ``attention`` repeats grouped kv heads before any implementation.

``attention(impl=...)`` takes ``"dense"``, ``"chunked"`` (the default:
online softmax over key chunks) or ``"pallas"``, the JAX package's name for
its flash kernel, which here selects K4 through
:func:`repro_torch.kernels.ops.flash_attention`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

# ---------------------------------------------------------------- numerics
NEG_INF = -1e30


def rms_norm(x, scale, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float = 10000.0):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., T, H, hd); positions: (..., T).

    The frequencies are :func:`rope_freqs` computed on x's device in f64
    (copying the numpy table in would make every call wait for the host).
    """
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd
    freqs = (1.0 / (theta ** exps)).to(x.dtype)                   # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs           # f32
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# -------------------------------------------------------------- attention
def _mask(Tq, Tk, *, causal, q_offset, window, device):
    qpos = q_offset + torch.arange(Tq, device=device)[:, None]
    kpos = torch.arange(Tk, device=device)[None, :]
    mask = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def _dense_attention(q, k, v, *, causal: bool, q_offset, window):
    """q: (B, Tq, H, hd), k/v: (B, Tk, H, hd). Materializes scores."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = _mask(q.shape[1], k.shape[1], causal=causal, q_offset=q_offset,
                 window=window, device=q.device)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def _chunked_attention(q, k, v, *, causal: bool, q_offset, window,
                       kv_chunk: int = 1024):
    """Flash-style online softmax over key chunks; O(Tq * kv_chunk) memory."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    n_chunks = max(1, -(-Tk // kv_chunk))
    pad = n_chunks * kv_chunk - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    dev = q.device
    qpos = q_offset + torch.arange(Tq, device=dev)[:, None]
    acc = torch.zeros((B, H, Tq, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kci, vci = k[:, sl], v[:, sl]
        s = torch.einsum("bqhd,bkhd->bhqk", q, kci) * scale     # (B,H,Tq,C)
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
        mask = kpos < Tk
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        s = torch.where(mask, s.float(), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        denom = denom * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", pexp.to(q.dtype), vci).float()
        m = m_new
    out = acc / torch.clamp_min(denom[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)                      # (B,Tq,H,hd)


def attention(q, k, v, *, causal=True, q_offset=0, window=None,
              impl="chunked", kv_chunk=1024):
    """GQA-ready attention. k/v may have fewer heads; repeats to match q."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    if impl == "dense":
        return _dense_attention(q, k, v, causal=causal, q_offset=q_offset,
                                window=window)
    if impl == "pallas":
        return ops.flash_attention(q, k, v, causal=causal,
                                   q_offset=q_offset, window=window)
    return _chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                              window=window, kv_chunk=kv_chunk)


# ----------------------------------------------------------------- blocks
def init_dense(generator, shape, scale=None, dtype=torch.float32,
               device="cpu"):
    """Normal x 1/sqrt(fan_in) (or ``scale``), drawn from ``generator``
    (a ``torch.Generator`` on ``device``)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    return (torch.randn(shape, generator=generator, device=device)
            * scale).to(dtype)


def linear(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    # the reference's gelu is the tanh approximation (its default)
    return linear(F.gelu(linear(x, w_in, b_in), approximate="tanh"), w_out,
                  b_out)
