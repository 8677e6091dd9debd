"""Mixture-of-Experts FFN with capacity-based dispatch (the JAX package's
``models/moe.py``, GShard-style).

Tokens are routed to per-expert buffers of capacity C = ceil(tokens * k /
E * capacity_factor) by a cumsum over the (token, slot) pairs, each expert
runs a SwiGLU over its buffer, and the outputs are gathered back and
weighted by the renormalised gates; a shared expert, when there is one,
runs on every token.  Each step copies the reference's, casts included,
so a float32 model computes the same function:

* the router's logits are float32 and the top-k is taken on their
  softmax, ties going to the lower expert index (``jax.lax.top_k``'s rule;
  ``torch.topk`` leaves the order of ties unspecified), through a stable
  descending sort;
* positions run token-major, slot-minor over the flattened (token, slot)
  axis; a pair past its expert's capacity is dropped (``keep`` false) and
  adds zeros at the clipped slot C - 1;
* the gate-weighted sum over k is taken in x's type and the shared
  expert is added last.

A decode step routes its B tokens alone: at B = 4 llama4-scout's capacity
is ceil(4 / 16 * 1.25) = 1 per expert, so a second token sent to the same
expert keeps only the shared expert's output, and the expert products read
every expert's weights.  Both are the reference's behaviour, copied.

``dispatch_groups=G`` reshapes the tokens to (G, n/G, d) with group-local
cumsums and capacities.  The reference's ``shard`` hook and its
``shard_map`` branch need a device mesh, which the port does not have yet.

The stages run inside ``torch.profiler.record_function`` ranges
(``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``), so a
trace attributes device time to them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import init_dense, swiglu


def init_moe(generator, d_model, d_ff, n_experts, n_shared,
             dtype=torch.float32, device="cuda"):
    """The reference's parameter dict: router (d, E), expert stacks
    (E, d, ff) / (E, ff, d) and, when ``n_shared``, a ``shared`` SwiGLU of
    width ff * n_shared; normal x 1/sqrt(fan_in) from ``generator``."""
    def w(shape):
        return init_dense(generator, shape, dtype=dtype, device=device)

    p = {"router": w((d_model, n_experts)),
         "w_gate": w((n_experts, d_model, d_ff)),
         "w_up": w((n_experts, d_model, d_ff)),
         "w_down": w((n_experts, d_ff, d_model))}
    if n_shared:
        fs = d_ff * n_shared
        p["shared"] = {"w_gate": w((d_model, fs)), "w_up": w((d_model, fs)),
                       "w_down": w((fs, d_model))}
    return p


class Routing(NamedTuple):
    """The routing of G groups of tokens (tpg tokens a group) over E
    experts, k slots a token."""
    probs: torch.Tensor        # (G, tpg, E) float32 softmax of the logits
    gates: torch.Tensor        # (G, tpg, k) float32, renormalised
    expert_idx: torch.Tensor   # (G, tpg, k) int64, best first
    pos: torch.Tensor          # (G, tpg * k) int64 slot in the expert buffer
    keep: torch.Tensor         # (G, tpg * k) bool: pos < capacity
    load: torch.Tensor         # (E,) int64 pairs sent to each expert
    capacity: int


def capacity(tokens_per_group: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """The reference's expression, in its order, in Python floats."""
    return int(max(1, math.ceil(tokens_per_group * top_k / n_experts
                                * capacity_factor)))


def route(logits, top_k: int, capacity_factor: float) -> Routing:
    """Top-k routing and capacity positions from float32 router logits
    (G, tpg, E).  Integer outputs are exact, so they agree bitwise across
    devices whenever the softmax orders the experts alike (always when the
    logits come out of a bfloat16 product: distinct values lie an ulp of
    bfloat16 apart)."""
    G, tpg, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    expert_idx = torch.sort(probs, dim=-1, descending=True,
                            stable=True).indices[..., :top_k]
    gates = torch.gather(probs, -1, expert_idx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    cap = capacity(tpg, top_k, E, capacity_factor)
    eidx = expert_idx.reshape(G, tpg * top_k)
    onehot = eidx[..., None] == torch.arange(E, device=logits.device)
    csum = torch.cumsum(onehot, 1)                       # (G, tpg * k, E)
    pos = torch.gather(csum, -1, eidx[..., None])[..., 0] - 1
    return Routing(probs, gates, expert_idx, pos, pos < cap,
                   csum[:, -1].sum(0), cap)


def aux_loss(r: Routing):
    """The Switch load-balance loss E * sum_e f_e P_e (float32)."""
    G, tpg, E = r.probs.shape
    f = r.load.float() / (G * tpg)
    return E * torch.sum(f * r.probs.mean((0, 1)))


def moe_ffn(params, x, *, top_k: int, capacity_factor: float = 1.25,
            dispatch_groups: int = 1):
    """x: (B, T, d) -> ((B, T, d), aux load-balance loss)."""
    B, T, d = x.shape
    E = params["router"].shape[-1]
    n_tok, G = B * T, dispatch_groups
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    tpg = n_tok // G
    tokens = x.reshape(G, tpg, d)
    with record_function("moe.dispatch"):
        r = route((tokens @ params["router"]).float(), top_k,
                  capacity_factor)
        aux = aux_loss(r)
        eidx = r.expert_idx.reshape(G, tpg * top_k)
        slot = torch.clamp(r.pos, 0, r.capacity - 1)
        grp = torch.arange(G, device=x.device)[:, None].expand_as(eidx)
        upd = torch.where(r.keep[..., None],
                          torch.repeat_interleave(tokens, top_k, dim=1), 0)
        buf = x.new_zeros((G, E, r.capacity, d))
        buf.index_put_((grp, eidx, slot), upd, accumulate=True)
    with record_function("moe.experts"):
        h = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
        u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
        out_buf = torch.einsum("gecf,efd->gecd", F.silu(h) * u,
                               params["w_down"])
    with record_function("moe.combine"):
        gval = (r.gates.reshape(G, tpg * top_k) * r.keep).to(x.dtype)
        combined = (out_buf[grp, eidx, slot] * gval[..., None]).reshape(
            G, tpg, top_k, d).sum(2)
    if "shared" in params:
        with record_function("moe.shared"):
            s = params["shared"]
            combined = combined.reshape(n_tok, d) + swiglu(
                tokens.reshape(n_tok, d), s["w_gate"], s["w_up"],
                s["w_down"])
    return combined.reshape(B, T, d), aux
