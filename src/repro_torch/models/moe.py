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
cumsums and capacities.  ``shard`` places the tokens and the expert
buffers by logical axes (:func:`repro_torch.runtime.sharding.make_sharder`;
the identity by default).  On a mesh the routing, the scatter into the
(G, E, C, d) buffers and the gather back run group-local under
``Sharder.local`` (the reference's ``shard_map`` branch), the groups
placed by the ``moe_groups`` rule: with G > 1 and groups spread over
the whole mesh no collective is needed there.  Without a ``moe_groups``
rule, or at G = 1, the same regions run replicated on every device,
which is what the reference's comment says GSPMD's scatter partitioner
does with its scatter.  The two
``shard(buf, "moe_groups_ep", "expert", "expert_cap", None)`` reshards
around the expert products are the expert all-to-all.

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
from repro_torch.runtime import sharding


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


def aux_loss(probs, load):
    """The Switch load-balance loss E * sum_e f_e P_e (float32) from the
    routing's ``probs`` (G, tpg, E) and ``load`` (E,)."""
    G, tpg, E = probs.shape
    f = load.float() / (G * tpg)
    return E * torch.sum(f * probs.mean((0, 1)))


def _dispatch(logits, tokens, top_k: int, capacity_factor: float):
    """Route G groups of tokens and scatter them into per-group expert
    buffers: (buf (G, E, C, d), eidx, slot, gval (G, tpg * k), probs
    (G, tpg, E), load (E,)), all group-local."""
    G, tpg, d = tokens.shape
    r = route(logits, top_k, capacity_factor)
    eidx = r.expert_idx.reshape(G, tpg * top_k)
    slot = torch.clamp(r.pos, 0, r.capacity - 1)
    grp = torch.arange(G, device=tokens.device)[:, None].expand_as(eidx)
    upd = torch.where(r.keep[..., None],
                      torch.repeat_interleave(tokens, top_k, dim=1), 0)
    buf = tokens.new_zeros((G, logits.shape[-1], r.capacity, d))
    buf.index_put_((grp, eidx, slot), upd, accumulate=True)
    gval = (r.gates.reshape(G, tpg * top_k) * r.keep).to(tokens.dtype)
    return buf, eidx, slot, gval, r.probs, r.load


def _combine(out_buf, eidx, slot, gval, top_k: int):
    """The experts' outputs gathered back to their (token, slot) pairs and
    summed over the k slots with the gates: (G, tpg, d)."""
    G, d = out_buf.shape[0], out_buf.shape[-1]
    grp = torch.arange(G, device=out_buf.device)[:, None].expand_as(eidx)
    return (out_buf[grp, eidx, slot] * gval[..., None]).reshape(
        G, -1, top_k, d).sum(2)


def _experts(buf, w_gate, w_up, w_down):
    """Every expert's SwiGLU over its buffer: (G, E, C, d) -> (G, E, C,
    d)."""
    h = torch.einsum("gecd,edf->gecf", buf, w_gate)
    u = torch.einsum("gecd,edf->gecf", buf, w_up)
    return torch.einsum("gecf,efd->gecd", F.silu(h) * u, w_down)


def moe_ffn(params, x, *, top_k: int, capacity_factor: float = 1.25,
            dispatch_groups: int = 1, shard=sharding.IDENTITY):
    """x: (B, T, d) -> ((B, T, d), aux load-balance loss)."""
    B, T, d = x.shape
    n_tok, G = B * T, dispatch_groups
    if n_tok % G:
        raise ValueError(f"{n_tok} tokens do not split into {G} groups")
    tpg = n_tok // G
    tokens = shard(x.reshape(G, tpg, d), "moe_groups", None, None)
    # On a mesh the dispatch and the combine run group-local, the groups
    # placed by the ``moe_groups`` rule (the load, summed over this
    # device's groups, a partial sum over the groups' mesh axes); the
    # experts run on the buffers in the compute layout, each device's
    # experts' weights whole (DTensor's einsum fails on the local views
    # its own redistribution leaves).
    g, b = ("moe_groups",), ("moe_groups_ep", "expert", "expert_cap", None)
    w = ("expert", None, None)
    dispatch = shard.local(
        lambda lg, tk: _dispatch(lg, tk, top_k, capacity_factor), (g, g),
        (g,) * 5 + (sharding.Summed((None,), "moe_groups"),))
    experts = shard.local(_experts, (b, w, w, w), (b,))
    combine = shard.local(lambda *a: _combine(*a, top_k), (g,) * 4, (g,))
    with record_function("moe.dispatch"):
        buf, eidx, slot, gval, probs, load = dispatch(
            (tokens @ params["router"]).float(), tokens)
        aux = aux_loss(probs, load)
        # the expert all-to-all: from the dispatch layout (groups over the
        # mesh) to the compute layout (experts over the EP axis)
        buf = shard(buf, "moe_groups_ep", "expert", "expert_cap", None)
    with record_function("moe.experts"):
        out_buf = experts(buf, params["w_gate"], params["w_up"],
                          params["w_down"])
        out_buf = shard(out_buf, "moe_groups_ep", "expert", "expert_cap",
                        None)
    with record_function("moe.combine"):
        combined = combine(out_buf, eidx, slot, gval)
    combined = combined.reshape(n_tok, d)
    if "shared" in params:
        with record_function("moe.shared"):
            s = params["shared"]
            combined = combined + swiglu(tokens.reshape(n_tok, d),
                                         s["w_gate"], s["w_up"], s["w_down"])
    # on a mesh the tokens leave in the batch layout, whose shards of the
    # flat token axis fall on whole sequences
    return shard(combined, "batch", None).reshape(B, T, d), aux
