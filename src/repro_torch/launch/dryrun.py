"""Multi-pod dry-run: run every (arch x shape x mesh) cell's real step on
``meta`` shards (the JAX package's ``launch/dryrun.py``).

For each cell this opens a fake process group of the production mesh's
size (256 or 512 ranks in one process), places the parameters, the
optimizer state and the batch or decode cache as DTensors whose local
shards are ``meta`` tensors (shapes, no storage) by the sharding rules,
and runs the real step (``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` with the sharder) under a dispatch mode that records,
as rank 0 of the mesh sees them:

* every collective DTensor issues (functional all-gather, all-reduce,
  reduce-scatter, all-to-all; their output bytes, as the reference counts
  its HLO collectives' output shapes),
* the FLOPs of the matrix products on the local shards
  (``torch.utils.flop_counter``'s table: mm, bmm, convolutions, ...; no
  element-wise FLOPs),
* the peak of the live local bytes the step allocates (storages tracked
  from allocation until they are freed),

and writes a JSON record in the reference's keys where they have a
meaning: ``memory.argument_size_in_bytes`` is the exact sum of the local
shards of the arguments, ``output_size_in_bytes`` that of the step's
outputs, ``temp_size_in_bytes`` the tracked peak less the arguments.
``roofline`` holds :func:`analytic_terms` with the collective term at
:data:`repro_torch.launch.mesh.NET_BW`; ``fits_80gb`` holds arguments plus
temp against an H100's 80 GB.

What torch cannot give is null: ``alias_size_in_bytes`` (no buffer
donation: the train step returns new parameters, the decode step writes
its cache in place), ``compile_s`` and ``generated_code_size_in_bytes``
(no ahead-of-time compile; ``trace_s`` is the eager run's time instead),
``bytes_per_device`` (no cost analysis).  The reference's HLO parser
(``collective_bytes`` with its loop trip counts) has no counterpart: torch
emits no HLO and runs its layer and time loops eagerly, so every
collective is seen as often as it runs.  The recurrences of the hybrid
and xlstm families are one op a layer (:mod:`repro_torch.kernels.
ssm_scan`), which the ``meta`` run takes through its fake implementation
and its FLOP formula, as the reference's ``lax.scan`` is one loop; only
their backward passes (train cells) still run as Python loops over the
time steps.  The peak is eager PyTorch's:
no fusion, no rematerialisation beyond ``cfg.remat``'s checkpoints, and
DTensor's sharding propagation, not GSPMD's, decides the layouts between
the constraints.

Importing this module sets no environment variable and opens no process
group; :func:`run_cell` restores the caller's state on return or error
(a caller that already has a default process group gets the cell run in
a child process).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from collections import Counter
from pathlib import Path

import torch

from repro_torch import configs, optim
from repro_torch.configs import shapes as shp
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tf
from repro_torch.runtime import sharding as sh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

HBM_BYTES = 80e9                   # an H100's device memory
# The reference's collective kinds, and the ops that count as each.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all",
}
# A train cell's recurrence time steps (sequence length x scanned layers)
# beyond which it is skipped: the backward passes of the recurrences run
# as Python loops of ~8 ops a step (the forward is one op a layer).
MAX_SCAN_STEPS = 1 << 12


# ------------------------------------------------------------ the trees
def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


def _zip_map(fn, tree, *others):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], *(o[k] for o in others))
                for k in tree}
    return fn(tree, *others)


def _defs(tree):
    if isinstance(tree, tf.ParamDef):
        yield tree
    else:
        for k in tree:
            yield from _defs(tree[k])


def opt_state_axes(opt_name: str, axes_tree):
    """Logical axes of :mod:`repro_torch.optim`'s state for parameters
    with ``axes_tree`` (the reference's layout: ``mu`` / ``m``, ``v`` /
    ``mom`` with Adafactor's factored ``vr``, ``vc``; ``step`` a scalar)."""
    if opt_name == "sgd":
        return {"mu": axes_tree, "step": ()}
    if opt_name == "adamw":
        return {"m": axes_tree, "v": axes_tree, "step": ()}
    if opt_name == "adafactor":
        def f(axes):
            if len(axes) >= 2:
                return {"vr": tuple(axes[:-1]),
                        "vc": tuple(axes[:-2]) + (axes[-1],)}
            return {"v": axes}
        return {"mom": sh._map_axes(f, axes_tree), "step": ()}
    raise ValueError(opt_name)


def local_shape(sizes: dict, spec: tuple, shape) -> tuple:
    """The shard of ``shape`` one device holds under ``spec`` (entries that
    divide their dims, as :meth:`ShardingRules.spec` returns them with a
    shape)."""
    return tuple(n // math.prod(sizes[a] for a in sh._names(e))
                 if e is not None else n for e, n in zip(spec, shape))


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def cell_arguments(cfg: tf.ArchConfig, shape: shp.ShapeSpec):
    """(abstract arguments, their logical axes) of the cell's step, as
    dicts: {"params", "opt_state", "batch"} for train, {"params",
    "batch"} for prefill, {"params", "cache", "tokens"} for decode."""
    p_abs, p_axes = tf.abstract_params(cfg), tf.logical_axes(cfg)
    b_abs = shp.batch_specs(cfg, shape)
    b_axes = shp.batch_logical_axes(cfg, shape)
    if shape.kind == "train":
        opt = optim.get_optimizer(cfg.optimizer)
        return ({"params": p_abs, "opt_state": opt.init(p_abs),
                 "batch": b_abs},
                {"params": p_axes,
                 "opt_state": opt_state_axes(cfg.optimizer, p_axes),
                 "batch": b_axes})
    if shape.kind == "prefill":
        return ({"params": p_abs, "batch": b_abs},
                {"params": p_axes, "batch": b_axes})
    return ({"params": p_abs, "cache": b_abs["cache"],
             "tokens": b_abs["tokens"]},
            {"params": p_axes, "cache": b_axes["cache"],
             "tokens": b_axes["tokens"]})


def argument_bytes(cfg: tf.ArchConfig, shape: shp.ShapeSpec, sizes: dict,
                   rules: sh.ShardingRules) -> int:
    """The bytes of one device's shards of the cell's arguments on a mesh
    of ``sizes`` ({axis name: size}), under the divisibility rule."""
    args, axes = cell_arguments(cfg, shape)
    return sum(_leaves(_zip_map(lambda a, t: _nbytes(local_shape(
        sizes, rules.spec(a, sizes, t.shape), t.shape), t.dtype), axes,
        args)))


# ------------------------------------------------------- the arithmetic
def model_flops(cfg: tf.ArchConfig, shape: shp.ShapeSpec):
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for inference."""
    total = sum(math.prod(d.shape) for d in _defs(tf.param_defs(cfg)))
    active = total
    if cfg.n_experts:                      # subtract inactive expert params
        expert_like = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * \
            cfg.n_layers
        active_expert = 3 * cfg.top_k * cfg.d_model * cfg.d_ff * cfg.n_layers
        active = total - expert_like + active_expert
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens, total, active


def analytic_terms(cfg: tf.ArchConfig, shape: shp.ShapeSpec,
                   n_devices: int) -> dict:
    """Roofline terms from first principles, the reference's arithmetic
    with the H100's constants (:mod:`repro_torch.launch.mesh`).

    Executed FLOPs = model matmul FLOPs + attention/SSM mixing FLOPs
    (+ one extra forward when remat recomputes activations in training).
    """
    mf, total, active = model_flops(cfg, shape)
    B, T = shape.global_batch, shape.seq_len
    L, H, hd, Hkv = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    kind = shape.kind

    # --- mixing flops (attention / SSM), forward pass, global ---
    if kind == "decode":
        tq, ctx = 1, T
    else:
        tq, ctx = T, T
    mix_fwd = 0.0
    eff_ctx = min(cfg.window, ctx) if cfg.window else ctx
    causal_half = 0.5 if (cfg.causal and kind != "decode"
                          and not cfg.window) else 1.0
    attn_fwd_per_layer = 4.0 * B * tq * eff_ctx * H * hd * causal_half
    if cfg.family in ("dense", "moe", "encoder"):
        mix_fwd = L * attn_fwd_per_layer
    elif cfg.family == "mamba_hybrid":
        d_inner, Hm = ssm_lib.mamba2_dims(cfg.d_model, cfg.ssm_state,
                                          cfg.ssm_headdim)
        ssm = 8.0 * B * tq * Hm * cfg.ssm_state * cfg.ssm_headdim * L
        n_attn = L // cfg.attn_every
        mix_fwd = ssm + n_attn * attn_fwd_per_layer
    elif cfg.family == "xlstm":
        hd2 = cfg.d_model // H
        mlstm = 8.0 * B * tq * H * hd2 * hd2 * (L // 2)
        slstm = 16.0 * B * tq * H * hd2 * hd2 * (L // 2)
        mix_fwd = mlstm + slstm

    fwd = mf / (6.0 if kind == "train" else 2.0) * 2.0 + mix_fwd
    if kind == "train":
        executed = 3.0 * fwd + (fwd if cfg.remat else 0.0)  # fwd+bwd(2x)+remat
        model = mf + 3.0 * mix_fwd
    else:
        executed = fwd
        model = mf + mix_fwd

    # --- HBM traffic per device ---
    p_local = total / n_devices            # all params sharded (FSDP/TP/EP)
    dtype_b = 2.0
    if kind == "train":
        opt_bytes = {"adamw": 16.0, "sgd": 8.0, "adafactor": 1.0}[
            cfg.optimizer]
        # fwd read + bwd read + grad w/r + opt state r/w + param write
        param_traffic = p_local * (3 * dtype_b + 4.0 + opt_bytes + dtype_b)
        # wide intermediates (ff/heads) are model-sharded, batch dp-sharded:
        # treat activation traffic as fully sharded across the mesh.
        act_traffic = B * T * cfg.d_model * L * 20.0 / n_devices
    elif kind == "prefill":
        param_traffic = p_local * dtype_b
        act_traffic = B * T * cfg.d_model * L * 8.0 / n_devices
    else:  # decode: read params + KV/state
        active_local = active / n_devices
        param_traffic = active_local * dtype_b
        if cfg.family in ("dense", "moe"):
            kv = L * B * T * Hkv * hd * 2 * dtype_b
        elif cfg.family == "mamba_hybrid":
            d_inner, Hm = ssm_lib.mamba2_dims(cfg.d_model, cfg.ssm_state,
                                              cfg.ssm_headdim)
            W = min(cfg.window or T, T)
            kv = L * B * Hm * cfg.ssm_state * cfg.ssm_headdim * 4 * 2 + \
                (L // cfg.attn_every) * B * W * Hkv * hd * 2 * dtype_b
        else:
            hd2 = cfg.d_model // H
            kv = (L // 2) * B * H * hd2 * (hd2 + 4) * 4 * 2 * 2
        act_traffic = kv / n_devices
    hbm_bytes = param_traffic + act_traffic

    return {
        "flops_model_global": model,
        "flops_executed_global": executed,
        "flops_executed_per_device": executed / n_devices,
        "hbm_bytes_per_device": hbm_bytes,
        "compute_term_s": executed / n_devices / mesh_lib.PEAK_FLOPS_BF16,
        "memory_term_s": hbm_bytes / mesh_lib.HBM_BW,
    }


def apply_variant(cfg, rules, variant: str, n_devices: int, multi_pod: bool):
    """Named perf variants (§Perf hillclimb iterations)."""
    dp = ("pod", "data") if multi_pod else ("data",)
    for piece in variant.split("+"):
        if piece in ("baseline", ""):
            continue
        elif piece == "moe_local":
            # device-local MoE dispatch: no cross-device cumsum/scatter
            cfg = dataclasses.replace(cfg, moe_dispatch_groups=n_devices)
            rules = dataclasses.replace(
                rules, moe_groups=dp + ("model",),
                moe_groups_ep=dp, expert_cap=None)
        elif piece == "sp":
            # Megatron-style sequence-parallel residual stream
            rules = dataclasses.replace(rules, resid_seq=("model",))
        elif piece == "kv_seq":
            # decode KV cache sharded over context (sequence-parallel decode)
            rules = dataclasses.replace(rules, kv_seq=("model",))
        elif piece == "no_fsdp":
            # inference: weights TP-only (no per-layer FSDP gathers)
            rules = dataclasses.replace(rules, d_model=None)
        elif piece == "no_remat":
            cfg = dataclasses.replace(cfg, remat=False)
        else:
            raise ValueError(f"unknown variant piece {piece!r}")
    return cfg, rules


def scan_steps(cfg: tf.ArchConfig, shape: shp.ShapeSpec) -> int:
    """Time steps of the cell's recurrences: sequence length x scanned
    layers for the hybrid and xlstm families (0 for the attention
    families, 1 token a layer at decode)."""
    if cfg.family not in ("mamba_hybrid", "xlstm"):
        return 0
    return cfg.n_layers * (1 if shape.kind == "decode" else shape.seq_len)


# --------------------------------------------------- the fake mesh
@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A fake default process group of ``world_size`` ranks in this one
    process (this process is rank 0; collectives return without moving
    data), destroyed on exit, on error too.  The caller must have no
    default group.  ``torch.testing._internal.distributed.fake_pg`` is a
    private module of PyTorch's; this is its only user."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Records what one device runs: collectives (kind -> output bytes and
    count), matrix-product FLOPs on local shards, and the peak of the live
    bytes of the storages allocated while it is on (outside ``exclude``,
    the arguments' storages).

    DTensor operations are passed on (``NotImplemented``), so the mode sees
    the local operations and the collectives they issue; the operations
    DTensor runs on fake tensors to propagate shapes are skipped.
    """

    def __init__(self, exclude=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.collective_bytes: Counter = Counter()
        self.collective_count: Counter = Counter()
        self.flops = 0
        self.peak = self.live_bytes = 0
        self._live: dict = {}
        self._exclude = {_storage_key(t) for t in exclude}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flat = list(_tensors(out))
        if _is_fake(args, kwargs, flat):
            return out
        kind = _COLLECTIVE_OPS.get(func._opname) if func.namespace in (
            "_c10d_functional", "_dtensor") else None
        if kind is not None:
            self.collective_bytes[kind] += sum(
                t.numel() * t.element_size() for t in flat)
            self.collective_count[kind] += 1
        elif func.overloadpacket in self._flop_registry:
            self.flops += self._flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out)
        for t in flat:
            self._allocated(t)
        return out

    def _allocated(self, t: torch.Tensor) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        st = t.untyped_storage()
        key = st._cdata
        if key in self._exclude:
            return
        if key in self._live:
            if not self._live[key][0].expired():
                return
            self.live_bytes -= self._live.pop(key)[1]
        n = st.nbytes()
        if self.live_bytes + n > self.peak:
            self.sweep()          # a new peak only if the dead are gone
        self._live[key] = (StorageWeakRef(st), n)
        self.live_bytes += n
        self.peak = max(self.peak, self.live_bytes)

    def sweep(self) -> None:
        """Forget the storages that have been freed."""
        for key in [k for k, (r, _) in self._live.items() if r.expired()]:
            self.live_bytes -= self._live.pop(key)[1]

    def collectives(self) -> dict:
        out = {k: int(self.collective_bytes.get(k, 0)) for k in KINDS}
        out.update({k: int(v) for k, v in self.collective_bytes.items()
                    if k not in out})
        out["total"] = sum(out.values())
        return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _is_fake(args, kwargs, outs) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor)
               for t in (*_tensors(list(args)),
                         *_tensors(list(kwargs.values())), *outs))


def _local(x) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def place_meta(mesh, rules: sh.ShardingRules, t: torch.Tensor, axes):
    """A DTensor of ``t``'s shape and dtype placed by the rules, whose
    local shard is a ``meta`` tensor (the divisibility rule makes every
    shard the same size)."""
    from torch.distributed.tensor import DTensor

    spec = rules.spec(axes, mesh, t.shape)
    loc = local_shape(sh.mesh_sizes(mesh), spec, t.shape)
    return DTensor.from_local(
        torch.empty(loc, dtype=t.dtype, device="meta"), mesh,
        rules.placements(mesh, axes, t.shape), run_check=False,
        shape=t.shape, stride=t.stride())


# ------------------------------------------------------------ one cell
def run_cell(arch: str, shape_name, multi_pod: bool,
             rules: sh.ShardingRules | None = None, tag: str = "baseline",
             variant: str = "baseline", device_type: str = "cuda", *,
             cfg: tf.ArchConfig | None = None, mesh_shape=None) -> dict:
    """One cell's record.  ``shape_name`` names a :data:`SHAPES` entry or
    is a ``ShapeSpec``; ``cfg`` replaces the registry's config of ``arch``
    and ``mesh_shape`` = (shape, axis names) the production mesh (both for
    small runs).  ``device_type`` is the mesh's ("cuda" on a card's
    machine; on a "cpu" mesh DTensor turns each all-to-all into an
    all-gather)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return _in_child(arch, shape_name, multi_pod, rules, tag, variant,
                         device_type, cfg, mesh_shape)
    cfg = cfg or configs.get(arch)
    shape = (shape_name if isinstance(shape_name, shp.ShapeSpec)
             else shp.SHAPES[shape_name])
    dims, names = mesh_shape or mesh_lib.mesh_shape(multi_pod)
    n_devices = math.prod(dims)
    rec = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(map(str, dims)), "tag": tag, "variant": variant}
    ok, reason = shp.applicable(cfg, shape)
    rules = rules or sh.default_rules(multi_pod=multi_pod)
    cfg, rules = apply_variant(cfg, rules, variant, n_devices, multi_pod)
    if ok and shape.kind == "train" and \
            scan_steps(cfg, shape) > MAX_SCAN_STEPS:
        ok, reason = False, (
            f"{scan_steps(cfg, shape):,} recurrence time steps (seq_len x "
            f"layers): the backward recurrences still run as Python loops, "
            f"beyond {MAX_SCAN_STEPS:,} steps")
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    with fake_process_group(n_devices):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(device_type, dims, mesh_dim_names=names)
        shard = sh.make_sharder(mesh, rules)
        abstract, axes = cell_arguments(cfg, shape)
        args = _zip_map(lambda t, a: place_meta(mesh, rules, t, a),
                        abstract, axes)
        locals_ = [_local(t) for t in _leaves(args)]
        arg_bytes = sum(t.numel() * t.element_size() for t in locals_)
        counter = StepCounter(exclude=locals_)
        t0 = time.perf_counter()
        with counter:
            if shape.kind == "train":
                opt = optim.get_optimizer(cfg.optimizer)
                out = tf.make_train_step(cfg, opt, shard=shard)(
                    args["params"], args["opt_state"], args["batch"])
            elif shape.kind == "prefill":
                out = tf.make_prefill_step(cfg, shard=shard)(
                    args["params"], args["batch"])
            else:
                out = tf.make_serve_step(cfg, shard=shard)(
                    args["params"], args["cache"], args["tokens"])
        trace_s = time.perf_counter() - t0
        counter.sweep()
        outs = [_local(t) for t in _leaves(_as_tree(out))
                if isinstance(t, torch.Tensor)]
        out_bytes = sum(t.numel() * t.element_size() for t in outs)
        del out, args, locals_, outs

    coll = counter.collectives()
    mf, n_total, n_active = model_flops(cfg, shape)
    terms = analytic_terms(cfg, shape, n_devices)
    terms["collective_term_s"] = coll["total"] / mesh_lib.NET_BW
    temp = counter.peak
    rec.update(
        status="ok", device_type=device_type, trace_s=round(trace_s, 3),
        compile_s=None, n_devices=n_devices,
        params_total=n_total, params_active=n_active,
        model_flops_global=mf, flops_per_device=float(counter.flops),
        bytes_per_device=None,
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": out_bytes,
                "temp_size_in_bytes": temp,
                "alias_size_in_bytes": None,
                "generated_code_size_in_bytes": None},
        fits_80gb=arg_bytes + temp <= HBM_BYTES,
        collectives=coll,
        collective_counts={k: int(v) for k, v in
                           counter.collective_count.items()},
        roofline=terms,
    )
    return rec


def _as_tree(x):
    """A step's output (tuples, dicts, tensors, numbers) as nested dicts."""
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {i: _as_tree(v) for i, v in enumerate(x)}
    return x


def _in_child(*args) -> dict:
    """:func:`run_cell` in a spawned child process, so that the caller's
    default process group stays as it is."""
    import concurrent.futures
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        return ex.submit(_child_cell, *args).result()


def _child_cell(arch, shape_name, multi_pod, rules, tag, variant,
                device_type, cfg, mesh_shape):
    return run_cell(arch, shape_name, multi_pod, rules, tag, variant,
                    device_type, cfg=cfg, mesh_shape=mesh_shape)


def summary_rows(records) -> list[str]:
    """Markdown rows, one an (arch, shape), each value "16x16 / 2x16x16"
    (one mesh alone when only one ran): per-device argument and temp GB,
    fits 80 GB, matmul TFLOP a device, all-gather, all-reduce,
    reduce-scatter and all-to-all GB, and the compute, memory and
    collective terms in seconds.  Skipped cells give their reason."""
    cells: dict = {}
    for r in records:
        cells.setdefault((r["arch"], r["shape"]), []).append(r)
    cols = [lambda r: r["memory"]["argument_size_in_bytes"] / 1e9,
            lambda r: r["memory"]["temp_size_in_bytes"] / 1e9,
            lambda r: "yes" if r["fits_80gb"] else "no",
            lambda r: r["flops_per_device"] / 1e12]
    cols += [lambda r, k=k: r["collectives"][k] / 1e9
             for k in ("all-gather", "all-reduce", "reduce-scatter",
                       "all-to-all")]
    cols += [lambda r, k=k: r["roofline"][k]
             for k in ("compute_term_s", "memory_term_s",
                       "collective_term_s")]

    def fmt(x):
        return x if isinstance(x, str) else f"{x:.4g}"

    rows = []
    for (arch, shape), recs in cells.items():
        recs = sorted(recs, key=lambda r: r["mesh"])     # 16x16 first
        if all(r["status"] != "ok" for r in recs):
            why = recs[0].get("reason") or recs[0].get("error", "")
            rows.append(f"| {arch} | {shape} | {recs[0]['status']}: {why} |"
                        + " |" * (len(cols) - 1))
            continue
        rows.append("| " + " | ".join([arch, shape] + [
            " / ".join(fmt(c(r)) if r["status"] == "ok" else "—"
                       for r in recs) for c in cols]) + " |")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--variant", default="baseline",
                    help="'+'-joined: moe_local, sp, kv_seq, no_fsdp, "
                         "no_remat")
    ap.add_argument("--device-type", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device type (cpu where no card is)")
    ap.add_argument("--out", default=str(RESULTS))
    args = ap.parse_args(argv)

    archs = list(configs.ARCHS) if args.arch == "all" else [args.arch]
    shape_names = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    records = []
    for arch in archs:
        for shape_name in shape_names:
            for mp in meshes:
                mesh_tag = "multipod" if mp else "singlepod"
                fname = outdir / f"{arch}__{shape_name}__{mesh_tag}__" \
                    f"{args.tag}.json"
                if fname.exists():
                    print(f"[skip-cached] {fname.name}")
                    records.append(json.loads(fname.read_text()))
                    continue
                print(f"[dryrun] {arch} x {shape_name} x {mesh_tag} ...",
                      flush=True)
                try:
                    rec = run_cell(arch, shape_name, mp, tag=args.tag,
                                   variant=args.variant,
                                   device_type=args.device_type)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if mp else "16x16",
                           "tag": args.tag, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                fname.write_text(json.dumps(rec, indent=1))
                records.append(rec)
                print(f"  -> {rec['status']}"
                      + (f" trace={rec.get('trace_s')}s"
                         if rec["status"] == "ok" else
                         f" ({rec.get('reason') or rec.get('error')})"),
                      flush=True)
    print("\n".join(summary_rows(records)))


if __name__ == "__main__":
    main()
