"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) for the zoo (the
JAX package's ``runtime/sharding.py``), on ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.

Every parameter and activation carries a tuple of *logical* axis names; a
rule table maps those to mesh axes.  ``ShardingRules.spec`` gives the
reference's ``PartitionSpec`` entries as a plain tuple (None, a mesh axis
name or a tuple of names, one entry a tensor dim); ``placements`` turns
them into DTensor placements, one a mesh dim: ``Shard(d)`` where tensor
dim ``d`` names that mesh axis, else ``Replicate()``.  A dim mapped to
several mesh axes (``("pod", "data")``) is ``Shard(d)`` on each of them;
DTensor splits it major-to-minor in mesh order, as JAX does, so such a
tuple must list its axes in mesh order.

Given a shape, a mesh axis that does not divide its dim is dropped (the
reference's dry-run does the same for pjit's arguments, which must divide
evenly): DTensor would accept the uneven shards, but its per-device bytes
would then differ from JAX's, and it cannot split a flattened dim into
heads whose count the mesh axis does not divide.  The sharder applies the
rule to every constraint too (JAX pads an uneven constraint instead).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch


def cell_mesh(devices=None) -> list[torch.device] | None:
    """The devices to split the fleet's cell axis over, or None for one
    device (the reference's 1-D cell mesh; D5 padding makes the per-cell
    shapes static, so cells split trivially).

    Only an explicit list of at least two devices splits; None (the
    default) keeps the whole search on the fleet's device, as the
    reference's ``cell_mesh`` returns None on a single device.
    """
    if devices is None:
        return None
    devices = [torch.device(d) for d in devices]
    return devices if len(devices) > 1 else None


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or tuple of axes, or None=replicate)."""

    batch: tuple | str | None = ("data",)
    seq: tuple | str | None = None          # SP: set to ('data',) for 500k
    d_model: tuple | str | None = None      # FSDP axis for the embed dim
    ff: tuple | str | None = ("model",)     # TP: FFN columns
    heads: tuple | str | None = ("model",)  # TP: attention heads
    qkv: tuple | str | None = ("model",)    # TP: flattened q/k/v output dim
    vocab: tuple | str | None = ("model",)
    expert: tuple | str | None = ("model",)  # EP
    expert_cap: tuple | str | None = ("data",)
    moe_groups: tuple | str | None = None    # MoE dispatch-group axis
    moe_groups_ep: tuple | str | None = None  # group axis in expert compute
    kv_batch: tuple | str | None = ("data",)  # decode-time KV cache batch
    kv_seq: tuple | str | None = None        # decode KV cache seq (SP decode)
    resid_seq: tuple | str | None = None     # Megatron-SP residual stream
    hfl_pod: tuple | str | None = ("pod",)   # HFL-LM per-pod replica axis
    microbatch: None = None                  # HFL-LM K-microbatch axis
    layers: None = None                     # stacked-layer dim: never sharded
    conv: None = None
    state: None = None

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        v = getattr(self, logical)
        if v is None or isinstance(v, str):
            return v
        return tuple(v) if len(v) > 1 else v[0]

    def spec(self, axes: tuple, mesh=None, shape=None) -> tuple:
        """The reference's ``PartitionSpec(*entries)`` as a tuple; with a
        mesh (a ``DeviceMesh`` or {axis name: size}) and a shape, an entry
        whose mesh axes do not divide its dim is None (a dim of size None
        keeps its entry)."""
        entries = tuple(self.mesh_axes(a) for a in axes)
        if mesh is None or shape is None:
            return entries
        sizes = mesh if isinstance(mesh, dict) else mesh_sizes(mesh)
        return tuple(
            None if e is not None and n is not None and n % math.prod(
                sizes[a] for a in _names(e)) else e
            for e, n in zip(entries, shape))

    def placements(self, mesh, axes: tuple, shape=None) -> list:
        """DTensor placements on ``mesh`` for a tensor whose dims carry the
        logical ``axes`` (the divisibility rule applies when ``shape`` is
        given)."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec(axes, mesh, shape)):
            if entry is None:
                continue
            idx = [names.index(a) for a in _names(entry)]
            if idx != sorted(idx):
                raise ValueError(f"mesh axes {entry} of dim {dim} are not "
                                 f"in mesh order {tuple(names)}")
            for i in idx:
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {names[i]!r} shards two "
                                     f"dims of axes {axes}")
                out[i] = Shard(dim)
        return tuple(out)


def _names(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_sizes(mesh) -> dict:
    """{mesh axis name: its size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


# Defaults used by the dry-run baseline; hillclimbs override fields.
def default_rules(multi_pod: bool = False, fsdp_model_dim: bool = True,
                  seq_shard: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    return ShardingRules(
        batch=dp,
        d_model=("data",) if fsdp_model_dim else None,
        seq=("data",) if seq_shard else None,
    )


def shard_index(mesh, placements, dim: int) -> tuple[int, int]:
    """(index, count): this device's shard of tensor dim ``dim`` among the
    ``count`` shards that ``placements`` cut it into on ``mesh`` (the mesh
    dims that shard it, major-to-minor in mesh order, as DTensor splits
    and as JAX's ``devices_indices_map`` does)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx, n = 0, 1
    for i, p in enumerate(placements):
        if p == Shard(dim):
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return idx, n


@dataclasses.dataclass(frozen=True)
class Summed:
    """An output spec of :meth:`Sharder.local`: a value whose dims carry the
    logical ``axes`` and which is a partial sum over the mesh axes of the
    logical axis ``over`` (each device summed only its own slice)."""

    axes: tuple
    over: str


class Sharder:
    """``shard(x, *logical_axes)`` places ``x`` by the rules: the identity
    when ``mesh`` is None (single-device runs); otherwise a DTensor is
    redistributed (the collectives its placements need), and a plain
    tensor is taken as replicated on every rank first, which costs no
    communication.

    The model calls nothing of DTensor but this object: :meth:`local` runs
    a function on each device's local shards (the counterpart of the
    reference's ``shard_map``), :meth:`index` says which shard of a dim
    this device holds, and :meth:`spmd` is the context of a sharded step.
    """

    def __init__(self, mesh, rules: ShardingRules):
        self.mesh, self.rules = mesh, rules
        self._depth = 0                  # open spmd() contexts

    def __call__(self, x, *axes):
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor, Replicate

        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, self.rules.placements(
            self.mesh, axes, x.shape))

    @contextlib.contextmanager
    def spmd(self):
        """Plain tensors made inside the model (positions, masks, RoPE
        tables, constants) meet DTensors as replicated ones.  A no-op
        without a mesh; re-entrant (DTensor's own context switches off on
        any exit, and a remat block recomputes inside the backward
        pass)."""
        if self.mesh is None or self._depth:
            yield
            return
        from torch.distributed.tensor.experimental import \
            implicit_replication
        self._depth += 1
        try:
            with implicit_replication():
                yield
        finally:
            self._depth -= 1

    def index(self, axes: tuple, shape, dim: int) -> tuple[int, int]:
        """:func:`shard_index` of dim ``dim`` of a tensor of ``shape``
        placed by the logical ``axes``; (0, 1) without a mesh."""
        if self.mesh is None:
            return 0, 1
        return shard_index(self.mesh, self.rules.placements(
            self.mesh, axes, shape), dim)

    def local(self, fn, in_axes: tuple, out_axes: tuple, uneven=()):
        """``fn`` run on each device's local shards (``fn`` itself without
        a mesh).

        ``in_axes`` holds one entry a positional argument, every one a
        tensor: the logical axes to place it by before its local shard is
        passed (a plain tensor counts as replicated; ``()`` leaves it
        whole).  A DTensor already placed so passes its own local shard,
        so ``fn`` may write into it.
        ``out_axes`` holds one entry an output of ``fn`` (a tuple of
        them, or one tensor for one entry): its logical axes, or a
        :class:`Summed`; () when ``fn`` returns nothing to place.  A mesh
        axis that does not divide its dim is dropped (the divisibility
        rule, with the sizes the arguments give each logical axis),
        except for the logical axes in ``uneven``, which split as
        ``torch.chunk`` does (JAX pads them) and whose outputs take their
        global size from the arguments.

        The gradient of an argument that is whole along a mesh axis over
        which the outputs split is the sum of the devices' local
        gradients (a partial sum there).  DTensor's ``local_map`` takes
        the local gradient as the whole one and leaves out that sum, and
        it infers uneven outputs' global shapes wrongly; hence this.
        """
        mesh, rules = self.mesh, self.rules
        if mesh is None:
            return fn

        def run(*args):
            from torch.distributed.tensor import (DTensor, Partial,
                                                  Replicate, Shard)

            sizes = {}
            for a, ax in zip(args, in_axes, strict=True):
                sizes.update((n, s) for n, s in zip(ax, a.shape)
                             if n is not None)

            def place(axes, shape):
                return rules.placements(mesh, axes, tuple(
                    None if n in uneven else s for n, s in zip(axes, shape)))

            outs = []
            for spec in out_axes:
                axes, over = ((spec.axes, spec.over)
                              if isinstance(spec, Summed) else (spec, None))
                pl = list(place(axes, [sizes.get(n) for n in axes]))
                if over is not None:
                    for i, p in enumerate(place((over,), (sizes.get(over),))):
                        if p != Replicate():
                            if pl[i] != Replicate():
                                raise ValueError(f"mesh dim {i} shards "
                                                 f"{axes} and sums {over}")
                            pl[i] = Partial()
                outs.append((axes, tuple(pl)))
            split = {i for _, pl in outs for i, p in enumerate(pl)
                     if p != Replicate()}

            local_args = []
            for a, ax in zip(args, in_axes):
                pl = place(ax, a.shape)
                if not isinstance(a, DTensor):
                    if all(p == Replicate() for p in pl):
                        local_args.append(a)
                        continue
                    a = DTensor.from_local(a, mesh,
                                           [Replicate()] * mesh.ndim,
                                           run_check=False)
                if tuple(a.placements) != pl:
                    a = a.redistribute(mesh, pl)
                local_args.append(a.to_local(grad_placements=tuple(
                    Partial() if i in split and p == Replicate() else p
                    for i, p in enumerate(pl))))

            res = fn(*local_args)
            if not out_axes:
                return res
            one = not isinstance(res, tuple)
            placed = []
            for o, (axes, pl) in zip((res,) if one else res, outs,
                                     strict=True):
                inferred, shape = [], []
                for d, n in enumerate(o.shape):
                    k = math.prod(mesh.size(i) for i, p in enumerate(pl)
                                  if p == Shard(d))
                    name = axes[d] if d < len(axes) else None
                    inferred.append(n * k)
                    shape.append(sizes[name] if k > 1 and name in sizes
                                 else n * k)
                kw = {} if shape == inferred else dict(
                    shape=torch.Size(shape), stride=_strides(shape))
                placed.append(DTensor.from_local(o, mesh, pl,
                                                 run_check=False, **kw))
            return placed[0] if one else tuple(placed)

        return run


def _strides(shape) -> tuple:
    out, n = [], 1
    for s in reversed(shape):
        out.append(n)
        n *= s
    return tuple(reversed(out))


def make_sharder(mesh, rules: ShardingRules) -> Sharder:
    """The :class:`Sharder` of ``mesh`` (None: the identity) and the rule
    table, which ride along as ``.mesh`` and ``.rules``."""
    return Sharder(mesh, rules)


IDENTITY = Sharder(None, ShardingRules())


def _map_axes(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_placements(mesh, axes_tree, rules: ShardingRules, shapes=None):
    """A nested dict of logical-axis tuples as DTensor placements on
    ``mesh`` (with a matching tree of ``shapes``, under the divisibility
    rule)."""
    if shapes is None:
        return _map_axes(lambda a: rules.placements(mesh, a), axes_tree)
    return {k: tree_placements(mesh, v, rules, shapes[k])
            if isinstance(v, dict) else rules.placements(mesh, v, shapes[k])
            for k, v in axes_tree.items()}
