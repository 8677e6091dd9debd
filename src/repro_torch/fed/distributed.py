"""Distributed HFL: Algorithm 1 with the clients split over ranks (the JAX
package's ``fed/distributed.py``), on ``torch.distributed``.

Mapping (DESIGN.md §2): the users are split over the mesh's ``data`` axis
(``("pod", "data")`` when ``multi_pod``), a contiguous slice a rank; the
model is replicated.  *Edge aggregation* (eq 2) is each rank's
(M, ...) weighted sum over its own users, all-reduced over the client
ranks together with the (M,) weights, then divided; *global aggregation*
(eq 3) follows from the reduced edge models on every rank alike.  The K
edge iterations between cloud averages make K + 1 all-reduces a global
iteration, each of one flat buffer (every leaf's numerator and the
denominator).  As in the reference, the distributed body takes no uplink
compression.

:func:`run_ranks` starts the ranks: ``torch.multiprocessing.spawn`` with a
``file://`` rendezvous in a temporary directory (parallel callers never
share a port), the backend named by the caller: ``"nccl"`` one rank a card
(NCCL refuses two ranks on one card), ``"gloo"`` on CPU or CUDA tensors.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.fed import hfl
from repro_torch.models import cnn
from repro_torch.models.cnn import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime import sharding


def _client_dims(multi_pod: bool) -> tuple:
    return ("pod", "data") if multi_pod else ("data",)


def make_distributed_global_iteration(mesh, cnn_cfg: cnn.CnnConfig,
                                      cfg: hfl.HflConfig, M: int,
                                      multi_pod: bool = False):
    """Returns ``fn(w, x_u, y_u, mask_u, sizes, onehot, participate) ->
    w``, run by every rank of ``mesh`` on its own users' slice (leading
    axis of ``x_u`` ... ``participate``, see :func:`shard_clients`); ``w``
    is the replicated global model, and every rank returns the same new
    one."""
    dims = _client_dims(multi_pod)
    # one all-reduce over the whole mesh when the clients span it, else
    # one a client axis (the sum of sums is the same sum)
    groups = ([None] if set(dims) == set(mesh.mesh_dim_names)
              else [mesh.get_group(d) for d in dims])

    def all_reduce(t):
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    def edge_aggregate(user_params, weights, onehot):
        """eq (2) over every rank's users: (edge models (M, ...), D_m)."""
        leaves = tree_leaves(user_params)
        num = [torch.einsum("n,nm,n...->m...", weights, onehot, leaf)
               for leaf in leaves]
        den = torch.einsum("n,nm->m", weights, onehot)
        flat = all_reduce(torch.cat([t.reshape(-1) for t in num] + [den]))
        den = flat[-M:]
        parts = flat[:-M].split([t.numel() for t in num])
        floor = torch.clamp_min(den, 1e-9)
        edge = [p.reshape(t.shape) / floor.reshape((-1,) + (1,) * (
            t.ndim - 1)) for p, t in zip(parts, num)]
        return tree_unflatten(user_params, edge), den

    def global_iteration(w, x_u, y_u, mask_u, sizes, onehot, participate):
        weights = sizes * participate
        with torch.no_grad(), hfl.f32_math():
            user_params = hfl.broadcast_tree(w, x_u.shape[0])
            for _ in range(cfg.K):
                trained = hfl._local_train(cnn_cfg, cfg, user_params, x_u,
                                           y_u, mask_u)
                edge, _ = edge_aggregate(trained, weights, onehot)
                user_params = tree_map(
                    lambda em: torch.einsum("nm,m...->n...", onehot, em),
                    edge)
            edge, den = edge_aggregate(user_params, weights, onehot)
            return hfl.cloud_average(edge, den)

    return global_iteration


def allreduce_bytes(w, M: int, K: int) -> int:
    """Bytes one rank all-reduces a global iteration: K + 1 buffers of the
    M edge models and the M weights, float32."""
    return (K + 1) * 4 * M * (sum(t.numel() for t in tree_leaves(w)) + 1)


def shard_clients(mesh, multi_pod: bool, *trees):
    """This rank's contiguous slice (the leading axis split over the
    client ranks in mesh order, as JAX's ``P(("pod", "data"))``) of each
    tensor."""
    rules = sharding.ShardingRules(batch=_client_dims(multi_pod))
    idx, n = sharding.shard_index(mesh, rules.placements(mesh, ("batch",)),
                                  0)
    return [t.tensor_split(n)[idx] for t in trees]


# ---------------------------------------------------------- the launcher
def run_ranks(world: int, backend: str, fn, *args, device="cuda"):
    """``fn(rank, world, device, *args)`` on ``world`` spawned processes,
    each with the default process group of ``backend`` open; returns the
    ranks' results (tensors moved to the CPU), in rank order.

    ``backend`` is ``"nccl"`` (``device`` must be ``"cuda"``: rank r on
    card r, at most one rank a card) or ``"gloo"`` (CPU tensors, or CUDA
    tensors with rank r on card r mod the card count).  ``fn`` must be
    importable by name from the children (a module-level function).  Each
    rank runs torch on one thread."""
    dev_type = torch.device(device).type
    if backend == "nccl":
        if dev_type != "cuda":
            raise ValueError("nccl runs on CUDA tensors only")
        if world > torch.cuda.device_count():
            raise ValueError(f"nccl takes one card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', not "
                         f"{backend!r}")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, backend, dev_type, tmp, fn, args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(rank, world, backend, dev_type, tmp, fn, args):
    torch.set_num_threads(1)
    if dev_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, dev, *args)
        torch.save(_to_cpu(out), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def mesh_over(world: int, multi_pod: bool, device_type: str):
    """The client mesh over ``world`` ranks: (2, world / 2) ``("pod",
    "data")`` when ``multi_pod``, else (world,) ``("data",)``."""
    from torch.distributed.device_mesh import init_device_mesh

    if multi_pod:
        return init_device_mesh(device_type, (2, world // 2),
                                mesh_dim_names=("pod", "data"))
    return init_device_mesh(device_type, (world,), mesh_dim_names=("data",))


def global_iteration_on_ranks(rank, world, dev, cnn_cfg, cfg, M, multi_pod,
                              w, data, parts, reps: int = 1):
    """A rank's part of :func:`run_ranks`: the client mesh over the
    ranks, this rank's slice of ``data`` = (x_u, y_u, mask_u, sizes,
    onehot), and one distributed global iteration from ``w`` for each
    participation mask of ``parts``.  Returns {"w": [new models], "ms":
    host-clock ms of ``reps`` more iterations on the first mask (the card
    synchronised), "bytes": all-reduced bytes an iteration}."""
    import time

    mesh = mesh_over(world, multi_pod, dev.type)
    step = make_distributed_global_iteration(mesh, cnn_cfg, cfg, M,
                                             multi_pod)
    w = tree_map(lambda t: t.to(dev), w)
    mine = shard_clients(mesh, multi_pod, *(t.to(dev) for t in data),
                         *(p.to(dev) for p in parts))
    data, parts = mine[:len(data)], mine[len(data):]
    outs = [step(w, *data, p) for p in parts]
    t0 = time.perf_counter()
    for _ in range(reps):
        step(w, *data, parts[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(reps, 1)
    return {"w": outs, "ms": ms, "bytes": allreduce_bytes(w, M, cfg.K)}
