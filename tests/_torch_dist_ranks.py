"""Rank functions for the port's multi-process tests: spawned children
import this module by name, so it imports torch and the port only (no JAX,
no pytest)."""
from __future__ import annotations


def sharded_prefill(rank, world, dev, runs):
    """For each (arch, variant) of ``runs``: :func:`_sharded_prefill`."""
    return [_sharded_prefill(world, arch, variant) for arch, variant in runs]


def _sharded_prefill(world, arch, variant):
    """The reduced ``arch``'s prefill logits, one decode step's logits
    from the prefill's cache, the loss and its gradient on a 2 x 2 (data,
    model) mesh over the 4 ranks, sharded by the dry-run's rules under
    ``variant``, beside the same model run unsharded on this rank."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.runtime import sharding as sh

    cfg, rules = dryrun.apply_variant(configs.get(arch).reduced(),
                                      sh.default_rules(), variant, world,
                                      False)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, g, "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16), generator=g)}

    def place(t, axes):
        return distribute_tensor(t, mesh, rules.placements(mesh, axes,
                                                           t.shape))

    placed = dryrun._zip_map(place, params, tf.logical_axes(cfg))
    pbatch = {"tokens": place(batch["tokens"], ("batch", "seq"))}
    shard = sh.make_sharder(mesh, rules)
    tok = batch["tokens"][:, -1:]
    got, cache = tf.make_prefill_step(cfg, shard=shard, pad_to=20)(placed,
                                                                  pbatch)
    step = tf.make_serve_step(cfg, shard=shard)(
        placed, cache, place(tok, ("kv_batch", None)))[0]
    loss, _, grads = tf.value_and_grad(cfg, placed, pbatch, shard=shard)
    with torch.no_grad():
        want, cache = tf.make_prefill_step(cfg, pad_to=20)(params, batch)
        want_step = tf.make_serve_step(cfg)(params, cache, tok)[0]
    want_loss, _, want_grads = tf.value_and_grad(cfg, params, batch)
    return {"logits": got.full_tensor(), "want": want,
            "step": step.full_tensor(), "want_step": want_step,
            "loss": loss.full_tensor(), "want_loss": want_loss,
            "grads": [g.full_tensor() for g in tf.tree_leaves(grads)],
            "want_grads": tf.tree_leaves(want_grads),
            "placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in got.placements]}
