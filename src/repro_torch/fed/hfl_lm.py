"""HFL for LM training: the paper's Algorithm 1 applied to a language
model (the JAX package's ``fed/hfl_lm.py``).

A pod is an edge server and the cross-pod mean is the cloud (eq 3).  Every
pod keeps its own replica of the parameters (a leading pod axis P on every
leaf, and on every optimizer-state leaf) and runs K local optimizer steps
on its own K microbatches; then every parameter leaf becomes its float32
mean over the pods, cast back to its dtype and given to every pod.  The
optimizer states are not averaged.  The local steps take neither gradient
clipping nor a learning-rate schedule, as in the reference.

The pods and their steps run as a Python loop on one device (the
reference vmaps the pods and scans the steps).  ``stacked_abstract`` and
``stacked_axes`` give the stacked parameters' ``meta`` tensors and logical
axes (the pod axis on ``hfl_pod``) for the dry-run
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.cnn import tree_map


def _pod(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def _stack(trees: list):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_hfl_lm_train_step(cfg: tf.ArchConfig, optimizer, *, K: int):
    """Returns ``step(params_stacked, opt_state_stacked, batches) ->
    (params, opt_state, {"ce"})``: params and opt_state leaves carry a
    leading pod axis P, batch leaves are (P, K, ...): K microbatches a pod
    an outer step.  ``ce`` is the mean over pods of each pod's mean
    cross-entropy over its K steps."""

    def step(params_stacked, opt_state_stacked, batches):
        P = next(iter(batches.values())).shape[0]
        pods, states, ces = [], [], []
        for i in range(P):
            params, state = _pod(params_stacked, i), _pod(opt_state_stacked,
                                                          i)
            ce = []
            for k in range(K):
                batch = {name: b[i, k] for name, b in batches.items()}
                _, metrics, grads = tf.value_and_grad(cfg, params, batch)
                params, state = optimizer.update(grads, state, params)
                ce.append(metrics["ce"])
            pods.append(params)
            states.append(state)
            ces.append(torch.stack(ce).mean())
        stacked = _stack(pods)
        # eq (3): the cloud's average, the only cross-pod step.
        params = tree_map(
            lambda p: p.float().mean(0, keepdim=True).to(p.dtype).expand(
                p.shape).contiguous(), stacked)
        return params, _stack(states), {"ce": torch.stack(ces).mean()}

    return step


def stacked_abstract(cfg: tf.ArchConfig, pods: int):
    """The parameters with a leading pod axis, as ``meta`` tensors."""
    return tree_map(lambda t: torch.empty((pods,) + tuple(t.shape),
                                          dtype=t.dtype, device="meta"),
                    tf.abstract_params(cfg))


def stacked_axes(cfg: tf.ArchConfig):
    """The stacked parameters' logical axes: ``hfl_pod`` first."""
    return tree_map(lambda a: ("hfl_pod",) + a, tf.logical_axes(cfg))
