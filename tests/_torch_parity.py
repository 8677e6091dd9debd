"""Carry the JAX package's pytrees across to the PyTorch port.

Both packages are fed the same inputs: a JAX ``Scenario`` or
``FleetScenario`` becomes a dict of numpy leaves, which the port's
``scenario_from_numpy`` / ``fleet_from_numpy`` turn into tensors bit for
bit; a JAX model's parameter dict goes through ``params_from_numpy``.
Results come back the other way through :func:`host`.
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(tree) -> dict:
    """A NamedTuple pytree as a (nested) dict of numpy arrays; ``None``
    leaves are dropped, nested NamedTuples become nested dicts."""
    out = {}
    for name, leaf in zip(tree._fields, tree):
        if leaf is None:
            continue
        out[name] = (to_numpy(leaf) if hasattr(leaf, "_fields")
                     else np.asarray(leaf))
    return out


def host(x) -> np.ndarray:
    """A torch tensor or a JAX array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scenario_to_torch(scn, device="cpu"):
    from repro_torch.core.wireless import scenario_from_numpy
    return scenario_from_numpy(to_numpy(scn), device)


def fleet_to_torch(fleet, device="cpu"):
    from repro_torch.fleet.batch import fleet_from_numpy
    return fleet_from_numpy(to_numpy(fleet), device)


def params_to_torch(jax_params, cfg, device="cpu"):
    """A JAX model's nested parameter dict as the port's tensors, for the
    port's ``ArchConfig`` ``cfg`` (bfloat16 leaves cross exactly)."""
    from repro_torch.models.transformer import params_from_numpy

    def numpy_tree(node):
        if isinstance(node, dict):
            return {k: numpy_tree(v) for k, v in node.items()}
        return np.asarray(node)

    return params_from_numpy(numpy_tree(jax_params), cfg, device)


def assert_bitwise(got, want, err_msg: str = "") -> None:
    """Same shape, same dtype width, same bits."""
    g, w = host(got), host(want)
    assert g.shape == w.shape, (err_msg, g.shape, w.shape)
    assert g.dtype == w.dtype, (err_msg, g.dtype, w.dtype)
    np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                  np.atleast_1d(w).view(np.uint8),
                                  err_msg=err_msg)
