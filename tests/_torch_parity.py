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

# The port's tests run beside the JAX package's in the same pytest-xdist
# workers, and every worker imports this module while it collects.  Left
# alone, torch's intra-op pool takes every core in every worker; the
# oversubscribed cores starve XLA's in-process collectives, and an
# all-reduce over the host devices that tests/test_dryrun_tools.py forces
# (512 of them) misses its rendezvous deadline, which aborts the worker
# (tests/test_service.py's prewarm).  The port's CPU tests are bound by the
# per-op overhead of small tensors: one thread costs them nothing.
torch.set_num_threads(1)


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


def lm_pair(arch, dtype=None, **kw):
    """(JAX config, port config, JAX params, port params) for a reduced
    ``arch`` with ``kw`` replaced in both configs; ``dtype`` 'bf16'
    switches both to bfloat16.  The weights are the JAX package's."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as jtf
    from repro_torch import configs as tconfigs

    jcfg = jconfigs.get(arch).reduced()
    tcfg = tconfigs.get(arch).reduced()
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
    jp = jtf.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, tcfg, jp, params_to_torch(jp, tcfg)


def lm_tokens(B, T, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def greedy_decode_both(jcfg, tcfg, jp, tp, toks, steps: int = 8,
                       tol: float = 1e-4):
    """Prefill ``toks`` (no pad_to: the ring buffer evicts, as ``serve``
    runs it) and decode ``steps`` greedy tokens in both packages; the
    prefill cache and every step's logits agree to ``tol``.  Returns the
    two token sequences (B, 1 + steps)."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtf
    from repro_torch.models import transformer as ttf

    jpre = jax.jit(jtf.make_prefill_step(jcfg))
    jserve = jax.jit(jtf.make_serve_step(jcfg))
    tpre, tserve = ttf.make_prefill_step(tcfg), ttf.make_serve_step(tcfg)

    jl_, jc = jpre(jp, {"tokens": toks})
    tl_, tc = tpre(tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(host(tl_), np.asarray(jl_), rtol=tol,
                               atol=tol)
    for key in ("k", "v"):
        np.testing.assert_allclose(host(tc[key]), np.asarray(jc[key]),
                                   rtol=tol, atol=tol)
    assert int(tc["pos"]) == int(jc["pos"]) == toks.shape[1]
    jtok = jnp.argmax(jl_[:, -1], -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl_[:, -1], -1)[:, None]
    jseq, tseq = [np.asarray(jtok)], [host(ttok)]
    for _ in range(steps):
        jl_, jc = jserve(jp, jc, jtok)
        tl_, tc = tserve(tp, tc, ttok)
        np.testing.assert_allclose(host(tl_), np.asarray(jl_), rtol=tol,
                                   atol=tol)
        jtok = jnp.argmax(jl_[:, -1], -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl_[:, -1], -1)[:, None]
        jseq.append(np.asarray(jtok))
        tseq.append(host(ttok))
    assert int(tc["pos"]) == toks.shape[1] + steps
    return np.concatenate(tseq, 1), np.concatenate(jseq, 1)


def tied_router_logits(E: int, tokens: int, seed: int = 0,
                       device="cpu"):
    """float32 router logits (1, tokens, E) as a bfloat16 router product
    gives them (values on the bfloat16 grid, so equal values are common at
    E = 384), with rows of exact ties: all equal, three-way ties at the
    top, pairs of equal values (a tie across the k-th place), and the
    pattern [1, 2, 2, 0, 2, ...]."""
    x = np.random.default_rng(seed).normal(size=(1, tokens, E))
    x = torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).float()
    x[0, 0] = 0.5
    x[0, 1, [0, E // 2, E - 1]] = 9.0
    x[0, 2] = torch.arange(E - 1, -1, -1) // 2
    x[0, 3, :5] = torch.tensor([1.0, 2.0, 2.0, 0.0, 2.0])
    x[0, 3, 5:] = -1.0
    return x.to(device)


def cnn_params_numpy(cfg, seed: int = 0, bias: float = 0.1) -> dict:
    """Parameters of the JAX package's CNN ``cfg`` (its ``CnnConfig``) in
    its layout, drawn with numpy: weights normal / sqrt(fan_in) as its
    ``init_params`` draws them, biases normal x ``bias`` (0: zeros, as
    ``init_params`` sets them).  (Eager ``jax.random`` compiles every
    shape on the CPU, seconds a model.)"""
    import jax

    from repro.models import cnn

    shapes = jax.eval_shape(lambda k: cnn.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        w, b = shapes[name]["w"].shape, shapes[name]["b"].shape
        fan_in = 25 * w[2] if len(w) == 4 else w[0]
        out[name] = {
            "w": (rng.normal(size=w) / np.sqrt(fan_in)).astype(np.float32),
            "b": (bias * rng.normal(size=b)).astype(np.float32)}
    return out


def assert_bitwise(got, want, err_msg: str = "") -> None:
    """Same shape, same dtype width, same bits."""
    g, w = host(got), host(want)
    assert g.shape == w.shape, (err_msg, g.shape, w.shape)
    assert g.dtype == w.dtype, (err_msg, g.dtype, w.dtype)
    np.testing.assert_array_equal(np.atleast_1d(g).view(np.uint8),
                                  np.atleast_1d(w).view(np.uint8),
                                  err_msg=err_msg)


def assert_engine_match(got, want, rtol: float = 1e-5) -> None:
    """Two engine results (``EngineResult`` of either package): integer
    leaves (assignment, compression levels, round and escape counts, the
    move trace) exactly equal, objectives to ``rtol``."""
    for name in ("assign", "rounds", "escapes", "converged", "comp"):
        np.testing.assert_array_equal(host(getattr(got, name)),
                                      host(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(host(got.trace.moves),
                                  host(want.trace.moves))
    np.testing.assert_array_equal(host(got.trace.rounds_valid),
                                  host(want.trace.rounds_valid))
    for name in ("R_best", "R_current"):
        np.testing.assert_allclose(host(getattr(got.trace, name)),
                                   host(getattr(want.trace, name)),
                                   rtol=rtol, err_msg=name)
    for name in ("R", "R_search"):
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=rtol,
                                   err_msg=name)
    np.testing.assert_allclose(host(got.sroa.t), host(want.sroa.t),
                               rtol=rtol)


def tree_bitwise(got, want) -> None:
    """Every leaf of two (nested) NamedTuple results bitwise equal."""
    if isinstance(got, tuple):
        assert type(got) is type(want)
        for g, w in zip(got, want):
            tree_bitwise(g, w)
    else:
        assert_bitwise(got, want)


_BIAS_NAMES = {"ln_b", "final_ln_b", "bq", "bk", "bv", "b_in", "b_out"}


def with_random_biases(jax_params, seed: int = 0, scale: float = 0.1):
    """A JAX model's parameters with every bias and layer-norm shift drawn
    normal x ``scale`` and every norm scale (``ln``, ``final_ln``) 1 +
    normal x ``scale``, from numpy's ``default_rng(seed)``: ``init_params``
    sets them to zeros and ones, which would hide a missing bias or a
    swapped scale and shift."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _BIAS_NAMES:
                out[k] = jnp.asarray(scale * rng.normal(size=v.shape),
                                     v.dtype)
            elif k in ("ln", "final_ln"):
                out[k] = jnp.asarray(1.0 + scale * rng.normal(size=v.shape),
                                     v.dtype)
            else:
                out[k] = v
        return out

    return walk(jax_params)


def lm_batch(cfg, B: int, T: int, seed: int = 0) -> dict:
    """A numpy batch of ``T`` positions for ``cfg``'s input mode: tokens
    (B, T); embeds (B, T, d) and labels (B, T); or patches (B, n_patches,
    d) and tokens (B, T - n_patches).  Normal float32 embeddings, int32
    ids."""
    rng = np.random.default_rng(seed)
    d, V = cfg.d_model, cfg.vocab
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, V, (B, T), dtype=np.int32)}
    if cfg.input_mode == "embeds":
        return {"embeds": rng.normal(size=(B, T, d)).astype(np.float32),
                "labels": rng.integers(0, V, (B, T), dtype=np.int32)}
    P = cfg.n_patches
    return {"patches": rng.normal(size=(B, P, d)).astype(np.float32),
            "tokens": rng.integers(0, V, (B, T - P), dtype=np.int32)}


def batch_both(batch: dict):
    """A numpy batch as (JAX arrays, torch tensors)."""
    import jax.numpy as jnp

    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.tensor(v) for k, v in batch.items()})
