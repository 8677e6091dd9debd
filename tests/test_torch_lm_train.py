"""Port parity for LM training: ``loss_fn``, its gradients and
``make_train_step`` (``models/transformer.py``) and ``fed/hfl_lm.py``
against the JAX package, on reduced f32 configs of the six kinds of model
(dense with qkv biases and tied embeddings, moe, the hybrid with a group
and a tail layer, xlstm with two pairs, the encoder on ``embeds``, the
dense family on ``mixed`` input), with the JAX package's weights carried
across and every bias drawn non-zero; the remat route against the plain
one; K4's refusal under autograd.  Serial time on one CPU thread: ~66 s.

Tolerances, each with its reason:

* ``loss_fn``'s loss, ce and aux: rtol 1e-5, atol 1e-5 (float32 in other
  summation orders, as the logits' 1e-4 of ``tests/test_torch_models.py``
  averaged over every position).
* Gradients: each leaf within 1e-4 of its max |g| (the same orders
  through the backward pass).
* One SGD ``make_train_step`` and one ``make_hfl_lm_train_step``: each
  leaf within 1e-5 of its max |leaf| (a step of lr x the gradient moves
  the gradients' 1e-4 by lr).  AdamW's first step moves each element by
  about lr x sign(g), so a last-bit difference of a near-zero gradient
  becomes a 2 lr gap: AdamW and Adafactor are held on identical gradients
  in ``tests/test_torch_optim.py`` instead.
* The remat route against the plain one: bitwise (the same operations
  recomputed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, batch_both, host,  # noqa: E402
                           lm_batch, lm_pair, params_to_torch,
                           with_random_biases)
from repro import optim as joptim  # noqa: E402
from repro.fed import hfl_lm as jhfl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.fed import hfl_lm as thfl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.cnn import tree_leaves  # noqa: E402

# (arch, config changes): one of each kind.
KINDS = {
    "dense": ("qwen1.5-0.5b", ()),
    "moe": ("llama4-scout-17b-a16e", ()),
    "hybrid": ("zamba2-7b", (("n_layers", 3),)),
    "xlstm": ("xlstm-125m", (("n_layers", 4),)),
    "encoder": ("hubert-xlarge", ()),
    "mixed": ("internvl2-76b", ()),
}
B, T = 2, 16


def _setup(kind, **kw):
    arch, changes = KINDS[kind]
    jcfg, tcfg, jp, _ = lm_pair(arch, **dict(changes), **kw)
    jp = with_random_biases(jp, seed=5)
    jb, tb = batch_both(lm_batch(tcfg, B, T, seed=6))
    return jcfg, tcfg, jp, params_to_torch(jp, tcfg), jb, tb


def _leaves_close(got, want, rel):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        g, w = host(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()),
                                                  1e-30))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loss_and_gradients_match_jax(kind):
    jcfg, tcfg, jp, tp, jb, tb = _setup(kind)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    loss, metrics, grads = ttf.value_and_grad(tcfg, tp, tb)
    for got, want in ((loss, jloss), (metrics["ce"], jm["ce"]),
                      (metrics["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)
    if kind == "moe":
        assert float(metrics["aux"]) > 0
    direct, parts = ttf.loss_fn(tcfg, tp, tb)
    assert float(direct) == float(loss) and not direct.requires_grad
    assert sorted(parts) == ["aux", "ce"]
    _leaves_close(grads, jg, 1e-4)
    assert not any(p.requires_grad for p in tree_leaves(tp))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sgd_train_step_matches_jax(kind):
    jcfg, tcfg, jp, tp, jb, tb = _setup(kind)
    jopt, topt = joptim.sgd(lr=0.1), toptim.sgd(lr=0.1)
    jstep = jax.jit(jtf.make_train_step(jcfg, jopt,
                                        lr_schedule=joptim.cosine(10, 2)))
    tstep = ttf.make_train_step(tcfg, topt, lr_schedule=toptim.cosine(10, 2))
    jp2, js2, jmet = jstep(jp, jopt.init(jp), jb)
    keep = {k: v.clone() for k, v in tp.items() if isinstance(v,
                                                              torch.Tensor)}
    tp2, ts2, tmet = tstep(tp, topt.init(tp), tb)
    for k, v in keep.items():                 # the caller's params stand
        assert torch.equal(tp[k], v)
    assert sorted(tmet) == sorted(jmet) == ["aux", "ce", "grad_norm", "loss"]
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=1e-5, atol=1e-5)
    assert float(tmet["grad_norm"]) > 1.0      # the clip is active
    _leaves_close(tp2, jp2, 1e-5)
    _leaves_close(ts2["mu"], js2["mu"], 1e-4)
    assert int(ts2["step"]) == int(js2["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(tp2),
                                                     tree_leaves(tp)))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_remat_gives_the_same_gradients_bitwise(kind, monkeypatch):
    _, tcfg, _, tp, _, tb = _setup(kind)
    calls = []
    real = ttf.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ttf, "checkpoint", counted)
    on = ttf.value_and_grad(dataclasses.replace(tcfg, remat=True), tp, tb)
    n_on = len(calls)
    off = ttf.value_and_grad(dataclasses.replace(tcfg, remat=False), tp, tb)
    assert len(calls) == n_on
    # one checkpoint a layer; a group and a tail layer (hybrid); a pair
    # (xlstm)
    assert n_on == {"hybrid": 2, "xlstm": 2}.get(kind, tcfg.n_layers)
    assert_bitwise(on[0], off[0])
    for g_on, g_off in zip(tree_leaves(on[2]), tree_leaves(off[2])):
        assert_bitwise(g_on, g_off)
    with torch.no_grad():                 # no grad mode, no checkpoint
        ttf.forward(tcfg, tp, tb, mode="train")
    assert len(calls) == n_on


def test_hfl_lm_step_matches_jax():
    jcfg, tcfg, jp, tp, _, _ = _setup("dense")
    P, K = 2, 2
    rng = np.random.default_rng(8)
    noise = jax.tree.map(
        lambda a: jnp.asarray(0.05 * rng.normal(size=a.shape), a.dtype), jp)
    jstack = jax.tree.map(lambda a, n: jnp.stack([a, a + n]), jp, noise)
    tstack = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstack)
    toks = rng.integers(0, tcfg.vocab, (P, K, B, T), dtype=np.int32)
    jopt, topt = joptim.sgd(lr=0.1), toptim.sgd(lr=0.1)
    jstate = jax.vmap(jopt.init)(jstack)
    tstate = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jstate)
    jout = jax.jit(jhfl.make_hfl_lm_train_step(jcfg, jopt, K=K))(
        jstack, jstate, {"tokens": jnp.asarray(toks)})
    tout = thfl.make_hfl_lm_train_step(tcfg, topt, K=K)(
        tstack, tstate, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(float(tout[2]["ce"]), float(jout[2]["ce"]),
                               rtol=1e-5, atol=1e-5)
    _leaves_close(tout[0], jout[0], 1e-5)
    _leaves_close(tout[1]["mu"], jout[1]["mu"], 1e-4)
    assert tout[1]["step"].tolist() == [K, K]
    for leaf, start in zip(tree_leaves(tout[0]), tree_leaves(tstack)):
        assert leaf.shape == start.shape
        assert_bitwise(leaf[0], leaf[1])      # every pod holds the mean
    # the mean of the pods' own K local steps, computed apart
    pods = []
    for i in range(P):
        p = jax.tree.map(lambda a: torch.tensor(np.asarray(a[i])), jstack)
        s = topt.init(p)
        for k in range(K):
            g = ttf.value_and_grad(tcfg, p, {"tokens": torch.tensor(
                toks[i, k])})[2]
            p, s = topt.update(g, s, p)
        pods.append(p)
    for got, a, b in zip(tree_leaves(tout[0]), tree_leaves(pods[0]),
                         tree_leaves(pods[1])):
        assert_bitwise(got[0], ((a.float() + b.float()) / 2).to(a.dtype))


def test_k4_refuses_to_run_under_autograd():
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=(1, 8, 2, 16)),
                            dtype=torch.float32) for _ in range(3))
    ops.flash_attention(q, k, v)                  # no grad needed: runs
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward.*chunked"):
        ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    _, tcfg, _, tp, _, tb = _setup("dense")
    flash = dataclasses.replace(tcfg, attn_impl="pallas")
    step = ttf.make_train_step(flash, toptim.sgd())
    with pytest.raises(RuntimeError, match="no backward"):
        step(tp, toptim.sgd().init(tp), tb)
    with torch.inference_mode():                  # serving still runs K4
        ttf.forward(flash, tp, tb)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_every_arch_takes_one_train_step(arch):
    cfg = tconfigs.get(arch).reduced()
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, batch = batch_both(lm_batch(cfg, B, T, seed=1))
    logits, aux, _, _ = ttf.forward(cfg, params, batch)
    assert logits.shape == (B, T, cfg.vocab)
    loss, _ = ttf.loss_fn(cfg, params, batch)
    assert torch.isfinite(loss)
    opt = toptim.get_optimizer(cfg.optimizer)
    new, state, metrics = ttf.make_train_step(cfg, opt)(
        params, opt.init(params), batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert int(state["step"]) == 1
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                   tree_leaves(params))]
    assert sum(moved) > len(moved) // 2
