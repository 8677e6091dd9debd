"""Port parity for the moe family: ``models/moe.py`` (top-k routing,
capacity dispatch, the shared expert), the moe blocks of
``models/transformer.py`` and ``serve --mode lm`` on them, against the JAX
package, with its weights carried across (``init_moe`` and
``transformer.init_params``) and inputs from numpy seeds.  Reduced widths:
d 32 or 128, E 8, f32.

Tolerances, each with its reason:

* Routing (expert indices, positions, ``keep``, capacity): identical on
  every fixture, exact ties included (both packages send a tie to the
  lower expert index).
* ``moe_ffn`` outputs: rtol 1e-5, atol 1e-6 (the same float32 arithmetic
  in other summation orders); aux rtol 1e-6.
* ``dispatch_groups=4`` against 1 at capacity factor 8 (no pair dropped,
  so the groups change only the buffer slots): logits rtol 1e-5, atol
  1e-6; aux rtol 1e-6, the JAX package's own test's tolerance
  (``tests/test_archs.py::test_moe_grouped_dispatch_matches_global``).
* ``forward`` logits and aux, prefill caches and decode logits: rtol 1e-4,
  atol 1e-4, as for the dense family (``tests/test_torch_models.py``);
  greedy tokens exactly.
* Decode against forward, the port against itself: rtol 1e-4, atol 1e-5,
  at capacity factor 8.  A decode step routes its B tokens alone
  (capacity ceil(B k / E cf), 1 at the default 1.25), so only an ample
  capacity drops no pair in either and makes the two the same function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (greedy_decode_both, host, lm_pair,  # noqa: E402
                           lm_tokens, tied_router_logits)
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

MOE = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_routing(logits, top_k, capacity_factor):
    """The reference's routing steps (``src/repro/models/moe.py:60-79``) on
    float32 logits (G, tpg, E): (expert_idx, pos, keep, capacity)."""
    G, tpg, E = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits, jnp.float32), axis=-1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.float32)
    capacity = int(max(1, np.ceil(tpg * top_k / E * capacity_factor)))
    flat = onehot.reshape(G, tpg * top_k, E)
    pos = ((jnp.cumsum(flat, axis=1) - 1.0) * flat).sum(-1)
    return (np.asarray(expert_idx), np.asarray(pos),
            np.asarray(pos < capacity), capacity)


def _assert_same_routing(r, logits, top_k, capacity_factor):
    eidx, pos, keep, cap = _jax_routing(logits, top_k, capacity_factor)
    assert r.capacity == cap
    np.testing.assert_array_equal(host(r.expert_idx), eidx)
    np.testing.assert_array_equal(host(r.pos), pos.astype(np.int64))
    np.testing.assert_array_equal(host(r.keep), keep)
    np.testing.assert_array_equal(
        host(r.load), np.bincount(eidx.reshape(-1),
                                  minlength=logits.shape[-1]))


# ---------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
@pytest.mark.parametrize("n_shared", [0, 1])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_jax(top_k, n_shared, capacity_factor):
    """48 tokens over E 8, with an offset shared by every token so that
    the router favours some experts: at capacity factor 1.25 their pairs
    overflow and drop, at 8 none drops.  Routing identical, outputs and
    aux to the stated rtol."""
    d, ff, E = 32, 48, 8
    jp = jmoe.init_moe(jax.random.PRNGKey(top_k + 2 * n_shared), d, ff, E,
                       n_shared)
    tp = jax.tree.map(lambda a: _t(a), jp)
    rng = np.random.default_rng(top_k)
    x = (rng.normal(size=(2, 24, d)) + rng.normal(size=d)).astype(
        np.float32)
    want, want_aux = jax.jit(lambda p, x: jmoe.moe_ffn(
        p, x, top_k=top_k, capacity_factor=capacity_factor))(jp, x)
    got, aux = tmoe.moe_ffn(tp, _t(x), top_k=top_k,
                            capacity_factor=capacity_factor)

    logits = x.reshape(1, 48, d) @ np.asarray(jp["router"])
    jlogits = np.asarray(jnp.asarray(x).reshape(1, 48, d) @ jp["router"])
    r = tmoe.route((_t(x).reshape(1, 48, d) @ tp["router"]).float(), top_k,
                   capacity_factor)
    _assert_same_routing(r, jlogits, top_k, capacity_factor)
    _assert_same_routing(tmoe.route(_t(logits), top_k, capacity_factor),
                         logits, top_k, capacity_factor)
    assert bool((~r.keep).any()) == (capacity_factor == 1.25)
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("E,top_k", [(5, 1), (5, 2), (8, 3), (16, 1),
                                     (384, 8)])
def test_ties_go_to_the_lower_expert_index(E, top_k):
    logits = tied_router_logits(E, 64).numpy()
    r = tmoe.route(_t(logits), top_k, 1.25)
    _assert_same_routing(r, logits, top_k, 1.25)
    idx = host(r.expert_idx)[0]
    assert idx[0].tolist() == list(range(top_k))
    if top_k == 2:
        assert idx[3].tolist() == [1, 2]        # torch.topk gives [2, 4]


@pytest.mark.parametrize("arch", MOE)
def test_grouped_dispatch_matches_global(arch):
    """``tests/test_archs.py::test_moe_grouped_dispatch_matches_global``
    in the port, on forward's logits and aux, and the grouped forward
    against the JAX package's."""
    jc1, c1, jp, tp = lm_pair(arch, capacity_factor=8.0)
    jc4 = dataclasses.replace(jc1, moe_dispatch_groups=4)
    c4 = dataclasses.replace(c1, moe_dispatch_groups=4)
    toks = lm_tokens(2, 32, c1.vocab, seed=5)
    l1, a1, _, _ = ttf.forward(c1, tp, {"tokens": _t(toks)})
    l4, a4, _, _ = ttf.forward(c4, tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(host(l4), host(l1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(a4), float(a1), rtol=1e-6)
    want, want_aux, _, _ = jax.jit(
        lambda p, t: jtf.forward(jc4, p, {"tokens": t}))(jp, toks)
    np.testing.assert_allclose(host(l4), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(a4), float(want_aux), rtol=1e-4)
    with pytest.raises(ValueError, match="groups"):
        ttf.forward(dataclasses.replace(c1, moe_dispatch_groups=5), tp,
                    {"tokens": _t(toks)})


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("impl", ["chunked", "dense", "pallas"])
@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match(arch, impl):
    """80 positions (160 tokens: at capacity factor 1.25 some pairs
    drop); on the CPU ``pallas`` runs K4's plain twin, held to JAX's
    chunked route (its flash kernel does not run on this jax)."""
    jcfg, tcfg, jp, tp = lm_pair(arch, attn_impl=impl)
    if impl == "pallas":
        jcfg = dataclasses.replace(jcfg, attn_impl="chunked")
    toks = lm_tokens(2, 80, jcfg.vocab)
    want, want_aux, _, _ = jax.jit(
        lambda p, t: jtf.forward(jcfg, p, {"tokens": t}))(jp, toks)
    before = dict(ops.LAUNCHES)
    got, aux, cache, mask = ttf.forward(tcfg, tp, {"tokens": _t(toks)})
    assert ops.LAUNCHES == before
    assert cache is None and mask is None and float(aux) > 0.0
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_greedy_decode_matches_jax(arch):
    """Prefill, then 8 greedy decode steps at the default capacity factor
    (decode's capacity is 1 per expert at B = 2, so tokens drop in both
    packages alike): the same tokens."""
    jcfg, tcfg, jp, tp = lm_pair(arch)
    toks = lm_tokens(2, 12, jcfg.vocab, seed=1)
    got, want = greedy_decode_both(jcfg, tcfg, jp, tp, toks, steps=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                               capacity_factor=8.0)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = _t(lm_tokens(2, 12, tcfg.vocab, seed=2))
    full = ttf.forward(tcfg, tp, {"tokens": toks})[0]
    _, cache = ttf.make_prefill_step(tcfg, pad_to=16)(
        tp, {"tokens": toks[:, :11]})
    dec, cache = ttf.decode_step(tcfg, tp, cache, toks[:, 11:12])
    assert int(cache["pos"]) == 12
    np.testing.assert_allclose(host(dec[:, 0]), host(full[:, 11]),
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", MOE)
def test_params_cross_with_the_nested_shared_expert(arch):
    """``params_from_numpy`` takes the JAX package's moe tree as it
    stands (``blocks/moe/shared`` nested) and names a wrong leaf by its
    path; ``init_params`` draws the same tree, in bfloat16 too."""
    jcfg, tcfg, jp, tp = lm_pair(arch)
    tree = jax.tree.map(np.asarray, jp)
    assert sorted(tp["blocks"]) == ["attn", "moe"]
    assert sorted(tp["blocks"]["moe"]["shared"]) == ["w_down", "w_gate",
                                                     "w_up"]
    np.testing.assert_array_equal(host(tp["blocks"]["moe"]["shared"]["w_up"]),
                                  tree["blocks"]["moe"]["shared"]["w_up"])
    shared = tree["blocks"]["moe"]["shared"]
    shared["w_up"] = shared["w_up"][:, :, :8]
    with pytest.raises(ValueError, match="blocks/moe/shared/w_up"):
        ttf.params_from_numpy(tree, tcfg, "cpu")
    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    drawn = ttf.init_params(bf16, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), drawn) == \
        jax.tree.map(lambda a: a.shape, jtf.abstract_params(jcfg))
    w = drawn["blocks"]["moe"]["w_down"]              # fan_in d_ff 256
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * 16.0 - 1.0) < 0.05


@pytest.mark.parametrize("n_shared", [0, 2])
def test_init_moe_draws_the_reference_tree(n_shared):
    """The same keys and shapes as the JAX package's ``init_moe``, normal
    x 1/sqrt(fan_in) from the generator, in the asked type."""
    want = jmoe.init_moe(jax.random.PRNGKey(0), 64, 96, 8, n_shared)
    got = tmoe.init_moe(torch.Generator().manual_seed(0), 64, 96, 8,
                        n_shared, dtype=torch.bfloat16, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == \
        jax.tree.map(lambda a: a.shape, want)
    w = got["w_up"]                                    # fan_in d 64
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * 8.0 - 1.0) < 0.05


# ------------------------------------------------------------ entry point
def test_serve_lm_runs_the_moe_family_on_cpu(capsys):
    before = dict(ops.LAUNCHES)
    out = serve.main(["--mode", "lm", "--arch", "llama4-scout-17b-a16e",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--new-tokens", "4"])
    assert ops.LAUNCHES == before
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "[serve]", "[prefill]", "[decode]", "[sample]"]
    assert "family=moe" in lines[0] and "layers=2" in lines[0]
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert np.isfinite(host(out["logits"])).all()


def test_run_lm_flash_route_matches_chunked_on_cpu():
    cfg = tconfigs.get("kimi-k2-1t-a32b").reduced()
    a = serve.run_lm(cfg, batch=2, prompt_len=20, new_tokens=3, seed=4,
                     device="cpu")
    b = serve.run_lm(dataclasses.replace(cfg, attn_impl="pallas"), batch=2,
                     prompt_len=20, new_tokens=3, seed=4, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(host(b["logits"]), host(a["logits"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["internvl2-76b"])
def test_serve_lm_still_refuses_the_unported_families(arch):
    """The mixed frontend (internvl2), refused until it was ported, is
    served on the CPU: the run prefills its patches before the prompt
    (``tests/test_torch_encoder.py`` holds its logits to JAX's).  The CLI
    still refuses the encoder (hubert-xlarge), which has no decode, as the
    JAX CLI does."""
    before = dict(ops.LAUNCHES)
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch,
                      "--batch", "1", "--prompt-len", "4", "--new-tokens",
                      "1"])
    assert ops.LAUNCHES == before
    assert out["tokens"].shape == (1, 2)
    assert np.isfinite(host(out["logits"])).all()
    with pytest.raises(SystemExit, match="no decode"):
        serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                    "hubert-xlarge"])
