"""Port parity for the LM path: the layers, the dense transformer, KV-cache
decode and the LM entry point against the JAX package, on reduced configs
(2 layers, d 128, 4 heads / 2 kv heads, vocab 512, f32) with the JAX
package's weights carried across and inputs from numpy seeds.

Tolerances, each with its reason:

* ``rms_norm``, ``layer_norm``, ``apply_rope``: rtol 1e-6, atol 1e-6 (the
  same f32 arithmetic; the atol covers rope's x1 cos - x2 sin cancelling).
* ``attention`` in every impl, with GQA, against JAX's chunked path: 2e-4,
  the reference's own tolerance between its impls
  (``tests/test_kernels.py:269``).  JAX's flash kernel does not run on this
  jax (``pl.load`` is gone), so its side is ``impl="chunked"``.
* ``forward`` logits in f32: rtol 1e-4, atol 1e-4 (matmul summation order
  differs between XLA and PyTorch); greedy tokens exactly.
* bfloat16: max |delta logit| within 3e-2 of max |logit| (both packages
  round every layer to bf16, in different orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (greedy_decode_both, host, lm_pair,  # noqa: E402
                           lm_tokens)
from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

DENSE = ["qwen1.5-0.5b", "llama3.2-3b", "qwen2.5-32b"]


def _t(x):
    return torch.tensor(np.asarray(x))


# --------------------------------------------------------------- configs
def test_registry_matches_the_reference():
    assert sorted(tconfigs.ARCHS) == sorted(jconfigs.ARCHS)
    for name, jc in jconfigs.ARCHS.items():
        for j, t in ((jc, tconfigs.get(name)),
                     (jc.reduced(), tconfigs.get(name).reduced())):
            jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
            assert str(jnp.dtype(jd.pop("dtype"))) == \
                str(td.pop("dtype")).replace("torch.", "")
            assert jd == td, name
            assert j.head_dim == t.head_dim
    with pytest.raises(KeyError):
        tconfigs.get("no-such-arch")


# ---------------------------------------------------------------- layers
def test_norms_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(host(tl.rms_norm(_t(x), _t(s))),
                               np.asarray(jl.rms_norm(x, s)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(host(tl.layer_norm(_t(x), _t(s), _t(b))),
                               np.asarray(jl.layer_norm(x, s, b)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches(theta, hd):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, hd)).astype(np.float32)
    pos = (np.arange(9)[None] + np.array([[0], [1000]])).astype(np.int32)
    np.testing.assert_array_equal(tl.rope_freqs(hd, theta),
                                  jl.rope_freqs(hd, theta))
    np.testing.assert_allclose(
        host(tl.apply_rope(_t(x), _t(pos), theta)),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-6, atol=1e-6)


def test_blocks_match():
    """linear, swiglu and the (tanh-approximated) GELU MLP: rtol 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    w1, w2, w3 = (rng.normal(size=s).astype(np.float32) / 6
                  for s in ((32, 48), (32, 48), (48, 32)))
    b1, b2 = (rng.normal(size=n).astype(np.float32) for n in (48, 32))
    for got, want in (
            (tl.linear(_t(x), _t(w1), _t(b1)), jl.linear(x, w1, b1)),
            (tl.linear(_t(x), _t(w1)), jl.linear(x, w1)),
            (tl.swiglu(_t(x), _t(w1), _t(w2), _t(w3)),
             jl.swiglu(x, w1, w2, w3)),
            (tl.gelu_mlp(_t(x), _t(w1), _t(b1), _t(w3), _t(b2)),
             jl.gelu_mlp(x, w1, b1, w3, b2))):
        np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    w = tl.init_dense(torch.Generator().manual_seed(0), (256, 64))
    assert w.dtype == torch.float32 and w.shape == (256, 64)
    assert abs(float(w.std()) * 16.0 - 1.0) < 0.05


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=True, window=8),
                                dict(causal=False)])
def test_attention_impls_match_jax_chunked(impl, kw):
    """GQA (4 query heads over 2 kv heads) as
    ``test_model_attention_pallas_path_matches_chunked``; on the CPU the
    ``pallas`` impl runs K4's plain twin and counts no launch."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 32, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 64)).astype(np.float32)
    want = jl.attention(q, k, v, impl="chunked", kv_chunk=16, **kw)
    before = dict(ops.LAUNCHES)
    got = tl.attention(_t(q), _t(k), _t(v), impl=impl, kv_chunk=16, **kw)
    assert ops.LAUNCHES == before
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match(arch, impl):
    """80 positions: two key chunks of the reduced kv_chunk 64, and two
    query blocks of K4's 64."""
    jcfg, tcfg, jp, tp = lm_pair(arch, attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl="chunked")
    toks = lm_tokens(2, 80, jcfg.vocab)
    want = jax.jit(lambda p, t: jtf.forward(jcfg, p, {"tokens": t})[0])(
        jp, toks)
    got, aux, cache, mask = ttf.forward(tcfg, tp, {"tokens": _t(toks)})
    assert cache is None and mask is None and float(aux) == 0.0
    np.testing.assert_allclose(host(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_decode_matches_jax(arch):
    """Prefill (no pad_to: the ring buffer evicts, as ``serve`` runs it)
    then 8 greedy decode steps: the same tokens, and the prefill cache and
    last logits to the forward tolerance."""
    jcfg, tcfg, jp, tp = lm_pair(arch)
    toks = lm_tokens(2, 12, jcfg.vocab, seed=1)
    got, want = greedy_decode_both(jcfg, tcfg, jp, tp, toks, steps=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The port against itself: KV-cache decode at position 11 equals the
    full forward there (``tests/test_archs.py::test_decode_matches_forward``
    with a prefill padded to 16)."""
    tcfg = tconfigs.get(arch).reduced()
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    toks = _t(lm_tokens(2, 12, tcfg.vocab, seed=2))
    full = ttf.forward(tcfg, tp, {"tokens": toks})[0]
    _, cache = ttf.make_prefill_step(tcfg, pad_to=16)(
        tp, {"tokens": toks[:, :11]})
    assert cache["k"].shape[2] == 16
    dec, cache = ttf.decode_step(tcfg, tp, cache, toks[:, 11:12])
    assert int(cache["pos"]) == 12
    np.testing.assert_allclose(host(dec[:, 0]), host(full[:, 11]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("filled", [True, False])
def test_decode_from_init_cache_matches_jax(filled):
    """A zero cache of 16 slots, full (pos 16: every slot valid, the write
    wraps to slot 0) or empty (pos 0: one valid slot): the same structure
    as JAX's, and three decode steps give its logits."""
    jcfg, tcfg, jp, tp = lm_pair("llama3.2-3b")
    jc = jtf.init_cache(jcfg, 2, 16, filled=filled)
    tc = ttf.init_cache(tcfg, 2, 16, filled=filled, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()}
    assert int(tc["pos"]) == int(jc["pos"]) == (16 if filled else 0)
    toks = lm_tokens(2, 3, jcfg.vocab, seed=4)
    jserve = jax.jit(jtf.make_serve_step(jcfg))
    for i in range(3):
        jl_, jc = jserve(jp, jc, toks[:, i:i + 1])
        tl_, tc = ttf.decode_step(tcfg, tp, tc, _t(toks[:, i:i + 1]))
        np.testing.assert_allclose(host(tl_), np.asarray(jl_), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(host(tc["k"]), np.asarray(jc["k"]),
                               rtol=1e-4, atol=1e-4)


def test_bf16_forward_close():
    jcfg, tcfg, jp, tp = lm_pair("qwen1.5-0.5b", dtype="bf16")
    toks = lm_tokens(2, 40, jcfg.vocab, seed=3)
    want = np.asarray(jax.jit(
        lambda p, t: jtf.forward(jcfg, p, {"tokens": t})[0])(jp, toks),
        np.float32)
    got = ttf.forward(tcfg, tp, {"tokens": _t(toks)})[0]
    assert got.dtype == torch.bfloat16
    got = host(got.float())
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_init_params_follows_the_reference_distribution():
    tcfg = tconfigs.get("qwen1.5-0.5b").reduced()
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree.map(lambda a: a.shape,
                           jtf.abstract_params(jconfigs.get(
                               "qwen1.5-0.5b").reduced()))
    assert jax.tree.map(lambda a: tuple(a.shape), tp) == jshapes
    assert "lm_head" not in tp                      # tied embeddings
    assert torch.equal(tp["final_ln"], torch.ones(128))
    assert torch.equal(tp["blocks"]["attn"]["bq"], torch.zeros(2, 128))
    w = tp["blocks"]["mlp"]["w_down"]                 # fan_in 256
    assert abs(float(w.std()) * 16.0 - 1.0) < 0.05
    again = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_params_from_numpy_checks_the_tree():
    tcfg = tconfigs.get("llama3.2-3b").reduced()
    tree = jax.tree.map(np.asarray, jtf.init_params(
        jconfigs.get("llama3.2-3b").reduced(), jax.random.PRNGKey(0)))
    tp = ttf.params_from_numpy(tree, tcfg, "cpu")
    np.testing.assert_array_equal(host(tp["embed"]), tree["embed"])
    wq = tree["blocks"]["attn"]["wq"]
    tree["blocks"]["attn"]["wq"] = wq[:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        ttf.params_from_numpy(tree, tcfg, "cpu")
    tree["blocks"]["attn"]["wq"] = wq
    del tree["final_ln"]
    with pytest.raises(KeyError, match="final_ln"):
        ttf.params_from_numpy(tree, tcfg, "cpu")


@pytest.mark.parametrize("arch", sorted(
    n for n, c in jconfigs.ARCHS.items()
    if c.family not in ("dense", "moe", "mamba_hybrid", "xlstm")
    or c.input_mode != "tokens"))
def test_other_families_raise(arch):
    """The encoder family and the embeds/mixed frontends (refused before
    they were ported): the port's parameter shapes are the JAX package's,
    full size and reduced, and a model without decode raises for a decode
    cache in both packages (``tests/test_torch_encoder.py`` holds their
    numbers)."""
    for jcfg, tcfg in ((jconfigs.get(arch), tconfigs.get(arch)),
                       (jconfigs.get(arch).reduced(),
                        tconfigs.get(arch).reduced())):
        want = jax.tree.map(lambda d: tuple(d.shape), jtf.param_defs(jcfg),
                            is_leaf=lambda d: isinstance(d, jtf.ParamDef))
        got = ttf._map_defs(ttf.param_defs(tcfg), lambda _, d: tuple(d.shape))
        assert got == want
        if not tcfg.has_decode:
            with pytest.raises(ValueError, match="no decode cache"):
                jtf.cache_defs(jcfg, 1, 8)
            with pytest.raises(ValueError, match="no decode cache"):
                ttf.cache_defs(tcfg, 1, 8)


# ------------------------------------------------------------ entry point
def test_serve_lm_on_cpu_prints_its_lines(capsys):
    before = dict(ops.LAUNCHES)
    out = serve.main(["--mode", "lm", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "16", "--new-tokens", "4"])
    assert ops.LAUNCHES == before
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "[serve]", "[prefill]", "[decode]", "[sample]"]
    assert "arch=qwen1.5-0.5b" in lines[0] and "layers=2" in lines[0]
    assert out["tokens"].shape == (2, 5)
    assert out["logits"].shape == (2, 512)
    assert np.isfinite(host(out["logits"])).all()


def test_run_lm_flash_route_matches_chunked_on_cpu():
    """``run_lm`` with ``attn_impl="pallas"`` (K4's twin on the CPU) gives
    the chunked route's tokens on the same seed's weights."""
    cfg = tconfigs.get("qwen1.5-0.5b").reduced()
    a = serve.run_lm(cfg, batch=2, prompt_len=20, new_tokens=3, seed=4,
                     device="cpu")
    b = serve.run_lm(dataclasses.replace(cfg, attn_impl="pallas"), batch=2,
                     prompt_len=20, new_tokens=3, seed=4, device="cpu")
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_allclose(host(b["logits"]), host(a["logits"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "no-such-arch"])
def test_serve_lm_rejects(arch):
    with pytest.raises(SystemExit):
        serve.main(["--mode", "lm", "--device", "cpu", "--arch", arch])
