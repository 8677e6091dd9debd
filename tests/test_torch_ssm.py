"""Port parity for the hybrid and xlstm families: ``models/ssm.py`` (the
Mamba2 scan and its causal conv, the mLSTM and sLSTM scans), the hybrid
and xlstm halves of ``models/transformer.py`` (forward, the prefill cache,
decode, the cache re-layout) and ``serve --mode lm`` on them, against the
JAX package, with its weights carried across as numpy
(``_torch_parity.params_to_torch``) and inputs from numpy seeds.  Reduced
widths: d 32 (blocks) or 128 (models), f32; zamba2 at 5 layers (two groups
of 2 and a one-layer tail, as 81 = 13 x 6 + 3 has), xlstm at 4 (two m/s
pairs).

Tolerances, each with its reason:

* The scans and the causal conv: rtol 1e-5, atol 1e-6.  The same float32
  arithmetic; the products of 3 factors and the sums over the state axis
  are taken in other orders (einsum contraction paths, BLAS blocking).
* ``forward`` logits, the prefill cache and decode logits: rtol 1e-4,
  atol 1e-4, as for the dense and moe families: the order differences
  above, through 5 layers and a recurrence of 12 steps.
* The re-layout: JAX's own ``decode_step`` on the re-laid JAX prefill cache
  against JAX's ``forward`` at position T: rtol 1e-4, atol 1e-5 (one
  package, two summation orders); the port's prefill, re-layout and decode
  against the same: rtol 1e-4, atol 1e-4.
* Greedy tokens: exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import host, lm_pair, lm_tokens  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# (arch, config changes): zamba2 with a window of 8 < T (the ring wraps),
# zamba2 with its reduced window of 64 > T, xlstm.
ZAMBA_WRAP = ("zamba2-7b", (("n_layers", 5), ("window", 8)))
ZAMBA = ("zamba2-7b", (("n_layers", 5),))
XLSTM = ("xlstm-125m", (("n_layers", 4),))
T = 12


def _t(x):
    return torch.tensor(np.asarray(x))


def _tree(node, fn):
    """``fn`` over the leaves of nested dicts and tuples (None kept)."""
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    if isinstance(node, tuple):
        return tuple(_tree(v, fn) for v in node)
    return None if node is None else fn(node)


def _assert_tree_close(got, want, **tol):
    g = jax.tree.leaves(_tree(got, host))
    w = jax.tree.leaves(_tree(want, np.asarray))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


@functools.lru_cache(maxsize=None)
def _pair(arch, changes, **kw):
    """lm_pair for a reduced ``arch`` with ``changes``; JAX's weights."""
    return lm_pair(arch, **dict(changes), **kw)


@functools.lru_cache(maxsize=None)
def _jax_prefill(arch, changes, T_, seed=0):
    """JAX's forward(mode="prefill") on the first T_ of seeded tokens
    (2, T + 1): (tokens, logits, cache) as numpy."""
    jcfg, _, jp, _ = _pair(arch, changes)
    toks = lm_tokens(2, T + 1, jcfg.vocab, seed=seed)[:, :T_]
    logits, _, cache, _ = jax.jit(lambda p, t: jtf.forward(
        jcfg, p, {"tokens": t}, mode="prefill"))(jp, toks)
    return toks, np.asarray(logits), _tree(cache, np.asarray)


# ------------------------------------------------------------ the scans
def _state(rng, *shapes):
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def test_softplus_and_log_sigmoid_are_jaxs():
    """Past torch's softplus threshold of 20 too, and far negative."""
    x = np.concatenate([np.linspace(-120, 120, 2401),
                        [-1e30, -88.5, 19.99, 20.0, 20.01, 1e30]]
                       ).astype(np.float32)
    np.testing.assert_allclose(host(tssm.softplus(_t(x))),
                               np.asarray(jax.nn.softplus(x)), **SCAN_TOL)
    np.testing.assert_allclose(host(tssm.log_sigmoid(_t(x))),
                               np.asarray(jax.nn.log_sigmoid(x)), **SCAN_TOL)


@pytest.mark.parametrize("given", [False, True])
def test_causal_conv_matches_jax(given):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 24)).astype(np.float32)
    w = rng.normal(size=(tssm.CONV_W, 24)).astype(np.float32)
    st = (rng.normal(size=(2, tssm.CONV_W - 1, 24)).astype(np.float32)
          if given else None)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    got = tssm._causal_conv(_t(x), _t(w), None if st is None else _t(st))
    _assert_tree_close(got, want, **SCAN_TOL)


def _mamba_params(seed, d=32, ds=8, hd=8):
    """init_mamba2's tree with A_log, D and dt_bias drawn (the init leaves
    them constant) so that every head decays at its own rate."""
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), d, ds, hd)
    rng = np.random.default_rng(seed)
    H = jp["A_log"].shape[0]
    return dict(jax.tree.map(np.asarray, jp),
                A_log=(0.5 * rng.normal(size=H)).astype(np.float32),
                D=rng.normal(size=H).astype(np.float32),
                dt_bias=(2.0 * rng.normal(size=H)).astype(np.float32))


# (T, from a given state): a sequence from zero, a sequence from a state,
# and the decode form (T = 1 from a state).
STATE_CASES = [(9, False), (9, True), (1, True)]


@pytest.mark.parametrize("T_,given", STATE_CASES)
def test_mamba2_scan_matches_jax(T_, given):
    d, ds, hd = 32, 8, 8
    p = _mamba_params(3)
    H = p["A_log"].shape[0]
    rng = np.random.default_rng(T_ + given)
    x = rng.normal(size=(2, T_, d)).astype(np.float32)
    s, cs = (_state(rng, (2, H, ds, hd), (2, tssm.CONV_W - 1, 2 * d + 2 * ds))
             if given else (None, None))
    want = jax.jit(lambda p, x, s, cs: jssm.mamba2_scan(
        p, x, ds, hd, state=s, conv_state=cs))(p, x, s, cs)
    got = tssm.mamba2_scan(_tree(p, _t), _t(x), ds, hd,
                           state=None if s is None else _t(s),
                           conv_state=None if cs is None else _t(cs))
    _assert_tree_close(got, want, **SCAN_TOL)


@pytest.mark.parametrize("T_,given", STATE_CASES)
def test_mlstm_scan_matches_jax(T_, given):
    d, H = 32, 4
    p = jax.tree.map(np.asarray, jssm.init_mlstm(jax.random.PRNGKey(5), d, H))
    rng = np.random.default_rng(10 + T_ + given)
    x = rng.normal(size=(2, T_, d)).astype(np.float32)
    st = (_state(rng, (2, H, 8, 8), (2, H, 8), (2, H)) if given else None)
    want = jax.jit(lambda p, x, st: jssm.mlstm_scan(p, x, H, state=st))(
        p, x, st)
    got = tssm.mlstm_scan(_tree(p, _t), _t(x), H,
                          state=None if st is None else _tree(st, _t))
    _assert_tree_close(got, want, **SCAN_TOL)


@pytest.mark.parametrize("T_,given", STATE_CASES)
def test_slstm_scan_matches_jax(T_, given):
    d, H = 32, 4
    p = jax.tree.map(np.asarray, jssm.init_slstm(jax.random.PRNGKey(6), d, H))
    rng = np.random.default_rng(20 + T_ + given)
    x = rng.normal(size=(2, T_, d)).astype(np.float32)
    st = (_state(rng, *[(2, H, 8)] * 4) if given else None)
    want = jax.jit(lambda p, x, st: jssm.slstm_scan(p, x, H, state=st))(
        p, x, st)
    got = tssm.slstm_scan(_tree(p, _t), _t(x), H,
                          state=None if st is None else _tree(st, _t))
    _assert_tree_close(got, want, **SCAN_TOL)


@pytest.mark.parametrize("block,args", [
    ("mamba2", (64, 16, 16)), ("mlstm", (64, 4)), ("slstm", (64, 4))])
def test_init_blocks_draw_the_reference_trees(block, args):
    """The same keys, shapes and types as the JAX package's ``init_*``,
    normal x 1/sqrt(fan_in) (conv_w: x 0.5) from the generator."""
    want = getattr(jssm, f"init_{block}")(jax.random.PRNGKey(0), *args,
                                          dtype=jnp.bfloat16)
    got = getattr(tssm, f"init_{block}")(torch.Generator().manual_seed(0),
                                         *args, dtype=torch.bfloat16,
                                         device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), a.dtype == torch.float32),
                        got) == \
        jax.tree.map(lambda a: (a.shape, a.dtype == jnp.float32), want)
    w = got["in_proj" if block == "mamba2" else "wz" if block == "slstm"
            else "wq"]
    assert abs(float(w.float().std()) * 8.0 - 1.0) < 0.05     # fan_in 64
    if block == "mamba2":
        assert abs(float(got["conv_w"].float().std()) / 0.5 - 1.0) < 0.1
        assert torch.equal(got["D"], torch.ones_like(got["D"]))


# ------------------------------------------------------------- the models
@pytest.mark.parametrize("case,impl", [
    (ZAMBA_WRAP, "chunked"), (ZAMBA_WRAP, "pallas"), (XLSTM, "chunked")])
def test_forward_and_prefill_cache_match_jax(case, impl):
    """Logits and every leaf of the reference's prefill cache; on the CPU
    ``pallas`` runs K4's plain twin (window 8 < T), held to JAX's chunked
    route (its flash kernel does not run on this jax)."""
    toks, want, want_cache = _jax_prefill(*case, T)
    _, tcfg, _, tp = _pair(*case)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl)
    before = dict(ops.LAUNCHES)
    got, aux, cache, mask = ttf.forward(tcfg, tp, {"tokens": _t(toks)},
                                        mode="prefill")
    assert ops.LAUNCHES == before
    assert mask is None and float(aux) == 0.0
    np.testing.assert_allclose(host(got), want, **MODEL_TOL)
    assert sorted(cache) == sorted(want_cache)
    _assert_tree_close(cache, want_cache, **MODEL_TOL)
    assert ttf.forward(tcfg, tp, {"tokens": _t(toks)})[2] is None


@pytest.mark.parametrize("case", [ZAMBA, XLSTM])
def test_decode_from_init_cache_matches_jax(case):
    """``tests/test_archs.py::test_smoke_decode`` in both packages: one
    step from a zero cache filled to 16 positions; logits and the new
    cache."""
    jcfg, tcfg, jp, tp = _pair(*case)
    tok = lm_tokens(2, 1, jcfg.vocab, seed=3)
    want, want_cache = jax.jit(jtf.make_serve_step(jcfg))(
        jp, jtf.init_cache(jcfg, 2, 16), tok)
    cache = ttf.init_cache(tcfg, 2, 16, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jtf.abstract_cache(jcfg, 2, 16).items()}
    got, new = ttf.decode_step(tcfg, tp, cache, _t(tok))
    assert got.shape == (2, 1, jcfg.vocab) and int(new["pos"]) == 17
    np.testing.assert_allclose(host(got), np.asarray(want), **MODEL_TOL)
    _assert_tree_close(new, want_cache, **MODEL_TOL)
    assert all(new[k] is cache[k] for k in cache if k != "pos")  # in place


@pytest.mark.parametrize("case,context", [
    (ZAMBA_WRAP, None), (ZAMBA, T + 1), (XLSTM, None)])
def test_relayout_makes_jax_decode_meet_jax_forward(case, context):
    """The port's ``prefill_cache_to_decode`` on JAX's prefill cache of T
    tokens, then JAX's own ``decode_step`` on token T, equals JAX's
    ``forward`` at position T: with the ring wrapped (window 8 < T; the
    default context T) and unwrapped (window 64, context T + 1); the
    port's prefill, re-layout and decode equal the same."""
    jcfg, tcfg, jp, tp = _pair(*case)
    toks, want, _ = _jax_prefill(*case, T + 1)
    _, _, jcache = _jax_prefill(*case, T)
    relaid = ttf.prefill_cache_to_decode(tcfg, _tree(jcache, _t), context)
    assert sorted(relaid) == sorted(jtf.abstract_cache(jcfg, 2, 4))
    logits, new = jax.jit(jtf.make_serve_step(jcfg))(
        jp, _tree(relaid, lambda x: jnp.asarray(host(x))), toks[:, T:])
    assert int(new["pos"]) == T + 1
    np.testing.assert_allclose(np.asarray(logits[:, 0]), want[:, T],
                               rtol=1e-4, atol=1e-5)
    _, cache = ttf.make_prefill_step(tcfg, pad_to=context)(
        tp, {"tokens": _t(toks[:, :T])})
    got, _ = ttf.decode_step(tcfg, tp, cache, _t(toks[:, T:]))
    np.testing.assert_allclose(host(got[:, 0]), want[:, T], **MODEL_TOL)


@pytest.mark.parametrize("case", [ZAMBA, XLSTM])
def test_greedy_tokens_of_run_lm_match_a_jax_loop(case):
    """``run_lm`` on the CPU (reduced, seed 4: the weights and prompts of
    its generator), and a JAX greedy loop on the same weights and prompts
    driven the same way: prefill without ``pad_to`` (context T, the ring
    evicts), the re-layout, then greedy decode steps: the same tokens."""
    _, tcfg, _, _ = _pair(*case)
    B, T_, steps = 2, 10, 6
    out = serve.run_lm(tcfg, batch=B, prompt_len=T_, new_tokens=steps,
                       seed=4, device="cpu")
    gen = torch.Generator().manual_seed(4)
    tp = ttf.init_params(tcfg, gen, "cpu")
    prompts = host(torch.randint(0, tcfg.vocab, (B, T_), generator=gen))
    jcfg = _pair(*case)[0]
    jp = _tree(tp, lambda x: jnp.asarray(host(x)))
    logits, _, cache, _ = jax.jit(lambda p, t: jtf.forward(
        jcfg, p, {"tokens": t}, mode="prefill"))(jp, prompts)
    np.testing.assert_allclose(np.asarray(logits[:, -1]), host(out["logits"]),
                               **MODEL_TOL)
    cache = ttf.prefill_cache_to_decode(tcfg, _tree(cache, _t))
    cache = _tree(cache, lambda x: jnp.asarray(host(x)))
    step = jax.jit(jtf.make_serve_step(jcfg))
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    seq = [np.asarray(tok)]
    for _ in range(steps):
        logits, cache = step(jp, cache, tok)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        seq.append(np.asarray(tok))
    np.testing.assert_array_equal(out["tokens"], np.concatenate(seq, 1))


@pytest.mark.parametrize("case", [ZAMBA, XLSTM])
def test_params_cross_and_init_params_draws_the_reference_tree(case):
    """``params_from_numpy`` walks the hybrid's unstacked ``shared_attn``
    and ``shared_mlp`` and xlstm's nested m/s blocks, names a wrong leaf
    by its path, and ``init_params`` draws the reference's tree in
    bfloat16 with the float32 leaves (A_log, D, dt_bias) kept float32."""
    jcfg, tcfg, jp, tp = _pair(*case)
    tree = jax.tree.map(np.asarray, jp)
    _assert_tree_close(tp, tree, rtol=0, atol=0)
    leaf = (("shared_attn", "wq") if tcfg.family == "mamba_hybrid"
            else ("blocks", "s", "rz"))
    node = tree
    for k in leaf[:-1]:
        node = node[k]
    node[leaf[-1]] = node[leaf[-1]][..., :4]
    with pytest.raises(ValueError, match="/".join(leaf)):
        ttf.params_from_numpy(tree, tcfg, "cpu")
    bf16 = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    drawn = ttf.init_params(bf16, torch.Generator().manual_seed(0), "cpu")
    jbf16 = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)[6:]), drawn) \
        == jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jtf.abstract_params(jbf16))


def test_xlstm_needs_pairs_of_layers():
    cfg = tconfigs.get("xlstm-125m").reduced(n_layers=3)
    with pytest.raises(ValueError, match="even"):
        ttf.param_defs(cfg)


# ------------------------------------------------------------ entry point
@pytest.mark.parametrize("arch,family", [("zamba2-7b", "mamba_hybrid"),
                                         ("xlstm-125m", "xlstm")])
def test_serve_lm_runs_the_family_on_cpu(arch, family, capsys):
    before = dict(ops.LAUNCHES)
    out = serve.main(["--mode", "lm", "--arch", arch, "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--new-tokens",
                      "4"])
    assert ops.LAUNCHES == before
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "[serve]", "[prefill]", "[decode]", "[sample]"]
    assert f"family={family}" in lines[0] and "layers=2" in lines[0]
    assert out["tokens"].shape == (2, 5)
    assert ((out["tokens"] >= 0) & (out["tokens"] < 512)).all()
    assert np.isfinite(host(out["logits"])).all()


def test_zamba2s_shared_attention_views_take_the_tensor_cores(monkeypatch):
    """``flash_attention.route`` (a pure function) on the q, k, v that
    zamba2-7b's shared block hands K4 at full width, B = 4, T = 1,024: the
    block runs on the meta device (shapes and strides, no data) with K4's
    wrapper replaced by a recorder.  (4, 1024, 32, 112) bf16 with the
    window of 4,096; each operand a fresh tensor (offset 0), so its base
    is the allocator's and 16-byte aligned."""
    from repro_torch.kernels import flash_attention as fa

    cfg = dataclasses.replace(tconfigs.get("zamba2-7b"), attn_impl="pallas")
    seen = []

    def record(q, k, v, **kw):
        seen.append((q, k, v, kw))
        return torch.empty_like(q)

    monkeypatch.setattr(ops, "flash_attention", record)
    defs = ttf.param_defs(cfg)
    meta = dict(dtype=torch.bfloat16, device="meta")
    params = {k: {n: torch.empty(d.shape, **meta) for n, d in defs[k].items()}
              for k in ("shared_attn", "shared_mlp")}
    x = torch.empty((4, 1024, cfg.d_model), **meta)
    positions = torch.arange(1024, device="meta").expand(4, 1024)
    ttf._shared_apply(cfg, params, x, positions=positions)
    (q, k, v, kw), = seen
    assert kw == dict(causal=True, q_offset=0, window=4096)
    B, T, H, hd = q.shape
    assert (B, T, H, hd) == (4, 1024, 32, 112) and q.dtype == torch.bfloat16
    assert all(t.shape == q.shape and t.stride(3) == 1
               and t.storage_offset() == 0 for t in (q, k, v))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               T * H * hd, H * hd, hd)
    assert fa.route(q.dtype, hd, strides, (512,) * 4) == "wgmma"
