"""Port parity for the encoder family and the ``embeds``/``mixed``
frontends (hubert-xlarge, internvl2-76b): ``models/transformer.py``'s
layer-norm blocks with biases, GELU MLP, non-causal attention,
``in_proj``, the patch prefix and its loss mask, and ``serve --mode lm``'s
``run_lm`` on ``mixed`` input, against the JAX package on reduced configs
(2 layers, d 128, 4 heads, vocab 512, f32) with its weights carried across
as numpy.  Every bias, layer-norm shift and norm scale is drawn non-zero
(``_torch_parity.with_random_biases``): ``init_params`` zeroes them, which
would hide a missing bias.  Serial time on one CPU thread: ~14 s.

Tolerances, each with its reason:

* Logits: rtol 1e-4, atol 1e-4, as for the other families
  (``tests/test_torch_models.py``): matmul summation order differs between
  XLA and PyTorch.
* K4's plain version against the chunked route: 2e-4, the reference's own
  tolerance between its attention impls.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (batch_both, host, lm_batch, lm_pair,  # noqa: E402
                           params_to_torch, with_random_biases)
from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
T = 24


def _pair(arch, **kw):
    jcfg, tcfg, jp, _ = lm_pair(arch, **kw)
    jp = with_random_biases(jp, seed=3)
    return jcfg, tcfg, jp, params_to_torch(jp, tcfg)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "internvl2-76b"])
def test_forward_logits_match_jax_with_nonzero_biases(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    if arch == "hubert-xlarge":
        assert {"in_proj", "final_ln_b"} <= set(tp) and "embed" not in tp
        assert {"ln_b", "b_in", "b_out"} <= set(tp["blocks"]["mlp"])
        assert float(tp["blocks"]["attn"]["ln_b"].abs().min()) > 0
    jb, tb = batch_both(lm_batch(tcfg, 2, T, seed=1))
    want = jax.jit(lambda p, b: jtf.forward(jcfg, p, b)[0])(jp, jb)
    got, aux, cache, mask = ttf.forward(tcfg, tp, tb)
    assert got.shape == (2, T, tcfg.vocab) and cache is None
    np.testing.assert_allclose(host(got), np.asarray(want), **TOL)
    # hubert attends both ways: a later frame moves an earlier logit.
    if arch == "hubert-xlarge":
        tb2 = dict(tb, embeds=tb["embeds"].clone())
        tb2["embeds"][:, -1] += 1.0
        moved = ttf.forward(tcfg, tp, tb2)[0]
        assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_mixed_loss_mask_is_false_on_the_patches():
    jcfg, tcfg, jp, tp = _pair("internvl2-76b")
    jb, tb = batch_both(lm_batch(tcfg, 3, T, seed=2))
    P = tcfg.n_patches
    x, pos, mask = ttf.embed_inputs(tcfg, tp, tb)
    jx, jpos, jmask = jtf.embed_inputs(jcfg, jp, jb, jtf._identity_shard)
    assert mask.dtype == torch.bool and mask.shape == (3, T)
    np.testing.assert_array_equal(host(mask), np.asarray(jmask))
    assert not mask[:, :P].any() and mask[:, P:].all()
    np.testing.assert_array_equal(host(pos), np.asarray(jpos))
    # the patches lead the sequence, the embedded tokens follow
    np.testing.assert_array_equal(host(x[:, :P]), host(tb["patches"]))
    np.testing.assert_allclose(host(x), np.asarray(jx), rtol=0, atol=0)
    assert ttf.forward(tcfg, tp, tb)[3].equal(mask)
    # the other modes have no mask
    hcfg = dataclasses.replace(tcfg, input_mode="embeds")
    assert ttf.embed_inputs(hcfg, {"in_proj": torch.eye(tcfg.d_model)},
                            {"embeds": tb["patches"]})[2] is None


def test_run_lm_prefills_patches_before_the_prompt():
    """``run_lm`` on internvl2 draws weights, then prompts, then patches
    from its generator; its prefill logits equal JAX's ``forward`` at the
    last position of (patches, prompt) with those tensors, and the cache
    holds n_patches + prompt_len positions."""
    cfg = tconfigs.get("internvl2-76b").reduced()
    B, L, seed = 2, 10, 5
    out = serve.run_lm(cfg, batch=B, prompt_len=L, new_tokens=2, seed=seed,
                       device="cpu")
    gen = torch.Generator().manual_seed(seed)
    tp = ttf.init_params(cfg, gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (B, L), generator=gen)
    patches = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                          dtype=cfg.dtype)
    jcfg = jconfigs.get("internvl2-76b").reduced()
    jp = jax.tree.map(lambda t: jnp.asarray(host(t)), tp)
    jb = {"tokens": jnp.asarray(host(prompts)),
          "patches": jnp.asarray(host(patches))}
    jlogits = jtf.forward(jcfg, jp, jb)[0]
    np.testing.assert_allclose(host(out["logits"]),
                               np.asarray(jlogits[:, -1]), **TOL)
    np.testing.assert_array_equal(out["tokens"][:, 0],
                                  np.asarray(jnp.argmax(jlogits[:, -1], -1)))
    _, cache = ttf.make_prefill_step(cfg)(
        tp, {"tokens": prompts, "patches": patches})
    assert int(cache["pos"]) == cfg.n_patches + L
    assert cache["k"].shape[2] == cfg.n_patches + L
    assert out["tokens"].shape == (B, 3)


def test_hubert_on_k4s_plain_version_matches_chunked():
    jcfg, tcfg, jp, tp = _pair("hubert-xlarge")
    _, tb = batch_both(lm_batch(tcfg, 2, T, seed=4))
    before = dict(ops.LAUNCHES)
    with torch.no_grad():
        want = ttf.forward(tcfg, tp, tb)[0]
        got = ttf.forward(dataclasses.replace(tcfg, attn_impl="pallas"), tp,
                          tb)[0]
    assert ops.LAUNCHES == before
    np.testing.assert_allclose(host(got), host(want), rtol=2e-4, atol=2e-4)


def test_the_encoder_has_no_decode():
    tcfg = tconfigs.get("hubert-xlarge").reduced()
    with pytest.raises(ValueError, match="no decode cache"):
        ttf.cache_defs(tcfg, 1, 8)
    with pytest.raises(ValueError, match="does not decode"):
        ttf.decode_step(tcfg, {}, {"pos": torch.zeros((), dtype=torch.int32)},
                        torch.zeros((1, 1), dtype=torch.int32))
