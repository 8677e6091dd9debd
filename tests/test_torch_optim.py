"""Port parity for ``optim/``: SGD (plain and Nesterov), AdamW and
Adafactor (factored and unfactored leaves), ``clip_by_global_norm`` and the
schedules, against the JAX package on the same numpy parameters and
gradients, in float32 and bfloat16, over 3 steps, with ``lr_scale`` a
Python number and a schedule's 0-d float32 tensor.  The JAX side runs
eagerly (one XLA computation an operation, as PyTorch rounds: bfloat16
results round after every operation in both).  Serial time: ~15 s.

Tolerance: 1e-6 (absolute and relative): the same float32 arithmetic in
the same order; bfloat16 parameters must agree to the bit, which 1e-6
demands of values of order 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import host  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
# Leaves of every rank the optimizers tell apart: a stacked (L, d, ff)
# weight and a (d, ff) one (Adafactor factors both over their last two
# axes), a vector and a 0-d scalar (a full moment).
SHAPES = {"blocks": {"w": (3, 8, 6), "ln": (8,)}, "head": (8, 5), "s": ()}
OPTS = {
    "sgd": dict(lr=0.05, momentum=0.9),
    "sgd_nesterov": dict(lr=0.05, momentum=0.9, nesterov=True),
    "adamw": dict(lr=3e-3),
    "adafactor": dict(lr=1e-2),
}


def _draw(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(shapes[k], rng, scale) for k in sorted(shapes)}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _both(tree, dtype):
    """numpy float32 leaves -> (JAX, torch) trees in ``dtype``."""
    if isinstance(tree, dict):
        pairs = {k: _both(v, dtype) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    j = jnp.asarray(tree).astype(dtype)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])


def _assert_tree(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree(got[k], want[k])
        return
    g = host(got.float()) if got.dtype == torch.bfloat16 else host(got)
    w = np.asarray(want.astype(jnp.float32)) if want.dtype == jnp.bfloat16 \
        else np.asarray(want)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_jax_over_three_steps(name, dtype, schedule):
    rng = np.random.default_rng(0)
    kw = dict(OPTS[name])
    base = "sgd" if name.startswith("sgd") else name
    jo, to = joptim.get_optimizer(base, **kw), toptim.get_optimizer(base,
                                                                   **kw)
    jp, tp = _both(_draw(SHAPES, rng), dtype)
    js, ts = jo.init(jp), to.init(tp)
    _assert_tree(ts, js)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    jsched, tsched = joptim.cosine(6, 2), toptim.cosine(6, 2)
    for _ in range(3):
        jg, tg = _both(_draw(SHAPES, rng, 0.3), dtype)
        jscale = jsched(js["step"]) if schedule else 1.0
        tscale = tsched(ts["step"]) if schedule else 1.0
        before = {k: v for k, v in tp.items()}
        jp, js = jo.update(jg, js, jp, lr_scale=jscale)
        tp, ts = to.update(tg, ts, tp, lr_scale=tscale)
        _assert_tree(tp, jp)
        _assert_tree(ts, js)
        assert before["head"] is not tp["head"]        # new tensors
    assert int(ts["step"]) == 3
    # the moments' dtypes: adamw's and adafactor's float32, sgd's the
    # parameter's
    if base == "adamw":
        assert ts["m"]["head"].dtype == torch.float32
    elif base == "adafactor":
        assert set(ts["mom"]["blocks"]["w"]) == {"vr", "vc"}
        assert ts["mom"]["blocks"]["w"]["vr"].shape == (3, 8)
        assert ts["mom"]["blocks"]["w"]["vc"].shape == (3, 6)
        assert set(ts["mom"]["blocks"]["ln"]) == {"v"}
    else:
        assert ts["mu"]["head"].dtype == tp["head"].dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm, dtype):
    jg, tg = _both(_draw(SHAPES, np.random.default_rng(1)), dtype)
    jc, jn = joptim.clip_by_global_norm(jg, max_norm)
    tc, tn = toptim.clip_by_global_norm(tg, max_norm)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    _assert_tree(tc, jc)
    assert tc["head"].dtype == tg["head"].dtype


@pytest.mark.parametrize("step", [0, 1, 3, 4, 9, 10, 15])
def test_schedules_match_jax(step):
    js, ts = jnp.asarray(step, jnp.int32), torch.tensor(step,
                                                        dtype=torch.int32)
    for jf, tf_ in ((joptim.constant(), toptim.constant()),
                    (joptim.linear_warmup(4), toptim.linear_warmup(4)),
                    (joptim.cosine(10, 4), toptim.cosine(10, 4)),
                    (joptim.cosine(10), toptim.cosine(10)),
                    (joptim.linear_warmup(0), toptim.linear_warmup(0))):
        got = tf_(ts)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jf(js)), **TOL)
