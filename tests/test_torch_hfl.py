"""Port parity: Algorithm 1 batched over users (``repro_torch.fed.hfl``)
and the uplink transforms of ``repro_torch.fed.compression``, against the
JAX package on the same inputs and JAX's weights.

Aggregation at rtol 1e-6; one global iteration (a dropped user, an edge
whose users all drop out) at rtol 1e-4 / atol 1e-6, with and without
top-k 0.05 + int8 on the uplink; the compressed update bitwise JAX's
``_compress_update`` on the same update; ``run_hfl`` over 3 iterations
with its accuracy history within one test sample and its final leaves at
rtol 1e-4.  Then ``tests/test_fed_hfl.py``'s contracts re-stated on the
port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_bitwise, cnn_params_numpy  # noqa: E402
from repro.data import make_dataset, partition_to_users  # noqa: E402
from repro.fed import compression as jcomp  # noqa: E402
from repro.fed import hfl as jhfl  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.fed import compression as tcomp  # noqa: E402
from repro_torch.fed import hfl as thfl  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

N, M = 8, 3
ASSIGN = np.array([0, 0, 1, 1, 1, 2, 2, 0])
# User 1 dropped; users 5 and 6, edge 2's only users, dropped too.
PART = np.array([1, 0, 1, 1, 1, 0, 0, 1], np.float32)
CFG = jhfl.HflConfig(L=2, K=2, I=3, lr=0.2)
COMP_CFG = dataclasses.replace(CFG, topk_frac=0.05, int8=True)


def _t(cfg):
    return thfl.HflConfig(**dataclasses.asdict(cfg))


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_close(got, want, rtol, atol=0.0):
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(
                got[layer][k].detach().numpy(), np.asarray(want[layer][k]),
                rtol=rtol, atol=atol, err_msg=f"{layer}/{k}")


@pytest.fixture(scope="module")
def setup():
    ds = make_dataset("fashionmnist", n_train=400, n_test=200, seed=0)
    sizes = np.random.default_rng(0).integers(20, 40, size=N)
    x_u, y_u, mask, sizes = partition_to_users(ds.x_train, ds.y_train, sizes)
    cfg = jcnn.PAPER_CNNS["fashionmnist"]
    w0 = cnn_params_numpy(cfg, bias=0.0)    # as init_params draws them
    return ds, cfg, tcnn.PAPER_CNNS["fashionmnist"], w0, x_u, y_u, mask, \
        sizes


def _jax_iteration(setup, cfg, part):
    ds, jcfg, _, w0, x_u, y_u, mask, sizes = setup
    onehot = jax.nn.one_hot(jnp.asarray(ASSIGN), M, dtype=jnp.float32)
    return _numpy(jhfl.global_iteration(
        jcfg, cfg, w0, x_u, y_u, mask, jnp.asarray(sizes, jnp.float32),
        onehot, jnp.asarray(part)))


def _port_iteration(setup, cfg, part):
    ds, _, tcfg, w0, x_u, y_u, mask, sizes = setup
    onehot = torch.nn.functional.one_hot(torch.tensor(ASSIGN), M).float()
    return thfl.global_iteration(
        tcfg, _t(cfg), tcnn.params_from_numpy(w0, tcfg, "cpu"),
        torch.tensor(x_u), torch.tensor(y_u), torch.tensor(mask),
        torch.tensor(sizes, dtype=torch.float32), onehot, torch.tensor(part))


def test_aggregation_matches_jax(setup):
    w0 = setup[3]
    rng = np.random.default_rng(2)
    users = jax.tree.map(
        lambda l: rng.normal(size=(N,) + l.shape).astype(np.float32), w0)
    onehot = np.eye(M, dtype=np.float32)[ASSIGN]
    for weights in (setup[7].astype(np.float32),
                    setup[7].astype(np.float32) * PART):
        je, jw = jhfl.weighted_edge_average(users, jnp.asarray(onehot),
                                            jnp.asarray(weights))
        te, tw = thfl.weighted_edge_average(
            tcnn.tree_map(torch.tensor, users), torch.tensor(onehot),
            torch.tensor(weights))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        # The sums of unit-scale terms run in another order: an average
        # that cancels to near 0 keeps their last bit (~6e-8) as its error.
        _assert_tree_close(te, je, rtol=1e-6, atol=1e-7)
        _assert_tree_close(thfl.cloud_average(te, tw),
                           jhfl.cloud_average(je, jw), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cfg", [CFG, COMP_CFG], ids=["plain", "topk_int8"])
def test_global_iteration_matches_jax(setup, cfg):
    """A dropped user and an edge whose users all drop out: that edge
    broadcasts zeros to its users and weighs 0 in the cloud, in both."""
    want = _jax_iteration(setup, cfg, PART)
    got = _port_iteration(setup, cfg, PART)
    _assert_tree_close(got, want, rtol=1e-4, atol=1e-6)
    # Every user in: a different model, equal across the packages too.
    ones = np.ones(N, np.float32)
    _assert_tree_close(_port_iteration(setup, cfg, ones),
                       _jax_iteration(setup, cfg, ones), rtol=1e-4,
                       atol=1e-6)


@pytest.mark.parametrize("cfg", [
    COMP_CFG, dataclasses.replace(CFG, topk_frac=0.05),
    dataclasses.replace(CFG, int8=True), CFG],
    ids=["topk_int8", "topk", "int8", "off"])
def test_compress_update_is_bitwise_jax(setup, cfg):
    """The same per-user updates (with ties at the top-k threshold) give
    the same compressed updates, bit for bit."""
    w0 = setup[3]
    rng = np.random.default_rng(3)
    upd = jax.tree.map(lambda l: (np.round(rng.normal(
        size=(N,) + l.shape) * 8) / 64).astype(np.float32), w0)
    want = _numpy(jax.vmap(lambda u: jhfl._compress_update(cfg, u))(upd))
    got = thfl._compress_update(_t(cfg), tcnn.tree_map(torch.tensor, upd))
    for layer in want:
        for k in want[layer]:
            assert_bitwise(got[layer][k], want[layer][k], f"{layer}/{k}")


def _mask_table(i):
    return np.roll(PART, i)


def test_run_hfl_matches_jax(setup):
    ds, jcfg, tcfg, w0, x_u, y_u, mask, sizes = setup
    jw, jh = jhfl.run_hfl(jcfg, w0, x_u, y_u, mask, sizes, ASSIGN, CFG,
                          x_test=ds.x_test, y_test=ds.y_test,
                          participate_fn=_mask_table)
    tw, th = thfl.run_hfl(tcfg, tcnn.params_from_numpy(w0, tcfg, "cpu"),
                          x_u, y_u, mask, sizes, ASSIGN, _t(CFG),
                          x_test=ds.x_test, y_test=ds.y_test,
                          participate_fn=_mask_table, device="cpu")
    assert th["iter"] == jh["iter"] == [0, 1, 2]
    np.testing.assert_allclose(th["acc"], jh["acc"],
                               atol=1.0 / len(ds.y_test))
    _assert_tree_close(tw, _numpy(jw), rtol=1e-4, atol=1e-6)


def test_a_near_tie_amplifies_the_last_bit_in_both_packages(setup):
    """Why ``run_hfl`` is compared from its initial weights and not along
    any trajectory: from these weights (biases non-zero), the first
    iteration's models differ between the packages in the last bit
    (<= 6e-8), and the next iteration turns that into ~8e-6 on a conv0
    bias (a ReLU or max-pool choice flips) -- in the port fed the two
    inputs, and in the JAX package alike.  From equal inputs the two
    packages agree at rtol 1e-4."""
    ds, jcfg, tcfg, _, x_u, y_u, mask, sizes = setup
    w = cnn_params_numpy(jcfg, bias=0.1)
    biased = (ds, jcfg, tcfg, w, x_u, y_u, mask, sizes)
    jw1 = _jax_iteration(biased, CFG, PART)
    tw1 = _port_iteration(biased, CFG, PART)
    _assert_tree_close(tw1, jw1, rtol=1e-4, atol=1e-6)
    tw1_np = tcnn.tree_map(lambda t: t.numpy(), tw1)
    part = np.roll(PART, 1)
    port = [_port_iteration((*biased[:3], v, *biased[4:]), CFG, part)
            for v in (jw1, tw1_np)]
    jax_ = [_jax_iteration((*biased[:3], v, *biased[4:]), CFG, part)
            for v in (jw1, tw1_np)]
    gap_port = float((port[0]["conv0"]["b"] - port[1]["conv0"]["b"]).abs()
                     .max())
    gap_jax = float(np.abs(jax_[0]["conv0"]["b"] - jax_[1]["conv0"]["b"])
                    .max())
    assert gap_port > 1e-6 and gap_jax > 1e-6, (gap_port, gap_jax)
    for got, want in zip(port, jax_):
        _assert_tree_close(got, want, rtol=1e-4, atol=1e-6)


def test_run_fl_is_run_hfl_at_m1_k1(setup):
    """FL is the M=1, K=1 special case — same global update."""
    ds, _, tcfg, w0, x_u, y_u, mask, sizes = setup
    w = tcnn.params_from_numpy(w0, tcfg, "cpu")
    hcfg = thfl.HflConfig(L=2, K=1, I=2, lr=0.05)
    w_fl, _ = thfl.run_fl(tcfg, w, x_u, y_u, mask, sizes, hcfg,
                          device="cpu")
    w_h, _ = thfl.run_hfl(tcfg, w, x_u, y_u, mask, sizes,
                          np.zeros(N, np.int32), hcfg, M=1, device="cpu")
    for a, b in zip(tcnn.tree_leaves(w_fl), tcnn.tree_leaves(w_h)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_hfl_aggregation_preserves_weighted_mean(setup):
    """Edge+cloud aggregation == direct weighted mean over users (L=0)."""
    w0, sizes = setup[3], setup[7]
    gen = torch.Generator().manual_seed(1)
    users = tcnn.tree_map(
        lambda l: torch.randn((N,) + l.shape, generator=gen), w0)
    onehot = torch.nn.functional.one_hot(torch.tensor(ASSIGN), M).float()
    weights = torch.tensor(sizes, dtype=torch.float32)
    edge, _ = thfl.weighted_edge_average(users, onehot, weights)
    w = thfl.cloud_average(edge, torch.einsum("n,nm->m", weights, onehot))
    direct = tcnn.tree_map(
        lambda l: torch.einsum("n,n...->...", weights, l) / weights.sum(),
        users)
    for a, b in zip(tcnn.tree_leaves(w), tcnn.tree_leaves(direct)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_f32_math_is_scoped():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with thfl.f32_math():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


# ----------------------------------------------------------- compression
def test_uplink_transforms_are_bitwise_jax():
    rng = np.random.default_rng(4)
    u = {"a": rng.normal(size=(64, 64)).astype(np.float32),
         "b": {"c": (np.round(rng.normal(size=33) * 2) / 2
                     ).astype(np.float32)}}          # ties at the threshold
    tu = tcnn.tree_map(torch.tensor, u)
    js, ts = jcomp.topk_init(u), tcomp.topk_init(tu)
    for _ in range(3):
        jk, js = jcomp.topk_compress(u, js, frac=0.1)
        tk, ts = tcomp.topk_compress(tu, ts, frac=0.1)
        for got, want in ((tk, jk), (ts.error, js.error)):
            assert_bitwise(got["a"], want["a"])
            assert_bitwise(got["b"]["c"], want["b"]["c"])
    jq, jsc = jcomp.int8_quantize(u)
    tq, tsc = tcomp.int8_quantize(tu)
    assert_bitwise(tq["a"], jq["a"])
    assert_bitwise(tsc["a"], jsc["a"])
    assert_bitwise(tcomp.int8_dequantize(tq, tsc)["b"]["c"],
                   jcomp.int8_dequantize(jq, jsc)["b"]["c"])


def test_topk_error_feedback_converges():
    gen = torch.Generator().manual_seed(0)
    u = {"a": torch.randn((64, 64), generator=gen)}
    state = tcomp.topk_init(u)
    acc = torch.zeros_like(u["a"])
    for _ in range(20):
        kept, state = tcomp.topk_compress(u, state, frac=0.1)
        acc = acc + kept["a"]
    # after many rounds, sum of compressed updates ~ sum of true updates
    # (residual bounded by ~1/frac rounds of backlog -> err ~ O(1/rounds))
    want = u["a"] * 20
    err = float(torch.linalg.norm(acc - want) / torch.linalg.norm(want))
    assert err < 0.3, err
    # without error feedback the same pipeline is far worse
    acc2 = torch.zeros_like(u["a"])
    for _ in range(20):
        kept, _ = tcomp.topk_compress(u, tcomp.topk_init(u), frac=0.1)
        acc2 = acc2 + kept["a"]
    err2 = float(torch.linalg.norm(acc2 - want) / torch.linalg.norm(want))
    assert err2 > err


def test_int8_roundtrip():
    gen = torch.Generator().manual_seed(0)
    u = {"w": torch.randn((32, 32), generator=gen)}
    q, s = tcomp.int8_quantize(u)
    assert q["w"].dtype == torch.int8
    back = tcomp.int8_dequantize(q, s)
    err = float(torch.max(torch.abs(back["w"] - u["w"])))
    assert err <= float(s["w"]) * 1.01
