"""Port parity: the paper's three CNNs (``repro_torch.models.cnn``) against
``repro.models.cnn`` on weights in JAX's layout, carried across with
``params_from_numpy``: logits at rtol 1e-5 / atol 1e-6, each user's
masked loss at rtol 1e-5, and the batched per-user gradients (one autograd call
over the users' summed losses) against ``jax.grad`` of each user's loss at
rtol 1e-4 / atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cnn_params_numpy  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

NAMES = sorted(jcnn.PAPER_CNNS)
N_USERS, BATCH = 3, 5


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=NAMES)
def case(request):
    """One CNN: JAX's weights, three users' perturbed copies of them, each
    user's batch with a mask that pads its last rows out."""
    name = request.param
    cfg = jcnn.PAPER_CNNS[name]
    w = cnn_params_numpy(cfg, 0)
    rng = np.random.default_rng(1)
    users = jax.tree.map(
        lambda l: (l[None] + 0.05 * rng.normal(size=(N_USERS,) + l.shape)
                   ).astype(np.float32), w)
    x = rng.uniform(-0.5, 0.5, (N_USERS, BATCH) + cfg.in_shape
                    ).astype(np.float32)
    y = rng.integers(0, 10, (N_USERS, BATCH)).astype(np.int32)
    mask = np.ones((N_USERS, BATCH), np.float32)
    mask[0, 3:] = 0.0
    mask[2, :] = 0.0                # no real row: the divisor's floor of 1
    return name, cfg, tcnn.PAPER_CNNS[name], w, users, x, y, mask


def test_config_and_param_bytes_match(case):
    name, jcfg, tcfg, w, *_ = case
    assert tcfg == tcnn.CnnConfig(**vars(jcfg))
    assert tcnn.param_bytes(tcfg) == jcnn.param_bytes(jcfg)
    shapes = tcnn.param_shapes(tcfg)
    want = jax.eval_shape(lambda k: jcnn.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    assert list(shapes) == list(want)             # the draw order too
    assert jax.tree.map(lambda s: s.shape, want) == shapes
    drawn = tcnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert tcnn.tree_map(lambda t: tuple(t.shape), drawn) == shapes


def test_forward_matches_jax(case):
    name, jcfg, tcfg, w, users, x, *_ = case
    want = np.asarray(jcnn.forward(jcfg, w, x[0]))
    got = tcnn.forward(tcfg, tcnn.params_from_numpy(w, tcfg, "cpu"),
                       torch.tensor(x[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def _user(tree, n):
    return jax.tree.map(lambda l: l[n], tree)


def test_per_user_masked_loss_matches_jax(case):
    name, jcfg, tcfg, w, users, x, y, mask = case
    tu = tcnn.tree_map(torch.tensor, users)
    got = tcnn.loss_users(tcfg, tu, torch.tensor(x), torch.tensor(y),
                          torch.tensor(mask)).numpy()
    want = [float(jcnn.loss_fn(jcfg, _user(users, n), x[n], y[n], mask[n]))
            for n in range(N_USERS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # loss_fn is the one-user case, with and without a mask.
    one = tcnn.params_from_numpy(_user(users, 1), tcfg, "cpu")
    for m in (mask[1], None):
        np.testing.assert_allclose(
            float(tcnn.loss_fn(tcfg, one, torch.tensor(x[1]),
                               torch.tensor(y[1]),
                               None if m is None else torch.tensor(m))),
            float(jcnn.loss_fn(jcfg, _user(users, 1), x[1], y[1], m)),
            rtol=1e-5)


def test_batched_user_gradients_match_jax_grad(case):
    name, jcfg, tcfg, w, users, x, y, mask = case
    grad = jax.jit(jax.vmap(jax.grad(jcnn.loss_fn, argnums=1),
                            in_axes=(None, 0, 0, 0, 0)), static_argnums=0)
    want = _numpy(grad(jcfg, users, x, y, mask))
    tu = tcnn.tree_map(lambda l: torch.tensor(l).requires_grad_(), users)
    leaves = tcnn.tree_leaves(tu)
    loss = tcnn.loss_users(tcfg, tu, torch.tensor(x), torch.tensor(y),
                           torch.tensor(mask)).sum()
    got = tcnn.tree_unflatten(tu, torch.autograd.grad(loss, leaves))
    for layer in want:
        for k in want[layer]:
            np.testing.assert_allclose(got[layer][k].numpy(),
                                       want[layer][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} {layer}/{k}")
    # The fully masked user's loss is 0 whatever its weights: no gradient.
    for leaf in tcnn.tree_leaves(got):
        assert not leaf[2].any()


def test_accuracy_matches_jax(case):
    name, jcfg, tcfg, w, users, x, y, mask = case
    xs, ys = x.reshape((-1,) + x.shape[2:]), y.reshape(-1)
    got = float(tcnn.accuracy(tcfg, tcnn.params_from_numpy(w, tcfg, "cpu"),
                              torch.tensor(xs), torch.tensor(ys)))
    want = float(jcnn.accuracy(jcfg, w, xs, ys))
    # The same count of right answers (XLA's mean may round the last bit
    # differently from the division).
    assert round(got * len(ys)) == round(want * len(ys))


def test_params_from_numpy_checks_shapes():
    cfg = tcnn.PAPER_CNNS["fashionmnist"]
    w = cnn_params_numpy(jcnn.PAPER_CNNS["fashionmnist"])
    bad = dict(w, head={"w": w["head"]["w"].T, "b": w["head"]["b"]})
    with pytest.raises(ValueError, match="head/w"):
        tcnn.params_from_numpy(bad, cfg, "cpu")
    with pytest.raises(KeyError, match="conv1"):
        tcnn.params_from_numpy({"conv0": w["conv0"]}, cfg, "cpu")
    # JAX arrays cross too, bit for bit.
    got = tcnn.params_from_numpy(jax.tree.map(jnp.asarray, w), cfg, "cpu")
    np.testing.assert_array_equal(got["conv1"]["w"].numpy(), w["conv1"]["w"])
