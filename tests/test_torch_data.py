"""Port parity: the synthetic datasets and the federated partitions are
numpy in both packages, drawn in the same ``default_rng`` order, so every
array must be bitwise the JAX package's."""
import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_parity import assert_bitwise  # noqa: E402
from repro.data import partitioner as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import partitioner as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


@pytest.mark.parametrize("name", sorted(jsyn.DATASET_SHAPES))
def test_make_dataset_is_bitwise_jax(name):
    assert tsyn.DATASET_SHAPES == jsyn.DATASET_SHAPES
    kw = dict(n_train=300, n_test=50, shape=jsyn.DATASET_SHAPES[name],
              seed=3)
    want, got = jsyn.make_dataset(name, **kw), tsyn.make_dataset(name, **kw)
    assert got.name == want.name and got.n_classes == want.n_classes
    for field in ("x_train", "y_train", "x_test", "y_test"):
        assert_bitwise(getattr(got, field), getattr(want, field), field)


@pytest.fixture(scope="module")
def ds():
    return jsyn.make_dataset("fashionmnist", n_train=600, n_test=10, seed=0)


@pytest.mark.parametrize("alpha", [None, 0.1, 0.5])
def test_partition_to_users_is_bitwise_jax(ds, alpha):
    sizes = np.random.default_rng(1).integers(20, 60, size=12)
    want = jpart.partition_to_users(ds.x_train, ds.y_train, sizes,
                                    alpha=alpha, seed=2)
    got = tpart.partition_to_users(ds.x_train, ds.y_train, sizes,
                                   alpha=alpha, seed=2)
    for g, w, name in zip(got, want, ("x", "y", "mask", "sizes")):
        assert_bitwise(g, w, name)


def test_partitioners_are_bitwise_jax(ds):
    sizes = np.array([40, 7, 90, 55])
    for g, w in zip(tpart.iid_partition(600, sizes, seed=4),
                    jpart.iid_partition(600, sizes, seed=4)):
        assert_bitwise(g, w)
    # A class runs dry at alpha 0.05: the global top-up draws too.
    big = np.array([150, 150, 150, 150])
    for g, w in zip(tpart.dirichlet_partition(ds.y_train, big, 0.05, seed=5),
                    jpart.dirichlet_partition(ds.y_train, big, 0.05, seed=5)):
        assert_bitwise(g, w)


def test_partition_keeps_sizes_when_iid_runs_short(ds):
    """More samples asked for than exist: the last users' parts are short,
    ``sizes`` stay as given and the mask marks the real rows."""
    sizes = np.array([250, 250, 250])                # 750 > 600 samples
    want = jpart.partition_to_users(ds.x_train, ds.y_train, sizes, seed=0)
    got = tpart.partition_to_users(ds.x_train, ds.y_train, sizes, seed=0)
    for g, w in zip(got, want):
        assert_bitwise(g, w)
    np.testing.assert_array_equal(got[3], sizes)
    np.testing.assert_array_equal(got[2].sum(axis=1), [250, 250, 100])


def test_token_stream_is_bitwise_jax():
    assert_bitwise(tsyn.token_stream(37, 500, seed=9),
                   jsyn.token_stream(37, 500, seed=9))
