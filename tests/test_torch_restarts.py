"""Port parity: the engine's random restarts (``n_starts > 2``).

The JAX engine draws restarts 2.. with ``jax.random.randint(fold_in(
PRNGKey(17), s), (N,), 0, M)``.  The port draws them with a numpy
threefry2x32 (``repro_torch.core.threefry``): every draw must equal
``jax.random``'s bit for bit, and the searches from them must give the
JAX engine's integers (assignments, move traces, round counts) exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, assert_engine_match,  # noqa: E402
                           fleet_to_torch, host, scenario_to_torch)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import engine as jeng  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
SPEC = dataclasses.replace(jw.ScenarioSpec(), N=10, M=3)

# The grid of ROADMAP queue 1 item 4: 8 x 9 x 6 = 432 draws.
STARTS = range(2, 10)
NS = (1, 2, 7, 16, 24, 56, 57, 128, 513)
MS = (1, 2, 3, 5, 8, 24)


# ------------------------------------------------------------- threefry
@pytest.mark.parametrize("N", NS)
def test_restart_draws_are_jax_random_bitwise(N):
    for s in STARTS:
        key = jax.random.fold_in(jax.random.PRNGKey(17), s)
        for M in MS:
            want = np.asarray(jax.random.randint(key, (N,), 0, M,
                                                 jnp.int32))
            assert_bitwise(threefry.restart_pattern(s, N, M), want,
                           f"s={s} N={N} M={M}")


@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 - 1])
def test_key_operations_are_jax_random_bitwise(seed):
    """PRNGKey, fold_in, split and 32-bit bits on their own."""
    jkey = jax.random.PRNGKey(seed)
    key = threefry.prng_key(seed)
    assert_bitwise(key, np.asarray(jkey))
    for d in (0, 1, 5, 2 ** 32 - 1):
        assert_bitwise(threefry.fold_in(key, d),
                       np.asarray(jax.random.fold_in(jkey, d)))
    for num in (2, 3, 8):
        assert_bitwise(threefry.split(key, num),
                       np.asarray(jax.random.split(jkey, num)))
    assert_bitwise(threefry.random_bits32(key, 11),
                   np.asarray(jax.random.bits(jkey, (11,), jnp.uint32)))


def test_randint_offset_range_matches_jax():
    key = threefry.fold_in(threefry.prng_key(3), 4)
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), 4)
    for lo, hi in ((5, 6), (-3, 9), (10, 4)):
        assert_bitwise(threefry.randint(key, 37, lo, hi),
                       np.asarray(jax.random.randint(jkey, (37,), lo, hi,
                                                     jnp.int32)))


# --------------------------------------------------------- start patterns
@pytest.fixture(scope="module")
def scn10():
    return jw.draw_scenario(3, SPEC)


@pytest.mark.parametrize("masked", [False, True], ids=["open", "edge_mask"])
def test_start_patterns_match_jax(masked):
    """Starts 0..5 and a tail row, with inactive users and (optionally) a
    closed site: the greedy start ranks open sites only and random draws
    on the closed site re-home to the first open one."""
    scn = jw.draw_scenario(5, dataclasses.replace(SPEC, M=4))
    if masked:
        scn = scn._replace(edge_mask=jnp.asarray([False, True, True,
                                                  False]))
    rng = np.random.default_rng(0)
    init = rng.integers(0, 4, 10).astype(np.int32)
    mask = rng.uniform(size=10) < 0.7
    tail = rng.integers(0, 4, 10).astype(np.int32)
    want = jeng._start_patterns(scn, jnp.asarray(init), jnp.asarray(mask),
                                6, jnp.asarray(tail))
    one = tb.map_scenario(lambda x: x[None], scenario_to_torch(scn))
    got = teng._start_patterns(one, torch.tensor(init)[None],
                               torch.tensor(mask)[None], 6,
                               torch.tensor(tail)[None])
    assert_bitwise(got[0], want)


# ----------------------------------------------------------------- search
@pytest.mark.parametrize("n_starts", [3, 4])
def test_solve_assignment_restarts_match_jax(scn10, n_starts):
    kw = dict(lam=1.0, max_rounds=4, escape_iters=1, top_k=6,
              n_starts=n_starts)
    want = jeng.solve_assignment(scn10, cfg=JCFG, **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), cfg=TCFG, **kw)
    assert_engine_match(got, want)


def test_restarts_on_the_full_neighbourhood_match_jax(scn10):
    """Five starts, a cold init and two inactive users, scoring every
    single move (no K3)."""
    init = np.zeros(10, np.int32)
    mask = np.ones(10, bool)
    mask[[3, 8]] = False
    kw = dict(lam=0.5, max_rounds=3, escape_iters=1, n_starts=5)
    want = jeng.solve_assignment(scn10, jnp.asarray(init), jnp.asarray(mask),
                                 cfg=JCFG, **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), torch.tensor(init),
                                torch.tensor(mask), cfg=TCFG, **kw)
    assert_engine_match(got, want)


def test_tail_init_restart_matches_jax(scn10):
    """A warm-start tail alone (one start plus the tail row)."""
    tail = np.asarray([1, 0, 2, 2, 1, 0, 0, 1, 2, 1], np.int32)
    kw = dict(lam=1.0, max_rounds=4, escape_iters=1, top_k=6)
    want = jeng.solve_assignment(scn10, cfg=JCFG, tail_init=jnp.asarray(tail),
                                 **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), cfg=TCFG,
                                tail_init=torch.tensor(tail), **kw)
    assert_engine_match(got, want)


@pytest.fixture(scope="module")
def fleet_pair():
    jf = jb.draw_fleet(2, 3, dataclasses.replace(SPEC, N=8, M=3),
                       n_range=(5, 8))
    return jf, fleet_to_torch(jf)


def test_fleet_restarts_match_jax_and_never_lose(fleet_pair):
    """Four starts for every cell of a fleet in one search (C*S rows):
    the JAX integers, and never worse than the single-start search."""
    jf, tf = fleet_pair
    kw = dict(lam=1.0, max_rounds=3, escape_iters=1, top_k=4)
    want = jeng.solve_fleet_assignments(jf, cfg=JCFG, n_starts=4, **kw)
    got = teng.solve_fleet_assignments(tf, cfg=TCFG, n_starts=4, **kw)
    assert_engine_match(got, want)
    one = teng.solve_fleet_assignments(tf, cfg=TCFG, n_starts=1, **kw)
    assert (host(got.R) <= host(one.R)).all()


def test_fleet_restart_rows_equal_each_start_alone(fleet_pair):
    """D2/D7 across the start axis: the winning start of a cell is bitwise
    that start searched on its own."""
    _, tf = fleet_pair
    kw = dict(lam=1.0, max_rounds=2, escape_iters=1, top_k=4)
    got = teng.solve_fleet_assignments(tf, cfg=TCFG, n_starts=3, **kw)
    init = tb.fleet_assignments(tf)
    starts = teng._start_patterns(tf.cells, init, tf.mask, 3)
    for c in (1,):
        outs = [teng.solve_fleet_assignments(tf.index([c]),
                                             starts[c, s][None], cfg=TCFG,
                                             **kw) for s in range(3)]
        best = int(np.argmin([float(o.R[0]) for o in outs]))
        assert_bitwise(got.assign[c], outs[best].assign[0])
        assert_bitwise(got.R[c], outs[best].R[0])
