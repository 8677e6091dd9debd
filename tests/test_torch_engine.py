"""Port parity: the assignment engine (TSIA's snapshot search), against the
JAX engine on the ``tests/test_engine.py`` fixtures.

Integer outputs (assignments, move traces, round and escape counts) must
match exactly; objectives to rtol 1e-5.  Inside torch the fleet search
equals each cell searched alone BITWISE (D2/D7): cells freeze one by one,
as under the JAX engine's vmapped ``while_loop``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, fleet_to_torch, host,  # noqa: E402
                           scenario_to_torch)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import engine as jeng  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
SPEC = dataclasses.replace(jw.ScenarioSpec(), N=10, M=3)
FSPEC = dataclasses.replace(jw.ScenarioSpec(), N=8, M=2)


@pytest.fixture(scope="module")
def scn10():
    """``tests/test_engine.py``'s ``scn10``."""
    return jw.draw_scenario(3, SPEC)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _assert_engine_match(got, want):
    """Integer leaves exact, objectives to rtol 1e-5."""
    for name in ("assign", "rounds", "escapes", "converged", "comp"):
        np.testing.assert_array_equal(host(getattr(got, name)),
                                      host(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(host(got.trace.moves),
                                  host(want.trace.moves))
    np.testing.assert_array_equal(host(got.trace.rounds_valid),
                                  host(want.trace.rounds_valid))
    for name in ("R_best", "R_current"):
        np.testing.assert_allclose(host(getattr(got.trace, name)),
                                   host(getattr(want.trace, name)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(host(got.R), host(want.R), rtol=1e-5)
    np.testing.assert_allclose(host(got.R_search), host(want.R_search),
                               rtol=1e-5)
    np.testing.assert_allclose(host(got.sroa.t), host(want.sroa.t),
                               rtol=1e-5)


def _row(tree, i):
    """Row i of every leaf of a (nested) result."""
    if isinstance(tree, tuple):
        return type(tree)(*(_row(x, i) for x in tree))
    return tree[i]


def _tree_bitwise(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _tree_bitwise(g, w)
    else:
        assert_bitwise(got, want)


# ----------------------------------------------------- candidate generation
@pytest.mark.parametrize("movable", [None, [True, False, True, True, False]])
def test_candidate_assigns_device_matches_jax(movable):
    assign = np.asarray([0, 2, 1, 1, 0], np.int32)
    jm = None if movable is None else jnp.asarray(movable)
    tm = None if movable is None else _t(movable)
    wc, wv = jb.candidate_assigns_device(jnp.asarray(assign), 3, jm)
    gc, gv = tb.candidate_assigns_device(_t(assign), 3, tm)
    assert_bitwise(gc, wc)
    assert_bitwise(gv, wv)


def test_candidate_assigns_device_batches_leading_axes():
    rng = np.random.default_rng(0)
    assign = rng.integers(0, 4, (3, 6)).astype(np.int32)
    movable = rng.uniform(size=(3, 6)) < 0.7
    gc, gv = tb.candidate_assigns_device(_t(assign), 4, _t(movable))
    for i in range(3):
        wc, wv = jb.candidate_assigns_device(jnp.asarray(assign[i]), 4,
                                             jnp.asarray(movable[i]))
        assert_bitwise(gc[i], wc)
        assert_bitwise(gv[i], wv)


# ------------------------------------------------------- escape (Def 1 / 2)
@pytest.mark.parametrize("case,expect", [
    # R_m = [5, 1, 3], members {0: users 0,1; 1: user 2}: costly edge 0,
    # economic edge 1, costly user 1 (b = 7 > 2).
    (([0, 0, 1], [5.0, 1.0, 3.0], [2.0, 7.0, 1.0], 3), (1, 0, 1, True)),
    # Edge 2 has the max R_m but is EMPTY: never "costly" (Def 1).
    (([0, 0, 1], [1.0, 2.0, 9.0], [1.0, 2.0, 3.0], 3), (2, 1, 0, True)),
    # m+ == m- (one occupied edge that is also cheapest): no move.
    (([0, 0], [1.0, 5.0], [1.0, 2.0], 2), (None, 0, 0, False)),
], ids=["definition_1_2", "empty_costly_edge", "degenerate"])
def test_escape_move_hand_checked(case, expect):
    """``tests/test_engine.py``'s hand-checked Definition 1/2 fixtures."""
    assign, R_m, b, M = case
    mask = np.ones(len(assign), bool)
    got = teng.escape_move(_t(assign, torch.int32), _t(R_m, torch.float32),
                           _t(b, torch.float32), _t(mask), M)
    want = jeng.escape_move(jnp.asarray(assign, jnp.int32),
                            jnp.asarray(R_m), jnp.asarray(b),
                            jnp.asarray(mask), M)
    got = tuple(host(x).item() for x in got)
    assert got == tuple(host(x).item() for x in want)
    if expect[0] is not None:
        assert got == expect
    assert got[3] == expect[3]


def test_escape_move_matches_jax_on_random_batches():
    rng = np.random.default_rng(3)
    C, N, M = 16, 7, 4
    assign = rng.integers(0, M, (C, N)).astype(np.int32)
    R_m = rng.uniform(0, 10, (C, M)).astype(np.float32)
    b = rng.uniform(0, 5, (C, N)).astype(np.float32)
    mask = rng.uniform(size=(C, N)) < 0.7
    got = teng.escape_move(_t(assign), _t(R_m), _t(b), _t(mask), M)
    for i in range(C):
        want = jeng.escape_move(jnp.asarray(assign[i]), jnp.asarray(R_m[i]),
                                jnp.asarray(b[i]), jnp.asarray(mask[i]), M)
        assert tuple(host(x[i]).item() for x in got) == tuple(
            host(x).item() for x in want)


def test_pruned_candidates_match_jax(scn10):
    tscn = scenario_to_torch(scn10)
    cur = jw.nearest_edge_assignment(scn10)
    mask = np.ones(10, bool)
    mask[4] = False
    wc, wv = jeng._pruned_candidates(scn10, cur, jnp.asarray(mask), 5)
    one = tb.map_scenario(lambda x: x[None], tscn)
    gc, gv = teng._pruned_candidates(one, _t(cur)[None], _t(mask)[None], 5)
    assert_bitwise(gc[0], wc)
    assert_bitwise(gv[0], wv)


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("top_k", [0, 6], ids=["full", "top6"])
def test_engine_matches_jax_on_scn10(scn10, top_k):
    kw = dict(lam=1.0, max_rounds=12, escape_iters=4, top_k=top_k)
    want = jeng.solve_assignment(scn10, cfg=JCFG, **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), cfg=TCFG, **kw)
    _assert_engine_match(got, want)


def test_engine_descent_escape_and_mask_match_jax(scn10):
    """A cold start far from the optimum: descents, then the Def-1/2
    escape, with two users masked out, on the kernel-nominated path."""
    init = np.zeros(10, np.int32)
    mask = np.ones(10, bool)
    mask[[2, 7]] = False
    kw = dict(lam=1.0, max_rounds=8, escape_iters=2, top_k=6)
    want = jeng.solve_assignment(scn10, jnp.asarray(init), jnp.asarray(mask),
                                 cfg=JCFG, **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), _t(init),
                                _t(mask), cfg=TCFG, **kw)
    _assert_engine_match(got, want)
    kinds = host(got.trace.moves)[:, 3][host(got.trace.rounds_valid)]
    assert (kinds == teng.KIND_DESCENT).sum() >= 3
    assert (kinds == teng.KIND_ESCAPE).sum() >= 1
    assert (host(got.assign)[~mask] == 0).all()      # never moved


def test_engine_zero_rounds_is_the_final_solve_only(scn10):
    want = jeng.solve_assignment(scn10, cfg=JCFG, max_rounds=0)
    got = teng.solve_assignment(scenario_to_torch(scn10), cfg=TCFG,
                                max_rounds=0)
    _assert_engine_match(got, want)
    assert int(got.rounds) == 0 and got.trace.moves.shape == (0, 5)


def test_two_starts_match_jax(scn10):
    kw = dict(lam=1.0, max_rounds=4, escape_iters=1, top_k=6, n_starts=2)
    want = jeng.solve_assignment(scn10, cfg=JCFG, **kw)
    got = teng.solve_assignment(scenario_to_torch(scn10), cfg=TCFG, **kw)
    _assert_engine_match(got, want)


@pytest.fixture(scope="module")
def fleet_pair():
    jf = jb.draw_fleet(0, 3, FSPEC, n_range=(5, 8))
    return jf, fleet_to_torch(jf)


FLEET_KW = dict(lam=1.0, max_rounds=3, escape_iters=1, top_k=4)


@pytest.fixture(scope="module")
def fleet_out(fleet_pair):
    jf, tf = fleet_pair
    return (jeng.solve_fleet_assignments(jf, cfg=JCFG, **FLEET_KW),
            teng.solve_fleet_assignments(tf, cfg=TCFG, **FLEET_KW))


def test_fleet_engine_matches_jax(fleet_out):
    want, got = fleet_out
    assert got.assign.shape == want.assign.shape
    _assert_engine_match(got, want)


def test_fleet_engine_equals_each_cell_alone_bitwise(fleet_pair, fleet_out):
    """D2/D7: a cell's search does not depend on the batch it rides in."""
    _, tf = fleet_pair
    _, got = fleet_out
    for i in range(tf.C):
        alone = teng.solve_fleet_assignments(tf.index([i]), cfg=TCFG,
                                             **FLEET_KW)
        _tree_bitwise(_row(got, i), _row(alone, 0))


def test_bucketed_fleet_search_equals_one_batch(fleet_pair):
    jf, _ = fleet_pair
    jf4 = jb.draw_fleet(1, 4, FSPEC, n_range=(5, 8))
    tf4 = fleet_to_torch(jf4)
    kw = dict(lam=1.0, max_rounds=2, escape_iters=1, top_k=4)
    one = teng.solve_fleet_assignments(tf4, cfg=TCFG, **kw)
    two = teng.solve_fleet_assignments_bucketed(tf4, cfg=TCFG, n_buckets=2,
                                                **kw)
    _tree_bitwise(two, one)


def test_difficulty_proxy_and_flop_model_match_jax(fleet_pair):
    jf, tf = fleet_pair
    np.testing.assert_allclose(host(teng.difficulty_proxy(tf)),
                               host(jeng.difficulty_proxy(jf)), rtol=1e-6)
    for cfg in (jsroa.SroaConfig(), JCFG):
        tcfg = tsroa.SroaConfig(**{f.name: getattr(cfg, f.name)
                                   for f in dataclasses.fields(cfg)})
        assert teng.sroa_solve_flops(56, tcfg) == \
            jeng.sroa_solve_flops(56, cfg)
        for k in (0, 8):
            assert teng.candidate_search_flops(56, 5, 12, tcfg, k) == \
                jeng.candidate_search_flops(56, 5, 12, cfg, k)
