"""Port parity: compression as a planning variable (DESIGN.md D11).

* The ladder (``repro_torch.fed.compression``) validates as the JAX one
  does and prices the same exact float factors.
* The cost model with per-user compression levels (``effective_loads``,
  ``evaluate``, ``sroa_constants``) matches the JAX package to ~1e-6.
* The joint (assignment, compression) search gives the JAX engine's
  integers exactly: assignments, levels and move traces (KIND_COMP rows
  included), on the full neighbourhood and on K3's nominations.
* Inside torch, a single-rung or absent ladder is bitwise the plain path.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, assert_engine_match,  # noqa: E402
                           fleet_to_torch, host, scenario_to_torch,
                           tree_bitwise)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import system_model as jsm  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fed import compression as jc  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import engine as jeng  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import system_model as tsm  # noqa: E402
from repro_torch.fed import compression as tc  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
TIERS = (("lo", 1.6, 1.0, 0.55, 0.35), ("mid",), ("hi", 0.7, 1.2, 1.5, 0.3))
SPEC = dataclasses.replace(jw.ScenarioSpec(), N=10, M=3,
                           tiers=tuple(jw.DeviceTier(*t) for t in TIERS))
JLAD, TLAD = jc.default_ladder(0.05), tc.default_ladder(0.05)


@pytest.fixture(scope="module")
def scn():
    """A tiered 10-user, 3-edge cell (both packages' leaves)."""
    s = jw.draw_scenario(6, SPEC)
    return s, scenario_to_torch(s)


def _comp(seed, shape):
    return np.random.default_rng(seed).integers(0, 3, shape).astype(np.int32)


# ----------------------------------------------------------------- ladder
@pytest.mark.parametrize("frac", [0.05, 0.1, 0.013, 0.5])
def test_default_ladder_factors_are_the_jax_factors(frac):
    want, got = jc.default_ladder(frac), tc.default_ladder(frac)
    assert got.bytes_factors() == want.bytes_factors()
    assert got.epoch_factors() == want.epoch_factors()
    assert [lv.name for lv in got.levels] == [lv.name for lv in want.levels]
    assert repr(got).replace("repro_torch", "repro") == repr(want)


@pytest.mark.parametrize("levels", [
    (),
    (("none", 0.9, 1.0),),
    (("none", 1.0, 1.1),),
    (("none", 1.0, 1.0), ("zero", 0.0, 1.0)),
    (("none", 1.0, 1.0), ("big", 1.5, 1.0)),
    (("none", 1.0, 1.0), ("fast", 0.5, 0.9)),
    (("none", 1.0, 1.0), ("ok", 0.5, 1.2)),
], ids=["empty", "lv0_bytes", "lv0_epoch", "zero_bytes", "big_bytes",
        "fast_epoch", "valid"])
def test_ladder_validation_agrees(levels):
    def build(mod):
        return mod.CompressionLadder(tuple(mod.CompressionLevel(*lv)
                                           for lv in levels))
    try:
        build(jc)
    except ValueError:
        with pytest.raises(ValueError):
            build(tc)
    else:
        assert len(build(tc)) == len(levels)


@pytest.mark.parametrize("kw", [{}, {"int8": True}, {"topk_frac": 0.05},
                                {"topk_frac": 0.0, "int8": True},
                                {"topk_frac": 1.0}])
def test_compressed_bytes_matches_jax_on_tensors_and_arrays(kw):
    shapes = [(7, 3), (129,), (2, 2, 5)]
    want = jc.compressed_bytes([jnp.zeros(s) for s in shapes], **kw)
    assert tc.compressed_bytes([torch.zeros(s) for s in shapes], **kw) == want
    assert tc.compressed_bytes({"a": np.zeros(shapes[0]),
                                "b": [np.zeros(s) for s in shapes[1:]]},
                               **kw) == want
    with pytest.raises(ValueError):
        tc.compressed_bytes(np.zeros(4), topk_frac=1.5)


# -------------------------------------------------------------- cost model
def test_effective_loads_match_jax(scn):
    js, ts = scn
    comp = _comp(0, 10)
    wc, ws = jsm.effective_loads(js, jnp.asarray(comp), JLAD)
    gc, gs = tsm.effective_loads(ts, torch.tensor(comp), TLAD)
    np.testing.assert_allclose(host(gc), host(wc), rtol=1e-6)
    np.testing.assert_allclose(host(gs), host(ws), rtol=1e-6)
    # Level 0 everywhere prices exactly like no ladder at all.
    tree_bitwise(tsm.effective_loads(ts, torch.zeros(10, dtype=torch.int32),
                                     TLAD), tsm.effective_loads(ts))


def test_evaluate_and_constants_with_levels_match_jax(scn):
    js, ts = scn
    rng = np.random.default_rng(1)
    a = rng.integers(0, 3, 10).astype(np.int32)
    comp = _comp(2, 10)
    res = jsroa.solve(js, jnp.asarray(a), 1.0, JCFG, comp=jnp.asarray(comp),
                      ladder=JLAD)
    b, f, p = (np.asarray(x) for x in (res.b, res.f, res.p))
    want = jsm.evaluate(js, jnp.asarray(a), b, f, p, 1.0, None,
                        jnp.asarray(comp), JLAD)
    got = tsm.evaluate(ts, torch.tensor(a), torch.tensor(b), torch.tensor(f),
                       torch.tensor(p), 1.0, None, torch.tensor(comp), TLAD)
    for name in ("T_cmp", "E_cmp", "T_com", "E_com", "R_m", "R"):
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)
    wk = jsm.sroa_constants(js, jnp.asarray(a), None, jnp.asarray(comp),
                            JLAD)
    gk = tsm.sroa_constants(ts, torch.tensor(a), None, torch.tensor(comp),
                            TLAD)
    for name in ("A", "J", "H", "delta", "h"):
        np.testing.assert_allclose(host(getattr(gk, name)),
                                   host(getattr(wk, name)), rtol=1e-6,
                                   err_msg=name)
    got_R = tsroa.solve(ts, torch.tensor(a), 1.0, TCFG,
                        comp=torch.tensor(comp), ladder=TLAD).R
    np.testing.assert_allclose(host(got_R), host(res.R), rtol=1e-5)


def test_fleet_solve_batch_with_levels_matches_jax():
    jf = jb.draw_fleet(1, 3, dataclasses.replace(SPEC, N=8), n_range=(5, 8))
    tf = fleet_to_torch(jf)
    comps = _comp(3, (3, 8))
    want = jb.solve_batch(jf, None, 1.0, JCFG, jnp.asarray(comps), JLAD)
    got = tb.solve_batch(tf, None, 1.0, TCFG, torch.tensor(comps), TLAD)
    np.testing.assert_allclose(host(got.R), host(want.R), rtol=1e-5)


# ------------------------------------------------------------ candidates
def test_comp_candidates_match_jax():
    rng = np.random.default_rng(4)
    cur = rng.integers(0, 3, 6).astype(np.int32)
    comp = _comp(5, 6)
    mask = np.array([True, True, False, True, True, False])
    em = np.array([True, False, True])
    for e in (None, em):
        want = jeng._comp_candidates(jnp.asarray(cur), jnp.asarray(comp), 3,
                                     3, jnp.asarray(mask),
                                     None if e is None else jnp.asarray(e))
        got = teng._comp_candidates(torch.tensor(cur)[None],
                                    torch.tensor(comp)[None], 3, 3,
                                    torch.tensor(mask)[None],
                                    None if e is None
                                    else torch.tensor(e)[None])
        for g, w in zip(got, want):
            assert_bitwise(g[0], w)


def test_pruned_comp_candidates_and_move_H_match_jax(scn):
    """K3 fed the comp-aware upload bits: the same nominations, the same
    1 + 5k joint rows."""
    js, ts = scn
    cur = np.asarray(jw.nearest_edge_assignment(js))
    comp = _comp(6, 10)
    mask = np.ones(10, bool)
    mask[7] = False
    one = tb.map_scenario(lambda x: x[None], ts)
    assert_bitwise(teng._move_H(one, torch.tensor(comp)[None], TLAD)[0],
                   jeng._move_H(js, jnp.asarray(comp), JLAD))
    want = jeng._pruned_candidates_comp(js, jnp.asarray(cur),
                                        jnp.asarray(comp),
                                        jnp.asarray(mask), 4, JLAD)
    got = teng._pruned_candidates_comp(one, torch.tensor(cur)[None],
                                       torch.tensor(comp)[None],
                                       torch.tensor(mask)[None], 4, TLAD)
    for g, w in zip(got, want):
        assert_bitwise(g[0], w)


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("top_k", [0, 4], ids=["full", "top4"])
def test_comp_engine_matches_jax(scn, top_k):
    js, ts = scn
    kw = dict(lam=1.0, max_rounds=6, escape_iters=1, top_k=top_k)
    want = jeng.solve_assignment(js, cfg=JCFG, ladder=JLAD, **kw)
    got = teng.solve_assignment(ts, cfg=TCFG, ladder=TLAD, **kw)
    assert_engine_match(got, want)
    kinds = host(got.trace.moves)[:, 3][host(got.trace.rounds_valid)]
    assert (kinds == teng.KIND_COMP).any()       # a level moved
    assert host(got.comp).max() > 0


def test_comp_engine_from_init_levels_matches_jax(scn):
    """Warm levels, two inactive users and two restarts."""
    js, ts = scn
    comp = _comp(7, 10)
    mask = np.ones(10, bool)
    mask[[1, 6]] = False
    kw = dict(lam=2.0, max_rounds=4, escape_iters=2, top_k=4, n_starts=2)
    want = jeng.solve_assignment(js, None, jnp.asarray(mask), cfg=JCFG,
                                 ladder=JLAD, init_comp=jnp.asarray(comp),
                                 **kw)
    got = teng.solve_assignment(ts, None, torch.tensor(mask), cfg=TCFG,
                                ladder=TLAD, init_comp=torch.tensor(comp),
                                **kw)
    assert_engine_match(got, want)
    np.testing.assert_array_equal(host(got.comp)[~mask], comp[~mask])


def test_fleet_comp_engine_matches_jax():
    jf = jb.draw_fleet(4, 3, dataclasses.replace(SPEC, N=8), n_range=(5, 8))
    tf = fleet_to_torch(jf)
    comps = _comp(8, (3, 8))
    kw = dict(lam=1.0, max_rounds=3, escape_iters=1, top_k=4)
    want = jeng.solve_fleet_assignments(jf, cfg=JCFG, ladder=JLAD,
                                        init_comps=jnp.asarray(comps), **kw)
    got = teng.solve_fleet_assignments(tf, cfg=TCFG, ladder=TLAD,
                                       init_comps=torch.tensor(comps), **kw)
    assert_engine_match(got, want)


def test_single_rung_or_no_ladder_is_bitwise_the_plain_path(scn):
    """Torch against torch: a ladder of one rung (and a ladder-free call
    with init levels) runs the plain search, bit for bit."""
    _, ts = scn
    one = tc.CompressionLadder()
    kw = dict(lam=1.0, max_rounds=4, escape_iters=1, top_k=4)
    plain = teng.solve_assignment(ts, cfg=TCFG, **kw)
    tree_bitwise(teng.solve_assignment(ts, cfg=TCFG, ladder=one, **kw),
                 plain)
    tree_bitwise(teng.solve_assignment(
        ts, cfg=TCFG, init_comp=torch.tensor(_comp(9, 10)), **kw), plain)
    assert int(plain.comp.abs().sum()) == 0
