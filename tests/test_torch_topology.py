"""Port parity: bilevel topology design, DESIGN.md D12.

Mirrors ``tests/test_topology.py`` on the port, and holds it against the
JAX package on the same inputs:

* inside torch an ALL-OPEN edge mask is bitwise the fixed-M path (the
  engine with and without K3 and restarts, the fused solve, the device
  split): the mask only ever enters as a select;
* closed sites are never assigned, never an escape target, never a start;
* the masked neighbourhood, escape, start patterns and searches give the
  JAX engine's integers exactly;
* ``design_topology``'s designed masks, assignments and accepted-move
  history equal the JAX run's on a small fleet.
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
from repro.core import wireless as jw  # noqa: E402
from repro.fed import compression as jc  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import engine as jeng  # noqa: E402
from repro.fleet import planner as jplan  # noqa: E402
from repro.fleet import topology as jtopo  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.fed import compression as tc  # noqa: E402
from repro_torch.fleet import dynamics as tdyn  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402
from repro_torch.fleet import incremental as tinc  # noqa: E402
from repro_torch.fleet import topology as ttopo  # noqa: E402
from repro_torch.fleet.planner import (FleetPlanner,  # noqa: E402
                                       scenario_digest)
from repro_torch.fleet.service import shard as tshard  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
SPEC = dataclasses.replace(jw.ScenarioSpec(), N=8, M=4)
LAM = 1.0
KW = dict(lam=LAM, max_rounds=4, escape_iters=2)


def make_fleet(seed=0, C=3, spec=SPEC):
    jf = jb.draw_fleet(seed, C, spec, n_range=(6, 8))
    return jf, fleet_to_torch(jf)


@pytest.fixture(scope="module")
def fleet0():
    return make_fleet()


def _solve(fleet, **kw):
    return teng.solve_fleet_assignments(fleet, tb.fleet_assignments(fleet),
                                        cfg=TCFG, **KW, **kw)


def _closed(C, M):
    em = np.ones((C, M), bool)
    em[:, 0] = False          # close every cell's site 0 ...
    em[1, 2] = False          # ... and one more in cell 1
    return em


# ------------------------------------------------------- all-open parity
@pytest.mark.parametrize("kw", [{}, {"top_k": 4}, {"n_starts": 3},
                                {"top_k": 4, "n_starts": 3}])
def test_all_open_mask_is_bitwise_fixed_m(fleet0, kw):
    _, tf = fleet0
    want = _solve(tf, **kw)
    got = _solve(ttopo.with_edge_mask(tf, np.ones((tf.C, tf.M), bool)),
                 **kw)
    tree_bitwise(got, want)


def test_all_open_parity_fused_and_device_split(fleet0):
    """The fused solve sees the same B, and the two-device split the same
    masks, under an all-open mask."""
    _, tf = fleet0
    open_ = ttopo.with_edge_mask(tf, np.ones((tf.C, tf.M), bool))
    fcfg = dataclasses.replace(TCFG, fused=True)
    init = tb.fleet_assignments(tf)
    tree_bitwise(tb.solve_batch(open_, init, LAM, fcfg),
                 tb.solve_batch(tf, init, LAM, fcfg))
    kw = dict(lam=LAM, cfg=TCFG, max_rounds=2, escape_iters=1, top_k=4)
    masked = ttopo.with_edge_mask(tf, _closed(tf.C, tf.M))
    tree_bitwise(tshard.solve_fleet_sharded(
        masked, init, devices=tshard.cell_mesh(["cpu", "cpu"]), **kw),
        teng.solve_fleet_assignments(masked, init, **kw))


# ------------------------------------------------ masked pieces vs JAX
def test_masked_neighbourhood_escape_and_nearest_edge_match_jax():
    rng = np.random.default_rng(3)
    C, N, M = 6, 7, 4
    assign = rng.integers(0, M, (C, N)).astype(np.int32)
    movable = rng.uniform(size=(C, N)) < 0.8
    em = rng.uniform(size=(C, M)) < 0.6
    em[:, 1] = True
    R_m = rng.uniform(0, 10, (C, M)).astype(np.float32)
    b = rng.uniform(0, 5, (C, N)).astype(np.float32)
    gc, gv = tb.candidate_assigns_device(torch.tensor(assign), M,
                                         torch.tensor(movable),
                                         torch.tensor(em))
    esc = teng.escape_move(torch.tensor(assign), torch.tensor(R_m),
                           torch.tensor(b), torch.tensor(movable), M,
                           torch.tensor(em))
    for c in range(C):
        wc, wv = jb.candidate_assigns_device(
            jnp.asarray(assign[c]), M, jnp.asarray(movable[c]),
            jnp.asarray(em[c]))
        assert_bitwise(gc[c], wc)
        assert_bitwise(gv[c], wv)
        want = jeng.escape_move(jnp.asarray(assign[c]), jnp.asarray(R_m[c]),
                                jnp.asarray(b[c]), jnp.asarray(movable[c]),
                                M, jnp.asarray(em[c]))
        assert tuple(host(x[c]).item() for x in esc) == tuple(
            host(x).item() for x in want)
    scn = jw.draw_scenario(4, SPEC)._replace(
        edge_mask=jnp.asarray([False, True, False, True]))
    assert_bitwise(tw.nearest_edge_assignment(scenario_to_torch(scn)),
                   jw.nearest_edge_assignment(scn))


@pytest.mark.parametrize("kw", [{}, {"top_k": 4}, {"n_starts": 3}],
                         ids=["full", "top4", "starts3"])
def test_closed_sites_never_assigned_and_match_jax(kw):
    jf, tf = make_fleet(seed=1)
    em = _closed(tf.C, tf.M)
    want = jeng.solve_fleet_assignments(
        jtopo.with_edge_mask(jf, em), cfg=JCFG, **KW, **kw)
    got = _solve(ttopo.with_edge_mask(tf, em), **kw)
    assert_engine_match(got, want)
    on_open = np.take_along_axis(em, host(got.assign).astype(np.int64), 1)
    assert on_open[host(tf.mask)].all()


def test_warm_start_on_closed_edge_is_rehomed(fleet0):
    _, tf = fleet0
    scn = tf.cell(0)
    base = tinc.solve(scn, LAM, TCFG, max_rounds=3, escape_iters=1)
    em = np.ones(scn.M, bool)
    em[base.assign[0]] = False               # close user 0's edge
    scn2 = scn._replace(edge_mask=torch.tensor(em))
    res = tinc.replan(scn2, base.assign, LAM, TCFG, max_rounds=3,
                      escape_iters=1)
    assert em[res.assign].all()


def test_validate_scenario_rejects_bad_masks_and_b_open():
    scn = tw.draw_scenario(0, dataclasses.replace(tw.ScenarioSpec(), N=8,
                                                  M=4), device="cpu")
    for bad in (torch.ones(5, dtype=torch.bool),
                torch.zeros(4, dtype=torch.bool)):
        with pytest.raises(ValueError):
            tw.validate_scenario(scn._replace(edge_mask=bad))
    tw.validate_scenario(scn._replace(edge_mask=torch.ones(4,
                                                           dtype=torch.bool)))
    assert_bitwise(scn._replace(edge_mask=torch.ones(
        4, dtype=torch.bool)).B_open, scn.B_total)
    em = torch.zeros(4, dtype=torch.bool)
    em[1] = True
    assert_bitwise(scn._replace(edge_mask=em).B_open, scn.B_edges[1])


def test_every_knob_at_once_matches_jax():
    """The knobs combine freely: closed sites, three restarts and a warm
    tail, a 3-slot horizon with a switching charge, and the compression
    ladder over device tiers from given levels, in one fleet search."""
    tiers = tuple(jw.DeviceTier(*t) for t in (("lo", 1.6, 1.0, 0.55, 0.35),
                                              ("hi", 0.7, 1.2, 1.5, 0.3)))
    jf, tf = make_fleet(seed=6, C=2, spec=dataclasses.replace(SPEC,
                                                              tiers=tiers))
    em = _closed(2, tf.M)
    jf, tf = jtopo.with_edge_mask(jf, em), ttopo.with_edge_mask(tf, em)
    state = tdyn.init_fleet_state(tf, seed=6)
    stacks = tdyn.predict_fleet_rollout(tf, state, K=3)
    rng = np.random.default_rng(6)
    init = host(tb.fleet_assignments(tf))
    comps = rng.integers(0, 3, init.shape).astype(np.int32)
    tails = rng.integers(0, tf.M, init.shape).astype(np.int32)
    kw = dict(lam=LAM, max_rounds=3, escape_iters=1, top_k=4, n_starts=3,
              switch_cost=50.0)
    want = jeng.solve_fleet_assignments(
        jf, jnp.asarray(init), cfg=JCFG, gain_stacks=jnp.asarray(stacks),
        ladder=jc.default_ladder(), init_comps=jnp.asarray(comps),
        tail_inits=jnp.asarray(tails), **kw)
    got = teng.solve_fleet_assignments(
        tf, init, cfg=TCFG, gain_stacks=stacks, ladder=tc.default_ladder(),
        init_comps=comps, tail_inits=tails, **kw)
    assert_engine_match(got, want)
    on_open = np.take_along_axis(em, host(got.assign).astype(np.int64), 1)
    assert on_open[host(tf.mask)].all()


# ------------------------------------------------------------ planner
def test_planner_cache_distinguishes_masks(fleet0):
    jf, tf = fleet0
    em = np.ones((tf.C, tf.M), bool)
    em2 = em.copy()
    em2[:, -1] = False
    one = ttopo.with_edge_mask(tf, em).cell(0)
    two = ttopo.with_edge_mask(tf, em2).cell(0)
    assert scenario_digest(one, LAM) != scenario_digest(two, LAM)
    assert scenario_digest(one, LAM) == jplan.scenario_digest(
        jtopo.with_edge_mask(jf, em).cell(0), LAM)
    planner = FleetPlanner(lam=LAM, cfg=TCFG, max_rounds=3, escape_iters=1)
    p1 = planner.plan(one)
    assert planner.plan(one).cached
    p2 = planner.plan(two)
    assert not p2.cached
    assert (p2.assign != tf.M - 1).all()
    assert np.isfinite(p1.R) and np.isfinite(p2.R)


# ------------------------------------------------------ design helpers
def test_uniform_mask_and_with_edge_mask_roundtrip(fleet0):
    _, tf = fleet0
    em = ttopo.uniform_mask(3, 4, 2)
    np.testing.assert_array_equal(em, jtopo.uniform_mask(3, 4, 2))
    with pytest.raises(ValueError):
        ttopo.uniform_mask(3, 4, 0)
    masked = ttopo.with_edge_mask(tf, em)
    assert masked.edge_mask.dtype == torch.bool
    assert ttopo.with_edge_mask(masked, None).edge_mask is None
    # The mask rides the fleet's leaf-wise maps.
    assert masked.index([2, 0]).edge_mask.shape == (2, 4)
    assert masked.cell(1).edge_mask.shape == (4,)


def test_proxy_cost_and_remap_match_jax():
    jf, tf = make_fleet(seed=3)
    all_open = np.ones((tf.C, tf.M), bool)
    sub = all_open.copy()
    sub[:, :2] = False
    for em in (all_open, sub, _closed(tf.C, tf.M)):
        np.testing.assert_allclose(ttopo.proxy_cost(tf, em, LAM),
                                   jtopo.proxy_cost(jf, em, LAM),
                                   rtol=1e-12)
    assert (ttopo.proxy_cost(tf, sub, LAM)
            >= ttopo.proxy_cost(tf, all_open, LAM)).all()
    a = np.zeros((tf.C, tf.N_max), np.int32)
    a[:, 0] = 1
    em = _closed(tf.C, tf.M)
    got = ttopo._remap_to_open(a, em, tf)
    np.testing.assert_array_equal(got, jtopo._remap_to_open(a, em, jf))
    assert (got[:, 0] == 1).all()
    assert np.take_along_axis(em, got.astype(np.int64), 1).all()


# ------------------------------------------------------- bilevel design
@pytest.mark.parametrize("fixed_count,edge_cost", [(True, 0.0),
                                                   (False, 400.0)],
                         ids=["relocate", "open_close"])
def test_design_topology_matches_jax(fixed_count, edge_cost):
    """Masks, assignments and the accepted-move history equal the JAX
    design's; greedy accept is monotone and honours fixed_count."""
    spec = dataclasses.replace(jw.ScenarioSpec(), N=8, M=5)
    jf, tf = make_fleet(seed=4, C=2, spec=spec)
    em0 = ttopo.uniform_mask(tf.C, tf.M, 2)
    topo = dict(fixed_count=fixed_count, edge_cost=edge_cost, max_rounds=3)
    kw = dict(max_rounds=4, escape_iters=1, top_k=4)
    want = jtopo.design_topology(jf, LAM, JCFG, jtopo.TopologyConfig(**topo),
                                 edge_mask=em0, **kw)
    got = ttopo.design_topology(tf, LAM, TCFG, ttopo.TopologyConfig(**topo),
                                edge_mask=em0, **kw)
    np.testing.assert_array_equal(got.edge_mask, want.edge_mask)
    np.testing.assert_array_equal(got.assigns, want.assigns)
    np.testing.assert_array_equal(got.comps, want.comps)
    np.testing.assert_array_equal(got.n_open, want.n_open)
    assert got.history == want.history
    assert got.inner_rounds == want.inner_rounds
    np.testing.assert_allclose(got.R, want.R, rtol=1e-5)
    assert len(got.history) >= 1
    if fixed_count:
        np.testing.assert_array_equal(got.n_open, em0.sum(axis=1))
    uni = ttopo.with_edge_mask(tf, em0)
    start = teng.solve_fleet_assignments(uni, tb.fleet_assignments(uni), LAM,
                                         TCFG, **kw)
    start_total = host(start.R) + edge_cost * em0.sum(axis=1)
    assert (got.total <= start_total + 1e-6).all()
    on_open = np.take_along_axis(got.edge_mask,
                                 got.assigns.astype(np.int64), 1)
    assert on_open[host(tf.mask)].all()
    assert_bitwise(got.fleet.edge_mask, torch.tensor(got.edge_mask))
