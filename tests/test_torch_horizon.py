"""Port parity: rolling-horizon (MPC) planning, DESIGN.md D10.

Mirrors ``tests/test_horizon.py`` on the port, and holds it against the
JAX package on the same inputs:

* the mean rollout is numpy in both packages: the predicted stacks are
  bitwise the JAX ones, slot 0 bitwise the live channel;
* the horizon search (every candidate against K slots plus a switching
  charge, the K slots of every candidate in one batched solve) gives the
  JAX engine's integers exactly and its ``R_search`` to rtol 1e-5;
* inside torch, horizon 1 with no switching charge is bitwise the
  snapshot path.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, assert_engine_match,  # noqa: E402
                           fleet_to_torch, host, tree_bitwise)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fed import compression as jc  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import dynamics as jdyn  # noqa: E402
from repro.fleet import engine as jeng  # noqa: E402
from repro.fleet import horizon as jhor  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.fed import compression as tc  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402
from repro_torch.fleet import dynamics as tdyn  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402
from repro_torch.fleet import horizon as thor  # noqa: E402
from repro_torch.fleet import incremental as tinc  # noqa: E402
from repro_torch.fleet.planner import FleetPlanner  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
SPEC = dataclasses.replace(jw.ScenarioSpec(), N=8, M=3)
LAM = 1.0
KW = dict(lam=LAM, max_rounds=4, escape_iters=1)


def make_fleet_state(seed=0, C=3):
    """Both packages' fleets (the mask = the dynamics' activity) and the
    port's dynamics state (numpy, shared by both)."""
    jf = jb.draw_fleet(seed, C, SPEC, n_range=(8, 8))
    state = tdyn.init_fleet_state(fleet_to_torch(jf), seed=seed)
    jf = jf._replace(mask=jnp.asarray(state.active))
    return jf, fleet_to_torch(jf), state


@pytest.fixture(scope="module")
def fs0():
    return make_fleet_state()


# ----------------------------------------------------------------- rollout
@pytest.mark.parametrize("fading_every", [5, 0])
def test_fleet_rollout_is_the_jax_rollout_bitwise(fading_every):
    jf, tf, state = make_fleet_state(seed=7)
    cfg = dict(fading_every=fading_every)
    jstate = jdyn.init_fleet_state(jf, seed=7)
    for name in jdyn.FleetDynamicsState._fields:
        np.testing.assert_array_equal(getattr(state, name),
                                      getattr(jstate, name))
    want = jdyn.predict_fleet_rollout(jf, jstate, K=5,
                                      cfg=jdyn.StreamConfig(**cfg))
    got = tdyn.predict_fleet_rollout(tf, state, K=5,
                                     cfg=tdyn.StreamConfig(**cfg))
    assert_bitwise(got, want)
    assert_bitwise(got[:, 0], host(tf.cells.gain))
    rows = np.array([2, 0])
    assert_bitwise(tdyn.predict_fleet_rollout(tf.index(rows), state, K=5,
                                              cfg=tdyn.StreamConfig(**cfg),
                                              rows=rows), got[rows])


def test_cell_rollout_is_the_jax_rollout_bitwise(fs0):
    jf, tf, state = fs0
    cs = tdyn.DynamicsState(velocity=state.velocity[1],
                            shadow_ue_db=state.shadow_ue_db[1],
                            active=state.active[1], t=state.t)
    got = tdyn.predict_rollout(tf.cell(1), cs, K=3)
    want = jdyn.predict_rollout(jf.cell(1), jdyn.DynamicsState(*cs), K=3)
    assert_bitwise(got, want)
    np.testing.assert_allclose(got, tdyn.predict_fleet_rollout(
        tf, state, K=3)[1], rtol=1e-6)


def test_rollout_decays_motion_and_shadowing():
    _, tf, state = make_fleet_state(seed=5)
    cfg = tdyn.StreamConfig(fading_every=4)
    a = tdyn.predict_fleet_rollout(tf, state, K=6, cfg=cfg)
    np.testing.assert_array_equal(a, tdyn.predict_fleet_rollout(
        tf, state, K=6, cfg=cfg))
    geo = tdyn.predict_fleet_rollout(
        tf, state._replace(shadow_ue_db=state.shadow_ue_db * 0.0), K=6,
        cfg=cfg)
    gap = np.abs(np.log(a.astype(np.float64))
                 - np.log(geo.astype(np.float64))).mean(axis=(0, 2, 3))
    assert gap[0] == 0 and gap[1] > 0
    np.testing.assert_allclose(gap[2:] / gap[1:-1], 0.75, rtol=1e-6)


# ------------------------------------------------- K=1 snapshot parity
def test_horizon_k1_zero_switch_cost_is_bitwise_snapshot(fs0):
    """Torch against torch: a horizon-1 stack with no switching charge
    plans bit for bit as the snapshot path (assign, R, allocation)."""
    _, tf, state = fs0
    init = tb.fleet_assignments(tf)
    want = teng.solve_fleet_assignments(tf, init, cfg=TCFG, **KW)
    got = thor.plan_fleet_horizon(tf, state, K=1, switch_cost=0.0,
                                  init_assigns=init, cfg=TCFG, max_rounds=4,
                                  escape_iters=1)
    tree_bitwise(got, want)
    assert_bitwise(got.R_search, want.R)


def test_horizon_k1_with_switch_cost_matches_jax(fs0):
    """K == 1 skips the slot axis but still bills handovers."""
    jf, tf, state = fs0
    init = np.asarray(jb.fleet_assignments(jf))
    stacks = tdyn.predict_fleet_rollout(tf, state, K=1)
    want = jeng.solve_fleet_assignments(
        jf, jnp.asarray(init), cfg=JCFG, gain_stacks=jnp.asarray(stacks),
        switch_cost=40.0, top_k=4, **KW)
    got = teng.solve_fleet_assignments(
        tf, torch.tensor(init), cfg=TCFG, gain_stacks=stacks,
        switch_cost=40.0, top_k=4, **KW)
    assert_engine_match(got, want)


# ----------------------------------------------------------- JAX parity
@pytest.mark.parametrize("top_k", [0, 4], ids=["full", "top4"])
def test_horizon_search_matches_jax_at_k3(top_k):
    """One cell, K = 3 predicted slots, a switching charge against the
    nearest-edge incumbent: the same moves, the same R_search."""
    jf, tf, state = make_fleet_state(seed=2, C=1)
    cs = tdyn.DynamicsState(velocity=state.velocity[0] * 20.0,
                            shadow_ue_db=state.shadow_ue_db[0],
                            active=state.active[0], t=state.t)
    stack = tdyn.predict_rollout(tf.cell(0), cs, K=3)
    inc = np.asarray(jw.nearest_edge_assignment(jf.cell(0)))
    kw = dict(KW, max_rounds=6, top_k=top_k, switch_cost=25.0)
    want = jeng.solve_assignment(jf.cell(0), cfg=JCFG,
                                 gain_stack=jnp.asarray(stack),
                                 incumbent=jnp.asarray(inc), **kw)
    got = teng.solve_assignment(tf.cell(0), cfg=TCFG, gain_stack=stack,
                                incumbent=inc, **kw)
    assert_engine_match(got, want)
    assert int(got.rounds) >= 2
    assert (host(got.R_search) > host(got.R)).all()


def test_plan_fleet_horizon_with_restarts_and_ladder_matches_jax(fs0):
    """D10 x D9 x D11 over a fleet: K = 3, two restarts, a ladder."""
    jf, tf, state = fs0
    init = np.asarray(jb.fleet_assignments(jf))
    kw = dict(K=3, switch_cost=10.0, incumbents=init, init_assigns=init,
              lam=LAM, max_rounds=3, escape_iters=1, top_k=4, n_starts=2)
    want = jhor.plan_fleet_horizon(jf, jdyn.init_fleet_state(jf, seed=0),
                                   cfg=JCFG, ladder=jc.default_ladder(),
                                   **kw)
    got = thor.plan_fleet_horizon(tf, state, cfg=TCFG,
                                  ladder=tc.default_ladder(), **kw)
    assert_engine_match(got, want)


# ------------------------------------------------------ switching hysteresis
def test_prohibitive_switch_cost_freezes_the_incumbent(fs0):
    _, tf, state = fs0
    init = tb.fleet_assignments(tf)
    out = thor.plan_fleet_horizon(tf, state, K=2, switch_cost=1e12,
                                  incumbents=init, init_assigns=init,
                                  cfg=TCFG, max_rounds=4, escape_iters=1)
    moved = (host(out.assign) != host(init)) & host(tf.mask)
    assert moved.sum() == 0


def test_tail_init_warm_start_never_worse():
    _, tf, state = make_fleet_state(seed=2)
    init = tb.fleet_assignments(tf)
    kw = dict(K=3, switch_cost=5.0, incumbents=init, init_assigns=init,
              cfg=TCFG, max_rounds=3, escape_iters=1, top_k=4)
    cold = thor.plan_fleet_horizon(tf, state, **kw)
    warm = thor.plan_fleet_horizon(tf, state, tail_inits=cold.assign, **kw)
    assert (host(warm.R_search) <= host(cold.R_search) + 1e-6).all()


# ------------------------------------------------------ handover accounting
def test_count_handovers_matches_jax():
    prev = np.array([0, 1, 2, 0, 1])
    cur = np.array([1, 1, 0, 0, 2])
    for active in (np.array([True, True, False, True, True]),
                   np.zeros(5, bool), np.ones(5, bool)):
        assert thor.count_handovers(torch.tensor(prev), cur, active) == \
            jhor.count_handovers(prev, cur, active)
    assert thor.count_handovers(prev, cur,
                                [True, True, False, True, True]) == 2


def test_estimate_switch_cost_matches_jax(fs0):
    jf, tf, _ = fs0
    init = np.asarray(jb.fleet_assignments(jf))
    jalloc = jb.solve_batch(jf, jnp.asarray(init), LAM, JCFG)
    talloc = tb.solve_batch(tf, torch.tensor(init), LAM, TCFG)
    want = jhor.estimate_switch_cost(jf, init, jalloc, lam=LAM)
    got = thor.estimate_switch_cost(tf, init, talloc, lam=LAM)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0 < got < float(host(talloc.R).mean())
    top = np.full(init.shape, 2, np.int32)
    wantc = jhor.estimate_switch_cost(jf, init, jalloc, lam=LAM, comps=top,
                                      ladder=jc.default_ladder())
    gotc = thor.estimate_switch_cost(tf, init, talloc, lam=LAM, comps=top,
                                     ladder=tc.default_ladder())
    np.testing.assert_allclose(gotc, wantc, rtol=1e-5)
    assert 0 < gotc < got
    assert thor.estimate_switch_cost(
        tf, init, talloc, lam=LAM, comps=top * 0,
        ladder=tc.default_ladder()) == got


# ------------------------------------------------------ planner integration
def test_planner_horizon_cache_distinguishes_windows(fs0):
    _, tf, state = fs0
    planner = FleetPlanner(lam=LAM, cfg=TCFG, max_rounds=3, escape_iters=1,
                           horizon=2, switch_cost=5.0)
    inc = host(tb.fleet_assignments(tf))
    cold = planner.plan_fleet_horizon(tf, state, incumbents=inc)
    assert all(not p.cached for p in cold)
    warm = planner.plan_fleet_horizon(tf, state, incumbents=inc)
    assert all(p.cached for p in warm)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c.assign, w.assign)
    state2 = state._replace(velocity=state.velocity * 2.0)
    fresh = planner.plan_fleet_horizon(tf, state2, incumbents=inc)
    assert all(not p.cached for p in fresh)


def test_incremental_replan_forwards_horizon_to_engine(fs0):
    _, tf, state = fs0
    scn = tf.cell(0)
    cs = tdyn.DynamicsState(velocity=state.velocity[0],
                            shadow_ue_db=state.shadow_ue_db[0],
                            active=state.active[0], t=state.t)
    stack = tdyn.predict_rollout(scn, cs, K=3)
    base = tinc.solve(scn, LAM, TCFG, max_rounds=3, escape_iters=1)
    res = tinc.replan(scn, base.assign, LAM, TCFG, max_rounds=3,
                      escape_iters=1, gain_stack=stack, switch_cost=1e12)
    np.testing.assert_array_equal(res.assign, base.assign)
