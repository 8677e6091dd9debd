"""Port parity: the per-cell dynamics, incremental TSIA (engine front end,
host loop, warm-start replan), ``FleetPlanner.plan`` and the
``--no-stream`` / ``--host-loop`` request loop, against the JAX package.

* The per-cell dynamics run on the host with numpy in both packages: a
  seeded stream is BITWISE the JAX one.
* Searches: assignments, move traces and round-trip accounting exact;
  objectives to rtol 1e-5 (trimmed SROA caps on both sides, as
  ``tests/test_torch_engine.py``).
* ``tests/test_fleet.py``'s batched-TSIA and replan contracts re-stated on
  the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_bitwise, fleet_to_torch,  # noqa: E402
                           host, scenario_to_torch)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import dynamics as jdyn  # noqa: E402
from repro.fleet import incremental as jinc  # noqa: E402
from repro.fleet import planner as jplan  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import system_model as tsm  # noqa: E402
from repro_torch.core import tsia as ttsia  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.fleet import dynamics as tdyn  # noqa: E402
from repro_torch.fleet import incremental as tinc  # noqa: E402
from repro_torch.fleet import planner as tplan  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
RTOL = 1e-5
LAM = 1.0
SPEC10 = dataclasses.replace(jw.ScenarioSpec(), N=10, M=3)
SPEC16 = dataclasses.replace(jw.ScenarioSpec(), N=16, M=3)
TSPEC16 = dataclasses.replace(tw.ScenarioSpec(), N=16, M=3)
TIERS = (("lo", 1.5, 1.0, 0.6, 0.3), ("hi", 0.7, 1.2, 1.4, 0.7))


@pytest.fixture(scope="module")
def scn10():
    """``tests/test_engine.py``'s ``scn10``."""
    return jw.draw_scenario(3, SPEC10)


@pytest.fixture(scope="module")
def scn16():
    """``tests/test_fleet.py``'s ``scn16``."""
    return jw.draw_scenario(0, SPEC16)


def _assert_search_match(got, want):
    """Integer outputs and accounting exact, objectives to rtol 1e-5."""
    np.testing.assert_array_equal(got.assign, want.assign)
    h, w = got.history, want.history
    assert h.moves == w.moves
    assert (h.rounds, h.solve_calls, h.candidates_evaluated) == \
        (w.rounds, w.solve_calls, w.candidates_evaluated)
    np.testing.assert_allclose(h.R_trace, w.R_trace, rtol=RTOL)
    np.testing.assert_allclose(got.R, want.R, rtol=RTOL)
    for name in ("b", "f", "p", "t"):
        np.testing.assert_allclose(getattr(got.sroa, name),
                                   np.asarray(getattr(want.sroa, name)),
                                   rtol=RTOL, err_msg=name)
    assert got.comp is None


# ---------------------------------------------------------------- dynamics
def _tiers(pkg):
    return tuple(pkg.DeviceTier(*t) for t in TIERS)


@pytest.mark.parametrize("tiered", [False, True], ids=["plain", "tiered"])
def test_stream_is_bitwise_the_jax_stream(tiered):
    """10 steps of mobility + fading + churn: every leaf, the latent state
    and the churn events equal, bit for bit."""
    jspec = dataclasses.replace(SPEC16, tiers=_tiers(jw) if tiered else ())
    tspec = dataclasses.replace(TSPEC16, tiers=_tiers(tw) if tiered else ())
    scn = jw.draw_scenario(5, jspec)
    tscn = scenario_to_torch(scn)
    np.testing.assert_array_equal(tdyn.recover_shadowing(tscn),
                                  jdyn.recover_shadowing(scn))
    kw = dict(arrival_rate=1.0, departure_rate=0.2)
    jstream = jdyn.stream(scn, seed=2, steps=10, spec=jspec,
                          cfg=jdyn.StreamConfig(**kw))
    tstream = tdyn.stream(tscn, seed=2, steps=10, spec=tspec,
                          cfg=tdyn.StreamConfig(**kw))
    n_arr = n_dep = 0
    for (js, jst, jev), (ts, tst, tev) in zip(jstream, tstream):
        for name in tw.Scenario._fields:
            if name != "edge_mask":
                assert_bitwise(getattr(ts, name), getattr(js, name), name)
        for name in ("velocity", "shadow_ue_db", "active"):
            assert_bitwise(getattr(tst, name), getattr(jst, name), name)
        assert tst.t == jst.t
        assert_bitwise(tev.arrived, jev.arrived, "arrived")
        assert_bitwise(tev.departed, jev.departed, "departed")
        assert tev.dropped == jev.dropped
        n_arr += len(tev.arrived)
        n_dep += len(tev.departed)
    assert n_arr > 0 and n_dep > 0     # the churn path was exercised


def test_single_steps_are_bitwise_the_jax_steps(scn16):
    """init_state, then each step alone with its own knobs."""
    tscn = scenario_to_torch(scn16)
    js, ts = scn16, tscn
    jst = jdyn.init_state(js, seed=4, mean_speed=3.0)
    tst = tdyn.init_state(ts, seed=4, mean_speed=3.0)
    for name in ("velocity", "shadow_ue_db", "active"):
        assert_bitwise(getattr(tst, name), getattr(jst, name), name)
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    js, jst = jdyn.mobility_step(js, jst, jr, dt=40.0, side_m=200.0)
    ts, tst = tdyn.mobility_step(ts, tst, tr, dt=40.0, side_m=200.0)
    js, jst = jdyn.fading_step(js, jst, jr, std_db=4.0)
    ts, tst = tdyn.fading_step(ts, tst, tr, std_db=4.0)
    js, jst, jev = jdyn.churn_step(js, jst, jr, SPEC16, arrival_rate=3.0,
                                   departure_rate=0.3)
    ts, tst, tev = tdyn.churn_step(ts, tst, tr, TSPEC16, arrival_rate=3.0,
                                   departure_rate=0.3)
    for name in ("user_pos", "gain", "c", "D"):
        assert_bitwise(getattr(ts, name), getattr(js, name), name)
    assert ts.gain.device == tscn.device
    for name in ("velocity", "shadow_ue_db", "active"):
        assert_bitwise(getattr(tst, name), getattr(jst, name), name)
    assert_bitwise(tev.arrived, jev.arrived)
    assert_bitwise(tev.departed, jev.departed)


# ------------------------------------------------------- incremental search
@pytest.mark.parametrize("top_k", [0, 8])
def test_solve_matches_jax(scn10, top_k):
    """The engine front end (one search, K3-pruned with top_k)."""
    kw = dict(max_rounds=10, escape_iters=2, top_k=top_k)
    want = jinc.solve(scn10, LAM, JCFG, **kw)
    got = tinc.solve(scenario_to_torch(scn10), LAM, TCFG, **kw)
    _assert_search_match(got, want)
    assert got.history.solve_calls == 1


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_solve_host_matches_jax(scn10, masked):
    """The host loop: one batched solve per round."""
    mask = None
    if masked:
        mask = np.ones(10, bool)
        mask[[2, 7]] = False
    kw = dict(max_rounds=10, escape_iters=2, mask=mask)
    want = jinc.solve_host(scn10, LAM, JCFG, **kw)
    got = tinc.solve_host(scenario_to_torch(scn10), LAM, TCFG, **kw)
    _assert_search_match(got, want)
    assert got.history.solve_calls == got.history.rounds
    if masked:      # a masked user never moves
        np.testing.assert_array_equal(
            got.assign[[2, 7]],
            host(tw.nearest_edge_assignment(scenario_to_torch(scn10)))[[2, 7]])


def test_solve_host_zero_rounds_scores_the_init(scn10):
    want = jinc.solve_host(scn10, LAM, JCFG, max_rounds=0)
    got = tinc.solve_host(scenario_to_torch(scn10), LAM, TCFG, max_rounds=0)
    _assert_search_match(got, want)
    assert got.history.solve_calls == 1


@pytest.mark.parametrize("use_engine", [True, False],
                         ids=["engine", "host"])
def test_replan_after_churn_matches_jax(scn16, use_engine):
    """``tests/test_fleet.py``'s replan recipe on both packages: a warm
    start from a short search, one churn step, then the polish."""
    tscn = scenario_to_torch(scn16)
    base = jinc.solve(scn16, LAM, JCFG, max_rounds=8, escape_iters=1)
    tbase = tinc.solve(tscn, LAM, TCFG, max_rounds=8, escape_iters=1)
    np.testing.assert_array_equal(tbase.assign, base.assign)
    js, jst, jev = jdyn.churn_step(scn16, jdyn.init_state(scn16, seed=0),
                                   np.random.default_rng(3), SPEC16,
                                   arrival_rate=3.0, departure_rate=0.3)
    ts, tst, tev = tdyn.churn_step(tscn, tdyn.init_state(tscn, seed=0),
                                   np.random.default_rng(3), TSPEC16,
                                   arrival_rate=3.0, departure_rate=0.3)
    assert len(tev.arrived) > 0 and not tst.active.all()
    kw = dict(max_rounds=6, use_engine=use_engine)
    want = jinc.replan(js, base.assign, LAM, JCFG, new_users=jev.arrived,
                       mask=jst.active, **kw)
    got = tinc.replan(ts, tbase.assign, LAM, TCFG, new_users=tev.arrived,
                      mask=tst.active, **kw)
    _assert_search_match(got, want)
    # test_replan_warm_start_after_churn's contract.
    a = got.assign
    assert a.shape == (16,)
    assert a.min() >= 0 and a.max() < ts.M
    assert np.isfinite(got.R)


def test_batched_tsia_dominates_seed_tsia(scn16):
    """``tests/test_fleet.py``'s contract on the port: objective <= the
    seed TSIA's with far fewer batched calls per candidate pattern."""
    tscn = scenario_to_torch(scn16)
    seed_res = ttsia.solve(tscn, lam=LAM, cfg=TCFG)
    ours = tinc.solve(tscn, lam=LAM, cfg=TCFG)
    assert ours.R <= seed_res.R * (1 + 1e-6), (ours.R, seed_res.R)
    h = ours.history
    assert h.solve_calls < h.candidates_evaluated
    assert h.round_trips_per_candidate < 1.0 / tscn.M
    cb = tsm.evaluate(tscn, torch.as_tensor(ours.assign),
                      torch.as_tensor(ours.sroa.b),
                      torch.as_tensor(ours.sroa.f),
                      torch.as_tensor(ours.sroa.p), LAM)
    np.testing.assert_allclose(float(cb.R), ours.R, rtol=1e-5)


# ----------------------------------------------------------------- planner
def test_planner_cache_hit_and_eviction(scn16):
    """``tests/test_fleet.py``'s cache contract on the port."""
    tscn = scenario_to_torch(scn16)
    pl = tplan.FleetPlanner(lam=LAM, cfg=TCFG, cache_size=2, max_rounds=3,
                            escape_iters=1)
    p1 = pl.plan(tscn)
    p2 = pl.plan(tscn)
    assert not p1.cached and p2.cached
    assert p1.R == p2.R
    np.testing.assert_array_equal(p1.assign, p2.assign)
    assert pl.stats["hits"] == 1 and pl.stats["misses"] == 1
    # mask=all-True is the unmasked problem: a hit.
    assert pl.plan(tscn, mask=np.ones(16, bool)).cached
    # A different scenario is a miss; overflowing the LRU evicts the least
    # recently used entry.
    other = scenario_to_torch(jw.draw_scenario(7, SPEC16))
    pl.plan(other)
    pl.allocate(tscn, p1.assign)
    assert pl.stats["size"] <= 2
    assert pl.plan(other).cached
    assert not pl.plan(tscn).cached


@pytest.mark.parametrize("use_engine", [True, False],
                         ids=["engine", "host"])
def test_planner_plan_matches_jax(scn10, use_engine):
    kw = dict(lam=LAM, max_rounds=4, escape_iters=1, use_engine=use_engine)
    jp = jplan.FleetPlanner(cfg=JCFG, **kw)
    tp = tplan.FleetPlanner(cfg=TCFG, **kw)
    want, got = jp.plan(scn10), tp.plan(scenario_to_torch(scn10))
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_allclose(got.R, want.R, rtol=RTOL)
    np.testing.assert_allclose(got.t, want.t, rtol=RTOL)
    assert got.solve_calls == want.solve_calls
    assert not got.cached and got.comp is None


def test_plan_fleet_warm_starts_match_jax():
    """``warm`` entries may be PlanResults, raw arrays or None, as in
    ``tests/test_fleet.py``; warm replans match the JAX package's."""
    jf = jb.draw_fleet(5, 3, SPEC16, n_range=(16, 16))
    tf = fleet_to_torch(jf)
    kw = dict(lam=LAM, max_rounds=3, escape_iters=1)
    jp = jplan.FleetPlanner(cfg=JCFG, **kw)
    tp = tplan.FleetPlanner(cfg=TCFG, **kw)
    jcold, tcold = jp.plan_fleet(jf), tp.plan_fleet(tf)
    rng = np.random.default_rng(1)
    moved = [rng.permutation(np.asarray(c.assign)) for c in jcold[:2]]
    jwarm = [moved[0], jplan.PlanResult(*jcold[1])._replace(
        assign=moved[1]), None]
    twarm = [moved[0], tcold[1]._replace(assign=moved[1]), None]
    want = jp.plan_fleet(jf, warm=jwarm)
    got = tp.plan_fleet(tf, warm=twarm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.assign, w.assign)
        np.testing.assert_allclose(g.R, w.R, rtol=RTOL)
        assert g.cached == w.cached
        assert np.isfinite(g.R)
        assert g.assign.min() >= 0 and g.assign.max() < tf.M
    assert got[2].cached                # the cold plan's cache entry


# ------------------------------------------------- the --no-stream CLI loop
@pytest.mark.parametrize("route", [["--no-stream"], ["--host-loop"]],
                         ids=["no-stream", "host-loop"])
def test_serve_request_loop_matches_jax(route):
    """2 cells of up to 6 users on 2 edges, one round of requests (the
    CLI's own SROA caps), on both packages."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    argv = ["--mode", "plan", "--cells", "2", "--cell-users", "6",
            "--cell-edges", "2", "--rounds", "1", "--plan-rounds", "1",
            "--seed", "0"] + route
    want = jserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"])
    np.testing.assert_allclose(got["sum_R"], want["sum_R"], rtol=RTOL)
    assert got["stats"] == want["stats"]
    (rnd,) = got["rounds"]
    assert rnd["hits"] == 2 - len(rnd["changed"])
    for r in rnd["responses"]:
        assert min(r["assign"]) >= 0 and max(r["assign"]) < 2
        assert np.isfinite(r["objective"])
