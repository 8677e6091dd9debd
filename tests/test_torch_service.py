"""Port parity: fleet dynamics, the planner, the shard split and the
streaming planning service, against the JAX package.

* ``fleet_step`` runs on the host with numpy in both packages: a seeded
  trace is BITWISE the JAX one, and cells outside ``cell_mask`` keep every
  leaf bit-identical (D8).
* The service over 2 ticks: replanned sets and assignments exact, sum R to
  rtol 1e-5 (a ``draw_fleet(C=3, N=8, M=2)`` fleet and the JAX service
  tests' trimmed SROA caps).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_bitwise, fleet_to_torch,  # noqa: E402
                           host)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fed import compression as jcomp  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro.fleet import dynamics as jdyn  # noqa: E402
from repro.fleet import planner as jplan  # noqa: E402
from repro.fleet import service as jsvc  # noqa: E402
from repro.fleet.service import drift as jdrift  # noqa: E402
from repro.fleet.service import telemetry as jtel  # noqa: E402
from repro.fleet import topology as jtopo  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.fed import compression as tcomp  # noqa: E402
from repro_torch.fleet import dynamics as tdyn  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402
from repro_torch.fleet import planner as tplan  # noqa: E402
from repro_torch.fleet import service as tsvc  # noqa: E402
from repro_torch.fleet.service import drift as tdrift  # noqa: E402
from repro_torch.fleet.service import telemetry as ttel  # noqa: E402
from repro_torch.fleet import topology as ttopo  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
JSPEC = dataclasses.replace(jw.ScenarioSpec(), N=8, M=2)
TSPEC = dataclasses.replace(tw.ScenarioSpec(), N=8, M=2)
TIERS = (("lo", 1.5, 1.0, 0.6, 0.3), ("hi", 0.7, 1.2, 1.4, 0.7))


def _fleets(seed=0, C=3, n_range=(5, 8)):
    jf = jb.draw_fleet(seed, C, JSPEC, n_range=n_range)
    return jf, fleet_to_torch(jf)


def _assert_fleet_bitwise(got, want):
    for name in tw.Scenario._fields:
        if name != "edge_mask":
            assert_bitwise(getattr(got.cells, name),
                           getattr(want.cells, name), name)
    assert_bitwise(got.mask, want.mask, "mask")
    assert_bitwise(got.n_users, want.n_users, "n_users")


# ----------------------------------------------------------------- dynamics
@pytest.mark.parametrize("tiered", [False, True], ids=["homog", "tiered"])
def test_fleet_step_trace_is_bitwise_the_jax_trace(tiered):
    """Three ticks of mobility, fading and heavy churn, with a random
    cell mask each tick: every leaf, state array and event is bitwise."""
    jspec = dataclasses.replace(
        JSPEC, tiers=tuple(jw.DeviceTier(*t) for t in TIERS) if tiered
        else ())
    tspec = dataclasses.replace(
        TSPEC, tiers=tuple(tw.DeviceTier(*t) for t in TIERS) if tiered
        else ())
    jf, tf = _fleets(seed=2, C=4)
    scfg = dict(arrival_rate=2.0, departure_rate=0.3, fading_every=2)
    js = jdyn.init_fleet_state(jf, seed=3)
    ts = tdyn.init_fleet_state(tf, seed=3)
    for name in jdyn.FleetDynamicsState._fields:
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for tick in range(3):
        cm = np.random.default_rng(tick).uniform(size=4) < 0.6
        jf, js, jev = jdyn.fleet_step(jf, js, jrng,
                                      jdyn.StreamConfig(**scfg), jspec, cm)
        tf, ts, tev = tdyn.fleet_step(tf, ts, trng,
                                      tdyn.StreamConfig(**scfg), tspec, cm)
        _assert_fleet_bitwise(tf, jf)
        for name in jdyn.FleetDynamicsState._fields:
            np.testing.assert_array_equal(getattr(ts, name),
                                          getattr(js, name), err_msg=name)
        for name in jdyn.FleetEvents._fields:
            np.testing.assert_array_equal(getattr(tev, name),
                                          getattr(jev, name), err_msg=name)
    assert tf.cells.gain.device.type == "cpu"


def test_fleet_step_keeps_unmasked_cells_bit_identical():
    """D8: cells outside ``cell_mask`` keep every leaf exactly."""
    _, tf = _fleets(seed=0, C=4, n_range=(8, 8))
    state = tdyn.init_fleet_state(tf, seed=0)
    cm = np.array([True, False, True, False])
    scfg = tdyn.StreamConfig(arrival_rate=0.0, departure_rate=0.0)
    tf2, _, ev = tdyn.fleet_step(tf, state, np.random.default_rng(1), scfg,
                                 TSPEC, cm)
    np.testing.assert_array_equal(ev.changed, cm)
    for name in tw.Scenario._fields:
        if name == "edge_mask":
            continue
        a, b = host(getattr(tf.cells, name)), host(getattr(tf2.cells, name))
        assert_bitwise(a[~cm], b[~cm], name)
    for name in ("user_pos", "gain"):
        a, b = host(getattr(tf.cells, name)), host(getattr(tf2.cells, name))
        assert not np.array_equal(a[cm], b[cm]), name


def test_drift_queue_and_telemetry_copies_behave_alike():
    rng = np.random.default_rng(0)
    g_ref = rng.uniform(0.5, 1.5, (3, 4, 2))
    g_now = g_ref * rng.uniform(0.8, 1.3, g_ref.shape)
    active = rng.uniform(size=(3, 4)) < 0.8
    R_ref, R_now = np.array([100.0, 50.0, 10.0]), np.array([99., 52., 11.])
    for cfg_kw in ({}, dict(channel_threshold=0.1), dict(use_channel=False)):
        want = jdrift.score(g_now, g_ref, active, R_now, R_ref,
                            jdrift.DriftConfig(**cfg_kw))
        got = tdrift.score(g_now, g_ref, active, R_now, R_ref,
                           tdrift.DriftConfig(**cfg_kw))
        for name in jdrift.DriftReport._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
    snaps = []
    for mod in (jtel, ttel):
        t = mod.Telemetry()
        scores = np.array([-0.5, 0.0, 0.003, 0.07, 2.0])
        t.record_tick(n_cells=5, n_changed=2, n_replanned=1, engine_calls=1,
                      alloc_calls=2, sum_R=10.0, tick_ms=3.0,
                      drift_scores=scores, objective_scores=scores,
                      coalesced=2, handovers=1,
                      tier_replans=np.array([0, 1, 1]))
        t.record_request(4.0)
        snap = t.snapshot()
        snap.pop("elapsed_s")
        for key in ("plans_per_s", "requests_per_s"):
            snap.pop(key)
        snaps.append(json.loads(json.dumps(snap)))
    assert snaps[0] == snaps[1]
    groups = []
    for mod in (jsvc, tsvc):
        q = mod.CoalescingQueue()
        reqs = [q.submit(key=k) for k in (0, 0, 1)]
        drained = q.drain()
        for reqs_k in drained.values():
            for r in reqs_k:
                r.resolve({"n": len(reqs_k)})
        groups.append(({k: len(v) for k, v in drained.items()},
                       [r.result(timeout=5) for r in reqs]))
    assert groups[0] == groups[1]


# ------------------------------------------------------------------ planner
def test_scenario_digest_is_the_jax_digest():
    jf, tf = _fleets()
    for i in range(jf.C):
        assert tplan.scenario_digest(tf.cell(i), 1.0) == \
            jplan.scenario_digest(jf.cell(i), 1.0)
    mask = np.array([True, False] * 4)
    assert tplan.scenario_digest(tf.cell(0), 0.5, mask, b"x") == \
        jplan.scenario_digest(jf.cell(0), 0.5, mask, b"x")
    # dtype is part of the identity (``planner.py:29``).
    z32 = tw.Scenario(*(None if x is None else torch.zeros(2, dtype=d)
                        for x, d in zip(tf.cell(0), [torch.float32] * 17
                                        + [torch.int32] + [torch.float32] * 3
                                        )))
    zf = z32._replace(tier=torch.zeros(2, dtype=torch.float32))
    assert tplan.scenario_digest(z32, 1.0) != tplan.scenario_digest(zf, 1.0)


@pytest.fixture(scope="module")
def planned():
    jf, tf = _fleets()
    jp = jplan.FleetPlanner(lam=1.0, cfg=JCFG, max_rounds=3, escape_iters=1,
                            top_k=4)
    tp = tplan.FleetPlanner(lam=1.0, cfg=TCFG, max_rounds=3, escape_iters=1,
                            top_k=4)
    return jf, tf, jp, tp, jp.plan_fleet(jf), tp.plan_fleet(tf)


def test_plan_fleet_matches_jax(planned):
    _, _, _, tp, want, got = planned
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.assign, w.assign)
        np.testing.assert_allclose(g.R, w.R, rtol=1e-5)
        np.testing.assert_allclose(g.t, w.t, rtol=1e-5)
        assert not g.cached
    assert [p.solve_calls for p in got] == [p.solve_calls for p in want]


def test_plan_fleet_second_call_is_all_cache_hits(planned):
    _, tf, _, tp, _, got = planned
    again = tp.plan_fleet(tf)
    assert all(p.cached and p.plan_ms == 0.0 for p in again)
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.assign, b.assign)
    assert tp.stats["hits"] >= tf.C


def test_allocate_matches_jax_and_caches(planned):
    jf, tf, jp, tp, _, _ = planned
    a = np.asarray(jw.nearest_edge_assignment(jf.cell(1)))
    want = jp.allocate(jf.cell(1), a)
    got = tp.allocate(tf.cell(1), a)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-5)
    np.testing.assert_allclose(got.b, want.b, rtol=1e-3, atol=1.0)
    assert tp.allocate(tf.cell(1), a).cached


def test_planner_ladder_plans_match_jax():
    """A planner with a compression ladder (D11): cold fleet plans carry
    the JAX plans' levels; a warm re-plan from a PlanResult seeds the
    search with its levels; ``allocate`` re-prices under given levels;
    ladder plans never share a cache key with ladder-off plans."""
    jf, tf = _fleets(seed=3)
    kw = dict(lam=1.0, max_rounds=3, escape_iters=1, top_k=4)
    jp = jplan.FleetPlanner(cfg=JCFG, ladder=jcomp.default_ladder(), **kw)
    tp = tplan.FleetPlanner(cfg=TCFG, ladder=tcomp.default_ladder(), **kw)
    want, got = jp.plan_fleet(jf), tp.plan_fleet(tf)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.assign, w.assign)
        np.testing.assert_array_equal(g.comp, w.comp)
        np.testing.assert_allclose(g.R, w.R, rtol=1e-5)
    warm_w = jp.plan_fleet(jf, warm=[want[0], None, None])
    warm_g = tp.plan_fleet(tf, warm=[got[0], None, None])
    assert [p.cached for p in warm_g] == [p.cached for p in warm_w]
    for w, g in zip(warm_w, warm_g):
        np.testing.assert_array_equal(g.comp, w.comp)
    comp = np.full(int(tf.n_users[1]), 2, np.int32)
    a = np.asarray(jw.nearest_edge_assignment(jf.cell(1)))
    wa = jp.allocate(jf.cell(1), a, comp)
    ga = tp.allocate(tf.cell(1), a, comp)
    np.testing.assert_allclose(ga.R, wa.R, rtol=1e-5)
    np.testing.assert_array_equal(ga.comp, comp)
    plain = tplan.FleetPlanner(cfg=TCFG, **kw)
    assert not plain.plan_fleet(tf)[0].cached


def test_planner_horizon_plan_matches_jax():
    """``plan`` with a predicted stack: the warm assignment is the
    incumbent, and the window joins the cache key."""
    jf, tf = _fleets(seed=5)
    kw = dict(lam=1.0, max_rounds=3, escape_iters=1, top_k=4, horizon=3,
              switch_cost=30.0)
    jp = jplan.FleetPlanner(cfg=JCFG, **kw)
    tp = tplan.FleetPlanner(cfg=TCFG, **kw)
    state = tdyn.init_fleet_state(tf, seed=2)
    stacks = tdyn.predict_fleet_rollout(tf, state, K=3)
    n = int(tf.n_users[0])
    warm = np.zeros(n, np.int32)
    want = jp.plan(jf.cell(0), warm_assign=warm,
                   gain_stack=stacks[0, :, :n])
    got = tp.plan(tf.cell(0), warm_assign=warm, gain_stack=stacks[0, :, :n])
    np.testing.assert_array_equal(got.assign, want.assign)
    np.testing.assert_allclose(got.R, want.R, rtol=1e-5)
    assert tp.plan(tf.cell(0), warm_assign=warm,
                   gain_stack=stacks[0, :, :n]).cached
    assert not tp.plan(tf.cell(0), warm_assign=warm,
                       gain_stack=stacks[0, :, :n] * 2).cached


# -------------------------------------------------------------------- shard
def test_shard_split_over_devices_equals_one_device():
    """One device is the plain engine call; a split over two devices (both
    the CPU here) gives the same bits in the caller's cell order."""
    _, tf = _fleets(seed=4, C=3, n_range=(8, 8))
    kw = dict(lam=1.0, cfg=TCFG, max_rounds=2, escape_iters=1, top_k=4)
    want = teng.solve_fleet_assignments(tf, **kw)
    assert tsvc.cell_mesh(None) is None
    assert tsvc.cell_mesh(["cpu"]) is None
    one = tsvc.solve_fleet_sharded(tf, devices=None, **kw)
    two = tsvc.solve_fleet_sharded(tf, devices=tsvc.cell_mesh(
        ["cpu", "cpu"]), **kw)
    for got in (one, two):
        for g, w in zip(_leaves(got), _leaves(want)):
            assert_bitwise(g, w)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [y for x in tree for y in _leaves(x)]
    return [tree]


# ------------------------------------------------------------------ service
SVC_KW = dict(max_rounds=4, escape_iters=1, top_k=4, event_rate=0.7)


@pytest.fixture(scope="module")
def services():
    """The JAX and the port service on one fleet, driven 2 ticks."""
    jf, tf = _fleets(seed=0, C=3)
    scfg = dict(arrival_rate=0.5, departure_rate=0.05)
    js = jsvc.PlanningService(
        jf, lam=1.0, sroa_cfg=JCFG, spec=JSPEC, seed=1,
        cfg=jsvc.ServiceConfig(stream=jdyn.StreamConfig(**scfg), **SVC_KW))
    ts = tsvc.PlanningService(
        tf, lam=1.0, sroa_cfg=TCFG, spec=TSPEC, seed=1, device="cpu",
        cfg=tsvc.ServiceConfig(stream=tdyn.StreamConfig(**scfg), **SVC_KW))
    boot = (js.assigns.copy(), ts.assigns.copy(), js.R_ref.copy(),
            ts.R_ref.copy())
    recs = []
    snaps = []
    for svc in (js, ts):
        rs = []
        snaps.append(jsvc.run_load(svc, ticks=2, req_per_tick=2.0, seed=7,
                                   on_tick=rs.append)
                     if svc is js else
                     tsvc.run_load(svc, ticks=2, req_per_tick=2.0, seed=7,
                                   on_tick=rs.append))
        recs.append(rs)
    return js, ts, boot, recs, snaps


def test_service_bootstrap_matches_jax(services):
    _, _, (ja, ta, jR, tR), _, _ = services
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tR, jR, rtol=1e-5)


def test_service_ticks_match_jax(services):
    """Replanned sets and assignments exact, sum R to rtol 1e-5."""
    js, ts, _, (jrecs, trecs), _ = services
    assert len(trecs) == 2
    for j, t in zip(jrecs, trecs):
        np.testing.assert_array_equal(t.replanned, j.replanned)
        assert (t.changed, t.served, t.engine_calls, t.handovers) == \
            (j.changed, j.served, j.engine_calls, j.handovers)
        np.testing.assert_allclose(t.sum_R, j.sum_R, rtol=1e-5)
    assert any(r.replanned.size for r in trecs)      # the search ran
    np.testing.assert_array_equal(ts.assigns, js.assigns)
    np.testing.assert_array_equal(ts.state.active, js.state.active)
    _assert_fleet_bitwise(ts.fleet, js.fleet)


def test_service_load_resolves_every_request(services):
    _, ts, _, _, (jsnap, tsnap) = services
    assert tsnap["unserved"] == 0 == jsnap["unserved"]
    assert tsnap["ticks"] == 2
    assert tsnap["requests_served"] == jsnap["requests_served"]
    assert sum(tsnap["drift_hist"].values()) == 2 * ts.fleet.C
    assert tsnap["drift_hist"] == jsnap["drift_hist"]
    json.loads(ts.telemetry.emit())


def _mode_cfg(mode: str, comp, topo) -> dict:
    """The ServiceConfig knobs of each README planning example, with one
    package's compression and topology modules."""
    if mode == "restarts":
        return dict(n_starts=4)
    if mode == "horizon":
        return dict(horizon=3, switch_cost=100.0)
    if mode == "compression":
        return dict(ladder=comp.default_ladder(0.05))
    return dict(topology_period=1,
                topology=topo.TopologyConfig(edge_cost=2000.0, max_rounds=2))


@pytest.mark.parametrize("mode", ["restarts", "horizon", "compression",
                                  "topology"])
def test_service_extended_modes_match_jax(mode):
    """The four planning extensions on the streaming service, 2 ticks on
    both packages: bootstrap and replanned sets, assignments, levels,
    handovers, topology moves and masks exact, sum R to rtol 1e-5."""
    spec_kw = dict(N=8, M=4 if mode == "topology" else 2)
    tiers = tuple(TIERS) if mode == "compression" else ()
    jspec = dataclasses.replace(JSPEC, tiers=tuple(jw.DeviceTier(*t)
                                                   for t in tiers), **spec_kw)
    tspec = dataclasses.replace(TSPEC, tiers=tuple(tw.DeviceTier(*t)
                                                   for t in tiers), **spec_kw)
    jf = jb.draw_fleet(1, 3, jspec, n_range=(5, 8))
    if mode == "topology":
        jf = jtopo.with_edge_mask(jf, jtopo.uniform_mask(3, 4, 2))
    tf = fleet_to_torch(jf)
    scfg = dict(arrival_rate=0.5, departure_rate=0.05)
    # One device each: the JAX service's mesh would span every host
    # device the suite forces (queue 3 of ROADMAP.md), which these
    # comparisons do not need.
    kw = dict(SVC_KW, event_rate=0.9, max_rounds=3, shard=False)
    js = jsvc.PlanningService(
        jf, lam=1.0, sroa_cfg=JCFG, spec=jspec, seed=1,
        cfg=jsvc.ServiceConfig(stream=jdyn.StreamConfig(**scfg), **kw,
                               **_mode_cfg(mode, jcomp, jtopo)))
    ts = tsvc.PlanningService(
        tf, lam=1.0, sroa_cfg=TCFG, spec=tspec, seed=1, device="cpu",
        cfg=tsvc.ServiceConfig(stream=tdyn.StreamConfig(**scfg), **kw,
                               **_mode_cfg(mode, tcomp, ttopo)))
    np.testing.assert_array_equal(ts.assigns, js.assigns)
    np.testing.assert_array_equal(ts.comps, js.comps)
    moves = 0
    for _ in range(2):
        j, t = js.tick(), ts.tick()
        moves += t.topo_moves
        np.testing.assert_array_equal(t.replanned, j.replanned)
        assert (t.changed, t.handovers, t.topo_moves) == \
            (j.changed, j.handovers, j.topo_moves)
        np.testing.assert_allclose(t.sum_R, j.sum_R, rtol=1e-5)
        np.testing.assert_array_equal(ts.assigns, js.assigns)
        np.testing.assert_array_equal(ts.comps, js.comps)
    assert any(r.size for r in (t.replanned, j.replanned))
    if mode == "compression":
        assert ts.comps.max() > 0
        assert ts.telemetry.snapshot()["compression_hist"] == \
            js.telemetry.snapshot()["compression_hist"]
    if mode == "topology":
        assert moves > 0
        np.testing.assert_array_equal(host(ts.fleet.edge_mask),
                                      np.asarray(js.fleet.cells.edge_mask))
    if mode == "horizon":
        np.testing.assert_array_equal(ts._tail, js._tail)


def test_serve_entry_point_refuses_what_is_not_ported():
    from repro_torch.launch import serve

    # LM serving runs every family with a decode step, the mixed frontend
    # (internvl2) too; the encoder (hubert), which has none, is refused.
    out = serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                      "internvl2-76b", "--batch", "1", "--prompt-len", "4",
                      "--new-tokens", "2"])
    assert out["tokens"].shape == (1, 3)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--mode", "lm", "--device", "cpu", "--arch",
                    "hubert-xlarge"])


class _Built(Exception):
    """Raised by a stand-in PlanningService once the CLI has built its
    arguments."""


@pytest.mark.parametrize("flags", [
    ["--n-starts", "4"],
    ["--horizon", "4", "--switch-cost", "100"],
    ["--tiers", "lo:1.6:1.0:0.55:0.35,mid,hi:0.7:1.2:1.5:0.3",
     "--compression", "--topk-frac", "0.05"],
    ["--cell-edges", "3", "--m-cand", "6", "--topology-period", "2",
     "--edge-cost", "2000"],
], ids=["restarts", "horizon", "compression", "topology"])
def test_serve_plan_flags_build_the_jax_service(monkeypatch, flags):
    """Each README planning example: the port's CLI hands PlanningService
    the fleet (leaves and edge mask bitwise) and the knobs the JAX CLI
    hands it."""
    import repro.fleet.service as jservice
    from repro.launch import serve as jserve
    import repro_torch.fleet.service as tservice
    from repro_torch.launch import serve as tserve

    seen = {}

    def stand_in(tag):
        def build(fleet, **kw):
            seen[tag] = (fleet, kw)
            raise _Built
        return build

    monkeypatch.setattr(jservice, "PlanningService", stand_in("jax"))
    monkeypatch.setattr(tservice, "PlanningService", stand_in("torch"))
    argv = ["--mode", "plan", "--cells", "2", "--cell-users", "6",
            "--cell-edges", "2"] + flags
    with pytest.raises(_Built):
        jserve.main(argv)
    with pytest.raises(_Built):
        tserve.main(argv + ["--device", "cpu"])
    (jfl, jkw), (tfl, tkw) = seen["jax"], seen["torch"]
    _assert_fleet_bitwise(tfl, jfl)
    if jfl.cells.edge_mask is None:
        assert tfl.edge_mask is None
    else:
        assert_bitwise(tfl.edge_mask, jfl.cells.edge_mask)
    jc, tc = jkw["cfg"], tkw["cfg"]
    for name in ("max_rounds", "escape_iters", "top_k", "n_starts",
                 "horizon", "switch_cost", "topology_period", "event_rate"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (tc.ladder is None) == (jc.ladder is None)
    if jc.ladder is not None:
        assert tc.ladder.bytes_factors() == jc.ladder.bytes_factors()
        assert tc.ladder.epoch_factors() == jc.ladder.epoch_factors()
    assert (tc.topology is None) == (jc.topology is None)
    if jc.topology is not None:
        assert tc.topology.edge_cost == jc.topology.edge_cost
    assert tkw["sroa_cfg"].fused and not jkw["sroa_cfg"].fused


def test_serve_plan_runs_every_planning_flag_at_once():
    """The CLI end to end on the CPU with restarts, a horizon, a ladder
    over device tiers and a candidate-site pool, one tick."""
    from repro_torch.launch import serve

    out = serve.main(["--mode", "plan", "--device", "cpu", "--cells", "1",
                      "--cell-users", "5", "--cell-edges", "2", "--m-cand",
                      "3", "--rounds", "1", "--plan-rounds", "1",
                      "--n-starts", "3", "--horizon", "2", "--switch-cost",
                      "100", "--compression", "--tiers",
                      "lo:1.6:1.0:0.55:0.35,mid", "--top-k", "2"])
    assert out["stats"]["ticks"] == 1 and out["stats"]["unserved"] == 0
    assert np.isfinite(out["sum_R"])
