"""The plain reference against the port's CPU path, at small sizes.

The reference imports nothing of the port; these tests import both and
hold them together: the float32 nest and its work tally bitwise the
kernel's plain twin, the float64 reference within SROA's tolerance of the
port's solve, the dynamics bitwise the service's step, the drift score and
the cost model the program's.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import fleet as bench_fleet
from conftest import ROOT, TINY_CONFIG
from reference import dynamics as rdyn
from reference import search as rsearch
from reference import sroa as rsroa
from repro_torch.core import sroa as psroa
from repro_torch.core import system_model
from repro_torch.core.wireless import ScenarioSpec, nearest_edge_assignment
from repro_torch.fleet import batch as fbatch
from repro_torch.fleet import dynamics as pdyn
from repro_torch.fleet import engine as pengine
from repro_torch.fleet.service import drift as pdrift
from repro_torch.kernels import ref as kref

CAPS = dict(b_iters=30, f_iters=10, p_iters=8, t_iters=12)
OPERANDS = ("A", "J", "H", "delta", "h", "f_max", "p_max", "B", "b_max",
            "N0", "lam", "E_cloud_total")


def _fleet(seed: int, **cut):
    cfg = json.loads((ROOT / "bench/configs/paper-fleet.json").read_text())
    cfg.update(TINY_CONFIG, **cut)
    cells, mask = bench_fleet.draw(cfg, seed)
    port = fbatch.fleet_from_numpy(
        {"cells": cells, "mask": mask,
         "n_users": mask.sum(1).astype(np.int32)}, "cpu")
    return cfg, cells, mask, port


def _assign(seed: int, mask: np.ndarray, M: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, M, size=mask.shape)


def _port_operands(port, assign) -> dict:
    c = fbatch.fleet_constants(port, torch.as_tensor(assign,
                                                     dtype=torch.int32))
    B = port.cells.B_open
    return dict(A=c.A, J=c.J, H=c.H, delta=c.delta, h=c.h,
                f_max=port.cells.f_max, p_max=port.cells.p_max, B=B,
                b_max=B, N0=port.cells.N0,
                lam=torch.ones(port.C), E_cloud_total=c.E_cloud_total)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_float32_constants_and_nest_are_the_twins(seed):
    cfg, cells, mask, port = _fleet(seed)
    assign = _assign(seed, mask, cfg["edges"])
    mine = rsroa.constants(cells, assign, mask, torch.float32, "cpu")
    theirs = _port_operands(port, assign)
    for k in ("A", "J", "H", "delta", "h", "E_cloud_total", "B"):
        assert torch.equal(mine[k], theirs[k].float()), k
    ops = [theirs[k].float().contiguous() for k in OPERANDS]
    w_ref, w_twin = {}, {}
    got = rsroa.solve(*ops, work=w_ref, **CAPS)
    want = kref.sroa_solve_plain(*ops, work=w_twin, **CAPS)
    for g, w in zip(got, want[:6]):
        assert torch.equal(g, w)
    assert w_ref == w_twin and w_ref["inversions"] > 0


def test_work_counts_frozen_problems_as_no_work():
    cfg, cells, mask, port = _fleet(3)
    ops = [x.float().contiguous() for x in
           _port_operands(port, _assign(3, mask, cfg["edges"])).values()]
    one, two = {}, {}
    rsroa.solve(*(x[:1] for x in ops), work=one, **CAPS)
    rsroa.solve(*(torch.cat([x[:1], x[:1]]) for x in ops), work=two,
                **CAPS)
    assert two == {k: 2 * v for k, v in one.items()}
    flops = rsroa.k2_flops(one, 1, ops[0].shape[1], CAPS)
    assert flops > 8 * CAPS["b_iters"] * one["inversions"]
    assert rsroa.k2_bytes(2, 8) == 2 * rsroa.k2_bytes(1, 8)


def test_grid_inversion_is_the_bisection_in_float64():
    g = torch.Generator().manual_seed(0)
    G = torch.rand((64, 8), generator=g, dtype=torch.float64) * 1e7 + 1e3
    bm = torch.full((64, 1), 2e6, dtype=torch.float64)
    target = torch.rand((64, 8), generator=g, dtype=torch.float64) * 4e6
    lo, hi = torch.zeros_like(G), bm.expand_as(G).clone()
    for _ in range(30):
        mid = (lo + hi) * 0.5
        ok = rsroa.rate(mid, G) >= target
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    want = torch.where(rsroa.rate(bm.expand_as(G), G) >= target, hi,
                       bm.expand_as(G))
    assert torch.equal(rsroa.invert_rate(G, target, bm, 30), want)


def test_float64_reference_prices_as_the_port_does():
    cfg, cells, mask, port = _fleet(4)
    assign = _assign(4, mask, cfg["edges"])
    res = fbatch.solve_batch(port, torch.as_tensor(assign, dtype=torch.int32),
                             1.0, psroa.SroaConfig(**CAPS, fused=True))
    ref = rsroa.solve_cells(cells, assign, mask, 1.0, CAPS, torch.float64)
    R_ref = rsroa.evaluate(cells, assign, mask, ref["b"], ref["f"], ref["p"],
                           1.0)
    plan = {k: getattr(res, k).double().numpy() for k in "bfpR"}
    R_plan = rsroa.evaluate(cells, assign, mask, plan["b"], plan["f"],
                            plan["p"], 1.0)
    np.testing.assert_allclose(plan["R"], R_ref, rtol=1e-3)
    # The published R is the cost of the published plan.
    np.testing.assert_allclose(plan["R"], R_plan, rtol=1e-5)


def test_cost_model_is_the_programs():
    cfg, cells, mask, port = _fleet(5)
    assign = _assign(5, mask, cfg["edges"])
    g = np.random.default_rng(5)
    b = g.uniform(1e3, 1e5, mask.shape)
    f = g.uniform(1e8, 5e9, mask.shape)
    p = g.uniform(1e-3, 0.2, mask.shape)
    want = system_model.evaluate(
        port.cells, torch.as_tensor(assign), *(torch.as_tensor(
            x, dtype=torch.float32) for x in (b, f, p)), 1.0,
        torch.as_tensor(mask)).R.double().numpy()
    got = rsroa.evaluate(cells, assign, mask,
                         *(x.astype(np.float32) for x in (b, f, p)), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_nearest_edge_is_the_programs():
    _, cells, _, port = _fleet(6)
    want = nearest_edge_assignment(port.cells).numpy()
    assert np.array_equal(rsroa.nearest_edge(cells["user_pos"],
                                             cells["edge_pos"]), want)


@pytest.mark.parametrize("stream", [
    dict(fading_every=2, arrival_rate=2.0, departure_rate=0.2),
    dict(mean_speed=0.0, fading_every=1, arrival_rate=0.0,
         departure_rate=0.0)])
def test_dynamics_replay_the_services_step(stream):
    cfg, cells, mask, port = _fleet(7, users_min=5)
    seed, event_rate = 2 ** 31 + 11, 0.6
    st = rdyn.Stream(**stream)
    pcfg = pdyn.StreamConfig(**stream)
    spec = ScenarioSpec(N=cfg["users_max"], M=cfg["edges"])
    draws = rdyn.Draws(c_range=spec.c_range, D_range=spec.D_range,
                       shadow_std_db=spec.shadow_std_db)
    state = pdyn.init_fleet_state(port, seed=seed,
                                  mean_speed=pcfg.mean_speed)
    ref = rdyn.Fleet(cells, mask, seed, st)
    assert np.array_equal(ref.velocity, state.velocity)
    assert np.array_equal(ref.shadow, state.shadow_ue_db)
    rng_p = np.random.default_rng(seed + 1)
    rng_r = np.random.default_rng(seed + 1)
    for _ in range(6):
        cm = rng_p.uniform(size=port.C) < event_rate
        port, state, ev = pdyn.fleet_step(port, state, rng_p, cfg=pcfg,
                                          spec=spec, cell_mask=cm)
        got = ref.step(rng_r, rng_r.uniform(size=port.C) < event_rate, st,
                       draws)
        assert np.array_equal(got["arrived"], ev.arrived)
        assert np.array_equal(got["departed"], ev.departed)
        assert np.array_equal(ref.active, state.active)
        for leaf, mine in (("gain", ref.gain), ("user_pos", ref.pos),
                           ("c", ref.c), ("D", ref.D)):
            assert np.array_equal(getattr(port.cells, leaf).numpy(), mine)


def test_channel_drift_is_the_programs():
    g = np.random.default_rng(8)
    now, ref = g.uniform(1e-14, 1e-9, (2, 4, 6, 3))
    active = g.uniform(size=(4, 6)) < 0.7
    assert np.array_equal(rdyn.channel_drift(now, ref, active),
                          pdrift.channel_drift(now, ref, active))


def test_fleet_draw_is_seeded_and_every_seed_plans_the_same_sizes():
    cfg = json.loads((ROOT / "bench/configs/paper-fleet.json").read_text())
    a_cells, a_mask = bench_fleet.draw(cfg, [5, 0])
    b_cells, b_mask = bench_fleet.draw(cfg, [5, 0])
    c_cells, c_mask = bench_fleet.draw(cfg, [6, 0])
    assert all(np.array_equal(a_cells[k], b_cells[k]) for k in a_cells)
    assert np.array_equal(a_mask, b_mask)
    assert not np.array_equal(a_cells["gain"], c_cells["gain"])
    assert sorted(a_mask.sum(1)) == sorted(c_mask.sum(1))
    assert sorted(a_cells["s_bits"]) == sorted(c_cells["s_bits"])
    assert a_mask.sum(1).min() == cfg["users_min"]
    assert a_mask.sum(1).max() == cfg["users_max"]


def test_move_scores_are_the_kernels():
    cfg, cells, mask, port = _fleet(12)
    assign = _assign(12, mask, cfg["edges"])
    H = port.cells.s_bits[:, None] * port.cells.size_mult
    want = kref.move_scores_plain(
        port.cells.gain, H, port.cells.p_max,
        torch.as_tensor(assign, dtype=torch.int32), port.mask,
        port.cells.N0, port.cells.B_open).double().numpy()
    got = rsearch.move_scores(cells, assign, mask)
    assert np.array_equal(got >= rsearch.BIG / 2, want >= rsearch.BIG / 2)
    legal = got < rsearch.BIG / 2
    np.testing.assert_allclose(got[legal], want[legal], rtol=1e-5)


@pytest.mark.parametrize("seed", [13, 2 ** 31 + 13])
def test_reference_search_takes_the_engines_rounds(seed):
    cfg, cells, mask, port = _fleet(seed, users_max=12, users_min=9,
                                    edges=4)
    init = rsroa.nearest_edge(cells["user_pos"], cells["edge_pos"])
    solver = dict(top_k=4, max_rounds=3, escape_iters=1)
    prog = pengine.solve_fleet_assignments(
        port, torch.as_tensor(init, dtype=torch.int32), 1.0,
        psroa.SroaConfig(**CAPS, fused=True), **solver)
    ref = rsearch.search(cells, init, mask, 1.0, CAPS, solver,
                         torch.float64)
    assert np.array_equal(ref["assign"][mask], prog.assign.numpy()[mask])
    assert np.array_equal(ref["rounds"], prog.rounds.numpy())
    plan = rsroa.solve_cells(cells, prog.assign.numpy(), mask, 1.0, CAPS,
                             torch.float64)
    np.testing.assert_allclose(
        rsroa.evaluate(cells, prog.assign.numpy(), mask, plan["b"],
                       plan["f"], plan["p"], 1.0), ref["R"], rtol=1e-12)
