"""The judge refuses a broken planner.

Each test drives a whole run of a small cell on the CPU (everything but the
harness's look for a card) with the planner broken underneath, and sees
``correct`` come out false: once for each fault this benchmark's cells can
have, and once for the control, the reference in bfloat16 put in the
program's place.  One sound run comes out true at the same limits.  (The
cells run on one chip: no exchange between chips to leave out.)
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import judge
import session
import system


def _run(cell, **kw):
    return session.run(cell, 2 ** 31 + 21, 0.0, False, "cpu", ticks=2, **kw)


def test_a_sound_run_is_correct(stream_cell):
    out = _run(stream_cell)
    assert out["correct"], out["checks"]
    assert "search_gap_p95" in out["numbers"]


def test_a_tick_that_leaves_the_fleet_unchanged_is_refused(stream_cell,
                                                           monkeypatch):
    from repro_torch.fleet import dynamics

    def unchanged(fleet, state, rng, cfg=None, spec=None, cell_mask=None):
        C, N = fleet.C, fleet.N_max
        none = np.zeros((C, N), bool)
        return fleet, state._replace(step=state.step + 1), \
            dynamics.FleetEvents(changed=np.zeros(C, bool), arrived=none,
                                 departed=none, dropped=np.zeros(C, int),
                                 faded=False)

    monkeypatch.setattr(dynamics, "fleet_step", unchanged)
    out = _run(stream_cell)
    assert not out["correct"]
    assert out["numbers"]["fleet_state"] > out["checks"]["fleet_state"][
        "limit"]


def test_a_re_price_of_half_the_fleet_is_refused(stream_cell, monkeypatch):
    from repro_torch.core import sroa
    from repro_torch.fleet import batch

    solve = batch.solve_batch

    def half(fleet, assigns=None, *args, **kw):
        keep = (fleet.C + 1) // 2
        idx = torch.arange(fleet.C) % keep
        res = solve(fleet.index(torch.arange(keep)), assigns[:keep], *args,
                    **kw)
        return sroa.SroaResult(*(x[idx] for x in res))

    monkeypatch.setattr(batch, "solve_batch", half)
    out = _run(stream_cell)
    assert not out["correct"]


def test_an_objective_altered_where_it_is_produced_is_refused(
        stream_cell, monkeypatch):
    from repro_torch.kernels import ops

    solve = ops.sroa_solve_batched

    def altered(*args, **kw):
        b, f, p, t, R, b_sum, feas = solve(*args, **kw)
        return b, f, p, t, R * 1.001, b_sum, feas

    monkeypatch.setattr(ops, "sroa_solve_batched", altered)
    out = _run(stream_cell)
    assert not out["correct"]
    assert out["numbers"]["reprice_consistency"] > out["checks"][
        "reprice_consistency"]["limit"]


def test_an_assignment_altered_where_it_is_produced_is_refused(
        stream_cell, monkeypatch):
    from repro_torch.fleet.service.control import PlanningService

    # The paper's user counts and edges: with a handful of users on three
    # edges a cell's cost barely depends on who serves whom.
    stream_cell.config.update(users_max=24, users_min=20, edges=5)
    replan = PlanningService._replan
    first = stream_cell.traffic["warmup_ticks"]

    def moved(self, idx, ev):
        # The window's first search answers with every user of its cells
        # at their weakest edge.
        replan(self, idx, ev)
        if self.tick_idx == first:
            gain = self.fleet.cells.gain[torch.as_tensor(idx)]
            self.assigns[idx] = gain.argmin(-1).numpy()

    monkeypatch.setattr(PlanningService, "_replan", moved)
    out = _run(stream_cell)
    assert not out["correct"]
    assert out["numbers"]["search_gap_p95"] > out["checks"][
        "search_gap_p95"]["limit"]


def test_a_gate_blind_to_objective_drift_is_refused(stream_cell):
    # Objective drift alone triggers: the channel signal off, the
    # objective's threshold at any degradation.
    stream_cell.traffic["drift"].update(use_channel=False,
                                        objective_threshold=0.0)
    stream_cell.traffic["stream"].update(arrival_rate=0.0,
                                         departure_rate=0.0)
    assert _run(stream_cell)["correct"]
    out = _run(stream_cell, drift={"use_objective": False})
    assert not out["correct"]
    assert out["numbers"]["drift_mismatch"] > 0


def test_an_answer_altered_on_a_tick_not_kept_is_refused(stream_cell):
    stream_cell.traffic["check_ticks"] = 1

    def alter(cells0, mask0, log):
        # One answer of a tick the judge does not keep whole.
        r = next(r for r in log.requests
                 if r.response["tick"] not in log.samples)
        r.response = dict(r.response,
                          R=[x * 1.001 for x in r.response["R"]])

    out = session.run(stream_cell, 2 ** 31 + 21, 0.0, False, "cpu",
                      ticks=3, after_window=alter)
    assert not out["correct"]
    assert out["numbers"]["answer_mismatch"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16])
def test_the_control_is_refused(stream_cell, dtype):
    cfg, tr = stream_cell.config, stream_cell.traffic
    seed = 2 ** 31 + 21

    def control(cells0, mask0, log):
        judge.control(cfg, tr, cells0, mask0, seed, log, system.caps(cfg),
                      "cpu", dtype)

    out = session.run(stream_cell, seed, 0.0, False, "cpu", ticks=2,
                      after_window=control)
    assert not out["correct"]
    checks = out["checks"]
    assert (out["numbers"]["reprice_consistency"]
            > checks["reprice_consistency"]["limit"])
    assert out["numbers"]["fleet_state"] > checks["fleet_state"]["limit"]
