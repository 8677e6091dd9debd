"""Port parity: the cost model (eqs 4-15), the SROA constants and SROA
(Algorithms 2-4), each against the JAX package on the same inputs.

Tolerances: pure arithmetic (``evaluate``, ``sroa_constants``) to 1e-6
relative; the Lemma-1 inversion to the reference's own kernel tolerance
(rtol 1e-5, atol 1e-3); a whole SROA solve to rtol 1e-5 on R and t.
Inside torch, a batched solve equals the standalone one BITWISE (D2).

The torch nest runs eagerly on the CPU, where every bisection step costs a
few tensor operations of overhead, so the solves here use the trimmed caps
the JAX service tests use (``tests/test_service.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, fleet_to_torch, host,  # noqa: E402
                           scenario_to_torch)
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import system_model as jsm  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import system_model as tsm  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
LAM = 1.0


@pytest.fixture(scope="module")
def scn():
    """The ``tests/test_core_sroa.py`` fixture: the paper's default draw."""
    return jw.draw_scenario(0)


@pytest.fixture(scope="module")
def tscn(scn):
    return scenario_to_torch(scn)


@pytest.fixture(scope="module")
def assign(scn):
    return jw.nearest_edge_assignment(scn)


def _tensor(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _allocation(scn, seed=0):
    """Random but plausible (b, f, p) for the cost model, from numpy."""
    rng = np.random.default_rng(seed)
    N = scn.N
    b = rng.uniform(0.2, 1.5, N) * float(scn.B_total) / N
    f = rng.uniform(0.3, 1.0, N) * np.asarray(scn.f_max)
    p = rng.uniform(0.1, 1.0, N) * np.asarray(scn.p_max)
    return tuple(np.asarray(x, np.float32) for x in (b, f, p))


# ---------------------------------------------------------------- cost model
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_evaluate_matches_jax(scn, tscn, assign, masked):
    b, f, p = _allocation(scn)
    mask = np.arange(scn.N) % 7 != 3 if masked else None
    want = jsm.evaluate(scn, assign, jnp.asarray(b), jnp.asarray(f),
                        jnp.asarray(p), LAM,
                        None if mask is None else jnp.asarray(mask))
    got = tsm.evaluate(tscn, _tensor(assign), _tensor(b), _tensor(f),
                       _tensor(p), LAM, None if mask is None
                       else _tensor(mask))
    for name in jsm.CostBreakdown._fields:
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)


def test_evaluate_matches_hand_computation(tscn):
    """``tests/test_core_sroa.py``'s numpy transcription of eqs 4-15."""
    s = tscn
    N, M = s.N, s.M
    a = host(tw.nearest_edge_assignment(s))
    b = np.full(N, float(s.B_total) / N)
    f, p = host(s.f_max), host(s.p_max)
    g = host(s.gain)[np.arange(N), a]
    L, K, I = float(s.L), float(s.K), float(s.I)
    c, D = host(s.c), host(s.D)
    sb, N0, alpha = float(s.s_bits), float(s.N0), float(s.alpha)
    T_cmp = L * c * D / f
    E_cmp = 0.5 * alpha * L * f ** 2 * c * D
    T_com = sb / (b * np.log2(1.0 + g * p / (N0 * b)))
    E_com = p * T_com
    T_m = np.array([K * (T_cmp + T_com)[a == m].max() if (a == m).any()
                    else 0.0 for m in range(M)])
    E_m = np.array([K * (E_cmp + E_com)[a == m].sum() for m in range(M)])
    occ = np.array([(a == m).any() for m in range(M)])
    T_sum = I * (np.where(occ, host(s.T_cloud()), 0) + T_m).max()
    E_sum = I * (np.where(occ, host(s.E_cloud()), 0) + E_m).sum()
    cb = tsm.evaluate(s, torch.tensor(a), torch.tensor(b, dtype=torch.float32),
                      s.f_max, s.p_max, LAM)
    np.testing.assert_allclose(float(cb.T_sum), T_sum, rtol=1e-5)
    np.testing.assert_allclose(float(cb.E_sum), E_sum, rtol=1e-5)
    np.testing.assert_allclose(float(cb.R), E_sum + LAM * T_sum, rtol=1e-5)


def test_evaluate_candidates_matches_jax(scn, tscn, assign):
    cands, _ = jb.candidate_assigns_device(assign, scn.M)
    cands = cands[:9]
    A = cands.shape[0]
    rng = np.random.default_rng(1)
    b, f, p = (np.asarray(np.broadcast_to(x, (A, scn.N))
                          * rng.uniform(0.5, 1.0, (A, scn.N)), np.float32)
               for x in _allocation(scn))
    want = jsm.evaluate_candidates(scn, cands, jnp.asarray(b),
                                   jnp.asarray(f), jnp.asarray(p), LAM)
    got = tsm.evaluate_candidates(tscn, _tensor(cands), _tensor(b),
                                  _tensor(f), _tensor(p), LAM)
    for name in ("R", "R_m", "T_m", "E_m", "b_per_edge"):
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_sroa_constants_match_jax(scn, tscn, assign, masked):
    mask = np.arange(scn.N) % 5 != 1 if masked else None
    want = jsm.sroa_constants(scn, assign,
                              None if mask is None else jnp.asarray(mask))
    got = tsm.sroa_constants(tscn, _tensor(assign),
                             None if mask is None else _tensor(mask))
    for name in jsm.SroaConstants._fields:
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)
    if masked:
        for name in ("A", "J", "H", "delta"):
            assert (host(getattr(got, name))[~mask] == 0).all()
        assert (host(got.h)[~mask] == 1).all()


def test_sroa_constants_batched_match_jax(scn, tscn, assign):
    cands, _ = jb.candidate_assigns_device(assign, scn.M)
    mask = np.arange(scn.N) % 9 != 0
    want = jsm.sroa_constants_batched(scn, cands, jnp.asarray(mask))
    got = tsm.sroa_constants_batched(tscn, _tensor(cands), _tensor(mask))
    for name in jsm.SroaConstants._fields:
        assert tuple(getattr(got, name).shape) == getattr(want, name).shape
        np.testing.assert_allclose(host(getattr(got, name)),
                                   host(getattr(want, name)), rtol=1e-6,
                                   err_msg=name)


def test_effective_loads_price_tiers_and_levels(tscn):
    """No ladder: the tier product, bitwise.  With one: each user's level
    scales compute by its epoch factor and the upload by its bytes factor
    (levels past the ladder clip onto its last rung)."""
    from repro_torch.fed.compression import default_ladder

    c_eff, s_eff = tsm.effective_loads(tscn)
    assert_bitwise(c_eff, tscn.c * tscn.cycle_mult)
    lad = default_ladder(0.05)
    comp = torch.arange(tscn.N, dtype=torch.int32) % 4
    gc, gs = tsm.effective_loads(tscn, comp=comp, ladder=lad)
    lv = comp.clamp(max=2).long()
    ef = torch.tensor(lad.epoch_factors(), dtype=torch.float32)
    bf = torch.tensor(lad.bytes_factors(), dtype=torch.float32)
    assert_bitwise(gc, c_eff * ef[lv])
    assert_bitwise(gs, s_eff * bf[lv])


# ------------------------------------------------------ Lemma-1 inversion
def test_rate_fn_matches_jax():
    rng = np.random.default_rng(2)
    b = np.concatenate([[0.0, 1e-13], rng.uniform(1e2, 1e7, 30)])
    G = rng.uniform(1e2, 1e10, b.size)
    b, G = (np.asarray(x, np.float32) for x in (b, G))
    np.testing.assert_allclose(host(tsroa.rate_fn(_tensor(b), _tensor(G))),
                               host(jsroa.rate_fn(jnp.asarray(b),
                                                  jnp.asarray(G))),
                               rtol=1e-6)


@pytest.mark.parametrize("iters", [16, 42])
@pytest.mark.parametrize("b_max", [1e7, "per_row"])
def test_invert_rate_matches_jax(iters, b_max):
    rng = np.random.default_rng(iters)
    G = np.asarray(rng.uniform(1e2, 1e10, (4, 13)), np.float32)
    frac = rng.uniform(0.01, 1.2, (4, 13))     # > 1/ln2 ~ infeasible rows
    tgt = np.asarray(frac * G / np.log(2.0), np.float32)
    tgt[0, :3] = 0.0                          # masked users: target 0
    bm = (np.asarray(rng.uniform(1e6, 1e8, (4, 1)), np.float32)
          if b_max == "per_row" else np.float32(b_max))
    want = jsroa.invert_rate(jnp.asarray(G), jnp.asarray(tgt),
                             jnp.asarray(bm), iters=iters)
    got = tsroa.invert_rate(_tensor(G), _tensor(tgt), _tensor(bm),
                            iters=iters)
    np.testing.assert_allclose(host(got), host(want), rtol=1e-5, atol=1e-3)
    infeasible = (frac >= 1 / np.log(2.0))
    np.testing.assert_array_equal(
        host(got)[infeasible], np.broadcast_to(bm, G.shape)[infeasible])


# ------------------------------------------------------------------- SROA
@pytest.fixture(scope="module")
def solved(scn, tscn, assign):
    want = jsroa.solve(scn, assign, LAM, JCFG)
    got = tsroa.solve(tscn, _tensor(assign), LAM, TCFG)
    return want, got


def test_eager_sroa_matches_jax(solved):
    want, got = solved
    np.testing.assert_allclose(float(got.R), float(want.R), rtol=1e-5)
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-5)
    np.testing.assert_allclose(host(got.b), host(want.b), rtol=1e-3,
                               atol=1.0)
    np.testing.assert_allclose(host(got.f), host(want.f), rtol=1e-3)
    np.testing.assert_allclose(host(got.p), host(want.p), rtol=1e-3)
    assert bool(got.feasible) == bool(want.feasible)


def test_sroa_solution_respects_constraints(tscn, solved):
    """The ``test_core_sroa`` contract, on the port's solution."""
    _, r = solved
    assert bool(r.feasible)
    assert float(r.b.sum()) <= float(tscn.B_total) * (1 + 1e-3)
    assert (host(r.f) <= host(tscn.f_max) * (1 + 1e-6)).all()
    assert (host(r.p) <= host(tscn.p_max) * (1 + 1e-6)).all()
    assert (host(r.b) > 0).all()
    # SROA's internal R is the cost model's R for the returned allocation.
    ev = tsm.evaluate(tscn, tw.nearest_edge_assignment(tscn), r.b, r.f, r.p,
                      LAM)
    np.testing.assert_allclose(float(ev.R), float(r.R), rtol=2e-3)


@pytest.mark.parametrize("lam", [0.1, 10.0])
def test_eager_sroa_matches_jax_across_lambda(scn, tscn, assign, lam):
    want = jsroa.solve(scn, assign, lam, JCFG)
    got = tsroa.solve(tscn, _tensor(assign), lam, TCFG)
    np.testing.assert_allclose(float(got.R), float(want.R), rtol=1e-5)
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-5)


def test_sroa_plus_polish_matches_jax():
    """The beyond-paper ``refine_iters`` polish (SROA+): grid scan plus
    golden section, on a small cell with two golden steps."""
    jspec = dataclasses.replace(jw.ScenarioSpec(), N=6, M=2)
    scn = jw.draw_scenario(7, jspec)
    a = jw.nearest_edge_assignment(scn)
    caps = dict(CAPS, refine_iters=2)
    want = jsroa.solve(scn, a, LAM, jsroa.SroaConfig(**caps))
    got = tsroa.solve(scenario_to_torch(scn), _tensor(a), LAM,
                      tsroa.SroaConfig(**caps))
    np.testing.assert_allclose(float(got.R), float(want.R), rtol=1e-5)
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-5)
    base = tsroa.solve(scenario_to_torch(scn), _tensor(a), LAM, TCFG)
    assert float(got.R) <= float(base.R)


def test_solve_plus_raises_refine_caps(monkeypatch):
    seen = {}

    def fake_solve(scn, assign, lam, cfg):
        seen["cfg"] = cfg
    monkeypatch.setattr(tsroa, "solve", fake_solve)
    tsroa.solve_plus(None, None, LAM, TCFG)
    assert seen["cfg"].refine_iters == 32
    assert seen["cfg"].b_iters == TCFG.b_iters


def test_manual_bounds_match_jax():
    """``auto_bounds=False`` bisects t on [t_low, t_up] as given."""
    jspec = dataclasses.replace(jw.ScenarioSpec(), N=5, M=2)
    scn = jw.draw_scenario(2, jspec)
    a = jw.nearest_edge_assignment(scn)
    caps = dict(CAPS, auto_bounds=False, t_low=10.0, t_up=1e6)
    want = jsroa.solve(scn, a, LAM, jsroa.SroaConfig(**caps))
    got = tsroa.solve(scenario_to_torch(scn), _tensor(a), LAM,
                      tsroa.SroaConfig(**caps))
    np.testing.assert_allclose(float(got.R), float(want.R), rtol=1e-5)
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-5)


# ------------------------------------------------- batching inside torch
def _fields_bitwise(got, want, cut=None):
    for name in tsroa.SroaResult._fields:
        g, w = getattr(got, name), getattr(want, name)
        if cut is not None and g.dim() > 0 and g.shape[-1] == cut[0]:
            g, w = g[..., :cut[1]], w[..., :cut[1]]
        assert_bitwise(g, w, name)


@pytest.fixture(scope="module")
def fleet3():
    jspec = dataclasses.replace(jw.ScenarioSpec(), N=8, M=2)
    return fleet_to_torch(jb.draw_fleet(0, 3, jspec, n_range=(5, 8)))


def test_batched_solve_equals_standalone_bitwise(fleet3):
    """D2: a cell's trajectory does not depend on the batch it rides in:
    each padded fleet row solved alone gives the batch's bits."""
    assigns = tb.fleet_assignments(fleet3)
    out = tb.solve_batch(fleet3, assigns, LAM, TCFG)
    for i in range(fleet3.C):
        one = fleet3.index([i])
        alone = tb.solve_batch(one, assigns[i:i + 1], LAM, TCFG)
        _fields_bitwise(tsroa.SroaResult(*(x[i:i + 1] for x in out)), alone)


def test_padded_users_are_neutral(fleet3):
    """D5: a padded cell solves like its unpadded self and its padded
    users take ~no bandwidth (the JAX package's own tolerance)."""
    assigns = tb.fleet_assignments(fleet3)
    out = tb.solve_batch(fleet3, assigns, LAM, TCFG)
    n_users = host(fleet3.n_users)
    assert len(set(n_users.tolist())) > 1
    for i in range(fleet3.C):
        n = int(n_users[i])
        cell = fleet3.cell(i)
        alone = tsroa.solve(cell, assigns[i][:n], LAM, TCFG)
        np.testing.assert_allclose(float(out.R[i]), float(alone.R),
                                   rtol=1e-3)
        assert float(out.b[i][n:].sum()) < 1e-3 * float(cell.B_total)


def test_use_pallas_route_equals_eager_bitwise_on_cpu(fleet3):
    """On CPU tensors the K1 wrapper runs its plain version, whose steps
    are the eager inversion's: the two routes give the same bits."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    got = tb.solve_batch(fleet3, lam=LAM,
                         cfg=dataclasses.replace(TCFG, use_pallas=True))
    want = tb.solve_batch(fleet3, lam=LAM, cfg=TCFG)
    _fields_bitwise(got, want)
    assert ops.LAUNCHES == before      # no kernel launched on the CPU


def test_solve_candidates_matches_jax(scn, tscn, assign):
    cands, _ = jb.candidate_assigns_device(assign, scn.M)
    cands = cands[:4]
    want = jb.solve_candidates(scn, cands, LAM, JCFG)
    got = tb.solve_candidates(tscn, _tensor(cands), LAM, TCFG)
    np.testing.assert_allclose(host(got.R), host(want.R), rtol=1e-5)
    np.testing.assert_allclose(host(got.t), host(want.t), rtol=1e-5)
