"""Port parity: TSIA (Algorithm 5) and the user-assignment baselines,
against the JAX package on the ``tests/test_core_tsia.py`` fixtures.

Both packages get the same scenario (drawn by the JAX package, carried
across bit for bit) and the same trimmed caps.  Integer outputs (the
assignment, the move trace, the iteration counts, every UA method's
pattern) must match exactly; objectives to rtol 1e-5.  The file's
contracts are then re-stated on the port alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import host, scenario_to_torch  # noqa: E402
from repro.core import assignment_baselines as jub  # noqa: E402
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import tsia as jtsia  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro_torch.core import assignment_baselines as tub  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import system_model as tsm  # noqa: E402
from repro_torch.core import tsia as ttsia  # noqa: E402

# The port's eager nest costs ~4 us an op on a CPU: trimmed caps on both
# sides (TSIA's decisions only need both packages to agree, not SROA to
# converge).
CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
JCFG = jsroa.SroaConfig(**CAPS)
TCFG = tsroa.SroaConfig(**CAPS)
# The paper's claims need SROA's deadline bisection to converge: after 10
# halvings SROA stops far above its optimum in both packages (TSIA then
# loses to JUARA at N = 16, M = 3); 20 halvings reach eps2.
CLAIM_CFG = tsroa.SroaConfig(**dict(CAPS, t_iters=20))
RTOL = 1e-5
SPEC16 = dataclasses.replace(jw.ScenarioSpec(), N=16, M=3)
SPEC8 = dataclasses.replace(jw.ScenarioSpec(), N=8, M=3)


@pytest.fixture(scope="module")
def scn():
    """``tests/test_core_tsia.py``'s fixture: the paper's N = 50, M = 5."""
    return jw.draw_scenario(0)


@pytest.fixture(scope="module")
def tscn(scn):
    return scenario_to_torch(scn)


@pytest.fixture(scope="module")
def jax_res(scn):
    return jtsia.solve(scn, lam=1.0, cfg=JCFG)


@pytest.fixture(scope="module")
def tsia_res(tscn):
    return ttsia.solve(tscn, lam=1.0, cfg=TCFG)


@pytest.fixture(scope="module")
def scn16():
    return jw.draw_scenario(0, SPEC16)


@pytest.fixture(scope="module")
def scn8():
    return jw.draw_scenario(0, SPEC8)


@pytest.fixture(scope="module")
def tsia8(scn8):
    """The port's TSIA on an N = 8, M = 3 scenario (eager nest)."""
    return ttsia.solve(scenario_to_torch(scn8), lam=1.0, cfg=TCFG)


def _assert_tsia_match(got, want):
    """Assignment, moves and iteration counts exact; R to rtol 1e-5."""
    np.testing.assert_array_equal(got.assign, want.assign)
    assert got.assign.dtype == np.int32
    assert got.history.moves == want.history.moves
    assert got.history.iters_stage1 == want.history.iters_stage1
    assert got.history.iters_stage2 == want.history.iters_stage2
    np.testing.assert_allclose(got.history.R_trace, want.history.R_trace,
                               rtol=RTOL)
    np.testing.assert_allclose(got.R, want.R, rtol=RTOL)
    for name in ("b", "f", "p"):
        np.testing.assert_allclose(host(getattr(got.sroa, name)),
                                   host(getattr(want.sroa, name)),
                                   rtol=RTOL, err_msg=name)


# ------------------------------------------------------------------ parity
def test_tsia_matches_jax_on_draw_scenario_0(jax_res, tsia_res):
    _assert_tsia_match(tsia_res, jax_res)


def test_tsia_matches_jax_from_random_init(scn, tscn):
    """``test_tsia_improves_random_init``'s initial pattern."""
    rng = np.random.default_rng(1)
    init = rng.integers(0, scn.M, size=scn.N).astype(np.int32)
    want = jtsia.solve(scn, lam=1.0, cfg=JCFG, init_assign=init)
    got = ttsia.solve(tscn, lam=1.0, cfg=TCFG, init_assign=init)
    _assert_tsia_match(got, want)
    assert got.R < got.history.R_trace[0] * 0.999


def test_tsia_fused_matches_eager_nest(scn8, tsia8):
    """``fused=True`` scores every pattern with K2 (its plain version on
    the CPU): the same decisions as the eager nest, R to the reference's
    own fused-vs-nest rtol 5e-3."""
    tscn = scenario_to_torch(scn8)
    eager = tsia8
    assert len(eager.history.moves) >= 5
    fused = ttsia.solve(tscn, lam=1.0,
                        cfg=dataclasses.replace(TCFG, fused=True))
    np.testing.assert_array_equal(fused.assign, eager.assign)
    assert fused.history.moves == eager.history.moves
    np.testing.assert_allclose(fused.history.R_trace, eager.history.R_trace,
                               rtol=5e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("method", sorted(jub.UA_METHODS))
def test_ua_methods_match_jax(method, seed):
    """Every UA method gives the JAX package's pattern.  HFEL-UA's local
    search is driven by the same deterministic score on both sides, so
    the test holds its rng call order."""
    scn = jw.draw_scenario(seed)
    tscn = scenario_to_torch(scn)
    w = np.random.default_rng(100 + seed).uniform(0.5, 2.0, (scn.N, scn.M))

    def score(a):                # a cost with its own local optima
        a = np.asarray(a)
        return float(np.sum(w[np.arange(len(a)), a] * (1 + np.bincount(
            a, minlength=scn.M)[a])))

    kw = dict(transfer_iters=30, exchange_iters=60) \
        if method == "HFEL-UA" else {}
    want = np.asarray(jub.UA_METHODS[method](scn, 1.0, score, seed=seed,
                                             **kw))
    got = tub.UA_METHODS[method](tscn, 1.0, score, seed=seed, **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_hfel_ua_trace_matches_jax(scn16):
    tscn = scenario_to_torch(scn16)
    score = lambda a: float(np.sum(np.asarray(a) * np.arange(16)))  # noqa
    tr_j, tr_t = [], []
    jub.hfel_ua(scn16, 1.0, score, seed=3, transfer_iters=20,
                exchange_iters=20, trace=tr_j)
    tub.hfel_ua(tscn, 1.0, score, seed=3, transfer_iters=20,
                exchange_iters=20, trace=tr_t)
    assert tr_t == tr_j


# ------------------------------------- test_core_tsia.py's contracts, torch
def test_tsia_returns_valid_partition(tscn, tsia_res):
    a = tsia_res.assign
    assert a.shape == (tscn.N,)
    assert a.min() >= 0 and a.max() < tscn.M        # (15e)-(15f)


def test_tsia_best_no_worse_than_init(tsia_res):
    """Algorithm 5 returns the best pattern it visited."""
    assert tsia_res.R <= tsia_res.history.R_trace[0] + 1e-6
    assert tsia_res.R == min(tsia_res.history.R_trace)


def test_tsia_result_rescores_to_its_R(tscn, tsia_res):
    a = torch.as_tensor(tsia_res.assign)
    cb = tsm.evaluate(tscn, a, tsia_res.sroa.b, tsia_res.sroa.f,
                      tsia_res.sroa.p, 1.0)
    assert float(cb.R) == tsia_res.R


def test_tsia_convergence_iterations(tsia_res):
    """Paper Fig 6: at N=50, M=5 TSIA converges in tens of iterations."""
    total = tsia_res.history.total_iters
    assert 5 <= total <= 120, total


def test_tsia_deterministic(scn8, tsia8):
    a = tsia8
    b = ttsia.solve(scenario_to_torch(scn8), lam=1.0, cfg=TCFG)
    np.testing.assert_array_equal(a.assign, b.assign)
    assert a.history.moves == b.history.moves
    assert a.R == b.R


def test_tsia_trace_records_moves(tscn, tsia_res):
    """Fig 5: every move is (stage, q, user, from, to) with from != to."""
    assert tsia_res.history.moves
    for stage, q, user, src, dst in tsia_res.history.moves:
        assert stage in (1, 2)
        assert 0 <= user < tscn.N
        assert src != dst
    assert len(tsia_res.history.R_trace) == 1 + tsia_res.history.total_iters


def test_tsia_plus_extension_beats_paper_tsia(scn, tscn, tsia_res):
    """Beyond-paper: best-gain init dominates the geographic init here,
    and the port walks the JAX package's path from it."""
    init = tub.bestgain_ua(tscn, 1.0, None)
    res = ttsia.solve(tscn, lam=1.0, cfg=TCFG, init_assign=init)
    assert res.R <= tsia_res.R * (1 + 1e-6)
    want = jtsia.solve(scn, lam=1.0, cfg=JCFG, init_assign=init)
    np.testing.assert_array_equal(res.assign, want.assign)
    assert res.history.moves == want.history.moves


def test_tsia_beats_published_baselines(scn16):
    """Paper Fig 4 on the port: TSIA(+SROA) below HFEL-UA(+HFEL-RA) and
    JUARA-UA(+JUARA-RA), each baseline with its own paper's RA, at N = 16,
    M = 3 with HFEL's trimmed budget (30 transfers, 60 exchanges)."""
    tscn = scenario_to_torch(scn16)
    R_tsia = ttsia.solve(tscn, lam=1.0, cfg=CLAIM_CFG).R

    def hfel_score(a):
        ra = tbase.hfel_ra(tscn, a, 1.0, CLAIM_CFG)
        return float(tsm.evaluate(tscn, torch.as_tensor(a), ra.b, ra.f,
                                  ra.p, 1.0).R)

    a_hfel = tub.hfel_ua(tscn, 1.0, hfel_score, seed=0,
                         transfer_iters=30, exchange_iters=60)
    R_hfel = hfel_score(a_hfel)
    a_juara = torch.as_tensor(tub.juara_ua(tscn, 1.0, None))
    ra = tbase.juara_ra(tscn, a_juara, 1.0, CLAIM_CFG)
    R_juara = float(tsm.evaluate(tscn, a_juara, ra.b, ra.f, ra.p, 1.0).R)
    assert R_tsia < R_hfel, (R_tsia, R_hfel)
    assert R_tsia < R_juara, (R_tsia, R_juara)
