"""Port parity: the kernels' plain PyTorch versions against the JAX
package's Pallas kernels (run in interpret mode, as the JAX tests run
them) or its oracles, and the public wrappers' flattening and dispatch.

* K1 ``invert_rate_plain``  vs ``ops.sroa_invert_rate(_batched)``:
  rtol 1e-5, atol 1e-3 (``tests/test_kernels.py:179``).
* K2 ``sroa_solve_plain``   vs ``sroa_solve_pallas``: the reference's own
  fused-vs-nest tolerance, rtol 5e-3 (``tests/test_kernels.py:143``).
  The TPU kernel pads users to 128 lanes and its padded lanes add
  ~B 2^-b_iters each to the budget sum, so the two are not bitwise.
* K3 ``topk_moves_plain``   vs ``ops.topk_move_scores``: indices exact,
  scores rtol 1e-5, padding, ties and cell axis included.
* K4 ``attention_plain`` (through ``ops.flash_attention``) vs
  ``ref.attention_ref`` on the JAX flash sweep: 2e-5 in f32, 2e-2 in bf16
  (``tests/test_kernels.py:70``).  The JAX flash kernel itself does not
  run on this jax (``pl.load`` is gone), so its oracle stands in.
* K5 ``rmsnorm_plain`` (through ``ops.fused_rmsnorm``) vs
  ``ops.fused_rmsnorm`` on the JAX rmsnorm sweep: 1e-5 in f32, 2e-2 in bf16
  (``tests/test_kernels.py:114``).

* The designs K1 and K2 rely on, as plain models held bitwise to the
  twins' arithmetic: the lanes K2's cross-warp sum (``warp_sum_plain``),
  the speculative bisection at depths 1 and 2 (``bisect_rate_plain``), the
  kLn2 threshold that replaces the step's division, and the kernel and
  depth picks (pure functions of the shape).  K3's warp kernel's selection
  (``topk_select_lanes_plain``) against the twin's, bitwise, and its route.

The CUDA kernels themselves are held against these twins on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_bitwise, host, scenario_to_torch  # noqa: E402
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import system_model as jsm  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sroa_bisect as jsb  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core import system_model as tsm  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)


def _t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


@pytest.fixture
def launches():
    """Counts before the test; the CPU path must never add to them."""
    before = dict(ops.LAUNCHES)
    yield
    assert ops.LAUNCHES == before


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("n", [1, 17, 51])
def test_invert_plain_matches_pallas(n, launches):
    rng = np.random.default_rng(n)
    G = np.asarray(rng.uniform(1e3, 1e9, n), np.float32)
    tgt = np.asarray(rng.uniform(0.0, 1.3, n) * G / np.log(2.0), np.float32)
    want = jops.sroa_invert_rate(jnp.asarray(G), jnp.asarray(tgt), 1e7,
                                 iters=42)
    got = ops.sroa_invert_rate(_t(G), _t(tgt), 1e7, iters=42)
    np.testing.assert_allclose(host(got), host(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("shape", [(3, 17), (2, 3, 5), (1, 1)])
def test_invert_batched_odd_shapes_match_pallas(shape, launches):
    rng = np.random.default_rng(len(shape))
    G = np.asarray(np.abs(rng.normal(size=shape)) * 1e6 + 1e3, np.float32)
    tgt = np.asarray(np.abs(rng.normal(size=shape)) * 1e4, np.float32)
    bm = np.asarray(rng.uniform(1e6, 2e7, shape[:-1]), np.float32)
    want = jops.sroa_invert_rate_batched(jnp.asarray(G), jnp.asarray(tgt),
                                         jnp.asarray(bm))
    got = ops.sroa_invert_rate_batched(_t(G), _t(tgt), _t(bm))
    assert got.shape == shape
    np.testing.assert_allclose(host(got), host(want), rtol=1e-5, atol=1e-3)
    # A scalar cap broadcasts the same way.
    want1 = jops.sroa_invert_rate_batched(jnp.asarray(G), jnp.asarray(tgt),
                                          1e7)
    got1 = ops.sroa_invert_rate_batched(_t(G), _t(tgt), 1e7)
    np.testing.assert_allclose(host(got1), host(want1), rtol=1e-5,
                               atol=1e-3)


def test_invert_infeasible_pegs_bmax(launches):
    G = torch.tensor([1e4, 1e4], dtype=torch.float32)
    tgt = torch.tensor([1e9, 1.0], dtype=torch.float32)
    out = ops.sroa_invert_rate(G, tgt, 5e5)
    assert float(out[0]) == 5e5 and float(out[1]) < 5e5


# ------------------------------------------------------------------ K2
def _problem(n, seed, M=2):
    spec = dataclasses.replace(jw.ScenarioSpec(), N=n, M=M)
    scn = jw.draw_scenario(seed, spec)
    return scn, jw.nearest_edge_assignment(scn)


def _solve_args(scn, consts):
    B = scn.B_total
    return (consts.A, consts.J, consts.H, consts.delta, consts.h, scn.f_max,
            scn.p_max, B, B, scn.N0, jnp.float32(1.0), consts.E_cloud_total)


@pytest.mark.parametrize("n", [1, 7, 10])
def test_solve_plain_matches_pallas(n, launches):
    scn, a = _problem(n, n)
    consts = jsm.sroa_constants(scn, a)
    args = [jnp.reshape(x, (1, -1)) if jnp.ndim(x) == 1 else
            jnp.reshape(x, (1,)) for x in _solve_args(scn, consts)]
    want = jsb.sroa_solve_pallas(*args, **CAPS, interpret=True)
    got = ref.sroa_solve_plain(*(_t(x) for x in args), **CAPS)
    wb, wf, wp, wt, wR, ws, wfe = (host(x) for x in want)
    gb, gf, gp, gt, gR, gs, gfe = (host(x) for x in got)
    np.testing.assert_array_equal(gfe, wfe)
    np.testing.assert_allclose(gR, wR, rtol=5e-3)
    np.testing.assert_allclose(gt, wt, rtol=5e-3)
    np.testing.assert_allclose(gb, wb, rtol=5e-3, atol=1.0)


@pytest.mark.parametrize("n", [1, 7])
def test_port_fused_matches_port_eager(n, launches):
    """The reference's ``test_fused_solve_matches_jnp_nest``, inside torch:
    the K2 route (its plain version here) against the eager nest."""
    scn, a = _problem(n, n)
    tscn = scenario_to_torch(scn)
    cfg = tsroa.SroaConfig(**CAPS)
    want = tsroa.solve(tscn, _t(a), 1.0, cfg)
    got = tsroa.solve(tscn, _t(a), 1.0, dataclasses.replace(cfg, fused=True))
    assert bool(got.feasible) == bool(want.feasible)
    np.testing.assert_allclose(float(got.R), float(want.R), rtol=5e-3)
    np.testing.assert_allclose(float(got.t), float(want.t), rtol=5e-3)
    np.testing.assert_allclose(host(got.b), host(want.b), rtol=5e-3,
                               atol=1.0)


def test_fused_masked_user_is_neutral(launches):
    """``tests/test_kernels.py``'s masked-user case on the port's K2 route,
    held against the JAX fused solve of the same masked constants."""
    scn, a = _problem(6, 11)
    consts = jsm.sroa_constants(scn, a)
    mask = np.array([True, True, False, True, True, True])
    jcfg = jsroa.SroaConfig(**CAPS, fused=True)
    want = jsroa.solve_constants_impl(
        jsm.mask_constants(consts, jnp.asarray(mask)), scn.B_total,
        scn.B_total, scn.f_max, scn.p_max, scn.N0, 1.0, jcfg)
    tscn = scenario_to_torch(scn)
    tconsts = tsm.mask_constants(tsm.sroa_constants(tscn, _t(a)), _t(mask))
    res = tsroa.solve_constants_impl(
        tconsts, tscn.B_total, tscn.B_total, tscn.f_max, tscn.p_max, tscn.N0,
        1.0, tsroa.SroaConfig(**CAPS, fused=True))
    assert np.isfinite(float(res.R))
    assert float(res.b[2]) < float(res.b[_t(mask)].min())
    np.testing.assert_allclose(float(res.R), float(want.R), rtol=5e-3)


@pytest.mark.parametrize("N", [1, 31, 56, 70])
def test_warp_sum_plain_adds_in_the_kernels_order(N):
    """K2 sums users per lane (users l, l+32, ...), then butterflies over
    lanes l ^ 16, 8, 4, 2, 1; the plain twin must add in that order."""
    rng = np.random.default_rng(N)
    x = np.asarray(rng.uniform(0, 1e6, (3, N)) * 10.0 ** rng.integers(
        -3, 4, (3, N)), np.float32)
    want = np.empty((3, 1), np.float32)
    for r in range(3):
        lane = [np.float32(0.0)] * 32
        for j in range(N):
            lane[j % 32] = np.float32(lane[j % 32] + x[r, j])
        for off in (16, 8, 4, 2, 1):
            lane = [np.float32(lane[i] + lane[i ^ off]) for i in range(32)]
        assert len(set(lane)) == 1            # every lane ends equal
        want[r, 0] = lane[0]
    assert_bitwise(ref.warp_sum_plain(_t(x)), want)


@pytest.mark.parametrize("N", [1, 31, 32, 33, 56, 64, 65, 200])
def test_lanes_sum_adds_in_warp_sum_plain_order(N):
    """The lanes K2's sum, one step at a time: W = ceil(N/32) warps, user
    l + 32w on lane l of warp w (0 past N); every warp adds the W values of
    its lane in warp order, then butterflies over lanes l ^ 16, 8, 4, 2, 1.
    Every lane of every warp ends with the same bits, warp_sum_plain's."""
    rng = np.random.default_rng(N + 1)
    x = np.asarray(rng.uniform(0, 1e6, (3, N)) * 10.0 ** rng.integers(
        -3, 4, (3, N)), np.float32)
    W = -(-N // 32)
    want = np.empty((3, 1), np.float32)
    for r in range(3):
        slot = np.zeros((W, 32), np.float32)
        slot.reshape(-1)[:N] = x[r]
        held = set()
        for _ in range(W):                    # each warp, redundantly
            lane = [slot[0, i] for i in range(32)]
            for k in range(1, W):
                lane = [np.float32(lane[i] + slot[k, i]) for i in range(32)]
            for off in (16, 8, 4, 2, 1):
                lane = [np.float32(lane[i] + lane[i ^ off])
                        for i in range(32)]
            held |= {v.tobytes() for v in lane}
        assert len(held) == 1
        want[r, 0] = lane[0]
    assert_bitwise(ref.warp_sum_plain(_t(x)), want)


def _rate_threshold(tgt: torch.Tensor) -> torch.Tensor:
    """``rate_threshold`` of ``csrc/sroa_bisect.cu``, element-wise: the
    smallest float y with fl(y / ln2) >= tgt (NaN and -inf pass through;
    +inf starts at FLT_MAX * ln2)."""
    c = torch.tensor(ref.LN2, dtype=torch.float32)
    fmax = torch.tensor(torch.finfo(torch.float32).max)
    up_inf = torch.tensor(float("inf"))
    live = tgt > -float("inf")
    y = torch.where(tgt <= fmax, tgt * c, fmax * c)
    while True:
        step = live & ~(y / c >= tgt)
        if not bool(step.any()):
            break
        y = torch.where(step, torch.nextafter(y, up_inf), y)
    while True:
        d = torch.nextafter(y, -up_inf)
        step = live & (d / c >= tgt)
        if not bool(step.any()):
            break
        y = torch.where(step, d, y)
    return torch.where(live, y, tgt)


def _rate_threshold_window(tgt: torch.Tensor):
    """``rate_threshold``'s fast path: the predicate at the seven floats
    y0 - 3 .. y0 + 3 around y0 = fl(tgt ln2); where the first fails and the
    last passes, the threshold is the first that passes.  Returns the
    threshold and where the window applied."""
    c = torch.tensor(ref.LN2, dtype=torch.float32)
    y0 = (tgt * c).view(torch.int32)
    ok = torch.stack([(y0 + k).view(torch.float32) / c >= tgt
                      for k in range(-3, 4)])
    fails = (~ok).sum(0).to(torch.int32)
    used = ((tgt >= 2.0 ** -50) & (tgt <= 2.0 ** 70) & ~ok[0] & ok[-1])
    return (y0 - 3 + fails).view(torch.float32), used


def _spec_bisect(G, tgt, bm, iters: int, depth: int) -> torch.Tensor:
    """``invert_rate_dev<depth>``'s bisection, element-wise: rounds of
    ``depth`` steps (then one for an odd remainder) that evaluate the
    predicate y >= thr at every midpoint the next steps can visit, then
    walk the sequential path through them with selects."""
    thr = _rate_threshold(tgt)

    def passes(b):
        bs = torch.clamp_min(b, 1e-12)
        return bs * torch.log1p(G / bs) >= thr

    def round_(lo, hi, d):
        S = 1 << d
        e = {0: lo, S: hi}
        s = S
        while s > 1:
            for i in range(0, S, s):
                e[i + s // 2] = 0.5 * (e[i] + e[i + s])
            s //= 2
        ok = {m: passes(e[m]) for m in range(1, S)}
        node = torch.zeros(G.shape, dtype=torch.int64)
        s = S // 2
        while s >= 1:
            okm = torch.zeros(G.shape, dtype=torch.bool)
            em = torch.zeros_like(G)
            for i in range(0, S, 2 * s):
                at = node == i
                okm = torch.where(at, ok[i + s], okm)
                em = torch.where(at, e[i + s], em)
            hi = torch.where(okm, em, hi)
            lo = torch.where(okm, lo, em)
            node = torch.where(okm, node, node + s)
            s //= 2
        return lo, hi

    lo, hi = torch.zeros_like(G), bm.clone()
    i = 0
    while i + depth <= iters:
        lo, hi = round_(lo, hi, depth)
        i += depth
    if depth == 2 and i < iters:
        lo, hi = round_(lo, hi, 1)
    return hi


def _bisect_sweep(seed: int, n: int = 4000):
    """G, targets and caps for the inversion: targets around rate(b_max)
    (feasible and infeasible caps), 1e30 (tau <= 0), 0, -0, subnormals,
    +-inf and NaN, and zero G."""
    rng = np.random.default_rng(seed)
    G = np.asarray(2.0 ** rng.uniform(-20, 60, n), np.float32)
    bm = np.asarray(2.0 ** rng.uniform(-5, 35, n), np.float32)
    tgt = np.asarray(rng.uniform(0, 1.3, n) * G / np.log(2.0)
                     * 10.0 ** rng.integers(-2, 3, n), np.float32)
    special = np.array([1e30, 0.0, -0.0, 1e-45, 1e-40, 1.2e-38, np.inf,
                        -np.inf, np.nan, -5.0, 3.4e38], np.float32)
    tgt[:special.size * 8] = np.repeat(special, 8)
    G[::17] = 0.0
    return _t(G), _t(tgt), _t(bm)


@pytest.mark.parametrize("iters", [30, 31, 42, 61, 13, 7, 5, 3, 2, 1, 0])
@pytest.mark.parametrize("depth", [1, 2])
def test_speculative_bisection_is_bitwise_the_sequential_one(depth, iters):
    """K1/K2's inversion model (threshold predicate, speculative rounds)
    against ref.bisect_rate_plain's sequential steps (division predicate),
    with the kernel's early return of b_max where b_max itself fails."""
    G, tgt, bm = _bisect_sweep(depth * 100 + iters)
    want = ref.bisect_rate_plain(G, tgt, bm, iters)
    assert torch.equal(_spec_bisect(G, tgt, bm, iters, depth), want)
    inv = ref.invert_rate_plain(G, tgt, bm, iters)
    bs = torch.clamp_min(bm, 1e-12)
    feas = bs * torch.log1p(G / bs) >= _rate_threshold(tgt)
    assert torch.equal(torch.where(feas, want, bm), inv)
    assert bool((~feas).any()) and bool(feas.any())


def test_rate_threshold_is_the_division_predicate():
    """fl(y / ln2) >= tgt  <=>  y >= thr(tgt), for y within 40 ulps of thr
    and for the rates of the sweep's midpoints, at every special target."""
    G, tgt, bm = _bisect_sweep(7)
    c = torch.tensor(ref.LN2, dtype=torch.float32)
    thr = _rate_threshold(tgt)
    inf = torch.tensor(float("inf"))
    y = thr.clone()
    for _ in range(40):
        y = torch.nextafter(y, -inf)
    for _ in range(81):
        assert torch.equal(y / c >= tgt, y >= thr)
        y = torch.nextafter(y, inf)
    for frac in np.linspace(0.0, 1.0, 23):
        b = torch.clamp_min(bm * float(frac), 1e-12)
        y = b * torch.log1p(G / b)
        assert torch.equal(ref.rate_plain(b, G) >= tgt, y >= thr)
    finite = torch.isfinite(tgt)
    assert bool((thr[finite] - tgt[finite] * c).abs().le(
        4 * torch.finfo(torch.float32).eps * (tgt[finite] * c).abs()
        + 1e-44).all())


def test_rate_threshold_window_is_the_walk():
    """The kernel's seven-float window gives the walk's threshold wherever
    it applies, and it applies to every target in [2^-50, 2^70]: random
    ones, the floats next to powers of two and the sweep's."""
    rng = np.random.default_rng(11)
    tgt = np.asarray(2.0 ** rng.uniform(-50, 70, 200_000), np.float32)
    edges = np.asarray(2.0 ** np.arange(-50, 70), np.float32)
    near = np.concatenate([np.nextafter(edges, 0), edges,
                           np.nextafter(edges, np.inf)]).astype(np.float32)
    G, sweep, bm = _bisect_sweep(3)
    tgt = torch.cat([_t(tgt), _t(near), sweep])
    thr, used = _rate_threshold_window(tgt)
    walk = _rate_threshold(tgt)
    assert torch.equal(thr[used], walk[used])
    in_range = (tgt >= 2.0 ** -50) & (tgt <= 2.0 ** 70)
    assert torch.equal(used, in_range)


@pytest.mark.parametrize("P,N,sms,route", [
    (1152, 56, 132, ("lanes", 1)),      # the planning round
    (128, 56, 132, ("lanes", 2)),       # the re-price shape
    (528, 56, 132, ("lanes", 2)),       # two warps a scheduler
    (529, 56, 132, ("lanes", 1)),
    (4, 12, 132, ("lanes", 2)),
    (1, 512, 132, ("lanes", 2)),
    (1, 513, 132, ("cluster", 2)),      # past 16 warps a problem
    (2000, 1024, 132, ("cluster", 1)),
    (128, 56, 114, ("lanes", 2)),       # an H100 PCIe
])
def test_k2_kernel_and_depth_pick(P, N, sms, route):
    """A pure function of (P, N) and the card's SM count: no card."""
    from repro_torch.kernels import sroa_bisect

    assert sroa_bisect.solve_route(P, N, sms) == route


def test_k2_route_refuses_past_4096_users():
    """Past the cluster kernel's 4,096 users the route raises before any
    launch and names the un-fused route, which has no cap."""
    from repro_torch.kernels import sroa_bisect

    assert sroa_bisect.solve_route(1, 4096, 132)[0] == "cluster"
    for P in (1, 34):
        with pytest.raises(ValueError, match="4096.*fused=False"):
            sroa_bisect.solve_route(P, 4097, 132)


@pytest.mark.parametrize("n,sms,depth", [
    (128 * 56, 132, 2), (56, 132, 2), (1, 132, 2), (32 * 1056, 132, 2),
    (32 * 1056 + 1, 132, 1), (10 ** 6, 132, 1)])
def test_k1_depth_pick(n, sms, depth):
    from repro_torch.kernels import sroa_bisect

    assert sroa_bisect.invert_depth(n, sms) == depth


def test_solve_plain_counts_the_work_the_kernel_does(launches):
    """With every loop at its cap, the count is the nest's worst case:
    t_iters bracketing inversions plus (t+1)(p+1)(f+1) in Algs 2-4."""
    scn, a = _problem(4, 2)
    consts = jsm.sroa_constants(scn, a)
    args = [_t(x).reshape(1, -1) if np.ndim(x) == 1 else _t(x).reshape(1)
            for x in _solve_args(scn, consts)]
    caps = dict(b_iters=8, f_iters=3, p_iters=2, t_iters=2, eps0=0.0,
                eps1=0.0, eps2=0.0)
    work = {}
    ref.sroa_solve_plain(*args, **caps, work=work)
    t, p, f = caps["t_iters"], caps["p_iters"], caps["f_iters"]
    assert work == {"inversions": t + (t + 1) * (p + 1) * (f + 1),
                    "f_steps": (t + 1) * (p + 1) * f,
                    "p_steps": (t + 1) * p, "t_steps": t}


def test_solve_wrapper_flattens_leading_axes(launches):
    """(2, 3, N) problems in one call == each problem alone, bitwise."""
    scn, a = _problem(5, 3)
    tscn = scenario_to_torch(scn)
    c = tsm.sroa_constants(tscn, _t(a))
    scale = _t(np.linspace(0.5, 1.5, 6, dtype=np.float32).reshape(2, 3, 1))
    per_user = [c.A * scale, c.J, c.H, c.delta, c.h, tscn.f_max, tscn.p_max]
    per_problem = [tscn.B_total, tscn.B_total, tscn.N0, 1.0,
                   c.E_cloud_total]
    out = ops.sroa_solve_batched(*per_user, *per_problem, **CAPS)
    assert out[0].shape == (2, 3, 5) and out[3].shape == (2, 3)
    one = ops.sroa_solve_batched(per_user[0][1, 2], *per_user[1:],
                                 *per_problem, **CAPS)
    for x, y in zip(out, one):
        assert_bitwise(x[1, 2], y)


# ------------------------------------------------------------------ K3
def _topk_case(P=None, N=9, M=4, seed=5):
    key = jax.random.PRNGKey(seed)
    shape = (N, M) if P is None else (P, N, M)
    gain = jnp.abs(jax.random.normal(key, shape)) * 1e-7 + 1e-9
    H = jnp.full(shape[:-1], 2.4e5)
    pm = jnp.full(shape[:-1], 0.2)
    assign = jax.random.randint(jax.random.PRNGKey(seed + 1), shape[:-1], 0,
                                M)
    return gain, H, pm, assign


def _compare_topk(args, k):
    want = jops.topk_move_scores(*args, k=k)
    got = ops.topk_move_scores(*(_t(x) if not isinstance(x, float) else x
                                 for x in args), k=k)
    for name, g, w in zip(("user", "dst"), got[:2], want[:2]):
        np.testing.assert_array_equal(host(g), host(w), err_msg=name)
        assert g.dtype == torch.int32
    np.testing.assert_allclose(host(got[2]), host(want[2]), rtol=1e-5)
    return got


def test_topk_plain_matches_pallas(launches):
    gain, H, pm, assign = _topk_case()
    mask = jnp.asarray([True] * 7 + [False, True])
    user, dst, _ = _compare_topk((gain, H, pm, assign, mask, 1e-17, 1e7), 6)
    assert (host(dst) != np.asarray(assign)[host(user)]).all()
    assert np.asarray(mask)[host(user)].all()


def test_topk_pads_when_few_valid(launches):
    gain = jnp.abs(jax.random.normal(jax.random.PRNGKey(7), (2, 2))) * 1e-8
    args = (gain, jnp.full((2,), 1e5), jnp.full((2,), 0.1),
            jnp.asarray([0, 1], jnp.int32), jnp.ones(2, bool), 1e-17, 1e7)
    _, _, score = _compare_topk(args, 5)
    score = host(score)
    assert (score[:2] < 1e29).all() and (score[2:] >= 1e29).all()


def test_topk_flattens_the_cell_axis(launches):
    P, k = 3, 4
    gain, H, pm, assign = _topk_case(P=P, N=6, M=3, seed=8)
    mask = jnp.ones((P, 6), bool).at[1, 2].set(False)
    args = (gain, H, pm, assign, mask, jnp.full((P,), 1e-17),
            jnp.full((P,), 1e7))
    user, dst, score = _compare_topk(args, k)
    assert user.shape == (P, k)
    for i in range(P):
        one = ops.topk_move_scores(*(_t(x[i]) for x in args), k=k)
        for x, y in zip((user, dst, score), one):
            assert_bitwise(x[i], y)


def _tie_heavy(P, N, M, seed):
    """numpy K3 operands full of equal scores: gains on a grid of three
    values, the second half of the users copies the first (gain, edge and
    mask), cell 1 is all masked and cell 2 has one active user (fewer legal
    moves than most k)."""
    rng = np.random.default_rng(seed)
    gain = rng.integers(1, 4, (P, N, M)).astype(np.float32) * 1e-8
    assign = rng.integers(0, M, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.8
    h = N // 2
    for x in (gain, assign, mask):
        x[:, N - h:] = x[:, :h]
    mask[1] = False
    mask[2] = False
    mask[2, N // 3] = True
    return (gain, np.full((P, N), 2.4e5, np.float32),
            np.full((P, N), 0.2, np.float32), assign, mask,
            np.full((P,), 1e-17, np.float32), np.full((P,), 1e7, np.float32))


@pytest.mark.parametrize("M", [1, 2, 5, 8])
@pytest.mark.parametrize("N", [1, 6, 31, 32, 33, 56, 64, 65, 128])
def test_warp_selection_model_is_the_twins_selection(N, M):
    """The warp kernel's lanes, +inf padding slots, cached minima, rounds
    of two minima over the lanes and owner knock-outs pick the twin's
    moves, bitwise, for every k (past the legal moves too).  Past the warp
    kernel's cap the model runs with ceil(N*M / 32) slots."""
    from repro_torch.kernels import topk_moves

    args = [torch.from_numpy(x) for x in _tie_heavy(4, N, M, 10 * N + M)]
    tile = ref.move_scores_plain(*args)
    S = (topk_moves.warp_slots(N, M)
         if N * M <= topk_moves.WARP_MAX_ENTRIES else -(-N * M // 32))
    for k in (1, 8, 32, 33, N * M + 3):
        idx, val = ref.topk_select_lanes_plain(tile, k, S)
        user, dst, score = ref.topk_moves_plain(*args, k=k)
        assert torch.equal(idx, user.long() * M + dst.long()), k
        assert_bitwise(val, score)


@pytest.mark.parametrize("N,M,route", [
    (56, 5, "warp"),            # the planning shape
    (1, 1, "warp"), (64, 8, "warp"), (512, 1, "warp"), (1, 512, "warp"),
    (128, 4, "warp"),           # at the cap: 16 entries a lane
    (65, 8, "cluster"), (513, 1, "cluster"), (129, 4, "cluster"),
    (300, 7, "cluster"),
    (58111, 1, "cluster"),      # the largest tile the block route took
    (2048, 16, "cluster"),      # the large-cell path
    (58112, 1, "cluster"), (4000, 15, "cluster"),   # past the block kernel
])
def test_k3_route(N, M, route):
    """A pure function of (N, M): no card; k does not choose (below the
    cluster kernel's cap)."""
    from repro_torch.kernels import topk_moves

    for k in (1, 8, N * M + 3):
        assert topk_moves.topk_route(N, M, k) == route


def test_k3_block_route_refuses_past_227_kb():
    """The route raises before any launch where the cluster kernel's
    shared memory passes 227 KB: 196,608 moves a cell at k >= 512, about
    1.8 million at k = 16.  Every tile the block kernel took fits, at any
    k; the block kernel, forced, still refuses past its own tile."""
    from repro_torch.kernels import topk_moves

    assert topk_moves.cluster_smem_bytes(196_608, 1, 512) <= 232_448
    with pytest.raises(ValueError, match="232448"):
        topk_moves.topk_route(196_609, 1, 512)
    with pytest.raises(ValueError, match="232448"):
        topk_moves.topk_route(2_000_000, 1, 16)
    for N, M in ((58111, 1), (1, 29056), (29055, 2), (3873, 15)):
        assert (N * M + M) * 4 <= 232_448
        assert topk_moves.cluster_smem_bytes(N, M, N * M + 3) <= 232_448
    # The block kernel's 36 static bytes: its largest cell is 58,102.
    topk_moves._plan(58102, 1, 8, "block")
    with pytest.raises(ValueError, match="232448"):
        topk_moves._plan(58103, 1, 8, "block")
    with pytest.raises(ValueError, match="232448"):
        topk_moves._plan(4000, 15, 8, "block")
    for bad in ((0, 5, 8), (56, 0, 8), (56, 5, 0)):
        with pytest.raises(ValueError, match=">= 1"):
            topk_moves.topk_route(*bad)


@pytest.mark.parametrize("N,M,S", [(56, 5, 9), (1, 1, 9), (32, 1, 9),
                                   (33, 1, 9), (6, 32, 9), (72, 4, 9),
                                   (73, 4, 16), (512, 1, 16), (64, 8, 16)])
def test_k3_warp_slots(N, M, S):
    from repro_torch.kernels import topk_moves

    assert topk_moves.warp_slots(N, M) == S


def test_k3_warp_slots_refuse_past_the_cap():
    from repro_torch.kernels import topk_moves

    with pytest.raises(ValueError, match="512"):
        topk_moves.warp_slots(65, 8)


def test_topk_tie_heavy_matches_pallas(launches):
    """Duplicated users, an all-masked cell and a cell with fewer legal
    moves than k, through the port's wrapper and the JAX kernel."""
    args = _tie_heavy(3, 33, 5, 11)
    k = 40                      # cell 2 has 4 legal moves
    user, dst, score = _compare_topk(tuple(jnp.asarray(x) for x in args),
                                     k)
    score = host(score)
    assert (score[1] >= 1e29).all() and (score[2, 4:] >= 1e29).all()
    assert (score[0] < 1e29).all()
    assert len(set(score[0].tolist())) < k      # ties among the picks


# ------------------------------------------------------------------ K4
def _qkv(shapes, dtype, seed):
    """numpy normals as (JAX, torch) pairs of one dtype: both round the
    same f32 values to bf16 to nearest even."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        x = rng.normal(size=shape).astype(np.float32)
        out.append((jnp.asarray(x, jnp.bfloat16 if dtype == "bf16"
                                else jnp.float32),
                    _t(x).to(torch.bfloat16 if dtype == "bf16"
                             else torch.float32)))
    return out


def _attention_ref(q, k, v, **kw):
    """JAX's oracle in the model layout (B, T, H, hd)."""
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    return t(jref.attention_ref(t(q), t(k), t(v), **kw))


def _close(got, want, tol):
    np.testing.assert_allclose(host(got.float()),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,T,hd", [
    (1, 1, 8, 64), (2, 4, 16, 64), (1, 2, 128, 128), (2, 2, 96, 80),
    (1, 4, 256, 112),
])
def test_flash_plain_matches_oracle(B, H, T, hd, dtype, launches):
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(B, T, H, hd)] * 3, dtype, T + hd)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.shape == (B, T, H, hd) and got.dtype == qt.dtype
    _close(got, _attention_ref(qj, kj, vj, causal=True),
           2e-2 if dtype == "bf16" else 2e-5)


@pytest.mark.parametrize("T", [64, 160])
@pytest.mark.parametrize("kw", [dict(causal=False),
                                dict(causal=True, window=16)])
def test_flash_plain_non_causal_and_window(T, kw, launches):
    """At T = 160 a query block's first key blocks lie wholly outside the
    window: the finite -1e30 folds exp(0) terms into the running sums and
    the next real block wipes them."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv([(1, T, 2, 64)] * 3, "f32", 1)
    _close(ops.flash_attention(qt, kt, vt, **kw),
           _attention_ref(qj, kj, vj, **kw), 2e-5)


def test_flash_plain_decode_offset(launches):
    """Tq = 1 with q_offset = S - 1 (a decode step against its context)."""
    S = 64
    (qj, qt), (kj, kt), (vj, vt) = _qkv(
        [(1, 1, 2, 64), (1, S, 2, 64), (1, S, 2, 64)], "f32", 2)
    _close(ops.flash_attention(qt, kt, vt, causal=True, q_offset=S - 1),
           _attention_ref(qj, kj, vj, causal=True, q_offset=S - 1), 2e-5)


def test_flash_plain_skips_blocks_past_the_causal_limit():
    """Key blocks past a query block's limit leave it untouched: poisoning
    them with NaN changes nothing (the TPU kernel never loads them)."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(rng.normal(size=(2, 130, 64)).astype(np.float32))
               for _ in range(3))
    want = ref.attention_plain(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 128:], v2[:, 128:] = float("nan"), float("nan")
    got = ref.attention_plain(q[:, :128], k2, v2, causal=True)
    assert_bitwise(got, want[:, :128])


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1, 512),
                                   (3, 33, 384)])
def test_rmsnorm_plain_matches_pallas(shape, dtype, launches):
    rng = np.random.default_rng(len(shape))
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=shape[-1]).astype(np.float32)
    want = jops.fused_rmsnorm(jnp.asarray(x, jdt), jnp.asarray(s, jdt))
    got = ops.fused_rmsnorm(_t(x).to(tdt), _t(s).to(tdt))
    assert got.shape == shape and got.dtype == tdt
    _close(got, want, 2e-2 if dtype == "bf16" else 1e-5)


@pytest.mark.parametrize("d", [1, 33, 1024, 1028])
def test_rmsnorm_plain_sums_in_the_kernels_order(d):
    """The sum of squares adds in K5's order: 16-byte chunks (4 f32 values)
    when they divide d, single elements otherwise; the result stays close
    to a plain mean (it is a reordering of the same sum)."""
    rng = np.random.default_rng(d)
    x = _t(rng.normal(size=(5, d)).astype(np.float32))
    s = _t(rng.normal(size=d).astype(np.float32))
    got = ref.rmsnorm_plain(x, s, 1e-6)
    vec = 4 if d % 4 == 0 else 1
    assert ref.rmsnorm_vec(d, torch.float32) == vec
    assert ref.rmsnorm_vec(d, torch.bfloat16) == (8 if d % 8 == 0 else 1)
    var = ref.chunk_sum_plain(x * x, vec) / torch.tensor(float(d))
    assert_bitwise(got, x * torch.rsqrt(var + 1e-6) * s)
    var = (x.double() ** 2).mean(-1, keepdim=True)
    want = x.double() * torch.rsqrt(var + 1e-6) * s.double()
    np.testing.assert_allclose(host(got), host(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,vec", [(1, 1), (33, 1), (1028, 1), (1024, 4),
                                   (1028, 4), (1024, 8), (8192, 8), (24, 8)])
def test_chunk_sum_plain_adds_in_the_kernels_order(N, vec):
    """K5's lanes, one step at a time: lane l adds chunks l, l + 32, ...
    of ``vec`` elements, each chunk's elements in order, then butterflies
    over lanes l ^ 16, 8, 4, 2, 1."""
    rng = np.random.default_rng(N + vec)
    x = np.asarray(rng.uniform(0, 1e3, (2, N)) * 10.0 ** rng.integers(
        -3, 4, (2, N)), np.float32)
    n_chunks = -(-N // vec)
    want = np.empty((2, 1), np.float32)
    for r in range(2):
        lane = [np.float32(0.0)] * 32
        for c in range(n_chunks):
            for e in range(vec):
                if c * vec + e < N:
                    lane[c % 32] = np.float32(lane[c % 32] + x[r, c * vec + e])
        for off in (16, 8, 4, 2, 1):
            lane = [np.float32(lane[i] + lane[i ^ off]) for i in range(32)]
        assert len(set(lane)) == 1            # every lane ends equal
        want[r, 0] = lane[0]
    assert_bitwise(ref.chunk_sum_plain(_t(x), vec), want)


# ------------------------------------------------------------ K4 route
_CONTIG = (4096, 1024, 64)     # (B, T, H, hd) = (., 64, 16, 64) strides


@pytest.mark.parametrize("dtype,hd,strides,ptrs,route", [
    (torch.bfloat16, 64, _CONTIG * 4, (0, 1 << 20, 2 << 20, 3 << 20),
     "wgmma"),
    (torch.bfloat16, 128, _CONTIG * 4, (256,) * 4, "wgmma"),
    (torch.bfloat16, 80, (7680, 480, 80) * 4, (512,) * 4, "wgmma"),
    (torch.bfloat16, 112, (7168, 448, 112) * 4, (512,) * 4, "wgmma"),
    (torch.bfloat16, 8, (512, 64, 8) * 4, (512,) * 4, "wgmma"),
    # the fused (B, T, 3, H, hd) projection's views: strides of 3 H hd
    (torch.bfloat16, 64, (3 * 70 * 256, 768, 64) * 3 + (70 * 256, 256, 64),
     (512, 512 + 512, 512 + 1024, 4096), "wgmma"),
    (torch.float32, 64, _CONTIG * 4, (512,) * 4, "tf32"),
    (torch.float16, 64, _CONTIG * 4, (512,) * 4, "simt"),
    (torch.bfloat16, 136, (8704, 544, 136) * 4, (512,) * 4, "wgmma"),
    (torch.bfloat16, 256, _CONTIG * 4, (512,) * 4, "wgmma"),
    (torch.bfloat16, 0, _CONTIG * 4, (512,) * 4, "simt"),
    (torch.bfloat16, 36, (2304, 144, 36) * 4, (512,) * 4, "simt"),
    (torch.bfloat16, 64, (4096, 1028, 64) + _CONTIG * 3, (512,) * 4, "simt"),
    (torch.bfloat16, 64, (4096, 1024, 0) + _CONTIG * 3, (512,) * 4, "simt"),
    (torch.bfloat16, 64, _CONTIG * 4, (512, 520, 512, 512), "simt"),
    (torch.bfloat16, 64, _CONTIG * 4, (512, 512, 512, 514), "simt"),
    # f32: 16-byte strides are multiples of 4 elements; hd up to 128.
    (torch.float32, 64, (4096, 1026, 64) + _CONTIG * 3, (512,) * 4, "simt"),
    (torch.float32, 36, (2304, 144, 36) * 4, (512,) * 4, "tf32"),
    (torch.float32, 128, (24 * 128, 128, 128) * 4, (512,) * 4, "tf32"),
    (torch.float32, 160, (2560, 320, 160) * 4, (512,) * 4, "simt"),
    (torch.float32, 64, _CONTIG * 4, (512, 520, 512, 512), "simt"),
    (torch.bfloat16, 192, (6144, 1536, 192) * 4, (512,) * 4, "wgmma"),
    (torch.bfloat16, 257, (8224, 2056, 257) * 4, (512,) * 4, "simt"),
])
def test_k4_routing_rule(dtype, hd, strides, ptrs, route):
    """bf16 with 0 < hd <= 256 takes the wgmma kernel and f32 with 0 < hd
    <= 128 the 3xTF32 one, each when every non-head-dim stride is a
    positive multiple of 16 bytes and every base 16-byte aligned;
    everything else goes to the SIMT kernel (hd 257 then raises before any
    launch: ``MAX_HEAD_DIM``).  A pure function: no card."""
    from repro_torch.kernels import flash_attention as fa

    assert fa.route(dtype, hd, strides, ptrs) == route
    assert fa.MAX_HEAD_DIM == 256


# ------------------------------------------------------------- dispatch
def test_wrappers_refuse_devices_without_a_kernel_route():
    x = torch.ones(4, device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        ops.sroa_invert_rate(x, x, 1.0)
    # A call whose operands lie on two devices raises, whichever device
    # holds the first operand: it never copies them onto one and runs.
    cpu, other = torch.ones(1, 4), torch.ones(1, 4, device="meta")
    calls = [
        lambda a, b: ops.sroa_invert_rate(a[0], b[0], 1.0),
        lambda a, b: ops.sroa_invert_rate_batched(a, b, 1.0),
        lambda a, b: ops.sroa_solve_batched(a, a, a, a, b, a, a, 1.0, 1.0,
                                            1.0, 1.0, 0.0),
        lambda a, b: ops.topk_move_scores(a[..., None], b, a, a.int(),
                                          a.bool(), 1.0, 1.0, k=1),
        lambda a, b: ops.flash_attention(a[:, None, None], b[:, None, None],
                                         a[:, None, None]),
        lambda a, b: ops.fused_rmsnorm(a, b[0]),
    ]
    for call in calls:
        for a, b in ((cpu, other), (other, cpu)):
            with pytest.raises(ValueError, match="one device"):
                call(a, b)


def test_build_names_the_library_by_source_and_flags(tmp_path):
    srcs = sorted(build.CSRC.glob("*.cu"))
    assert [s.name for s in srcs] == ["flash_attention.cu",
                                      "flash_attention_sm90.cu",
                                      "flash_attention_sm90_f32.cu",
                                      "rmsnorm.cu", "sroa_bisect.cu",
                                      "ssm_scan.cu", "topk_moves.cu"]
    d1 = build._digest(srcs, build.NVCC_FLAGS)
    assert d1 == build._digest(srcs, list(build.NVCC_FLAGS))
    assert d1 != build._digest(srcs, build.NVCC_FLAGS + ["-G"])
    # The shared header is hashed with the sources (it is not compiled).
    assert [h.name for h in build.headers()] == ["cluster.cuh",
                                                 "fast_math.cuh",
                                                 "sm90.cuh"]
    assert d1 != build._digest(srcs + build.headers(), build.NVCC_FLAGS)
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
