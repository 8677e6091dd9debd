"""The port's hand-written CUDA kernels (K1-K5, and S1-S3 and their
backward S1b-S3b for the recurrences) against their plain PyTorch twins,
on a card (K2's and K3's two kernels and every speculation depth of K1
and K2 bitwise; on the sequential route S1's state and S1b's d s0
bitwise; S1's and S1b's chunked kernels against the sequential twins and
their chunked model, S2b's chunked kernel likewise, S3b's short step and
the barrier S3b beside them), and the served paths on the card against
the CPU (the trainer, the moe model and its dispatch, the hybrid and
xlstm models), distributed HFL on NCCL and gloo against one process, and
the dry-run's argument bytes against what the card allocates.  Every
test here is marked ``cuda`` and skips itself when
``torch.cuda.is_available()`` is false; this file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import wireless  # noqa: E402
from repro_torch.core.system_model import (expand_scenario,  # noqa: E402
                                           sroa_constants)
from repro_torch.fleet import batch, engine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

CAPS = dict(b_iters=30, f_iters=24, p_iters=20, t_iters=28)
SPEC = dataclasses.replace(wireless.ScenarioSpec(), N=12, M=3)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def fleet(cuda):
    return batch.draw_fleet(3, 4, SPEC, n_range=(6, 12), device=cuda)


_K4_ROUTES = {"wgmma": "flash_attention_sm90",
              "tf32": "flash_attention_sm90_f32"}


def _launched(name, fn, route=None):
    """fn's result; fn launched kernel ``name`` once and, for K4, took the
    kernel of ``route``: "wgmma" (bf16 tensor cores), "tf32" (f32 tensor
    cores) or "simt"."""
    n0 = ops.LAUNCHES[name]
    k4 = {r: ops.LAUNCHES[c] for r, c in _K4_ROUTES.items()}
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n0 + 1
    if route is not None:
        for r, c in _K4_ROUTES.items():
            assert ops.LAUNCHES[c] == k4[r] + int(route == r), (route, c)
    return out


def _k4_route(dt, hd):
    """The kernel K4's rule picks for contiguous operands."""
    if dt == torch.bfloat16:
        return "wgmma"
    return "tf32" if hd <= 128 else "simt"


@pytest.mark.cuda
def test_k1_matches_its_twin(cuda):
    rng = np.random.default_rng(0)
    G = torch.tensor(rng.uniform(1e3, 1e9, (3, 17)), dtype=torch.float32,
                     device=cuda)
    tgt = G * torch.tensor(rng.uniform(0, 1.3, (3, 17)), dtype=torch.float32,
                           device=cuda) / np.log(2.0)
    bm = torch.full((3,), 1e7, device=cuda)
    got = _launched("sroa_invert",
                    lambda: ops.sroa_invert_rate_batched(G, tgt, bm))
    assert torch.equal(got, ref.invert_rate_plain(G, tgt, bm[:, None], 42))
    got = _launched("sroa_invert",
                    lambda: ops.sroa_invert_rate(G[0], tgt[0], 1e6))
    assert torch.equal(got, ref.invert_rate_plain(G[0], tgt[0], 1e6, 42))


@pytest.mark.cuda
def test_k2_matches_its_twin_and_is_batch_independent(fleet):
    cells, mask = fleet.cells, fleet.mask
    init = batch.fleet_assignments(fleet)
    cands, _ = engine._pruned_candidates(cells, init, mask, 4)
    cs = expand_scenario(cells, 1)
    c = sroa_constants(cs, cands, mask[:, None, :])
    args = (c.A, c.J, c.H, c.delta, c.h, cs.f_max, cs.p_max, cs.B_open,
            cs.B_open, cs.N0, 1.0, c.E_cloud_total)
    lanes = ops.LAUNCHES["sroa_solve_lanes"]
    got = _launched("sroa_solve",
                    lambda: ops.sroa_solve_batched(*args, **CAPS))
    assert ops.LAUNCHES["sroa_solve_lanes"] == lanes + 1
    P = cands.shape[0] * cands.shape[1]
    flat = [torch.broadcast_to(torch.as_tensor(x, device=cands.device),
                               cands.shape[:2] + (cands.shape[2],)
                               ).reshape(P, -1).contiguous()
            for x in args[:7]]
    flat += [torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32,
                                                device=cands.device),
                                cands.shape[:2]).reshape(P).contiguous()
             for x in args[7:]]
    want = ref.sroa_solve_plain(*flat, **CAPS)
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    alone = ops.sroa_solve_batched(*(x[5:6] for x in flat), **CAPS)
    for g, a in zip(got, alone):
        assert torch.equal(g.reshape((P,) + g.shape[2:])[5:6], a)


def _k2_problems(fleet, top_k):
    """One engine round's (P, N) and (P,) K2 operands for ``fleet``."""
    cells, mask = fleet.cells, fleet.mask
    init = batch.fleet_assignments(fleet)
    cands, _ = engine._pruned_candidates(cells, init, mask, top_k)
    cs = expand_scenario(cells, 1)
    c = sroa_constants(cs, cands, mask[:, None, :])
    C, A, N = cands.shape
    ones = torch.ones((), device=cands.device)
    per_user = [torch.broadcast_to(x, (C, A, N)).reshape(C * A, N)
                .contiguous() for x in (c.A, c.J, c.H, c.delta, c.h,
                                        cs.f_max, cs.p_max)]
    per_problem = [torch.broadcast_to(x, (C, A)).reshape(C * A).contiguous()
                   for x in (cs.B_open, cs.B_open, cs.N0, ones,
                             c.E_cloud_total)]
    return per_user, per_problem


# Odd b_iters, so every depth runs its remainder rounds.
SWEEP_CAPS = dict(b_iters=31, f_iters=12, p_iters=10, t_iters=12)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [12, 33, 56, 64, 65, 200])
def test_k2_lanes_matches_pr11_kernel_and_twin(cuda, N):
    """The lanes K2 at every speculation depth, PR 11's kernel and the twin
    give the same bits; N = 12 is the fixture's 6-12 users (padding), the
    others one W = 1-7 warps a problem."""
    from repro_torch.kernels import sroa_bisect

    n_range = (6, 12) if N == 12 else (N, N)
    spec = dataclasses.replace(wireless.ScenarioSpec(), N=N, M=3)
    fleet = batch.draw_fleet(N, 3, spec, n_range=n_range, device=cuda)
    per_user, per_problem = _k2_problems(fleet, 2)
    kw = dict(SWEEP_CAPS, eps0=1e-4, eps1=1e-4, eps2=1e-4, t_low=1.0,
              t_up=3e7)
    want = ref.sroa_solve_plain(*per_user, *per_problem, **kw)
    routes = [("warp", 0)] + [("lanes", d) for d in sroa_bisect.DEPTHS]
    for route in routes:
        got, ran = sroa_bisect.solve_cuda(tuple(per_user),
                                          tuple(per_problem), **kw,
                                          _route=route)
        assert ran == route
        for g, w in zip(got, want):
            assert torch.equal(g, w), route


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_k2_lanes_alone_equals_in_batch(fleet, depth):
    from repro_torch.kernels import sroa_bisect

    per_user, per_problem = _k2_problems(fleet, 4)
    kw = dict(CAPS, eps0=1e-4, eps1=1e-4, eps2=1e-4, t_low=1.0, t_up=3e7)
    got, _ = sroa_bisect.solve_cuda(tuple(per_user), tuple(per_problem),
                                    **kw, _route=("lanes", depth))
    P = per_user[0].shape[0]
    for q in (0, P // 2, P - 1):
        alone, _ = sroa_bisect.solve_cuda(
            tuple(x[q:q + 1].contiguous() for x in per_user),
            tuple(x[q:q + 1].contiguous() for x in per_problem), **kw,
            _route=("lanes", depth))
        for g, a in zip(got, alone):
            assert torch.equal(g[q:q + 1], a)


def _k2_cell(N, seed, device, P=2):
    """K2's (P, N) and (P,) operands: draw_scenario's nearest-edge pattern
    at M = 16, the second problem with a scaled energy weight."""
    spec = dataclasses.replace(wireless.ScenarioSpec(), N=N, M=16)
    scn = wireless.draw_scenario(seed, spec, device=device)
    c = sroa_constants(scn, wireless.nearest_edge_assignment(scn))
    scale = torch.linspace(1.0, 1.7, P, device=device)[:, None]
    per_user = [(c.A * scale).contiguous()] + [
        x.expand(P, N).contiguous() for x in (c.J, c.H, c.delta, c.h,
                                               scn.f_max, scn.p_max)]
    one = torch.ones(P, device=device)
    per_problem = [scn.B_open * one, scn.B_open * one, scn.N0 * one, one,
                   c.E_cloud_total * one]
    return per_user, per_problem


@pytest.mark.cuda
@pytest.mark.parametrize("N", [513, 600, 2048, 4096])
def test_k2_cluster_matches_its_twin(cuda, N):
    """The cluster K2 at every speculation depth gives the twin's bits, and
    the one-warp kernel's where it runs (N <= 3632); the routed call takes it
    and counts it."""
    from repro_torch.kernels import sroa_bisect

    per_user, per_problem = _k2_cell(N, N, cuda)
    kw = dict(SWEEP_CAPS, eps0=1e-4, eps1=1e-4, eps2=1e-4, t_low=1.0,
              t_up=3e7)
    want = ref.sroa_solve_plain(*per_user, *per_problem, **kw)
    routes = [("cluster", d) for d in sroa_bisect.DEPTHS]
    if N <= sroa_bisect.WARP_MAX_N:
        routes.append(("warp", 0))
    for route in routes:
        got, ran = sroa_bisect.solve_cuda(tuple(per_user),
                                          tuple(per_problem), **kw,
                                          _route=route)
        assert ran == route
        for g, w in zip(got, want):
            assert torch.equal(g, w), route
    c0 = ops.LAUNCHES["sroa_solve_cluster"]
    got = _launched("sroa_solve", lambda: ops.sroa_solve_batched(
        *per_user, *per_problem, **SWEEP_CAPS))
    assert ops.LAUNCHES["sroa_solve_cluster"] == c0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [30, 31, 42, 1])
@pytest.mark.parametrize("depth", [1, 2])
def test_k1_matches_its_twin_at_every_depth(cuda, depth, iters):
    """Feasible and infeasible caps, tau <= 0's 1e30 target, 0, -0, a
    subnormal, +inf and zero G."""
    from repro_torch.kernels import sroa_bisect

    rng = np.random.default_rng(depth + iters)
    G = rng.uniform(1e3, 1e10, 4096).astype(np.float32)
    tgt = (G * rng.uniform(0, 1.3, 4096) / np.log(2.0)).astype(np.float32)
    tgt[:6] = [1e30, 0.0, -0.0, 1e-40, np.inf, 1e12]
    G[6] = 0.0
    bm = rng.uniform(1e5, 2e7, 4096).astype(np.float32)
    G, tgt, bm = (torch.tensor(x, device=cuda) for x in (G, tgt, bm))
    got = sroa_bisect.invert_rate_cuda(G, tgt, bm, iters, _depth=depth)
    assert torch.equal(got, ref.invert_rate_plain(G, tgt, bm, iters))


@pytest.mark.cuda
def test_branch_free_math_is_the_toolkits(cuda):
    """K1/K2's branch-free log1pf on every float of [+0, FLT_MAX] and their
    branch-free division on 2^32 hashed pairs of its range, bitwise the
    toolkit's."""
    from repro_torch.kernels import sroa_bisect

    assert sroa_bisect.math_check(cuda) == (0, 0)


@pytest.mark.cuda
def test_k2_routes_by_shape_and_refuses_bad_routes(cuda):
    from repro_torch.kernels import sroa_bisect

    one = torch.ones((2, 600), device=cuda)
    per_user = (one,) * 7
    per_problem = (one[:, 0].contiguous(),) * 5
    kw = dict(b_iters=2, f_iters=1, p_iters=1, t_iters=1, eps0=1e-4,
              eps1=1e-4, eps2=1e-4, t_low=1.0, t_up=3e7)
    _, ran = sroa_bisect.solve_cuda(per_user, per_problem, **kw)
    assert ran == ("cluster", 2)
    with pytest.raises(ValueError, match="lanes"):
        sroa_bisect.solve_cuda(per_user, per_problem, **kw,
                               _route=("lanes", 1))
    small = tuple(x[..., :56].contiguous() for x in per_user)
    with pytest.raises(ValueError, match="depth"):
        sroa_bisect.solve_cuda(small, per_problem, **kw, _route=("lanes", 3))
    with pytest.raises(ValueError, match="depth"):
        sroa_bisect.invert_rate_cuda(one[0], one[0], one[0], 8, _depth=3)
    # Each kernel's cap raises before anything is allocated or launched.
    big = torch.ones((1, 4097), device=cuda)
    with pytest.raises(ValueError, match="4096.*fused=False"):
        sroa_bisect.solve_cuda((big,) * 7, (big[:, 0].contiguous(),) * 5,
                               **kw)
    mid = tuple(x[..., :3633].contiguous() for x in (big,) * 7)
    with pytest.raises(ValueError, match="3632"):
        sroa_bisect.solve_cuda(mid, (big[:, 0].contiguous(),) * 5, **kw,
                               _route=("warp", 0))


@pytest.mark.cuda
def test_k3_matches_its_twin(fleet):
    cells = fleet.cells
    init = batch.fleet_assignments(fleet)
    args = (cells.gain, engine._move_H(cells), cells.p_max, init,
            fleet.mask, cells.N0, cells.B_open)
    w0 = ops.LAUNCHES["topk_moves_warp"]
    got = _launched("topk_moves",
                    lambda: ops.topk_move_scores(*args, k=6))
    assert ops.LAUNCHES["topk_moves_warp"] == w0 + 1     # N*M <= 512
    want = ref.topk_moves_plain(*(x.contiguous() for x in args), k=6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _k3_operands(P, N, M, seed, device):
    """K3 operands full of equal scores, made with numpy: gains on a grid of
    three values, the second half of the users a copy of the first; cell 1
    all masked and cell 2 with one active user (where P allows)."""
    rng = np.random.default_rng(seed)
    gain = rng.integers(1, 4, (P, N, M)).astype(np.float32) * 1e-8
    assign = rng.integers(0, M, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.8
    h = N // 2
    for x in (gain, assign, mask):
        x[:, N - h:] = x[:, :h]
    if P > 2:
        mask[1:3] = False
        mask[2, N // 3] = True
    arrays = (gain, np.full((P, N), 2.4e5, np.float32),
              np.full((P, N), 0.2, np.float32), assign, mask,
              np.full((P,), 1e-17, np.float32), np.full((P,), 1e7, np.float32))
    return [torch.from_numpy(x).to(device) for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 1152])
@pytest.mark.parametrize("M", [1, 2, 5, 8])
@pytest.mark.parametrize("N", [1, 6, 31, 32, 33, 56, 64, 65, 128])
def test_k3_warp_and_block_kernels_match_the_twin(cuda, N, M, P):
    """Every kernel gives the twin's user, dst and score (torch.equal) for
    every k, past the legal moves too (the warp kernel up to N*M = 512;
    the cluster kernel on one block's cluster here)."""
    from repro_torch.kernels import topk_moves as tk

    args = _k3_operands(P, N, M, 10 * N + M, cuda)
    for k in (1, 8, 32, 33, N * M + 3):
        want = ref.topk_moves_plain(*args, k=k)
        outs = [tk.topk_moves_cuda(*args, k, _route=r)
                for r in ("block", "cluster")]
        if N * M <= tk.WARP_MAX_ENTRIES:
            outs.append(tk.topk_moves_cuda(*args, k, _route="warp"))
        torch.cuda.synchronize()
        for got, route in outs:
            for g, w in zip(got, want):
                assert torch.equal(g, w), (route, k)


def _k3_off_range(P, N, M, case, device):
    """K3 operands that send the warp kernel's slots off its branch-free
    division and log1pf (csrc/fast_math.cuh) onto the toolkit's.
    "operands": in every cell a tenth of the gains are 1e-30 (g p_max 2^t
    and log1p below 2^-60) and user 0's are, one gain is 0 (fast), one
    1e30 (g p_max / noise = inf), user 1 has H = 1e30 and user 2 H = 1e-30
    (H outside [2^-60, 2^80]), with ordinary gains.  "noise": every other
    cell has N0 = 1e-3 and B = 1e25 (B past 2^80, and noise past 2^60, so
    each of its slots is off the range).  Made with numpy."""
    gain, H, p_max, assign, mask, N0, B = (
        x.cpu().numpy().copy() for x in _k3_operands(P, N, M, N + M, "cpu"))
    rng = np.random.default_rng(7 * N + M)
    if case == "operands":
        gain[rng.random(gain.shape) < 0.1] = 1e-30
        gain[:, 0] = 1e-30
        if N > 2:
            gain[:, 1:3] = 2e-8
            H[:, 1], H[:, 2] = 1e30, 1e-30
        gain[:, -1, 0] = 0.0
        gain[:, N // 2, M - 1] = 1e30
    else:
        N0[::2], B[::2] = 1e-3, 1e25
    arrays = (gain, H, p_max, assign, mask, N0, B)
    return [torch.from_numpy(x).to(device) for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["operands", "noise"])
@pytest.mark.parametrize("P", [1, 1152])
@pytest.mark.parametrize("N,M", [(6, 5), (56, 5), (64, 8)])
def test_k3_warp_kernel_off_its_fast_ranges(cuda, N, M, P, case):
    """Slots whose operands leave the branch-free ranges (several a lane,
    or every slot of a cell) give the twin's and the block kernel's user,
    dst and score (torch.equal)."""
    from repro_torch.kernels import topk_moves as tk

    args = _k3_off_range(P, N, M, case, cuda)
    assert not ref.move_scores_plain(*args).isnan().any()
    for k in (8, N * M + 3):
        want = ref.topk_moves_plain(*args, k=k)
        warp, route = tk.topk_moves_cuda(*args, k, _route="warp")
        blk, _ = tk.topk_moves_cuda(*args, k, _route="block")
        clu, _ = tk.topk_moves_cuda(*args, k, _route="cluster")
        assert route == "warp"
        for g, b, c, w in zip(warp, blk, clu, want):
            assert torch.equal(g, w) and torch.equal(b, w) \
                and torch.equal(c, w), (k, case)


def _k3_large(P, N, M, seed, device, active=None):
    """Ordinary K3 operands made with numpy; ``active`` users of each cell
    active, the rest masked (fewer legal moves than k)."""
    rng = np.random.default_rng(seed)
    gain = (np.abs(rng.normal(size=(P, N, M))) * 1e-7 + 1e-9).astype(
        np.float32)
    H = rng.uniform(1e5, 4e5, (P, N)).astype(np.float32)
    assign = rng.integers(0, M, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.9
    if active is not None:
        mask[:] = False
        mask[:, :active] = True
    arrays = (gain, H, np.full((P, N), 0.2, np.float32), assign, mask,
              np.full((P,), 1e-17, np.float32), np.full((P,), 1e7, np.float32))
    return [torch.from_numpy(x).to(device) for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("P,N,M", [(2, 2048, 16), (128, 128, 5),
                                   (1, 58111, 1)])
def test_k3_cluster_matches_its_twin(cuda, P, N, M):
    """The cluster K3 (the route past N*M = 512) gives the twin's user, dst
    and score and the block kernel's (where its tile fits: not at 58,111
    entries, whose 36 static bytes it never counted), at k = 16 and past
    the legal moves (a tie-heavy cell of one active user, an all-masked
    one, and cells of two active users); the routed call counts it."""
    from repro_torch.kernels import topk_moves as tk

    cases = [(_k3_large(P, N, M, N + M, cuda), 16),
             (_k3_large(P, N, M, N + M + 1, cuda, active=2), 2 * M + 3)]
    if P > 2:
        cases.append((_k3_operands(P, N, M, N + M, cuda), 40))
    for args, k in cases:
        want = ref.topk_moves_plain(*args, k=k)
        c0 = ops.LAUNCHES["topk_moves_cluster"]
        got = _launched("topk_moves",
                        lambda: ops.topk_move_scores(*args, k=k))
        assert ops.LAUNCHES["topk_moves_cluster"] == c0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w), k
        if tk.block_smem_bytes(N, M) <= tk.SMEM_MAX:
            blk, _ = tk.topk_moves_cuda(*args, k, _route="block")
            for b, w in zip(blk, want):
                assert torch.equal(b, w), k


@pytest.mark.cuda
def test_k3_cluster_shared_memory_is_the_routes(cuda):
    """The launcher's shared bytes a block equal cluster_smem_bytes, the
    figure the route's cap reads."""
    from repro_torch.kernels import build
    from repro_torch.kernels import topk_moves as tk

    lib = build.load()
    for N, M, k in ((2048, 16, 16), (65, 8, 1), (58111, 1, 40),
                    (1, 29056, 10 ** 6), (196_608, 1, 512), (600, 4, 40)):
        assert lib.topk_moves_cluster_smem(N, M, k) == \
            tk.cluster_smem_bytes(N, M, k)


@pytest.mark.cuda
def test_k3_on_the_readme_fleet(cuda):
    """draw_fleet(0, 128): every launch takes the warp kernel, and it equals
    the block kernel and the twin."""
    from repro_torch.kernels import topk_moves as tk

    big = batch.draw_fleet(0, 128, device=cuda)
    cells = big.cells
    args = [x.contiguous() for x in (
        cells.gain, engine._move_H(cells), cells.p_max,
        batch.fleet_assignments(big), big.mask, cells.N0, cells.B_open)]
    w0 = ops.LAUNCHES["topk_moves_warp"]
    got = _launched("topk_moves", lambda: ops.topk_move_scores(*args, k=8))
    assert ops.LAUNCHES["topk_moves_warp"] == w0 + 1
    blk, route = tk.topk_moves_cuda(*args, 8, _route="block")
    assert route == "block"
    want = ref.topk_moves_plain(*args, k=8)
    for g, b, w in zip(got, blk, want):
        assert torch.equal(g, w) and torch.equal(b, w)


@pytest.mark.cuda
def test_k3_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import topk_moves as tk

    args = _k3_operands(2, 65, 8, 0, cuda)          # N*M = 520 > 512
    with pytest.raises(ValueError, match="512"):
        tk.topk_moves_cuda(*args, 4, _route="warp")
    with pytest.raises(ValueError, match="no K3 kernel"):
        tk.topk_moves_cuda(*args, 4, _route="lanes")
    _, route = tk.topk_moves_cuda(*args, 4)
    assert route == "cluster"
    big = _k3_operands(1, 58112, 1, 0, cuda)        # 232,452 bytes of tile
    with pytest.raises(ValueError, match="232448"):
        tk.topk_moves_cuda(*big, 4, _route="block")
    _, route = tk.topk_moves_cuda(*big, 4)
    assert route == "cluster"
    huge = _k3_operands(1, 196_609, 1, 0, cuda)     # past the cluster cap
    with pytest.raises(ValueError, match="232448"):
        tk.topk_moves_cuda(*huge, 512)
    small = _k3_operands(2, 6, 5, 0, cuda)
    with pytest.raises(ValueError, match="assign"):
        tk.topk_moves_cuda(*small[:3], small[3].long(), *small[4:], 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        tk.topk_moves_cuda(*small[:6], small[6].cpu(), 4)


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


def _attention_plain(q, k, v, **kw):
    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(ref.attention_plain(t(q), t(k), t(v), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,hd", [
    (1, 1, 8, 64), (2, 4, 16, 64), (1, 2, 128, 128), (2, 2, 96, 80),
    (1, 4, 256, 112), (1, 2, 70, 256),
])
def test_k4_matches_its_twin(cuda, B, H, T, hd, dtype):
    """The JAX flash sweep's shapes plus hd 256: 2e-5 in f32, 2e-2 in bf16
    (exp and the summation order differ from the twin's).  bf16 takes the
    wgmma kernel at every hd, f32 the 3xTF32 one up to hd 128 and the SIMT
    one at hd 256."""
    dt = getattr(torch, dtype)
    q, k, v = (_randn((B, T, H, hd), dt, cuda, T + hd + i) for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    route=_k4_route(dt, hd))
    assert got.dtype == dt and got.shape == (B, T, H, hd)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(),
                               _attention_plain(q, k, v, causal=True).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw,Tq,Tk", [
    (dict(causal=False), 64, 64),
    (dict(causal=True, window=16), 160, 160),
    (dict(causal=True, q_offset=63), 1, 64),
    (dict(causal=True, q_offset=100), 30, 130),
])
def test_k4_masks_and_offsets(cuda, kw, Tq, Tk, dtype):
    """f32 runs on the 3xTF32 kernel (2e-5), bf16 on the wgmma kernel
    (2e-2): their non-causal, window, q_offset and Tq != Tk paths."""
    dt = getattr(torch, dtype)
    q = _randn((2, Tq, 3, 64), dt, cuda, 1)
    k = _randn((2, Tk, 3, 64), dt, cuda, 2)
    v = _randn((2, Tk, 3, 64), dt, cuda, 3)
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, **kw),
                    route=_k4_route(dt, 64))
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(),
                               _attention_plain(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [(4, 1024, 16, 64), (1, 1024, 24, 128),
                                     (4, 1024, 40, 128)])
def test_k4_takes_the_tensor_cores_at_the_model_shapes(cuda, B, T, H, hd):
    """qwen1.5-0.5b's prefill (hd 64), llama3.2-3b's heads and
    llama4-scout's prefill (hd 128, 40 heads after the GQA repeat): in bf16
    the wgmma kernel, held to the twin at 2e-2; in f32 the 3xTF32 one."""
    q, k, v = (_randn((B, T, H, hd), torch.bfloat16, cuda, 7 + i)
               for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    route="wgmma")
    torch.testing.assert_close(
        got.float(), _attention_plain(q, k, v, causal=True).float(),
        rtol=2e-2, atol=2e-2)
    f = q[:1, :128].float()
    _launched("flash_attention",
              lambda: ops.flash_attention(f, f, f, causal=True),
              route="tf32")


@pytest.mark.cuda
def test_k4_reads_strided_operands(cuda):
    """q, k and v as views of one fused (B, T, 3, H, hd) projection: the
    kernel addresses them through their strides."""
    qkv = _randn((2, 70, 3, 4, 64), torch.bfloat16, cuda, 4)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    route="wgmma")
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [(4, 1024, 16, 64), (1, 1024, 24, 128)])
def test_k4_f32_takes_the_tensor_cores_at_the_model_shapes(cuda, B, T, H,
                                                            hd):
    """qwen1.5-0.5b's prefill and llama3.2-3b's heads in f32: the 3xTF32
    kernel, held to the twin at 2e-5."""
    q, k, v = (_randn((B, T, H, hd), torch.float32, cuda, 11 + i)
               for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    route="tf32")
    torch.testing.assert_close(got, _attention_plain(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [160, 192, 256])
@pytest.mark.parametrize("kw,Tq,Tk", [
    (dict(causal=True), 200, 200),
    (dict(causal=True, window=48), 160, 160),
    (dict(causal=True, q_offset=100), 30, 130),
])
def test_k4_bf16_wide_heads_on_the_tensor_cores(cuda, hd, kw, Tq, Tk):
    """bf16 with hd in (128, 256] on the wgmma kernel (hd 160 pads to the
    192 template through TMA's zero fill), at 2e-2 against the twin: the
    causal tail, a window and a query offset with Tq != Tk."""
    q = _randn((2, Tq, 3, hd), torch.bfloat16, cuda, 21)
    k = _randn((2, Tk, 3, hd), torch.bfloat16, cuda, 22)
    v = _randn((2, Tk, 3, hd), torch.bfloat16, cuda, 23)
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, **kw),
                    route="wgmma")
    assert got.shape == (2, Tq, 3, hd)
    torch.testing.assert_close(got.float(),
                               _attention_plain(q, k, v, **kw).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_k4_f32_unaligned_views_take_the_simt_kernel(cuda):
    """f32 q, k, v as views of one fused (B, T, 3, H, 65) tensor cut to hd
    64: a time stride of 780 elements is no multiple of 16 bytes, so the
    rule sends them to the SIMT kernel, which reads them through their
    strides (2e-5 against the twin)."""
    qkv = _randn((2, 70, 3, 4, 65), torch.float32, cuda, 31)[..., :64]
    q, k, v = qkv.unbind(2)
    assert q.stride(1) == 780
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    route="simt")
    torch.testing.assert_close(got, _attention_plain(q, k, v, causal=True),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128), (2, 7, 256), (1, 1, 512),
                                   (3, 33, 384), (64, 1024), (2, 8192),
                                   (3, 4100), (4, 36)])
def test_k5_matches_its_twin(cuda, shape, dtype):
    """Bitwise: the twin adds in the kernel's order (16-byte chunks, or
    single elements where d is not a multiple of the vector), and rsqrtf is
    torch.rsqrt on the card.  d 8192 keeps a bf16 row in registers and
    reads an f32 one twice; 4100 and 36 take bf16's scalar path."""
    dt = getattr(torch, dtype)
    x = _randn(shape, dt, cuda, 5)
    s = _randn(shape[-1:], dt, cuda, 6)
    got = _launched("rmsnorm", lambda: ops.fused_rmsnorm(x, s))
    assert got.dtype == dt and got.shape == shape
    want = ref.rmsnorm_plain(x, s)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k4_k5_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import flash_attention, rmsnorm

    x = torch.ones((1, 4, 1, 300), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention.flash_attention_cuda(x, x, x, causal=True,
                                             q_offset=0, window=None)
    h = x[..., :64].half()
    with pytest.raises(TypeError):
        flash_attention.flash_attention_cuda(h, h, h, causal=True,
                                             q_offset=0, window=None)
    # The tensor-core kernels refuse what the rule does not send them,
    # when asked for by name: f32 on the bf16 kernel, hd 160 on the f32 one.
    f = x[..., :64]
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention.flash_attention_cuda(f, f, f, causal=True,
                                             q_offset=0, window=None,
                                             _route="wgmma")
    w = torch.ones((1, 4, 1, 160), device=cuda)
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention.flash_attention_cuda(w, w, w, causal=True,
                                             q_offset=0, window=None,
                                             _route="tf32")
    with pytest.raises(TypeError):
        rmsnorm.rmsnorm_cuda(h[0, :, 0], torch.ones(64, device=cuda), 1e-6)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels import sroa_bisect

    G = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        sroa_bisect.invert_rate_cuda(G.double(), G.double(), G[:1], 8)
    with pytest.raises(ValueError):
        sroa_bisect.invert_rate_cuda(G, G[:4], G[:1], 8)
    # Operands on the CPU and on the card: raise, whichever comes first.
    for a, b in ((G.cpu(), G), (G, G.cpu())):
        with pytest.raises(ValueError, match="one device"):
            ops.sroa_invert_rate(a, b, 1.0)


def _extended_fleet(cuda, C=3, N=12, M=5, n_open=3):
    """A tiered fleet with a candidate-site pool (the first ``n_open`` of M
    sites open), per-user compression levels of the default ladder and a
    3-slot predicted-gain stack: the operands the planner's extended
    decision space feeds K2 and K3."""
    from repro_torch.fed.compression import default_ladder
    from repro_torch.fleet import dynamics, topology

    tiers = tuple(wireless.DeviceTier(*t) for t in (
        ("lo", 1.6, 1.0, 0.55, 0.35), ("mid",), ("hi", 0.7, 1.2, 1.5, 0.3)))
    spec = dataclasses.replace(wireless.ScenarioSpec(), N=N, M=M,
                               tiers=tiers)
    fl = batch.draw_fleet(5, C, spec, n_range=(N // 2, N), device=cuda)
    fl = topology.with_edge_mask(fl, topology.uniform_mask(C, M, n_open))
    state = dynamics.init_fleet_state(fl, seed=5)
    stack = torch.as_tensor(dynamics.predict_fleet_rollout(fl, state, 3),
                            device=cuda)
    comp = torch.as_tensor(np.random.default_rng(5).integers(
        0, 3, (C, fl.N_max)).astype(np.int32), device=cuda)
    return fl, stack, comp, default_ladder(0.05)


@pytest.mark.cuda
def test_k2_on_compression_horizon_and_mask_operands(cuda):
    """One horizon round of the joint (assignment, compression) search on
    a masked fleet: comp-scaled loads, predicted slots' gains and B over
    open sites only.  K2 gives its twin's bits."""
    fl, stack, comp, ladder = _extended_fleet(cuda)
    cells, mask = fl.cells, fl.mask
    assert (cells.B_open < cells.B_total).all()
    init = engine._rehome(batch.fleet_assignments(fl), cells.edge_mask)
    cands, comps, _ = engine._pruned_candidates_comp(cells, init, comp, mask,
                                                     4, ladder)
    C, A, N = cands.shape
    K = stack.shape[1]
    cs = expand_scenario(expand_scenario(cells, 1), 1)._replace(
        gain=stack[:, :, None])
    c = sroa_constants(cs, cands[:, None].expand(C, K, A, N),
                       mask[:, None, None, :],
                       comps[:, None].expand(C, K, A, N), ladder)
    lead = (C, K, A)
    args = [torch.broadcast_to(x, lead + (N,)).reshape(-1, N).contiguous()
            for x in (c.A, c.J, c.H, c.delta, c.h, cs.f_max, cs.p_max)]
    args += [torch.broadcast_to(x, lead).reshape(-1).contiguous()
             for x in (cs.B_open, cs.B_open, cs.N0,
                       torch.ones((), device=cuda), c.E_cloud_total)]
    got = _launched("sroa_solve",
                    lambda: ops.sroa_solve_batched(*args, **CAPS))
    want = ref.sroa_solve_plain(*args, **CAPS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_k3_comp_aware_H_at_M8_on_both_kernels(cuda):
    """K3 on the comp-aware upload bits at N_max = 56, M = 8 (N*M = 448,
    the warp kernel's S = 16): the routed call, both kernels and the twin
    agree bit for bit."""
    from repro_torch.kernels import topk_moves as tk

    fl, _, comp, ladder = _extended_fleet(cuda, C=16, N=56, M=8, n_open=5)
    cells = fl.cells
    H = engine._move_H(cells, comp, ladder)
    assert not torch.equal(H, engine._move_H(cells))
    args = [x.contiguous() for x in (
        cells.gain, H, cells.p_max, batch.fleet_assignments(fl), fl.mask,
        cells.N0, cells.B_open)]
    assert tk.topk_route(fl.N_max, 8, 8) == "warp"
    w0 = ops.LAUNCHES["topk_moves_warp"]
    got = _launched("topk_moves", lambda: ops.topk_move_scores(*args, k=8))
    assert ops.LAUNCHES["topk_moves_warp"] == w0 + 1
    blk, _ = tk.topk_moves_cuda(*args, 8, _route="block")
    want = ref.topk_moves_plain(*args, k=8)
    for g, b, w in zip(got, blk, want):
        assert torch.equal(g, w) and torch.equal(b, w)


@pytest.mark.cuda
def test_restarts_on_the_card_give_the_cpu_integers(cuda):
    """Four restarts (the threefry draws) over a fleet on K2 and K3: the
    assignments, move traces and round counts of the same search on the
    CPU's plain twins.  The objectives agree to the deadline bisection's
    tolerance (eps2 = 1e-4): the constants and the cost model run on each
    device's own log1p and log2, so one bisection step may branch apart."""
    from repro_torch.core import sroa

    cfg = sroa.SroaConfig(**CAPS, fused=True)
    kw = dict(lam=1.0, cfg=cfg, max_rounds=4, escape_iters=1, top_k=4,
              n_starts=4)
    fl = batch.draw_fleet(3, 4, SPEC, n_range=(6, 12), device=cuda)
    got = engine.solve_fleet_assignments(fl, **kw)
    want = engine.solve_fleet_assignments(fl.to("cpu"), **kw)
    for name in ("assign", "rounds", "escapes", "converged"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert torch.equal(got.trace.moves.cpu(), want.trace.moves)
    torch.testing.assert_close(got.R.cpu(), want.R, rtol=1e-4, atol=0)


def _train_inputs(device, n=8, m=3):
    """One global iteration's operands (fashionmnist CNN, n users on m
    edges) on ``device``: users 1 and 4 dropped, and every user of edge 2
    too (that edge averages to zeros and weighs 0 in the cloud)."""
    from repro_torch.data import make_dataset, partition_to_users
    from repro_torch.models import cnn

    cfg = cnn.PAPER_CNNS["fashionmnist"]
    ds = make_dataset("fashionmnist", n_train=400, n_test=10, seed=0)
    sizes = np.random.default_rng(0).integers(20, 40, size=n)
    x_u, y_u, mask, sizes = partition_to_users(ds.x_train, ds.y_train, sizes)
    assign = np.arange(n) % m
    part = np.ones(n, np.float32)
    part[[1, 4]] = 0.0
    part[assign == 2] = 0.0
    w = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    onehot = torch.nn.functional.one_hot(torch.as_tensor(assign), m).float()
    return cfg, tuple(
        x.to(device) if isinstance(x, torch.Tensor) else
        cnn.tree_map(lambda t: t.to(device), x)
        for x in (w, torch.as_tensor(x_u), torch.as_tensor(y_u),
                  torch.as_tensor(mask), torch.as_tensor(sizes).float(),
                  onehot, torch.as_tensor(part)))


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
def test_global_iteration_on_the_card_matches_the_cpu(cuda, compress):
    """Float32 on both devices (TF32 off inside the trainer): every leaf
    within 1e-4 of its max |leaf| of the CPU's, and of a second card run
    (cuDNN's weight gradients may add in a run-dependent order)."""
    from repro_torch.fed import hfl
    from repro_torch.models import cnn

    cfg = hfl.HflConfig(L=2, K=2, lr=0.2, topk_frac=0.05 if compress
                        else None, int8=compress)
    ccfg, card = _train_inputs(cuda)
    _, host = _train_inputs("cpu")
    got = hfl.global_iteration(ccfg, cfg, *card)
    again = hfl.global_iteration(ccfg, cfg, *card)
    want = hfl.global_iteration(ccfg, cfg, *host)
    for g, a, w in zip(cnn.tree_leaves(got), cnn.tree_leaves(again),
                       cnn.tree_leaves(want)):
        tol = 1e-4 * float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= tol
        assert float((g - a).abs().max()) <= tol


@pytest.mark.cuda
def test_compress_update_is_bitwise_on_both_devices(cuda):
    from repro_torch.fed import hfl
    from repro_torch.models import cnn

    cfg = hfl.HflConfig(topk_frac=0.05, int8=True)
    gen = torch.Generator().manual_seed(1)
    upd = cnn.tree_map(lambda t: torch.randn((8,) + tuple(t.shape),
                                             generator=gen),
                       _train_inputs("cpu")[1][0])
    got = hfl._compress_update(cfg, cnn.tree_map(lambda t: t.to(cuda), upd))
    want = hfl._compress_update(cfg, upd)
    for g, w in zip(cnn.tree_leaves(got), cnn.tree_leaves(want)):
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_train_main_plans_on_the_lanes_kernel(cuda, tmp_path):
    """The pipeline on the card at a small size: every TSIA score one K2
    launch on the lanes kernel, R the cost model's, a resumed run from
    the last checkpoint."""
    from repro_torch.core.system_model import evaluate
    from repro_torch.launch import train

    argv = ["--users", "8", "--edges", "3", "--device", "cuda",
            "--ckpt-dir", str(tmp_path)]
    ops.reset_launches()
    run = train.main(argv + ["--iters", "2"])
    torch.cuda.synchronize()
    scores = len(run.plan.history.R_trace) + 1
    assert ops.LAUNCHES["sroa_solve"] == ops.LAUNCHES["sroa_solve_lanes"] \
        == scores
    res = run.plan.sroa
    cb = evaluate(run.scenario, torch.as_tensor(run.plan.assign,
                                                device=cuda),
                  res.b, res.f, res.p, 1.0)
    assert abs(float(cb.R) - run.plan.R) <= 1e-5 * abs(run.plan.R)
    assert all(np.isfinite(run.history["acc"]))
    resumed = train.main(argv + ["--iters", "3", "--resume"])
    assert resumed.history["iter"] == [2]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_moe_reduced_model_on_the_card_matches_the_cpu(cuda, arch):
    """The reduced moe model in float32 on the same weights: forward's
    logits and aux, and a prefill plus four greedy decode steps on K4
    (``attn_impl="pallas"``: the SIMT kernel in f32), within 1e-4 of the
    CPU's; the same tokens."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get(arch).reduced(),
                              attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tf.params_from_numpy(_numpy_tree(params), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 80),
                         generator=torch.Generator().manual_seed(1))
    want, want_aux, _, _ = tf.forward(cfg, params, {"tokens": toks})
    got, aux, _, _ = tf.forward(cfg, card, {"tokens": toks.to(cuda)})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)
    seqs = []
    for p, dev in ((params, "cpu"), (card, cuda)):
        logits, cache = tf.make_prefill_step(cfg)(
            p, {"tokens": toks[:, :12].to(dev)})
        out = [logits.cpu()]
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for _ in range(4):
            logits, cache = tf.decode_step(cfg, p, cache, tok)
            out.append(logits.cpu())
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        seqs.append(out)
    for g, w in zip(seqs[1], seqs[0]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(g.argmax(-1), w.argmax(-1))


def _numpy_tree(params):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in params.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("E,top_k", [(16, 1), (384, 8)])
def test_moe_dispatch_is_bitwise_on_both_devices(cuda, E, top_k):
    """llama4-scout's and kimi-k2's routing of 4,096 tokens on float32
    logits of the bfloat16 grid with rows of exact ties: the same expert
    indices, positions, keep flags, loads and capacity on both devices."""
    from _torch_parity import tied_router_logits
    from repro_torch.models import moe

    logits = tied_router_logits(E, 4096)
    want = moe.route(logits, top_k, 1.25)
    got = moe.route(logits.to(cuda), top_k, 1.25)
    assert got.capacity == want.capacity
    for field in ("expert_idx", "pos", "keep", "load"):
        assert torch.equal(getattr(got, field).cpu(), getattr(want, field))
    assert want.expert_idx[0, 0].tolist() == list(range(top_k))


# ------------------------------------------- the hybrid and xlstm families
@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes", [
    ("zamba2-7b", dict(n_layers=5, window=8)),
    ("xlstm-125m", dict(n_layers=4))])
def test_hybrid_and_xlstm_reduced_models_on_the_card_match_the_cpu(
        cuda, arch, changes):
    """The reduced model in float32 on the same weights (zamba2 at two
    groups and a tail, window 8 < T so the ring wraps; on K4 through
    ``attn_impl="pallas"``: the SIMT kernel in f32), TF32 off: forward's
    logits and the prefill cache, then a prefill of 12 tokens and one
    decode step from the re-laid cache, within 1e-4 of the CPU's."""
    from repro_torch import configs
    from repro_torch.fed.hfl import f32_math
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get(arch).reduced(), attn_impl="pallas",
                              **changes)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tf.params_from_numpy(_numpy_tree(params), cfg, cuda)
    toks = torch.randint(0, cfg.vocab, (2, 13),
                         generator=torch.Generator().manual_seed(1))
    tol = dict(rtol=1e-4, atol=1e-4)
    out = {}
    with f32_math():
        for p, dev in ((params, "cpu"), (card, cuda)):
            t = toks.to(dev)
            logits, _, cache, _ = tf.forward(cfg, p, {"tokens": t},
                                             mode="prefill")
            _, dcache = tf.make_prefill_step(cfg)(p, {"tokens": t[:, :12]})
            step, dcache = tf.decode_step(cfg, p, dcache, t[:, 12:])
            out[dev if dev == "cpu" else "cuda"] = (logits, cache, step,
                                                     dcache)
    for got, want in zip(_leaves(out["cuda"]), _leaves(out["cpu"])):
        torch.testing.assert_close(got.cpu(), want, **tol)


# (op, B, H, hd, ds): the reduced configs' widths (zamba2: ds 16, hd 16;
# xlstm: 4 heads of 32).
_SCANS = (("mamba2_scan", 2, 3, 16, 16), ("mlstm_scan", 2, 2, 32, 0),
          ("slstm_scan", 2, 2, 32, 0))


def _scan_operands(name, B, T, H, hd, ds, dev, seed=0):
    """Seeded float32 operands of one recurrence op, a non-zero state."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g)).to(dev)

    if name == "mamba2_scan":
        return (torch.exp(-torch.rand((B, T, H), generator=g)).to(dev),
                rn(B, T, ds), rn(B, T, ds), rn(B, T, H, hd, scale=0.1),
                rn(B, H, ds, hd))
    if name == "mlstm_scan":
        s = hd ** -0.5
        return (rn(B, T, H, hd, scale=s), rn(B, T, H, hd, scale=s),
                rn(B, T, H, hd), rn(B, T, H), rn(B, T, H) - 2.0,
                rn(B, H, hd, hd, scale=0.1), rn(B, H, hd), rn(B, H))
    return (*(rn(B, T, H, hd) for _ in range(4)),
            rn(H, hd, 4 * hd, scale=hd ** -0.5),
            *(rn(B, H, hd) for _ in range(4)))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("name,B,H,hd,ds", _SCANS)
def test_recurrence_kernels_match_their_twins(cuda, name, B, H, hd, ds, T):
    """S1-S3 at the reduced widths, a state carried in: y and every state
    within 1e-4 of the twin's max |.| on the card (the read-outs and h . R
    add in other orders); S1's state bitwise (its update reads no sum)."""
    from repro_torch.kernels import ssm_scan

    args = _scan_operands(name, B, T, H, hd, ds, cuda)
    got = _launched(name, lambda: getattr(ssm_scan, name)(*args))
    want = getattr(ref, name.replace("_scan", "_recurrence_plain"))(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    if name == "mamba2_scan":
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_recurrence_kernels_raise_and_never_fall_back(cuda):
    """A width the kernels do not take raises before any launch, on the
    card as the op's CUDA implementation; an error the launch returns
    raises too, and neither counts a launch."""
    from repro_torch.kernels import build, ssm_scan

    before = dict(ops.LAUNCHES)
    args = _scan_operands("mamba2_scan", 1, 4, 2, 12, 16, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.mamba2_scan(*args)
    args = _scan_operands("slstm_scan", 1, 4, 2, 24, 0, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.slstm_scan(*args)
    args = _scan_operands("mamba2_scan", 1, 4, 2, 16, 16, cuda)
    outs = (torch.empty_like(args[3]), torch.empty_like(args[4]))
    with pytest.raises(RuntimeError, match="mamba2_scan failed"):
        ssm_scan._launch("mamba2_scan", build.load().mamba2_scan, outs,
                         *args, dims=(1, 4, 2, 16, 12))     # hd 12
    assert ops.LAUNCHES == before


# (op, B, H, hd, ds): the reduced widths, and the full widths of zamba2-7b
# (ds 64, hd 64) and xlstm-125m (hd 192) at one (b, h).
_SCANS_BWD = _SCANS + (("mamba2_scan", 1, 2, 64, 64),
                       ("mlstm_scan", 1, 1, 192, 0),
                       ("slstm_scan", 1, 1, 192, 0))


def _bwd_operands(name, args, outs, seed=1):
    """A backward op's operands: the forward's, y (S2, S3) and a seeded
    upstream gradient of every output, final states too."""
    g = torch.Generator().manual_seed(seed)
    ups = tuple(torch.randn(o.shape, generator=g).to(o.device) for o in outs)
    return args + (() if name == "mamba2_scan" else (outs[0],)) + ups


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("name,B,H,hd,ds", _SCANS_BWD)
def test_recurrence_backward_kernels_match_their_twins(cuda, name, B, H, hd,
                                                       ds, T):
    """S1b-S3b, a state carried in, seeded upstream gradients of every
    output: each gradient within 1e-4 of the backward twin's max |.| on
    the card (the contractions add in other orders); on the sequential
    route S1b's G, so d s0, bitwise the twin's (its update reads no sum;
    the chunked route, which T = 64 at ds = hd = 64 takes, sums chunk
    products, so there the sequential S1b is forced on the same operands
    and held to both).  Through autograd, the op's gradients are the
    backward op's."""
    from repro_torch.kernels import ssm_scan

    args = _scan_operands(name, B, T, H, hd, ds, cuda)
    outs = getattr(ssm_scan, name)(*args)
    bargs = _bwd_operands(name, args, outs)
    bwd = getattr(ssm_scan, name + "_bwd")
    got = _launched(name + "_bwd", lambda: bwd(*bargs))
    want = getattr(ref, name.replace("_scan", "_recurrence_bwd_plain"))(
        *bargs)
    assert len(got) == len(want) == len(args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    if name == "mamba2_scan":
        seq = got
        if ssm_scan.mamba2_route(T, ds, hd) != "sequential":
            seq = ssm_scan.mamba2_scan_bwd_cuda(*bargs, _route="sequential")
            for g, w in zip(seq, want):
                assert g.shape == w.shape
                assert float((g - w).abs().max()) <= 1e-4 * float(
                    w.abs().max())
        assert torch.equal(seq[4], want[4])
    leaves = [a.clone().requires_grad_(True) for a in args]
    n0 = dict(ops.LAUNCHES)
    grads = torch.autograd.grad(getattr(ssm_scan, name)(*leaves), leaves,
                                bargs[len(bargs) - len(outs):])
    assert ops.LAUNCHES[name] == n0[name] + 1
    assert ops.LAUNCHES[name + "_bwd"] == n0[name + "_bwd"] + 1
    for g, w in zip(grads, got):
        assert torch.equal(g, w)


# (B, T, H, ds, hd): the chunked kernels' four widths, T from one step to
# past two chunks (a tail of 36 and of 2 steps).
_CHUNKED = ((2, 100, 3, 64, 64), (1, 7, 2, 32, 64), (2, 64, 2, 64, 32),
            (1, 130, 4, 32, 32), (1, 1, 2, 64, 64))


def _mamba2_special(B, T, H, ds, hd, dev, seed):
    """S1's operands with decays of exactly 0 and exactly 1 (a forgetting
    step at the first, a middle and the last step; a head that never
    decays)."""
    args = _scan_operands("mamba2_scan", B, T, H, hd, ds, dev, seed)
    decay = args[0].clone()
    for t in {0, T // 2, T - 1}:
        decay[0, t, 0] = 0.0
    decay[-1, :, H - 1] = 1.0
    return (decay,) + args[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,ds,hd", _CHUNKED)
def test_chunked_mamba2_kernels_match_the_twins_and_the_model(cuda, B, T, H,
                                                              ds, hd):
    """The chunked S1 and S1b (csrc/ssd_chunked.cu), forced on the same
    operands, decays of exactly 0 and 1 among them: y, s_T and the five
    gradients within 1e-4 of the sequential twins' max |.| and within 1e-5
    of the chunked model's (the same chunks and products; the model sums
    the 3xTF32 split's passes exactly); no NaN."""
    from repro_torch.kernels import ssm_scan

    args = _mamba2_special(B, T, H, ds, hd, cuda, seed=T)
    g = torch.Generator().manual_seed(T + 1)
    ups = (torch.randn(args[3].shape, generator=g).to(cuda),
           torch.randn(args[4].shape, generator=g).to(cuda))
    n0 = dict(ops.LAUNCHES)
    got = ssm_scan.mamba2_scan_cuda(*args, _route="chunked")
    gg = ssm_scan.mamba2_scan_bwd_cuda(*args, *ups, _route="chunked")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba2_scan_chunked"] == \
        n0["mamba2_scan_chunked"] + 1
    assert ops.LAUNCHES["mamba2_scan_bwd_chunked"] == \
        n0["mamba2_scan_bwd_chunked"] + 1
    for have, twin, model in (
            (got, ref.mamba2_recurrence_plain(*args),
             ref.mamba2_chunked_plain(*args)),
            (gg, ref.mamba2_recurrence_bwd_plain(*args, *ups),
             ref.mamba2_chunked_bwd_plain(*args, *ups))):
        for h_, w, m in zip(have, twin, model):
            assert h_.shape == w.shape and bool(torch.isfinite(h_).all())
            assert float((h_ - w).abs().max()) <= 1e-4 * float(
                w.abs().max())
            assert float((h_ - m).abs().max()) <= 1e-5 * float(
                m.abs().max())


@pytest.mark.cuda
def test_mamba2_routes_on_the_card(cuda):
    """The op takes mamba2_route's kernel: the chunked ones at T = 100
    (ds = hd = 64), forward and under autograd backward, the sequential
    ones at T = 1; the routed call equals the forced one bitwise."""
    from repro_torch.kernels import ssm_scan

    for T, route in ((100, "chunked"), (1, "sequential")):
        args = _scan_operands("mamba2_scan", 2, T, 3, 64, 64, cuda)
        assert ssm_scan.mamba2_route(T, 64, 64) == route
        n0 = dict(ops.LAUNCHES)
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = ssm_scan.mamba2_scan(*leaves)
        grads = torch.autograd.grad(out, leaves,
                                    [torch.ones_like(o) for o in out])
        torch.cuda.synchronize()
        chunked = int(route == "chunked")
        assert ops.LAUNCHES["mamba2_scan"] == n0["mamba2_scan"] + 1
        assert ops.LAUNCHES["mamba2_scan_bwd"] == n0["mamba2_scan_bwd"] + 1
        assert ops.LAUNCHES["mamba2_scan_chunked"] == \
            n0["mamba2_scan_chunked"] + chunked
        assert ops.LAUNCHES["mamba2_scan_bwd_chunked"] == \
            n0["mamba2_scan_bwd_chunked"] + chunked
        forced = ssm_scan.mamba2_scan_cuda(*args, _route=route)
        for a, b in zip(out, forced):
            assert torch.equal(a, b)
        fgrads = ssm_scan.mamba2_scan_bwd_cuda(
            *args, *(torch.ones_like(o) for o in out), _route=route)
        for a, b in zip(grads, fgrads):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_recurrence_backward_kernels_raise_and_never_fall_back(cuda):
    """A width the backward kernels do not take raises before any launch;
    an error a launch returns raises too (a width, or a chunk length that
    is not the chunked kernels' own); neither counts a launch."""
    from repro_torch.kernels import build, ssm_scan

    before = dict(ops.LAUNCHES)
    for name, hd, ds in (("mamba2_scan", 12, 16), ("mlstm_scan", 20, 0),
                         ("slstm_scan", 24, 0)):
        args = _scan_operands(name, 1, 4, 2, hd, ds, cuda)
        ups = tuple(torch.zeros_like(x) for x in (
            (args[3], args[4]) if name == "mamba2_scan" else
            (args[0], *args[5:8]) if name == "mlstm_scan" else
            (args[0], *args[5:9])))
        y = () if name == "mamba2_scan" else (args[0],)
        with pytest.raises(ValueError, match="no kernel"):
            getattr(ssm_scan, name + "_bwd")(*args, *y, *ups)
    args = _scan_operands("mamba2_scan", 1, 4, 2, 16, 16, cuda)
    bufs = tuple(torch.empty(4096, device=cuda) for _ in range(9))
    with pytest.raises(RuntimeError, match="mamba2_scan_bwd failed"):
        ssm_scan._run("mamba2_scan_bwd", args[3], (
            build.load().mamba2_scan_bwd, args + bufs,
            (1, 4, 2, 16, 12)))                          # hd 12
    args = _scan_operands("mamba2_scan", 1, 4, 2, 64, 64, cuda)
    outs = (torch.empty_like(args[3]), torch.empty_like(args[4]))
    bufs = tuple(torch.empty(4096 * 64, device=cuda) for _ in range(6))
    lib = build.load()
    for fn, tensors in ((lib.mamba2_chunked, args + outs + (None,)),
                        (lib.mamba2_chunked_bwd, args[:4] + outs + bufs)):
        with pytest.raises(RuntimeError, match="mamba2_scan failed"):
            ssm_scan._run("mamba2_scan", args[3], (
                fn, tensors, (1, 4, 2, 64, 64, ssm_scan.S1_CHUNK // 2)))
    assert ops.LAUNCHES == before


# (B, T, H, hd): the chunked S2b's widths (hd 32 and 64: one and two value
# tiles, and the n column's), T from one step past four chunks (tails of
# 7, 4 and 2 steps), and xlstm-125m's full shape.
_MLSTM_CHUNKED = ((2, 7, 2, 32), (2, 64, 2, 32), (2, 100, 3, 64),
                  (1, 130, 2, 64), (1, 1, 2, 192), (4, 1024, 4, 192))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", _MLSTM_CHUNKED)
def test_chunked_mlstm_backward_matches_the_twin_and_the_model(cuda, B, T,
                                                              H, hd):
    """The chunked S2b (csrc/mlstm_chunked.cu) and the sequential one,
    forced on the same operands, a state carried in, every upstream
    gradient seeded: the eight gradients within 1e-4 of the backward
    twin's max |.|, the chunked ones also within 1e-5 of the chunked
    model's (the same chunks and products; the model sums the 3xTF32
    split's passes exactly); no NaN."""
    from repro_torch.kernels import ssm_scan

    args = _scan_operands("mlstm_scan", B, T, H, hd, 0, cuda, seed=T)
    bargs = _bwd_operands("mlstm_scan", args, ssm_scan.mlstm_scan(*args))
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    model = ref.mlstm_chunked_bwd_plain(*bargs)
    for route in ssm_scan.MLSTM_ROUTES:
        n0 = dict(ops.LAUNCHES)
        got = ssm_scan.mlstm_scan_bwd_cuda(*bargs, _route=route)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["mlstm_scan_bwd"] == n0["mlstm_scan_bwd"] + 1
        assert ops.LAUNCHES["mlstm_scan_bwd_chunked"] == \
            n0["mlstm_scan_bwd_chunked"] + int(route == "chunked")
        for g, w, m in zip(got, want, model):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
            if route == "chunked":
                assert float((g - m).abs().max()) <= 1e-5 * float(
                    m.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 192])
@pytest.mark.parametrize("T", [1, 7, 1024])
def test_short_slstm_backward_matches_the_twin(cuda, T, hd):
    """S3b's short reverse step (slstm_bwd_short_kernel, then
    slstm_dR_kernel) and the barrier kernel, forced on the same operands, a
    state carried in, every upstream gradient seeded: the nine gradients
    within 1e-4 of the backward twin's max |.| (h . R, dR and the
    partials' sums add in other orders)."""
    from repro_torch.kernels import ssm_scan

    args = _scan_operands("slstm_scan", 2, T, 2, hd, 0, cuda, seed=T)
    bargs = _bwd_operands("slstm_scan", args, ssm_scan.slstm_scan(*args))
    want = ref.slstm_recurrence_bwd_plain(*bargs)
    for route in ssm_scan.SLSTM_BWD_ROUTES:
        n0 = dict(ops.LAUNCHES)
        got = ssm_scan.slstm_scan_bwd_cuda(*bargs, _route=route)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["slstm_scan_bwd"] == n0["slstm_scan_bwd"] + 1
        assert ops.LAUNCHES["slstm_scan_bwd_short"] == \
            n0["slstm_scan_bwd_short"] + int(route == "short")
        for g, w in zip(got, want):
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.cuda
def test_mlstm_and_slstm_backward_routes_on_the_card(cuda):
    """Under autograd the ops take their rules' kernels: S2b the chunked
    one at T = 64 and the sequential one at T = 1 (hd 32), S3b its short
    step at both; the routed call equals the forced one bitwise.  A forced
    chunked S2b at a width it has no instance of raises before any
    launch."""
    from repro_torch.kernels import ssm_scan

    for T, route in ((64, "chunked"), (1, "sequential")):
        assert ssm_scan.mlstm_route(T, 32) == route
        for name, counter, forced in (
                ("mlstm_scan", "mlstm_scan_bwd_chunked", route),
                ("slstm_scan", "slstm_scan_bwd_short", "short")):
            args = _scan_operands(name, 2, T, 2, 32, 0, cuda)
            leaves = [a.clone().requires_grad_(True) for a in args]
            out = getattr(ssm_scan, name)(*leaves)
            ups = [torch.ones_like(o) for o in out]
            n0 = dict(ops.LAUNCHES)
            grads = torch.autograd.grad(out, leaves, ups)
            torch.cuda.synchronize()
            assert ops.LAUNCHES[name + "_bwd"] == n0[name + "_bwd"] + 1
            assert ops.LAUNCHES[counter] == n0[counter] + int(
                forced in ("chunked", "short"))
            fgrads = getattr(ssm_scan, name + "_bwd_cuda")(
                *args, out[0].detach(), *ups, _route=forced)
            for a, b in zip(grads, fgrads):
                assert torch.equal(a, b)
    args = _scan_operands("mlstm_scan", 1, 8, 2, 16, 0, cuda)
    bargs = _bwd_operands("mlstm_scan", args, ssm_scan.mlstm_scan(*args))
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="chunked kernel"):
        ssm_scan.mlstm_scan_bwd_cuda(*bargs, _route="chunked")
    assert ops.LAUNCHES == before


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) if tree[k] is not None
                for x in _leaves(tree[k])]
    return [x for t in tree if t is not None for x in _leaves(t)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, 16])
def test_k4_at_zamba2s_shared_attention_shape(cuda, window):
    """zamba2-7b's prefill attention, (4, 1024, 32, 112) in bf16 (hd 112:
    the HD = 128 template), at its window and at 16: the tensor-core
    kernel, within 2e-2 of the twin."""
    q, k, v = (_randn((4, 1024, 32, 112), torch.bfloat16, cuda, 11 + i)
               for i in range(3))
    got = _launched("flash_attention", lambda: ops.flash_attention(
        q, k, v, causal=True, window=window), route="wgmma")
    torch.testing.assert_close(
        got.float(), _attention_plain(q, k, v, causal=True,
                                      window=window).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_zamba2s_shared_block_takes_the_tensor_cores(cuda):
    """zamba2-7b's shared attention block and SwiGLU at full width on
    random bf16 weights, B = 4, T = 1,024: its q, k, v views go to K4's
    tensor-core kernel (one launch), and the output is finite."""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get("zamba2-7b"), attn_impl="pallas")
    defs = tf.param_defs(cfg)
    g = torch.Generator(device=cuda).manual_seed(0)

    def draw(d):
        fan_in = d.shape[-2] if len(d.shape) >= 2 else 1.0
        return torch.randn(d.shape, generator=g, device=cuda).mul_(
            fan_in ** -0.5).to(torch.bfloat16)

    params = {k: {n: draw(d) for n, d in defs[k].items()}
              for k in ("shared_attn", "shared_mlp")}
    x = torch.randn((4, 1024, cfg.d_model), generator=g, device=cuda).to(
        torch.bfloat16)
    positions = torch.arange(1024, device=cuda).expand(4, 1024)
    y, (k, v) = _launched("flash_attention", lambda: tf._shared_apply(
        cfg, params, x, positions=positions), route="wgmma")
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert k.shape == (4, 1024, 32, 112)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,causal", [(4, 1024, 16, 80, False),
                                             (4, 1024, 64, 128, True)])
def test_k4_at_the_encoder_and_vlm_prefill_shapes(cuda, B, T, H, hd, causal):
    """hubert-xlarge's attention (16 heads of 80, non-causal: the P.V
    product's n tile past hd 80 reads TMA's zero fill) and internvl2-76b's
    prefill (64 heads of 128 after the GQA repeat, causal): the
    tensor-core kernel, within 2e-2 of the twin."""
    q, k, v = (_randn((B, T, H, hd), torch.bfloat16, cuda, 21 + i)
               for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=causal),
                    route="wgmma")
    torch.testing.assert_close(
        got.float(), _attention_plain(q, k, v, causal=causal).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_k4_refuses_to_run_under_autograd_on_the_card(cuda):
    """K4 has no backward: with grad mode on and an operand that requires
    grad the wrapper raises before any launch; without either it runs."""
    q, k, v = (_randn((1, 64, 2, 64), torch.bfloat16, cuda, 30 + i)
               for i in range(3))
    q.requires_grad_(True)
    n0 = ops.LAUNCHES["flash_attention"]
    with pytest.raises(RuntimeError, match="no backward.*chunked"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == n0
    with torch.no_grad():
        _launched("flash_attention", lambda: ops.flash_attention(q, k, v),
                  route="wgmma")


# One of each kind of model, reduced: (arch, config changes).
TRAIN_KINDS = [("qwen1.5-0.5b", {}), ("llama4-scout-17b-a16e", {}),
               ("zamba2-7b", {"n_layers": 3}), ("xlstm-125m", {"n_layers": 4}),
               ("hubert-xlarge", {}), ("internvl2-76b", {})]
_BIASES = {"ln_b", "final_ln_b", "bq", "bk", "bv", "b_in", "b_out"}


def _lm_train_inputs(cfg, B=2, T=16, seed=0):
    """Parameters (biases drawn non-zero) and a batch for ``cfg``'s input
    mode, on the CPU."""
    from repro_torch.models import transformer as tf

    g = torch.Generator().manual_seed(seed)

    def biased(node):
        return {k: biased(v) if isinstance(v, dict) else
                (0.1 * torch.randn(v.shape, generator=g) if k in _BIASES
                 else v) for k, v in node.items()}

    params = biased(tf.init_params(cfg, g, "cpu"))
    V, d = cfg.vocab, cfg.d_model
    if cfg.input_mode == "embeds":
        batch = {"embeds": torch.randn((B, T, d), generator=g),
                 "labels": torch.randint(0, V, (B, T), generator=g)}
    elif cfg.input_mode == "mixed":
        P = cfg.n_patches
        batch = {"patches": torch.randn((B, P, d), generator=g),
                 "tokens": torch.randint(0, V, (B, T - P), generator=g)}
    else:
        batch = {"tokens": torch.randint(0, V, (B, T), generator=g)}
    return params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes", TRAIN_KINDS,
                         ids=[a for a, _ in TRAIN_KINDS])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch, changes):
    """One float32 ``make_train_step`` (SGD, a cosine schedule, the clip)
    with remat on, TF32 off: every new parameter within 1e-4 of its max
    |leaf| of the CPU's, the metrics within 1e-4."""
    from repro_torch import configs, optim
    from repro_torch.fed.hfl import f32_math
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves, tree_map

    cfg = dataclasses.replace(configs.get(arch).reduced(), **changes)
    params, batch = _lm_train_inputs(cfg)
    opt = optim.sgd(lr=0.1)
    step = tf.make_train_step(cfg, opt, lr_schedule=optim.cosine(10, 2))
    with f32_math():
        want = step(params, opt.init(params), batch)
        card = tree_map(lambda t: t.to(cuda), params)
        got = step(card, opt.init(card),
                   {k: v.to(cuda) for k, v in batch.items()})
    for g, w in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert g.device.type == "cuda"
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * float(
            w.abs().max())
    for k, w in want[2].items():
        assert abs(float(got[2][k]) - float(w)) <= 1e-4 * max(abs(float(w)),
                                                               1.0)
    assert int(got[1]["step"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,changes", TRAIN_KINDS[2:4],
                         ids=[a for a, _ in TRAIN_KINDS[2:4]])
def test_recurrent_train_steps_launch_the_backward_kernels(cuda, arch,
                                                          changes):
    """A train step of the hybrid (3 Mamba2 layers) and xlstm (2 pairs)
    models with remat on the card: each forward recurrence twice a layer
    (the forward and its recompute), each backward once, and no twin."""
    from repro_torch import configs, optim
    from repro_torch.kernels import ssm_scan
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_map

    cfg = dataclasses.replace(configs.get(arch).reduced(), **changes)
    assert cfg.remat
    params, batch = _lm_train_inputs(cfg)
    card = tree_map(lambda t: t.to(cuda), params)
    opt = optim.sgd(lr=0.1)
    twins = []

    def trap(*args):
        twins.append(args)
        raise AssertionError("a twin ran on the card")

    saved = ssm_scan.ref
    ssm_scan.ref = type("Trap", (), {"__getattr__": lambda _, n: trap})()
    try:
        ops.reset_launches()
        tf.make_train_step(cfg, opt)(card, opt.init(card),
                                     {k: v.to(cuda) for k, v in batch.items()})
        torch.cuda.synchronize()
    finally:
        ssm_scan.ref = saved
    assert not twins
    if cfg.family == "mamba_hybrid":
        want = {"mamba2_scan": 2 * cfg.n_layers,
                "mamba2_scan_bwd": cfg.n_layers}
    else:
        pairs = cfg.n_layers // 2
        want = {"mlstm_scan": 2 * pairs, "slstm_scan": 2 * pairs,
                "mlstm_scan_bwd": pairs, "slstm_scan_bwd": pairs}
    assert {k: ops.LAUNCHES[k] for k in want} == want
    assert ops.LAUNCHES["ssm_scan"] == sum(want.values())


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_distributed_hfl_on_the_card_matches_one_process(cuda, backend):
    """Algorithm 1 with the users split over ranks: NCCL at one rank a
    card (up to 4 cards), gloo at 2 ranks sharing card 0 (CUDA tensors).
    Every rank's new model within 1e-4 of the model's max |leaf| of the
    single-process iteration on the card (cuDNN's weight gradients are
    not bitwise from run to run)."""
    from repro_torch.fed import distributed as tdist
    from repro_torch.fed import hfl
    from repro_torch.models import cnn

    ccfg, host = _train_inputs("cpu")
    _, card = _train_inputs(cuda)
    hcfg = hfl.HflConfig(L=2, K=2, lr=0.2)
    want = cnn.tree_leaves(hfl.global_iteration(ccfg, hcfg, *card))
    world = min(4, torch.cuda.device_count()) if backend == "nccl" else 2
    w, *data, part = host
    ranks = tdist.run_ranks(world, backend, tdist.global_iteration_on_ranks,
                            ccfg, hcfg, 3, False, w, tuple(data), [part], 0,
                            device="cuda")
    assert len(ranks) == world
    scale = max(float(c.abs().max()) for c in want)
    for out in ranks:
        for g, c in zip(cnn.tree_leaves(out["w"][0]), want):
            assert float((g - c.cpu()).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_dryrun_arguments_equal_the_bytes_the_card_allocates(cuda, kind):
    """The 1 x 1 dry-run of a reduced bf16 model: its argument bytes are
    the bytes of the parameters, the optimizer state and the inputs that
    the same step allocates on the card."""
    from repro_torch import configs, optim
    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    from repro_torch.models.cnn import tree_leaves

    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(),
                              dtype=torch.bfloat16)
    shape = shp.ShapeSpec("small", kind, 64, 4)
    rec = dryrun.run_cell("qwen1.5-0.5b", shape, False, device_type="cuda",
                          cfg=cfg, mesh_shape=((1, 1), ("data", "model")))
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    args = [params, {"tokens": torch.zeros((4, 64), dtype=torch.int32,
                                           device=cuda)}]
    if kind == "train":
        args.insert(1, optim.get_optimizer(cfg.optimizer).init(params))
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for a in args for t in tree_leaves(a)}
    assert rec["memory"]["argument_size_in_bytes"] == sum(storages.values())
    assert rec["status"] == "ok" and rec["collectives"]["total"] == 0
