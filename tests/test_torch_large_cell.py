"""Port parity at the large-cell planning shapes (N = 600 to 2,048 users,
M = 16 edges, top-16: the pruned candidate search of DESIGN.md D9), where
K2 runs on its cluster kernel and K3 on its cluster kernel, and plain
models of those two kernels' designs held bitwise to the twins.

* K2: ``ref.sroa_solve_plain`` against ``sroa_solve_pallas`` (interpret
  mode) at N = 600, P = 2: feasible exact; R, t and b at rtol 5e-3 (the
  TPU kernel's padded lanes add ~B 2^-b_iters each to the budget sum, as
  in ``tests/test_torch_kernels.py``).
* K3: ``ops.topk_move_scores`` against the JAX package's at (1, 2048, 16),
  k = 16, and at (2, 600, 4), k = 40 past the legal moves: user and dst
  exact, scores rtol 1e-5.
* The cluster K2's reduction, one step at a time: every warp pushes its
  lane values into each block's slot, then reads the W partials of its lane
  in warp order from its own block: ``ref.warp_sum_plain``'s bits.
* The cluster K3's selection (``ref.topk_select_slices_plain``: slice
  lists, one merge, the padding rule) against the twin's sequential
  knock-outs, bitwise, for k from 1 to past the legal moves.

The kernels themselves are held to these twins on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase x.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_bitwise, host  # noqa: E402
from repro.core import system_model as jsm  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sroa_bisect as jsb  # noqa: E402
from repro_torch.kernels import ops, ref, sroa_bisect, topk_moves  # noqa

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)


@pytest.fixture
def launches():
    """Counts before the test; the CPU path must never add to them."""
    before = dict(ops.LAUNCHES)
    yield
    assert ops.LAUNCHES == before


# ------------------------------------------------------------------ K2
def test_solve_plain_matches_pallas_at_600_users(launches):
    """Two problems of N = 600 (the second with A scaled), past the lanes
    kernel's 512: the cluster kernel's route on the card."""
    spec = dataclasses.replace(jw.ScenarioSpec(), N=600, M=16)
    scn = jw.draw_scenario(600, spec)
    c = jsm.sroa_constants(scn, jw.nearest_edge_assignment(scn))
    B = scn.B_total
    per_user = [jnp.stack([x, x * s]) for x, s in
                ((c.A, 1.7), (c.J, 1.0), (c.H, 1.0), (c.delta, 1.0),
                 (c.h, 1.0), (scn.f_max, 1.0), (scn.p_max, 1.0))]
    per_problem = [jnp.full((2,), x, jnp.float32)
                   for x in (B, B, scn.N0, 1.0, c.E_cloud_total)]
    args = per_user + per_problem
    assert sroa_bisect.solve_route(2, 600, 132)[0] == "cluster"
    want = jsb.sroa_solve_pallas(*args, **CAPS, interpret=True)
    got = ref.sroa_solve_plain(*(torch.tensor(np.asarray(x)) for x in args),
                               **CAPS)
    wb, _, _, wt, wR, _, wfe = (host(x) for x in want)
    gb, _, _, gt, gR, _, gfe = (host(x) for x in got)
    np.testing.assert_array_equal(gfe, wfe)
    np.testing.assert_allclose(gR, wR, rtol=5e-3)
    np.testing.assert_allclose(gt, wt, rtol=5e-3)
    np.testing.assert_allclose(gb, wb, rtol=5e-3, atol=1.0)


@pytest.mark.parametrize("W", [17, 19, 64, 128])
def test_cluster_sum_adds_in_warp_sum_plain_order(W):
    """The cluster K2's sum, one step at a time: W warps over the cluster
    that ``sroa_bisect.cluster_shape`` gives (C blocks of ceil(W / C)
    warps, the last ones idle), user l + 32w on lane l of warp w (0 past
    N).  Every warp that holds users stores its lane values into the slot
    of every block; then every warp of every block, idle ones too, adds the
    W values of its lane from its own block's slot in warp order and
    butterflies over lanes l ^ 16, 8, 4, 2, 1.  Every lane of every warp
    ends with warp_sum_plain's bits."""
    N = 32 * W - 5
    C, per_block = sroa_bisect.cluster_shape(N)
    assert C <= 8 and C * per_block >= W > (C - 1) * per_block
    rng = np.random.default_rng(W)
    x = np.asarray(rng.uniform(0, 1e6, (3, N)) * 10.0 ** rng.integers(
        -3, 4, (3, N)), np.float32)
    idx = np.arange(32)
    want = np.empty((3, 1), np.float32)
    for r in range(3):
        lanes = np.zeros(32 * W, np.float32)
        lanes[:N] = x[r]
        slots = np.full((C, W, 32), np.nan, np.float32)
        for w in range(W):                     # the pushes
            for b in range(C):
                slots[b, w] = lanes[32 * w:32 * (w + 1)]
        held = set()
        for w in range(C * per_block):         # every warp, idle ones too
            s = slots[w // per_block]
            v = s[0].copy()
            for kk in range(1, W):
                v = v + s[kk]
            for off in (16, 8, 4, 2, 1):
                v = v + v[idx ^ off]
            held |= {e.tobytes() for e in v}
        assert len(held) == 1
        want[r, 0] = v[0]
    assert_bitwise(ref.warp_sum_plain(torch.from_numpy(x)), want)


@pytest.mark.parametrize("P,N,sms,route", [
    (34, 2048, 132, ("cluster", 1)),    # the large-cell path's round
    (1, 600, 132, ("cluster", 2)),
    (1, 4096, 132, ("cluster", 2)),
    (136, 2048, 132, ("cluster", 1)),   # serve --cell-users 2048, 8 cells
])
def test_k2_large_cell_route(P, N, sms, route):
    assert sroa_bisect.solve_route(P, N, sms) == route
    C, per_block = sroa_bisect.cluster_shape(N)
    assert C * per_block >= math.ceil(N / 32) and C <= 8 \
        and per_block <= 16


# ------------------------------------------------------------------ K3
def _k3_numpy(P, N, M, seed, active=None):
    rng = np.random.default_rng(seed)
    gain = (np.abs(rng.normal(size=(P, N, M))) * 1e-7 + 1e-9).astype(
        np.float32)
    H = rng.uniform(1e5, 4e5, (P, N)).astype(np.float32)
    pm = np.full((P, N), 0.2, np.float32)
    assign = rng.integers(0, M, (P, N)).astype(np.int32)
    mask = rng.random((P, N)) < 0.9
    if active is not None:
        mask[:] = False
        mask[:, :active] = True
    N0 = np.full((P,), 1e-17, np.float32)
    B = np.full((P,), 1e7, np.float32)
    return gain, H, pm, assign, mask, N0, B


@pytest.mark.parametrize("P,N,M,k,active", [
    (1, 2048, 16, 16, None),     # the large-cell path's nomination
    (2, 600, 4, 40, 10),         # 10 active users: 30 legal moves < 40
])
def test_topk_matches_pallas_at_large_cells(P, N, M, k, active, launches):
    args = _k3_numpy(P, N, M, N + k, active)
    assert topk_moves.topk_route(N, M, k) == "cluster"
    want = jops.topk_move_scores(*(jnp.asarray(x) for x in args), k=k)
    got = ops.topk_move_scores(*(torch.from_numpy(x) for x in args), k=k)
    for name, g, w in zip(("user", "dst"), got[:2], want[:2]):
        np.testing.assert_array_equal(host(g), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(host(got[2]), np.asarray(want[2]), rtol=1e-5)
    score = host(got[2])
    if active is not None:
        assert (score[:, 30:] >= 1e29).all() and (score[:, :30] < 1e29).all()


def _tie_heavy(P, N, M, seed):
    """numpy K3 operands full of equal scores: gains on a grid of three
    values, the second half of the users copies the first, cell 1 all
    masked and cell 2 with one active user."""
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
    return [torch.from_numpy(x) for x in (
        gain, np.full((P, N), 2.4e5, np.float32),
        np.full((P, N), 0.2, np.float32), assign, mask,
        np.full((P,), 1e-17, np.float32), np.full((P,), 1e7, np.float32))]


@pytest.mark.parametrize("slice_entries", [512, 64])
@pytest.mark.parametrize("N,M", [(33, 5), (65, 8), (128, 8), (300, 7),
                                 (600, 4), (2048, 16)])
def test_slice_selection_model_is_the_twins_selection(N, M, slice_entries):
    """The cluster kernel's slices (512 entries; 64 puts more lists into
    the merge), truncated lists of legal moves, one merge and the padding
    rule pick the twin's moves, bitwise, for k from 1 to past the legal
    moves of the cell with one active user and of the all-masked cell (and
    of every cell, where the tile is small enough for N*M rounds)."""
    args = _tie_heavy(4, N, M, 10 * N + M)
    tile = ref.move_scores_plain(*args)
    ks = {1, 2, 8, 16, 33, 40}
    if N * M <= 1024:
        legal = int((tile[0] < 1e29).sum())
        ks |= {legal, legal + 3, N * M + 3}
    for k in sorted(ks):
        idx, val = ref.topk_select_slices_plain(tile, k, slice_entries)
        user, dst, score = ref.topk_moves_plain(*args, k=k)
        assert torch.equal(idx, user.long() * M + dst.long()), k
        assert_bitwise(val, score)


def _sequential(tile, k):
    """The twin's rounds on a tile: argmin (ties to the lower entry), then
    the pick becomes 1e30."""
    s = tile.clone()
    idx, val = [], []
    for _ in range(k):
        mn = s.amin(1)
        pos = torch.where(s == mn[:, None],
                          torch.arange(s.shape[1]), 2 ** 30).amin(1)
        idx.append(pos)
        val.append(mn)
        s[torch.arange(s.shape[0]), pos] = 1e30
    return torch.stack(idx, 1), torch.stack(val, 1)


@pytest.mark.parametrize("slice_entries", [2, 3, 512])
def test_slice_selection_rounds_above_1e30(slice_entries):
    """Scores above 1e30 and +inf (off-range operands make them): a cell
    with no score <= 1e30 takes its smallest (score, entry) first, then
    that entry with 1e30; a cell with 1e30 entries ahead of its legal
    moves takes the lowest of them once the moves run out."""
    tile = torch.tensor([
        [2e30, 3e30, 2e30, float("inf"), 5e30, 2e30],
        [5.0, 1e30, 7.0, 2e30, 5.0, float("inf")],
        [float("inf")] * 6,
        [3e30, 1e30, 2.0, 1e30, 9e30, 1.0]], dtype=torch.float32)
    for k in range(1, 10):
        idx, val = ref.topk_select_slices_plain(tile, k, slice_entries)
        want_i, want_v = _sequential(tile, k)
        assert torch.equal(idx, want_i), k
        assert_bitwise(val, want_v)
