"""The port's hand-written CUDA kernels against their plain PyTorch twins,
on a card.  Every test here is marked ``cuda`` and skips itself when
``torch.cuda.is_available()`` is false; this file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

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


def _launched(name, fn):
    n0 = ops.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n0 + 1
    return out


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
    got = _launched("sroa_solve",
                    lambda: ops.sroa_solve_batched(*args, **CAPS))
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


@pytest.mark.cuda
def test_k3_matches_its_twin(fleet):
    cells = fleet.cells
    init = batch.fleet_assignments(fleet)
    args = (cells.gain, engine._move_H(cells), cells.p_max, init,
            fleet.mask, cells.N0, cells.B_open)
    got = _launched("topk_moves",
                    lambda: ops.topk_move_scores(*args, k=6))
    want = ref.topk_moves_plain(*(x.contiguous() for x in args), k=6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
