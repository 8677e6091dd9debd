"""The port's hand-written CUDA kernels (K1-K5) against their plain
PyTorch twins, on a card.  Every test here is marked ``cuda`` and skips itself when
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


def _launched(name, fn, wgmma=None):
    """fn's result; fn launched kernel ``name`` once and, for K4, took the
    tensor-core kernel when ``wgmma`` is True and the SIMT one when it is
    False."""
    n0, w0 = ops.LAUNCHES[name], ops.LAUNCHES["flash_attention_sm90"]
    out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES[name] == n0 + 1
    if wgmma is not None:
        assert ops.LAUNCHES["flash_attention_sm90"] == w0 + int(wgmma)
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
    (exp and the summation order differ from the twin's)."""
    dt = getattr(torch, dtype)
    q, k, v = (_randn((B, T, H, hd), dt, cuda, T + hd + i) for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    wgmma=dt == torch.bfloat16 and hd <= 128)
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
    """f32 runs on the SIMT kernel (2e-5), bf16 on the tensor-core kernel
    (2e-2): its non-causal, window, q_offset and Tq != Tk paths."""
    dt = getattr(torch, dtype)
    q = _randn((2, Tq, 3, 64), dt, cuda, 1)
    k = _randn((2, Tk, 3, 64), dt, cuda, 2)
    v = _randn((2, Tk, 3, 64), dt, cuda, 3)
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, **kw),
                    wgmma=dt == torch.bfloat16)
    tol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(),
                               _attention_plain(q, k, v, **kw).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd", [(4, 1024, 16, 64), (1, 1024, 24, 128)])
def test_k4_takes_the_tensor_cores_at_the_model_shapes(cuda, B, T, H, hd):
    """qwen1.5-0.5b's prefill (hd 64) and llama3.2-3b's heads (hd 128): in
    bf16 the wgmma kernel, held to the twin at 2e-2; in f32 the SIMT one."""
    q, k, v = (_randn((B, T, H, hd), torch.bfloat16, cuda, 7 + i)
               for i in range(3))
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    wgmma=True)
    torch.testing.assert_close(
        got.float(), _attention_plain(q, k, v, causal=True).float(),
        rtol=2e-2, atol=2e-2)
    f = q[:1, :128].float()
    _launched("flash_attention",
              lambda: ops.flash_attention(f, f, f, causal=True), wgmma=False)


@pytest.mark.cuda
def test_k4_reads_strided_operands(cuda):
    """q, k and v as views of one fused (B, T, 3, H, hd) projection: the
    kernel addresses them through their strides."""
    qkv = _randn((2, 70, 3, 4, 64), torch.bfloat16, cuda, 4)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    got = _launched("flash_attention",
                    lambda: ops.flash_attention(q, k, v, causal=True),
                    wgmma=True)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert torch.equal(got, want)


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
    # The tensor-core kernel refuses f32 when asked for by name.
    f = x[..., :64]
    with pytest.raises(ValueError, match="tensor-core"):
        flash_attention.flash_attention_cuda(f, f, f, causal=True,
                                             q_offset=0, window=None,
                                             _route="wgmma")
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
