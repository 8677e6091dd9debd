"""S2b, the mLSTM recurrence's backward, in the chunked form on the CPU, at
reduced widths: the plain model of the chunked kernel's arithmetic
(``kernels/ref.py``: ``mlstm_chunked_bwd_plain``, the products taken by
the 3xTF32 split as ``csrc/mlstm_chunked.cu`` takes them) against the
sequential backward twin and against ``jax.vjp`` through one mLSTM block of
the JAX package; ``ssm_scan.mlstm_route``'s rule and the forced routes'
refusals (S2b's and S3b's); the scratch S2b's CUDA wrapper allocates on
each route and the dry-run's ``StepCounter`` counts.

Tolerances, each with its reason:

* Chunked model against the sequential twin: 1e-5 of max |.| of each
  gradient.  The same recurrence summed in another order: a chunk's
  products (three TF32 passes, about 2^-21 relative a term) against the
  twin's step-by-step float32 updates.
* One TF32 pass instead of the split misses 1e-4 (the tolerance the
  kernels are held to on the card): the reason for the split.
* Against ``jax.vjp`` of the JAX package's block: 1e-4 of max |grad|, as
  ``tests/test_torch_ssm_scan_bwd.py`` holds the sequential route.

The card's kernels are held to the model and to the twin in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase s (g).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread)
from _torch_parity import host  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref, ssm_scan  # noqa: E402
from repro_torch.launch import dryrun as d  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

B, H = 2, 2
TWIN_TOL = 1e-5
KERNEL_TOL = 1e-4
JAX_TOL = 1e-4


def _f32(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _operands(T, hd, seed=0):
    """S2b's operands at T steps: S2's (scaled q and k, log forget gates
    below 0), a non-zero state carried in, the forward's y, and seeded
    upstream gradients of y and of the final C, n and m."""
    rng = np.random.default_rng(seed)
    s = hd ** -0.5
    args = (_f32(rng, B, T, H, hd, scale=s), _f32(rng, B, T, H, hd, scale=s),
            _f32(rng, B, T, H, hd), _f32(rng, B, T, H),
            torch.nn.functional.logsigmoid(_f32(rng, B, T, H) + 2.0),
            _f32(rng, B, H, hd, hd, scale=0.1), _f32(rng, B, H, hd),
            _f32(rng, B, H))
    y = ref.mlstm_recurrence_plain(*args)[0]
    ups = (_f32(rng, B, T, H, hd), _f32(rng, B, H, hd, hd),
           _f32(rng, B, H, hd), _f32(rng, B, H))
    return args + (y,) + ups


def _rel(got, want):
    """max |got - want| / max |want|: 0 where they are equal (zeros too)."""
    diff = float((got - want).abs().max())
    return 0.0 if diff == 0 else diff / float(want.abs().max())


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("L", [ref.S2_CHUNK, 16, 4])
@pytest.mark.parametrize("T", [1, 7, 16, 33, 64, 100])
def test_chunked_backward_matches_the_twin(T, L, hd):
    """The eight gradients of the chunked model (one and two value slices
    of 32 columns, and the n column), a state carried in and every
    upstream gradient seeded, within 1e-5 of the backward twin's max
    |.|."""
    bargs = _operands(T, hd, seed=T + hd)
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    got = ref.mlstm_chunked_bwd_plain(*bargs, L=L)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TWIN_TOL


def test_the_first_forget_gate_is_exactly_zero():
    """With m0 = -1e30 (the models' empty state) the first step's f is
    exactly 0 (m_1 = log_i_1): the chunk's running products hold it, no
    NaN, and the carried state's gradients are exactly the twin's zeros."""
    bargs = list(_operands(40, 32, seed=3))
    bargs[7] = torch.full((B, H), -1e30)
    bargs[8] = ref.mlstm_recurrence_plain(*bargs[:8])[0]
    lfm, m, f, i = ref.mlstm_gates_plain(bargs[3], bargs[4], bargs[7])
    assert float(f[:, 0].abs().max()) == 0.0
    assert bool(((f >= 0) & (f <= 1) & (i >= 0) & (i <= 1)).all())
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    for L in (ref.S2_CHUNK, 16):
        got = ref.mlstm_chunked_bwd_plain(*bargs, L=L)
        assert all(bool(torch.isfinite(g).all()) for g in got)
        for g, w in zip(got[:5], want[:5]):
            assert _rel(g, w) <= TWIN_TOL
        for g, w in zip(got[5:], want[5:]):
            assert float(w.abs().max()) == 0.0 and torch.equal(g, w)


def test_a_tie_of_q_dot_n_at_one():
    """q . n = +1 and -1 exactly (den = max(|q . n|, 1) at its kink, where
    JAX passes half the gradient): the chunked model's q . n, from its
    chunk products, hits the tie as the twin's does, and its gradients
    are within 1e-5 of the twin's."""
    hd, T = 32, 3
    bargs = list(_operands(T, hd, seed=4))
    q, k = bargs[0].clone(), bargs[1].clone()
    # From an empty state the first step's n is k (i = 1, f = 0): one-hot q
    # and k of +-1 make q . n exactly +-1 in both orders of summation.
    q[:, 0], k[:, 0] = 0.0, 0.0
    q[:, 0, :, 0] = 1.0
    k[0, 0, :, 0], k[1, 0, :, 0] = 1.0, -1.0
    bargs[0], bargs[1] = q, k
    bargs[5], bargs[6] = torch.zeros(B, H, hd, hd), torch.zeros(B, H, hd)
    bargs[7] = torch.full((B, H), -1e30)
    bargs[8] = ref.mlstm_recurrence_plain(*bargs[:8])[0]
    n1 = k[:, 0]                                   # n after the first step
    qn = (q[:, 0] * n1).sum(-1)
    assert torch.equal(qn.abs(), torch.ones(B, H))
    assert torch.equal(ref._den_grad(qn), 0.5 * torch.sign(qn))
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    for L in (ref.S2_CHUNK, 4):
        got = ref.mlstm_chunked_bwd_plain(*bargs, L=L)
        for g, w in zip(got, want):
            assert _rel(g, w) <= TWIN_TOL


def test_the_split_holds_where_one_tf32_pass_misses():
    """At hd 64 over 256 steps the 3xTF32 model holds 1e-4 of max |.|
    against the sequential twin in every gradient, and one TF32 pass
    misses it."""
    bargs = _operands(256, 64, seed=5)
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    worst = {}
    for mm in (ref.matmul_tf32x3, ref.matmul_tf32):
        got = ref.mlstm_chunked_bwd_plain(*bargs, mm=mm)
        worst[mm.__name__] = max(_rel(g, w) for g, w in zip(got, want))
    assert worst["matmul_tf32x3"] <= KERNEL_TOL / 10
    assert worst["matmul_tf32"] > KERNEL_TOL


def test_the_stabiliser_backward_is_autograd_through_the_gates():
    """``ref.mlstm_gates_bwd_plain`` (the gates kernels' arithmetic) on
    seeded gradients of f, i and the final m: d log_i, d log_f and d m0
    within 1e-5 of autograd through ``ref.mlstm_gates_plain``."""
    bargs = _operands(9, 32, seed=6)
    li, lf, m0, dm = bargs[3], bargs[4], bargs[7], bargs[12]
    g = torch.Generator().manual_seed(7)
    df, di = (torch.randn(li.shape, generator=g) for _ in range(2))
    lfm, m, f, i = ref.mlstm_gates_plain(li, lf, m0)
    got = ref.mlstm_gates_bwd_plain(lfm, li, f, i, df, di, dm)
    leaves = [x.clone().requires_grad_(True) for x in (li, lf, m0)]
    _, m2, f2, i2 = ref.mlstm_gates_plain(*leaves)
    want = torch.autograd.grad(
        (f2 * df).sum() + (i2 * di).sum() + (m2[:, -1] * dm).sum(), leaves)
    for g_, w in zip(got, want):
        assert g_.shape == w.shape and _rel(g_, w) <= TWIN_TOL


class _Chunked(torch.autograd.Function):
    """The mLSTM recurrence on the twin, its gradient the chunked backward
    model: what the op computes on the chunked route."""

    L = ref.S2_CHUNK

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C0, n0, m0):
        out = ref.mlstm_recurrence_plain(q, k, v, log_i, log_f, C0, n0, m0)
        ctx.save_for_backward(q, k, v, log_i, log_f, C0, n0, m0, out[0])
        return out

    @staticmethod
    def backward(ctx, dy, dC, dn, dm):
        return ref.mlstm_chunked_bwd_plain(*ctx.saved_tensors, dy, dC, dn,
                                           dm, L=_Chunked.L)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("T,L", [(7, ref.S2_CHUNK), (7, 4), (40, 16)])
def test_mlstm_block_on_the_chunked_model_matches_jax_vjp(T, L, monkeypatch):
    """One mLSTM block of the port, its recurrence's gradient on the
    chunked model, against the JAX package's block and ``jax.vjp``: every
    weight's, the input's and the carried state's gradients from seeded
    cotangents of the output and of every final state, within 1e-4 of max
    |.|."""
    rng = np.random.default_rng(T + L)
    d, Hx = 32, 4
    hd = d // Hx
    p = jax.tree.map(np.asarray, jssm.init_mlstm(jax.random.PRNGKey(5), d,
                                                 Hx))
    x = rng.normal(size=(2, T, d)).astype(np.float32)
    st = (rng.normal(size=(2, Hx, hd, hd)).astype(np.float32),
          rng.normal(size=(2, Hx, hd)).astype(np.float32),
          rng.normal(size=(2, Hx)).astype(np.float32))

    def jfn(p, x, st):
        return jssm.mlstm_scan(p, x, Hx, state=st)

    out, vjp = jax.vjp(jax.jit(jfn), p, x, st)
    cot = jax.tree.map(
        lambda o: rng.normal(size=o.shape).astype(np.float32), out)
    gp, gx, gs = vjp(cot)
    want = dict({f"p.{k}": v for k, v in gp.items()}, x=gx,
                **{f"state{i}": v for i, v in enumerate(gs)})

    monkeypatch.setattr(_Chunked, "L", L)
    monkeypatch.setattr(tssm, "ssm_scan", type(
        "Chunked", (), {"mlstm_scan": staticmethod(_Chunked.apply)}))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    ts = tuple(_t(s).requires_grad_(True) for s in st)
    tout = tssm.mlstm_scan(tp, tx, Hx, state=ts)
    leaves = jax.tree.leaves(tout, is_leaf=lambda v: isinstance(
        v, torch.Tensor))
    for a, b in zip(leaves, jax.tree.leaves(out)):
        b = np.asarray(b)
        assert float(np.abs(host(a) - b).max()) <= JAX_TOL * float(
            np.abs(b).max())
    names = sorted(tp)
    grads = torch.autograd.grad(leaves, [tp[k] for k in names] + [tx, *ts],
                                [_t(c) for c in jax.tree.leaves(cot)])
    got = dict({f"p.{k}": host(g) for k, g in zip(names, grads)},
               x=host(grads[len(names)]),
               **{f"state{i}": host(g)
                  for i, g in enumerate(grads[len(names) + 1:])})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        assert float(np.abs(got[k] - w).max()) <= JAX_TOL * float(
            np.abs(w).max()), k


# -------------------------------------------------------------- routing
@pytest.mark.parametrize("T,hd,route", [
    (1, 192, "sequential"),                           # every decode step
    (ssm_scan.MLSTM_CHUNKED_MIN_T - 1, 192, "sequential"),
    (ssm_scan.MLSTM_CHUNKED_MIN_T, 192, "chunked"),
    (1024, 192, "chunked"),                           # xlstm-125m's train
    (4096, 192, "chunked"), (100, 64, "chunked"), (100, 32, "chunked"),
    (1024, 16, "sequential"), (1024, 128, "sequential"),
    (1024, 8, "sequential")])
def test_mlstm_route(T, hd, route):
    assert ssm_scan.mlstm_route(T, hd) == route


def test_forced_routes_refuse_before_any_launch():
    """A forced route the kernels do not take raises a ValueError before
    any build or launch (so on any device), as does an unknown route;
    nothing counts a launch."""
    before = dict(ops.LAUNCHES)
    bargs = _operands(8, 16)
    with pytest.raises(ValueError, match="chunked kernel"):
        ssm_scan.mlstm_scan_bwd_cuda(*bargs, _route="chunked")
    with pytest.raises(ValueError, match="no S2b route"):
        ssm_scan.mlstm_scan_bwd_cuda(*bargs, _route="blocked")
    bargs = _operands(8, 12)
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.mlstm_scan_bwd_cuda(*bargs, _route="sequential")
    rng = np.random.default_rng(0)
    hd = 32
    sargs = (*(_f32(rng, B, 8, H, hd) for _ in range(4)),
             _f32(rng, H, hd, 4 * hd), *(_f32(rng, B, H, hd)
                                         for _ in range(4)),
             _f32(rng, B, 8, H, hd), _f32(rng, B, 8, H, hd),
             *(_f32(rng, B, H, hd) for _ in range(4)))
    with pytest.raises(ValueError, match="no S3b route"):
        ssm_scan.slstm_scan_bwd_cuda(*sargs, _route="cluster")
    assert ops.LAUNCHES == before


# ------------------------------------------------ scratch and the dry-run
def test_backward_scratch_shapes():
    """S2b's scratch on each route at xlstm-125m's (4, 1024, 4, 192): both
    keep C, n and m every 16 steps (the saving forward's); the chunked
    route adds m_t and 7 tiles (6 of v, 1 of n) of dq, dk, d f and d i
    partials, the sequential one its recompute scratch and 6 slices of
    partials."""
    sc = ssm_scan.mlstm_bwd_scratch(4, 1024, 4, 192)
    assert sc == {"C": (4, 4, 64, 192, 192), "n": (4, 4, 64, 192),
                  "m": (4, 4, 64), "mt": (4, 1024, 4),
                  "dq": (7, 4, 1024, 4, 192), "dk": (7, 4, 1024, 4, 192),
                  "dfi": (2, 7, 4, 1024, 4)}
    assert ssm_scan.scratch_bytes(sc) == 328_929_280
    seq = ssm_scan.mlstm_bwd_scratch(4, 1024, 4, 192, "sequential")
    assert seq["dq"] == (6, 4, 1024, 4, 192) and "mt" not in seq
    assert ssm_scan.scratch_bytes(seq) == 342_560_768
    assert ssm_scan.mlstm_bwd_scratch(4, 1, 4, 192) == \
        ssm_scan.mlstm_bwd_scratch(4, 1, 4, 192, "sequential")
    assert ssm_scan.mlstm_tiles(192) == 7 and ssm_scan.mlstm_tiles(32) == 2


def _meta_mlstm_bwd(B_, T, h, hd):
    def m(*shape):
        return torch.empty(shape, device="meta")

    return (m(B_, T, h, hd), m(B_, T, h, hd), m(B_, T, h, hd), m(B_, T, h),
            m(B_, T, h), m(B_, h, hd, hd), m(B_, h, hd), m(B_, h),
            m(B_, T, h, hd), m(B_, T, h, hd), m(B_, h, hd, hd), m(B_, h, hd),
            m(B_, h))


@pytest.mark.parametrize("dims,route", [((2, 100, 4, 32), "chunked"),
                                        ((2, 7, 4, 32), "sequential"),
                                        ((2, 100, 4, 16), "sequential")])
def test_step_counter_counts_the_routes_scratch(dims, route):
    """The dry-run's StepCounter over S2b on meta tensors: its largest
    scratch is what the CUDA wrapper allocates on the rule's route, and the
    peak is the outputs plus that scratch, live together."""
    args = _meta_mlstm_bwd(*dims)
    assert ssm_scan.mlstm_route(dims[1], dims[3]) == route
    scratch = ssm_scan.scratch_bytes(ssm_scan.mlstm_bwd_scratch(
        *dims, route))
    assert ssm_scan.bwd_scratch("mlstm_scan_bwd", args) == \
        ssm_scan.mlstm_bwd_scratch(*dims, route)
    counter = d.StepCounter(exclude=args)
    with counter:
        outs = ssm_scan.mlstm_scan_bwd(*args)
    out_bytes = sum(o.numel() * 4 for o in outs)
    assert counter.scratch_peak == scratch
    assert counter.peak == out_bytes + scratch
