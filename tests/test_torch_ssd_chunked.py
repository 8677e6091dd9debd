"""S1 and S1b in the chunked SSD form on the CPU, at reduced widths: the
plain model of the chunked kernels' arithmetic (``kernels/ref.py``:
``mamba2_chunked_plain`` and ``mamba2_chunked_bwd_plain``, the products
taken by the 3xTF32 split as ``csrc/ssd_chunked.cu`` takes them) against
the sequential twins and against ``jax.vjp`` through one Mamba2 layer of
the JAX package; ``ssm_scan.mamba2_route``'s rule and its forced routes'
refusals; the scratch each backward op's CUDA wrapper allocates and the
dry-run's ``StepCounter`` counts.

Tolerances, each with its reason:

* Chunked model against the sequential twins: 1e-5 of max |.| of y, s_T
  and each gradient.  The same recurrence summed in another order: a
  chunk's products (three TF32 passes, about 2^-21 relative a term)
  against the twins' step-by-step float32 updates.
* One TF32 pass instead of the split misses 1e-4 (the tolerance the
  kernels are held to on the card): the reason for the split.
* Against ``jax.vjp`` of the JAX package's layer: 1e-4 of max |grad|, as
  ``tests/test_torch_ssm_scan_bwd.py`` holds the sequential route.

The card's kernels are held to the model and to the twins in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase s (g).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread)
from _torch_parity import host  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref, ssm_scan  # noqa: E402
from repro_torch.launch import dryrun as d  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

B, H, DS, HD = 2, 3, 8, 8
TWIN_TOL = 1e-5
KERNEL_TOL = 1e-4
JAX_TOL = 1e-4


def _f32(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _operands(T, seed=0, ds=DS, hd=HD, h=H, special=False):
    """S1's operands at T steps, a non-zero state carried in, and seeded
    upstream gradients of y and s_T.  ``special`` sets decays to exactly 0
    and exactly 1 at the first, a middle and the last step, and at a chunk
    boundary of a 4-step chunk."""
    rng = np.random.default_rng(seed)
    decay = torch.tensor(np.exp(-rng.random((B, T, h))), dtype=torch.float32)
    if special:
        for t in {0, T // 2, T - 1, min(4, T - 1)}:
            decay[0, t, 0] = 0.0
            decay[1, t, h - 1] = 1.0
        decay[1, :, 0] = 1.0
    args = (decay, _f32(rng, B, T, ds), _f32(rng, B, T, ds),
            _f32(rng, B, T, h, hd), _f32(rng, B, h, ds, hd))
    ups = (_f32(rng, B, T, h, hd), _f32(rng, B, h, ds, hd))
    return args, ups


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("L", [ref.S1_CHUNK, 4])
@pytest.mark.parametrize("T", [1, 7, 64, 100])
def test_chunked_forward_matches_the_twin(T, L):
    """y and s_T of the chunked model within 1e-5 of the sequential
    twin's max |.|; its chunk start states are the twin's states at the
    chunk boundaries."""
    args, _ = _operands(T)
    y, s = ref.mamba2_recurrence_plain(*args)
    yc, sc, starts = ref.mamba2_chunked_plain(*args, L=L, starts=True)
    assert yc.shape == y.shape and sc.shape == s.shape
    assert _rel(yc, y) <= TWIN_TOL and _rel(sc, s) <= TWIN_TOL
    assert starts.shape == (B, H, math.ceil(T / L), DS, HD)
    for c in range(starts.shape[2]):
        want = args[4] if c == 0 else ref.mamba2_recurrence_plain(
            *(a[:, :c * L] for a in args[:4]), args[4])[1]
        assert _rel(starts[:, :, c], want) <= TWIN_TOL


@pytest.mark.parametrize("L", [ref.S1_CHUNK, 4])
@pytest.mark.parametrize("T", [1, 7, 64, 100])
def test_chunked_backward_matches_the_twin(T, L):
    """The five gradients of the chunked backward model, a state carried
    in and upstream gradients of y and s_T, within 1e-5 of the backward
    twin's max |.|."""
    args, ups = _operands(T, seed=1)
    want = ref.mamba2_recurrence_bwd_plain(*args, *ups)
    got = ref.mamba2_chunked_bwd_plain(*args, *ups, L=L)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TWIN_TOL


@pytest.mark.parametrize("T", [7, 100])
def test_decays_of_exactly_zero_and_one(T):
    """Decays of exactly 0 (a step that forgets the state) and exactly 1
    give no NaN: the segment products are running products in linear
    space and d decay needs no division."""
    args, ups = _operands(T, seed=2, special=True)
    for L in (ref.S1_CHUNK, 4):
        y, s = ref.mamba2_chunked_plain(*args, L=L)
        got = ref.mamba2_chunked_bwd_plain(*args, *ups, L=L)
        assert all(bool(torch.isfinite(x).all()) for x in (y, s, *got))
        yt, st = ref.mamba2_recurrence_plain(*args)
        assert _rel(y, yt) <= TWIN_TOL and _rel(s, st) <= TWIN_TOL
        for g, w in zip(got, ref.mamba2_recurrence_bwd_plain(*args, *ups)):
            assert _rel(g, w) <= TWIN_TOL


def test_segments_are_running_products():
    """seg, p, w and pm of a chunk, the running products the kernel
    builds, bitwise a loop of multiplications in the same order, zero
    above the diagonal."""
    dec = torch.tensor([[0.5, 0.0, 0.9, 1.0, 0.3]])
    seg, p, w, pm = ref.ssd_segments(dec)
    for s in range(5):
        v = torch.tensor(1.0)
        for t in range(5):
            if t < s:
                assert float(seg[0, t, s]) == 0.0
                continue
            if t > s:
                v = v * dec[0, t]
            assert torch.equal(seg[0, t, s], v)
    run = torch.cumprod(dec, -1)
    assert torch.equal(p, run)
    assert torch.equal(w, seg[:, -1])
    assert torch.equal(pm[:, 1:], p[:, :-1]) and float(pm[0, 0]) == 1.0


def test_the_split_holds_where_one_tf32_pass_misses():
    """At the kernels' widths (ds = hd = 64) over 256 steps, the 3xTF32
    model holds 1e-4 of max |.| against the sequential twins in y, s_T
    and every gradient, and one TF32 pass misses it."""
    args, ups = _operands(256, seed=3, ds=64, hd=64, h=2)
    y, s = ref.mamba2_recurrence_plain(*args)
    want = (y, s) + ref.mamba2_recurrence_bwd_plain(*args, *ups)
    worst = {}
    for mm in (ref.matmul_tf32x3, ref.matmul_tf32):
        got = (ref.mamba2_chunked_plain(*args, mm=mm)
               + ref.mamba2_chunked_bwd_plain(*args, *ups, mm=mm))
        worst[mm.__name__] = max(_rel(g, w) for g, w in zip(got, want))
    assert worst["matmul_tf32x3"] <= KERNEL_TOL / 10
    assert worst["matmul_tf32"] > KERNEL_TOL


class _Chunked(torch.autograd.Function):
    """The Mamba2 recurrence on the chunked model, its gradient the chunked
    backward model: what the op computes on the chunked route."""

    L = ref.S1_CHUNK

    @staticmethod
    def forward(ctx, decay, Bm, Cm, dtx, s0):
        ctx.save_for_backward(decay, Bm, Cm, dtx, s0)
        return ref.mamba2_chunked_plain(decay, Bm, Cm, dtx, s0,
                                        L=_Chunked.L)

    @staticmethod
    def backward(ctx, dy, dsT):
        return ref.mamba2_chunked_bwd_plain(*ctx.saved_tensors, dy, dsT,
                                            L=_Chunked.L)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("T,L", [(7, ref.S1_CHUNK), (7, 4),
                                 (100, ref.S1_CHUNK)])
def test_mamba2_layer_on_the_chunked_model_matches_jax_vjp(T, L,
                                                           monkeypatch):
    """One Mamba2 layer of the port, its recurrence on the chunked model
    forward and backward, against the JAX package's layer and
    ``jax.vjp``: the output and final states, and every weight's, the
    input's and the carried states' gradients from seeded cotangents,
    within 1e-4 of max |.|."""
    rng = np.random.default_rng(T + L)
    d = 32
    p = jax.tree.map(np.asarray, jssm.init_mamba2(jax.random.PRNGKey(3), d,
                                                  DS, HD))
    n = p["A_log"].shape[0]
    p.update(A_log=(0.5 * rng.normal(size=n)).astype(np.float32),
             D=rng.normal(size=n).astype(np.float32),
             dt_bias=rng.normal(size=n).astype(np.float32))
    x = rng.normal(size=(2, T, d)).astype(np.float32)
    st = (rng.normal(size=(2, n, DS, HD)).astype(np.float32),
          rng.normal(size=(2, tssm.CONV_W - 1, 2 * d + 2 * DS)
                     ).astype(np.float32))

    def jfn(p, x, st):
        return jssm.mamba2_scan(p, x, DS, HD, state=st[0], conv_state=st[1])

    out, vjp = jax.vjp(jax.jit(jfn), p, x, st)
    cot = jax.tree.map(
        lambda o: rng.normal(size=o.shape).astype(np.float32), out)
    gp, gx, gs = vjp(cot)
    want = dict({f"p.{k}": v for k, v in gp.items()}, x=gx,
                **{f"state{i}": v for i, v in enumerate(gs)})

    monkeypatch.setattr(_Chunked, "L", L)
    monkeypatch.setattr(tssm, "ssm_scan", type(
        "Chunked", (), {"mamba2_scan": staticmethod(_Chunked.apply)}))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    ts = tuple(_t(s).requires_grad_(True) for s in st)
    tout = tssm.mamba2_scan(tp, tx, DS, HD, state=ts[0], conv_state=ts[1])
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
@pytest.mark.parametrize("T,ds,hd,route", [
    (1, 64, 64, "sequential"),                        # every decode step
    (ssm_scan.MAMBA2_CHUNKED_MIN_T - 1, 64, 64, "sequential"),
    (ssm_scan.MAMBA2_CHUNKED_MIN_T, 64, 64, "chunked"),
    (1024, 64, 64, "chunked"),                        # zamba2-7b's prefill
    (4096, 32, 64, "chunked"), (100, 64, 32, "chunked"),
    (100, 32, 32, "chunked"),
    (1024, 16, 16, "sequential"),                     # zamba2's reduced()
    (1024, 48, 64, "sequential"), (1024, 64, 128, "sequential"),
    (7, 64, 64, "sequential")])
def test_mamba2_route(T, ds, hd, route):
    assert ssm_scan.mamba2_route(T, ds, hd) == route


def test_forced_routes_refuse_before_any_launch():
    """A forced route that the kernels do not take raises a ValueError
    before any build or launch (so on any device), as does an unknown
    route; nothing counts a launch."""
    from repro_torch.kernels import ops

    before = dict(ops.LAUNCHES)
    args, ups = _operands(8, ds=16, hd=16)
    for fn, extra in ((ssm_scan.mamba2_scan_cuda, ()),
                      (ssm_scan.mamba2_scan_bwd_cuda, ups)):
        with pytest.raises(ValueError, match="chunked kernel"):
            fn(*args, *extra, _route="chunked")
        with pytest.raises(ValueError, match="no S1"):
            fn(*args, *extra, _route="blocked")
    args, ups = _operands(8, ds=64, hd=12)
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.mamba2_scan_cuda(*args, _route="sequential")
    assert ops.LAUNCHES == before


# ------------------------------------------------ scratch and the dry-run
def test_backward_scratch_shapes():
    """The scratch S1b's wrapper allocates on each route at zamba2-7b's
    (4, 1024, 112, 64, 64): the chunked route keeps a start state a chunk
    of 32 steps (0.2349 GB) beside the per-head dB and dC partials (0.2349
    GB); the sequential one a state every 8 steps (0.9395 GB), a block's
    recompute scratch and the same partials."""
    sc = ssm_scan.mamba2_bwd_scratch(4, 1024, 112, 64, 64)
    assert sc == {"dBh": (4, 1024, 112, 64), "dCh": (4, 1024, 112, 64),
                  "starts": (4, 112, 32, 64, 64)}
    assert ssm_scan.scratch_bytes(sc) == 469_762_048
    seq = ssm_scan.mamba2_bwd_scratch(4, 1024, 112, 64, 64, "sequential")
    assert seq["ckpt"] == (4, 112, 128, 64, 64)
    assert ssm_scan.scratch_bytes(seq) == 1_233_125_376
    assert ssm_scan.mamba2_bwd_scratch(4, 1, 112, 64, 64) == \
        ssm_scan.mamba2_bwd_scratch(4, 1, 112, 64, 64, "sequential")
    # S2b at xlstm-125m's train_4k shard (16, 4096, 4, 192): the chunked
    # route's 7 tiles of dq and dk partials against the sequential route's
    # 6 slices and its recompute scratch.
    assert ssm_scan.scratch_bytes(ssm_scan.mlstm_bwd_scratch(
        16, 4096, 4, 192)) == 5_262_868_480
    assert ssm_scan.scratch_bytes(ssm_scan.mlstm_bwd_scratch(
        16, 4096, 4, 192, "sequential")) == 5_013_831_680
    assert ssm_scan.scratch_bytes(ssm_scan.slstm_bwd_scratch(
        16, 4096, 4, 192)) == 1_447_034_880


def _meta_bwd_args(op, B_, T, h, hd, ds=0):
    """A backward op's operands as meta tensors (what the dry-run's
    shards are)."""
    def m(*shape):
        return torch.empty(shape, device="meta")

    if op == "mamba2_scan_bwd":
        return (m(B_, T, h), m(B_, T, ds), m(B_, T, ds), m(B_, T, h, hd),
                m(B_, h, ds, hd), m(B_, T, h, hd), m(B_, h, ds, hd))
    if op == "mlstm_scan_bwd":
        return (m(B_, T, h, hd), m(B_, T, h, hd), m(B_, T, h, hd),
                m(B_, T, h), m(B_, T, h), m(B_, h, hd, hd), m(B_, h, hd),
                m(B_, h), m(B_, T, h, hd), m(B_, T, h, hd), m(B_, h, hd, hd),
                m(B_, h, hd), m(B_, h))
    return (*(m(B_, T, h, hd) for _ in range(4)), m(h, hd, 4 * hd),
            *(m(B_, h, hd) for _ in range(4)), m(B_, T, h, hd),
            m(B_, T, h, hd), *(m(B_, h, hd) for _ in range(4)))


@pytest.mark.parametrize("op,dims", [
    ("mamba2_scan_bwd", (2, 100, 3, 64, 64)),         # chunked
    ("mamba2_scan_bwd", (2, 100, 3, 16, 16)),         # sequential
    ("mamba2_scan_bwd", (2, 7, 3, 64, 64)),           # sequential (short)
    ("mlstm_scan_bwd", (2, 100, 4, 32)),
    ("slstm_scan_bwd", (2, 100, 4, 32))])
def test_step_counter_counts_each_backward_ops_scratch(op, dims):
    """The dry-run's StepCounter over one backward op on meta tensors:
    its largest scratch is what the op's CUDA wrapper allocates
    (``ssm_scan.bwd_scratch``, the shapes the wrapper allocates from), and
    the peak is the outputs plus that scratch, live together."""
    args = _meta_bwd_args(op, *dims)
    scratch = ssm_scan.scratch_bytes(ssm_scan.bwd_scratch(op, args))
    assert scratch > 0
    counter = d.StepCounter(exclude=args)
    with counter:
        outs = getattr(ssm_scan, op)(*args)
    out_bytes = sum(o.numel() * 4 for o in outs)
    assert counter.scratch_peak == scratch
    assert counter.peak == out_bytes + scratch
    assert ssm_scan.bwd_scratch("mamba2_scan", args) == {}
