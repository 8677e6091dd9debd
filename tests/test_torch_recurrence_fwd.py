"""S2 and S3, the mLSTM and sLSTM forward recurrences, on their redesigned
kernels' terms on the CPU, at reduced widths: the plain model of the
chunked S2 kernel's arithmetic (``kernels/ref.py``:
``mlstm_chunked_plain``, the products taken by the 3xTF32 split as
``csrc/mlstm_chunked.cu`` takes them) against the sequential twin and
against the JAX package's mLSTM block; its chunk-start checkpoints, which
the chunked S2b model reads; S2's forward routing rule; the forced routes'
refusals of S2 and S3; S3's short-step layout at every xlstm config; and
S2b's scratch at one checkpoint a chunk.

Tolerances, each with its reason:

* Chunked model against the sequential twin: 1e-5 of max |.| of y and of
  each state.  The same recurrence summed in another order: a chunk's
  products (three TF32 passes, about 2^-21 relative a term) against the
  twin's step-by-step float32 updates.
* Against the JAX package's block (forward and ``jax.vjp``): 1e-4 of max
  |.|, as ``tests/test_torch_mlstm_chunked.py`` holds the chunked
  backward.

The card's kernels are held to the model and to the twins in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase s (g).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread)
from _torch_parity import host  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import ops, ref, ssm_scan  # noqa: E402
from repro_torch.launch import dryrun as d  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

B, H = 2, 2
TWIN_TOL = 1e-5
JAX_TOL = 1e-4


def _f32(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _operands(T, hd, seed=0):
    """S2's operands at T steps: scaled q and k, log forget gates below 0,
    and a non-zero state carried in."""
    rng = np.random.default_rng(seed)
    s = hd ** -0.5
    return (_f32(rng, B, T, H, hd, scale=s), _f32(rng, B, T, H, hd, scale=s),
            _f32(rng, B, T, H, hd), _f32(rng, B, T, H),
            torch.nn.functional.logsigmoid(_f32(rng, B, T, H) + 2.0),
            _f32(rng, B, H, hd, hd, scale=0.1), _f32(rng, B, H, hd),
            _f32(rng, B, H))


def _rel(got, want):
    """max |got - want| / max |want|: 0 where they are equal (zeros too)."""
    diff = float((got - want).abs().max())
    return 0.0 if diff == 0 else diff / float(want.abs().max())


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("L", [ref.S2_CHUNK, 4])
@pytest.mark.parametrize("T", [1, 7, 32, 33, 100])
def test_chunked_forward_matches_the_twin(T, L, hd):
    """y and the final C, n and m of the chunked model, a state carried in,
    within 1e-5 of the twin's max |.|; m (the stabiliser's chain, the
    twin's arithmetic) bitwise."""
    args = _operands(T, hd, seed=T + hd + L)
    want = ref.mlstm_recurrence_plain(*args)
    got = ref.mlstm_chunked_plain(*args, L=L)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TWIN_TOL
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("T,L", [(100, ref.S2_CHUNK), (64, ref.S2_CHUNK),
                                 (33, 4)])
def test_chunk_start_checkpoints_are_the_twin_states(T, L):
    """The model's checkpoints (what the saving kernel writes: C, n and m
    before every chunk) against the twin's states after T' = 0, L, 2 L, ...
    steps, within 1e-5 (m bitwise)."""
    args = _operands(T, 32, seed=T)
    y, C, n, m, Cs, ns, ms = ref.mlstm_chunked_plain(*args, L=L,
                                                      starts=True)
    nC = -(-T // L)
    assert Cs.shape == (B, H, nC, 32, 32) and ns.shape == (B, H, nC, 32)
    assert ms.shape == (B, H, nC)
    for c in range(nC):
        if c == 0:
            want = args[5:]
        else:
            t = c * L
            want = ref.mlstm_recurrence_plain(
                *(x[:, :t] for x in args[:5]), *args[5:])[1:]
        assert _rel(Cs[:, :, c], want[0]) <= TWIN_TOL
        assert _rel(ns[:, :, c], want[1]) <= TWIN_TOL
        assert torch.equal(ms[:, :, c], want[2])


def test_the_first_forget_gate_is_exactly_zero():
    """With m0 = -1e30 (the models' empty state) the first step's f is
    exactly 0: the chunk's running products carry it, no NaN, and the
    model holds the twin's y and states."""
    args = list(_operands(40, 32, seed=3))
    args[7] = torch.full((B, H), -1e30)
    f = ref.mlstm_gates_plain(args[3], args[4], args[7])[2]
    assert float(f[:, 0].abs().max()) == 0.0
    want = ref.mlstm_recurrence_plain(*args)
    for L in (ref.S2_CHUNK, 4):
        got = ref.mlstm_chunked_plain(*args, L=L)
        assert all(bool(torch.isfinite(g).all()) for g in got)
        for g, w in zip(got, want):
            assert _rel(g, w) <= TWIN_TOL


def test_a_tie_of_q_dot_n_at_one():
    """q . n = +1 and -1 exactly at the first step (den = max(|q . n|, 1)
    at its kink): the chunk form's q . n (sum_s M[t, s] i_s + p_t q_t .
    n_start) hits the tie as the twin's dot product does, and y agrees."""
    hd, T = 32, 3
    args = list(_operands(T, hd, seed=4))
    q, k = args[0].clone(), args[1].clone()
    q[:, 0], k[:, 0] = 0.0, 0.0
    q[:, 0, :, 0] = 1.0
    k[0, 0, :, 0], k[1, 0, :, 0] = 1.0, -1.0
    args[0], args[1] = q, k
    args[5], args[6] = torch.zeros(B, H, hd, hd), torch.zeros(B, H, hd)
    args[7] = torch.full((B, H), -1e30)
    qn = (q[:, 0] * k[:, 0]).sum(-1)               # n after the first step
    assert torch.equal(qn.abs(), torch.ones(B, H))
    want = ref.mlstm_recurrence_plain(*args)
    for L in (ref.S2_CHUNK, 4):
        got = ref.mlstm_chunked_plain(*args, L=L)
        for g, w in zip(got, want):
            assert _rel(g, w) <= TWIN_TOL


@pytest.mark.parametrize("T", [7, 33, 100])
def test_chunked_backward_on_the_forward_checkpoints(T):
    """``ref.mlstm_chunked_bwd_plain`` fed the chunked forward's
    checkpoints (what the chunked S2b kernel reads) is its default, bit for
    bit, and holds the backward twin within 1e-5; fed the twin's own states
    at the chunk starts it holds it too."""
    args = _operands(T, 32, seed=5 + T)
    rng = np.random.default_rng(T)
    y = ref.mlstm_recurrence_plain(*args)[0]
    ups = (_f32(rng, B, T, H, 32), _f32(rng, B, H, 32, 32),
           _f32(rng, B, H, 32), _f32(rng, B, H))
    bargs = args + (y,) + ups
    starts = ref.mlstm_chunked_plain(*args, starts=True)[4:6]
    fed = ref.mlstm_chunked_bwd_plain(*bargs, starts=starts)
    default = ref.mlstm_chunked_bwd_plain(*bargs)
    want = ref.mlstm_recurrence_bwd_plain(*bargs)
    L = ref.S2_CHUNK
    twin_starts = [ref.mlstm_recurrence_plain(
        *(x[:, :c * L] for x in args[:5]), *args[5:])[1:3] if c else args[5:7]
        for c in range(-(-T // L))]
    by_twin = ref.mlstm_chunked_bwd_plain(
        *bargs, starts=tuple(torch.stack(x, 2) for x in zip(*twin_starts)))
    for f, dflt, w, tw in zip(fed, default, want, by_twin):
        assert torch.equal(f, dflt)
        assert _rel(f, w) <= TWIN_TOL and _rel(tw, w) <= TWIN_TOL


class _ChunkedForward(torch.autograd.Function):
    """The mLSTM recurrence as the chunked route computes it: the forward
    on the chunked model, the gradient on the chunked backward model fed
    the forward's checkpoints."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C0, n0, m0):
        out = ref.mlstm_chunked_plain(q, k, v, log_i, log_f, C0, n0, m0,
                                      starts=True)
        ctx.save_for_backward(q, k, v, log_i, log_f, C0, n0, m0, out[0],
                              *out[4:6])
        return out[:4]

    @staticmethod
    def backward(ctx, dy, dC, dn, dm):
        *a, Cs, ns = ctx.saved_tensors
        return ref.mlstm_chunked_bwd_plain(*a, dy, dC, dn, dm,
                                           starts=(Cs, ns))


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("T", [7, 40])
def test_mlstm_block_on_the_chunked_model_matches_jax(T, monkeypatch):
    """One mLSTM block of the port, its recurrence on the chunked forward
    and backward models, against the JAX package's block and ``jax.vjp``:
    the output, the final states, every weight's, the input's and the
    carried state's gradients from seeded cotangents, within 1e-4 of max
    |.|."""
    rng = np.random.default_rng(T)
    d, Hx = 64, 2
    hd = d // Hx
    p = jax.tree.map(np.asarray, jssm.init_mlstm(jax.random.PRNGKey(6), d,
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

    monkeypatch.setattr(tssm, "ssm_scan", type(
        "Chunked", (), {"mlstm_scan": staticmethod(_ChunkedForward.apply)}))
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
    (ssm_scan.MLSTM_FWD_CHUNKED_MIN_T - 1, 192, "sequential"),
    (ssm_scan.MLSTM_FWD_CHUNKED_MIN_T, 192, "chunked"),
    (1024, 192, "chunked"),                           # xlstm-125m's prefill
    (100, 64, "chunked"), (16, 32, "chunked"),        # reduced() train steps
    (1024, 16, "sequential"), (1024, 128, "sequential")])
def test_mlstm_fwd_route(T, hd, route):
    assert ssm_scan.mlstm_fwd_route(T, hd) == route


def test_the_forward_crossover_is_at_or_above_the_backward_one():
    """S2's chunked kernel starts where the sweep found it beating the
    sequential one (T = 16), at or after S2b's (T = 8): a train step at T
    in between runs the sequential forward and the chunked backward, each
    on its own saving forward."""
    assert ssm_scan.MLSTM_FWD_CHUNKED_MIN_T == 16
    assert ssm_scan.MLSTM_FWD_CHUNKED_MIN_T >= ssm_scan.MLSTM_CHUNKED_MIN_T
    assert ssm_scan.mlstm_fwd_route(8, 192) == "sequential"
    assert ssm_scan.mlstm_route(8, 192) == "chunked"


def test_forced_forward_routes_refuse_before_any_launch():
    """A forced S2 or S3 route the kernels do not take raises a ValueError
    before any build or launch (so on any device), as does an unknown
    route; nothing counts a launch."""
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="chunked kernel"):
        ssm_scan.mlstm_scan_cuda(*_operands(8, 16), _route="chunked")
    with pytest.raises(ValueError, match="no S2 route"):
        ssm_scan.mlstm_scan_cuda(*_operands(8, 32), _route="blocked")
    with pytest.raises(ValueError, match="no kernel"):
        ssm_scan.mlstm_scan_cuda(*_operands(8, 12), _route="sequential")
    rng = np.random.default_rng(0)

    def sargs(hd):
        return (*(_f32(rng, B, 8, H, hd) for _ in range(4)),
                _f32(rng, H, hd, 4 * hd),
                *(_f32(rng, B, H, hd) for _ in range(4)))

    with pytest.raises(ValueError, match="no S3 route"):
        ssm_scan.slstm_scan_cuda(*sargs(32), _route="cluster")
    for route in ssm_scan.SLSTM_ROUTES:
        with pytest.raises(ValueError, match="no kernel"):
            ssm_scan.slstm_scan_cuda(*sargs(24), _route=route)
    assert ops.LAUNCHES == before


_XLSTM = [(name, red) for name, cfg in configs.ARCHS.items()
          if cfg.family == "xlstm" for red in (False, True)]


@pytest.mark.parametrize("name,red", _XLSTM)
def test_slstm_short_layout_at_every_xlstm_config(name, red):
    """Every xlstm config of the zoo and its ``reduced()`` form has an S3
    the short step's layout takes (csrc/ssm_scan.cu's
    ``slstm_short_kernel``): a cluster of 8 blocks of E = hd / 8 elements,
    a half-warp an element (16 E threads: whole warps, at most 1,024), one
    (step, element) a thread in each window of 16 steps, and the block's 4
    E columns of R spread four to a lane at hd / 16 rows (at most 64
    registers of R a lane); S2 takes the same width."""
    cfg = configs.ARCHS[name]
    cfg = cfg.reduced() if red else cfg
    hd = cfg.d_model // cfg.n_heads
    assert ssm_scan.slstm_supported(hd) and ssm_scan.mlstm_supported(hd)
    E, threads, window = hd // 8, 2 * hd, 16
    assert 8 * E == hd and threads == 16 * E == window * E
    assert threads % 32 == 0 and threads <= 1024
    assert threads * 4 * (hd // 16) == hd * 4 * E and 4 * (hd // 16) <= 64


@pytest.mark.parametrize("hd,ok", [(16, True), (32, True), (192, True),
                                   (256, True), (24, False), (8, False),
                                   (320, False)])
def test_slstm_supported(hd, ok):
    assert ssm_scan.slstm_supported(hd) == ok


# ------------------------------------------------ scratch and the dry-run
def test_backward_scratch_keeps_one_checkpoint_a_chunk():
    """S2b's chunked route keeps C, n and m before every chunk of S2_CHUNK
    steps (the chunked saving forward's), half the sequential route's
    every S2B_CKPT: at the dry-run's xlstm ``train_4k`` shard (16, 4096,
    4, 192), 128 checkpoints, not 256, and 4.05 GB of scratch."""
    sc = ssm_scan.mlstm_bwd_scratch(16, 4096, 4, 192)
    seq = ssm_scan.mlstm_bwd_scratch(16, 4096, 4, 192, "sequential")
    assert sc["C"] == (16, 4, 128, 192, 192) and seq["C"][2] == 256
    assert sc["n"] == (16, 4, 128, 192) and sc["m"] == (16, 4, 128)
    assert ssm_scan.scratch_bytes(sc) == 4_048_584_704
    assert ssm_scan.mlstm_bwd_scratch(2, 33, 4, 32)["C"] == (2, 4, 2, 32, 32)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("T", [33, 100])
def test_step_counter_counts_one_checkpoint_a_chunk(T):
    """The dry-run's StepCounter over S2b on meta tensors at T not a
    multiple of the chunk: its scratch is the chunked route's, ceil(T / 32)
    checkpoints."""
    b, h, hd = 2, 4, 32
    args = (_meta(b, T, h, hd), _meta(b, T, h, hd), _meta(b, T, h, hd),
            _meta(b, T, h), _meta(b, T, h), _meta(b, h, hd, hd),
            _meta(b, h, hd), _meta(b, h), _meta(b, T, h, hd),
            _meta(b, T, h, hd), _meta(b, h, hd, hd), _meta(b, h, hd),
            _meta(b, h))
    sc = ssm_scan.bwd_scratch("mlstm_scan_bwd", args)
    assert sc["C"][2] == -(-T // ssm_scan.S2_CHUNK)
    counter = d.StepCounter(exclude=args)
    with counter:
        ssm_scan.mlstm_scan_bwd(*args)
    assert counter.scratch_peak == ssm_scan.scratch_bytes(sc)
