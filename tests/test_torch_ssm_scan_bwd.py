"""The recurrences' backward (``repro_torch.kernels.ssm_scan``: S1b, S2b,
S3b) on the CPU, at small widths and T <= 7: each backward twin
(``kernels/ref.py``) against ``torch.autograd`` through its forward twin,
each op under autograd against the backward twin, ``opcheck`` of the
forward ops' autograd registration and fakes, and one Mamba2 layer, one
mLSTM block and one sLSTM block against ``jax.vjp`` of the JAX package's
``models/ssm.py``.

Tolerances, each with its reason:

* Backward twin against autograd through the forward twin: 1e-5 of the
  operand's max |grad|.  The same float32 formulas in other orders (the
  twin's explicit contractions against autograd's transposed products).
* Op under autograd against the backward twin: bitwise (the CPU op is the
  twin).
* Against ``jax.vjp``: 1e-4 of max |grad|.  Both differentiate the same
  float32 blocks; the projections and the reverse loops sum in other
  orders, over T steps.

The card's kernels are held to the backward twins in
``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_parity import host  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref, ssm_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

B, H, DS, HD = 2, 3, 8, 8        # Mamba2: batch, heads, state, head dim
XH, XD = 2, 8                    # xLSTM: heads, head dim
TWIN_TOL = 1e-5
JAX_TOL = 1e-4


def _f32(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _operands(name, T, seed=0):
    """Each op's operands at T steps, a non-zero state carried in."""
    rng = np.random.default_rng(seed)
    if name == "mamba2":
        return (torch.tensor(np.exp(-rng.random((B, T, H))),
                             dtype=torch.float32),
                _f32(rng, B, T, DS), _f32(rng, B, T, DS),
                _f32(rng, B, T, H, HD), _f32(rng, B, H, DS, HD))
    qkv = [_f32(rng, B, T, XH, XD, scale=XD ** -0.5) for _ in range(3)]
    if name == "mlstm":
        return (*qkv, _f32(rng, B, T, XH), _f32(rng, B, T, XH) - 1.0,
                _f32(rng, B, XH, XD, XD), _f32(rng, B, XH, XD),
                _f32(rng, B, XH))
    return (*[_f32(rng, B, T, XH, XD) for _ in range(4)],
            _f32(rng, XH, XD, 4 * XD, scale=XD ** -0.5),
            *[_f32(rng, B, XH, XD) for _ in range(4)])


OPS = {"mamba2": (ssm_scan.mamba2_scan, ref.mamba2_recurrence_plain,
                  ref.mamba2_recurrence_bwd_plain),
       "mlstm": (ssm_scan.mlstm_scan, ref.mlstm_recurrence_plain,
                 ref.mlstm_recurrence_bwd_plain),
       "slstm": (ssm_scan.slstm_scan, ref.slstm_recurrence_plain,
                 ref.slstm_recurrence_bwd_plain)}


def _upstream(outs, seed=5):
    """A seeded upstream gradient of every output, final states too."""
    rng = np.random.default_rng(seed)
    return [_f32(rng, *o.shape) for o in outs]


def _bwd_args(name, args, outs, ups):
    """The backward twin's arguments: S2 and S3 read the forward's y."""
    y = () if name == "mamba2" else (outs[0].detach(),)
    return [a.detach() for a in args] + list(y) + list(ups)


@pytest.mark.parametrize("name", sorted(OPS))
@pytest.mark.parametrize("T", [1, 7])
def test_backward_twin_is_autograd_through_the_forward_twin(name, T):
    _, twin, bwd = OPS[name]
    args = [a.requires_grad_(True) for a in _operands(name, T)]
    outs = twin(*args)
    ups = _upstream(outs)
    want = torch.autograd.grad(outs, args, ups)
    got = bwd(*_bwd_args(name, args, outs, ups))
    assert len(got) == len(want) == len(args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        assert scale > 0
        assert float((g - w).abs().max()) <= TWIN_TOL * scale


@pytest.mark.parametrize("name", sorted(OPS))
def test_the_op_under_autograd_is_the_backward_twin(name):
    """Bitwise on the CPU; with no upstream gradient of the final states
    too (they count as zeros)."""
    op, _, bwd = OPS[name]
    args = [a.requires_grad_(True) for a in _operands(name, 7)]
    outs = op(*args)
    ups = _upstream(outs)
    got = torch.autograd.grad(outs, args, ups, retain_graph=True)
    want = bwd(*_bwd_args(name, args, outs, ups))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = torch.autograd.grad(outs[0], args, ups[0])
    zeros = [torch.zeros_like(u) for u in ups[1:]]
    want = bwd(*_bwd_args(name, args, outs, [ups[0]] + zeros))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", sorted(OPS))
def test_opcheck_of_the_forward_op(name):
    op = OPS[name][0]
    args = [a.requires_grad_(True) for a in _operands(name, 3)]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))


# ------------------------------------------------------ against jax.vjp
def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want):
    for name, g, w in zip(sorted(want), (got[k] for k in sorted(want)),
                          (want[k] for k in sorted(want))):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        assert float(np.abs(g - w).max()) <= JAX_TOL * scale, name


def _block_case(block, seed):
    """JAX's block function, its weights, input and initial state (numpy),
    and the port's block function."""
    rng = np.random.default_rng(seed)
    d = 32
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    if block == "mamba2":
        p = jax.tree.map(np.asarray, jssm.init_mamba2(
            jax.random.PRNGKey(seed), d, DS, HD))
        n = p["A_log"].shape[0]
        p.update(A_log=(0.5 * rng.normal(size=n)).astype(np.float32),
                 D=rng.normal(size=n).astype(np.float32),
                 dt_bias=rng.normal(size=n).astype(np.float32))
        st = (rng.normal(size=(2, n, DS, HD)).astype(np.float32),
              rng.normal(size=(2, tssm.CONV_W - 1, 2 * d + 2 * DS)
                         ).astype(np.float32))

        def jfn(p, x, st):
            return jssm.mamba2_scan(p, x, DS, HD, state=st[0],
                                    conv_state=st[1])

        def tfn(p, x, st):
            return tssm.mamba2_scan(p, x, DS, HD, state=st[0],
                                    conv_state=st[1])
        return jfn, tfn, p, x, st
    Hx = 4
    hd = d // Hx
    if block == "mlstm":
        p = jax.tree.map(np.asarray, jssm.init_mlstm(
            jax.random.PRNGKey(seed), d, Hx))
        st = (rng.normal(size=(2, Hx, hd, hd)).astype(np.float32),
              rng.normal(size=(2, Hx, hd)).astype(np.float32),
              rng.normal(size=(2, Hx)).astype(np.float32))
        return (lambda p, x, st: jssm.mlstm_scan(p, x, Hx, state=st),
                lambda p, x, st: tssm.mlstm_scan(p, x, Hx, state=st),
                p, x, st)
    p = jax.tree.map(np.asarray, jssm.init_slstm(
        jax.random.PRNGKey(seed), d, Hx))
    st = tuple(rng.normal(size=(2, Hx, hd)).astype(np.float32)
               for _ in range(4))
    return (lambda p, x, st: jssm.slstm_scan(p, x, Hx, state=st),
            lambda p, x, st: tssm.slstm_scan(p, x, Hx, state=st),
            p, x, st)


@pytest.mark.parametrize("block", ["mamba2", "mlstm", "slstm"])
def test_block_gradients_match_jax_vjp(block):
    """Every weight's, the input's and the carried state's gradient, from
    seeded cotangents of the output and of every final state."""
    jfn, tfn, p, x, st = _block_case(block, seed={"mamba2": 3, "mlstm": 5,
                                                  "slstm": 6}[block])
    out, vjp = jax.vjp(jax.jit(jfn), p, x, st)
    rng = np.random.default_rng(11)
    cot = jax.tree.map(
        lambda o: rng.normal(size=o.shape).astype(np.float32), out)
    gp, gx, gs = vjp(cot)
    want = dict({f"p.{k}": v for k, v in gp.items()}, x=gx,
                **{f"state{i}": v for i, v in enumerate(gs)})

    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    tx = _t(x).requires_grad_(True)
    ts = tuple(_t(s).requires_grad_(True) for s in st)
    tout = tfn(tp, tx, ts)
    leaves = jax.tree.leaves(tout, is_leaf=lambda v: isinstance(
        v, torch.Tensor))
    cots = [_t(c) for c in jax.tree.leaves(cot)]
    names = sorted(tp)
    grads = torch.autograd.grad(leaves, [tp[k] for k in names] + [tx, *ts],
                                cots)
    got = dict({f"p.{k}": host(g) for k, g in zip(names, grads)},
               x=host(grads[len(names)]),
               **{f"state{i}": host(g)
                  for i, g in enumerate(grads[len(names) + 1:])})
    assert sorted(got) == sorted(want)
    _close(got, want)
    # the torch outputs are the JAX block's, as tests/test_torch_ssm.py has
    for a, b in zip(leaves, jax.tree.leaves(out)):
        np.testing.assert_allclose(host(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
