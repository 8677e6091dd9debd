"""The recurrences as ops (``repro_torch.kernels.ssm_scan``: S1 Mamba2, S2
mLSTM, S3 sLSTM, and their backward ops S1b-S3b) on the CPU, at small
widths: the route of ``models/ssm.py`` (the op, with or without a
gradient), each op's fake implementation against its real one, the
dry-run's ``StepCounter`` over an op against its twin's loop, gradients
through the scans' ops against autograd through the twins, and
``launch.dryrun.run_cell`` on prefill and train cells whose recurrences
run 4,608 time steps.

The op's outputs are held bitwise (the CPU op is the twin, the loop
``models/ssm.py`` ran before the ops); gradients within 1e-5 of max |grad|
(the backward twin's explicit reverse loop against autograd through the
forward twin: the same formulas in other orders).  The card's kernels are
held to the twins in ``tests/test_torch_cuda.py``, the backward twins to
autograd and to ``jax.vjp`` in ``tests/test_torch_ssm_scan_bwd.py``.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import _torch_parity  # noqa: E402,F401  (one torch thread)
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.kernels import ops, ref, ssm_scan  # noqa: E402
from repro_torch.launch import dryrun as d  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

B, H, DS, HD = 2, 3, 8, 8        # Mamba2: batch, heads, state, head dim
XH, XD = 2, 8                    # xLSTM: heads, head dim


def _f32(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _operands(name, T, seed=0):
    """Each op's operands at T steps, a non-zero state carried in."""
    rng = np.random.default_rng(seed)
    if name == "mamba2":
        return (torch.exp(-torch.rand(B, T, H, generator=torch.Generator()
                                      .manual_seed(seed))),
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


OPS = {"mamba2": (ssm_scan.mamba2_scan, ref.mamba2_recurrence_plain),
       "mlstm": (ssm_scan.mlstm_scan, ref.mlstm_recurrence_plain),
       "slstm": (ssm_scan.slstm_scan, ref.slstm_recurrence_plain)}


class _Seen(TorchDispatchMode):
    """The names of the ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _blocks(seed=0, grad=False):
    """A Mamba2 layer's weights (A_log, D, dt_bias drawn), an m/s pair's,
    and their input x (1, 5, 16)."""
    g = torch.Generator().manual_seed(seed)
    pm = ssm.init_mamba2(g, 16, DS, HD, device="cpu")
    n = pm["A_log"].shape[0]
    pm.update(A_log=0.5 * torch.randn(n, generator=g),
              D=torch.randn(n, generator=g),
              dt_bias=torch.randn(n, generator=g))
    pair = {"m": dict(ssm.init_mlstm(g, 16, XH, device="cpu"),
                      ln=torch.ones(16)),
            "s": dict(ssm.init_slstm(g, 16, XH, device="cpu"),
                      ln=torch.ones(16))}
    for tree in (pm, pair["m"], pair["s"]):
        for v in tree.values():
            v.requires_grad_(grad)
    return pm, pair, torch.randn((1, 5, 16), generator=g)


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("grad", [True, False])
def test_the_route_takes_the_twin_under_autograd_and_the_op_else(grad):
    """The scans call their ops with and without a gradient (the ops'
    autograd formulas are the backward ops)."""
    pm, pair, x = _blocks(grad=grad)
    cfg = configs.get("xlstm-125m").reduced(d_model=16, n_heads=XH)
    before = dict(ops.LAUNCHES)
    with torch.set_grad_enabled(grad), _Seen() as seen:
        ssm.mamba2_scan(pm, x, DS, HD)
        tf._xlstm_pair(cfg, pair, x)
    ops_seen = {n for n in seen.names if n.startswith("repro_torch.")}
    assert ops_seen == {"repro_torch.mamba2_scan",
                        "repro_torch.mlstm_scan",
                        "repro_torch.slstm_scan"}
    assert ops.LAUNCHES == before        # the CPU runs the twins: no launch


@pytest.mark.parametrize("name", sorted(OPS))
def test_the_op_is_its_twin_and_its_fake_has_its_shapes(name):
    op, twin = OPS[name]
    args = _operands(name, 7)
    got = op(*args)
    want = twin(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert all(g.data_ptr() != a.data_ptr() for a in args)
    fake = op(*(a.to("meta") for a in args))
    assert [(f.shape, f.dtype, f.device.type) for f in fake] == [
        (g.shape, g.dtype, "meta") for g in got]


BWD = {"mamba2_bwd": (ssm_scan.mamba2_scan_bwd,
                      ref.mamba2_recurrence_bwd_plain),
       "mlstm_bwd": (ssm_scan.mlstm_scan_bwd, ref.mlstm_recurrence_bwd_plain),
       "slstm_bwd": (ssm_scan.slstm_scan_bwd, ref.slstm_recurrence_bwd_plain)}


def _bwd_operands(name, T):
    """A backward op's operands: the forward's, y (S2, S3) and an upstream
    gradient of every output."""
    fwd = name[:-len("_bwd")]
    args = _operands(fwd, T)
    outs = OPS[fwd][1](*args)
    rng = np.random.default_rng(7)
    ups = tuple(_f32(rng, *o.shape) for o in outs)
    return args + (() if fwd == "mamba2" else (outs[0],)) + ups


@pytest.mark.parametrize("name", sorted(OPS) + sorted(BWD))
@pytest.mark.parametrize("T", [1, 7])
def test_step_counter_counts_the_op_as_the_twins_loop(name, T):
    op, twin = {**OPS, **BWD}[name]
    args = (_bwd_operands(name, T) if name in BWD else _operands(name, T))
    flops = []
    for fn in (op, twin):
        counter = d.StepCounter()
        with counter:
            fn(*args)
        flops.append(counter.flops)
    assert flops[0] == flops[1] > 0


def test_gradients_through_the_routed_scans_are_the_twins(monkeypatch):
    """A Mamba2 layer's and an m/s pair's gradients through the ops (their
    backward twins' reverse loops), against autograd through the same with
    every recurrence on its forward twin: within 1e-5 of max |grad|."""
    cfg = configs.get("xlstm-125m").reduced(d_model=16, n_heads=XH)

    def grads():
        pm, pair, x = _blocks(grad=True)
        x.requires_grad_(True)
        y, (s, _) = ssm.mamba2_scan(pm, x, DS, HD)
        z, m_state, s_state = tf._xlstm_pair(cfg, pair, x)
        loss = (y * y).sum() + s.sum() + (z * z).sum() + sum(
            t.sum() for t in (*m_state, *s_state))
        leaves = [x] + _leaves(pm) + _leaves(pair)
        return torch.autograd.grad(loss, leaves)

    routed = grads()
    monkeypatch.setattr(ssm, "ssm_scan", types.SimpleNamespace(
        mamba2_scan=ref.mamba2_recurrence_plain,
        mlstm_scan=ref.mlstm_recurrence_plain,
        slstm_scan=ref.slstm_recurrence_plain))
    direct = grads()
    for a, b in zip(routed, direct):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    # every leaf's gradient reaches it: none is cut at an op
    assert all(bool(g.abs().sum() > 0) for g in routed)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_run_cell_takes_long_prefills_through_the_ops(arch):
    """A prefill and a train cell whose recurrences run 2 layers x 2,304 =
    4,608 time steps, on a fake 2 x 4 mesh at reduced() size: both run,
    the train cell's gradients through the backward ops' fakes (across the
    sharder's local maps), its FLOPs past the prefill's."""
    cfg = configs.get(arch).reduced()
    sizes = {"data": 2, "model": 4}
    mesh = ((2, 4), ("data", "model"))
    prefill = shp.ShapeSpec("long", "prefill", 2304, 4)
    assert d.scan_steps(cfg, prefill) == 2 * 2304
    rec = d.run_cell(arch, prefill, False, device_type="cpu", cfg=cfg,
                     mesh_shape=mesh)
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["memory"]["argument_size_in_bytes"] == d.argument_bytes(
        cfg, prefill, sizes, sh.default_rules()) > 0
    assert rec["flops_per_device"] > 0
    train = d.run_cell(arch, shp.ShapeSpec("long", "train", 2304, 4), False,
                       device_type="cpu", cfg=cfg, mesh_shape=mesh)
    assert train["status"] == "ok" and train["n_devices"] == 8
    assert train["flops_per_device"] > rec["flops_per_device"]
