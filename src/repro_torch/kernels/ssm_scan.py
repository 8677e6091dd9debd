"""The recurrences of the hybrid and xlstm families as one op each: S1
(Mamba2), S2 (mLSTM) and S3 (sLSTM), with their kernels in
``csrc/ssm_scan.cu``.

The JAX package runs each recurrence as one ``lax.scan`` (its
``models/ssm.py``): one loop that XLA keeps on the device, and that its
dry-run counts once and multiplies by the trip count.  Here each is one
``torch.library`` op, ``repro_torch::mamba2_scan``, ``::mlstm_scan`` and
``::slstm_scan``, with

* a CPU implementation, the plain twin in :mod:`repro_torch.kernels.ref`
  (the time loop of ``models/ssm.py`` step by step);
* a CUDA implementation that launches the hand-written kernel, counts the
  launch in ``ops.LAUNCHES["ssm_scan"]`` and under the op's own name, and
  raises on a shape the kernel does not take or on a launch error;
* a fake implementation (shapes and dtypes), which ``meta`` tensors and
  the dry-run take;
* a FLOP formula for ``torch.utils.flop_counter``: T times the per-step
  matrix products the twin runs (the Mamba2 read-out, mLSTM's q . C,
  sLSTM's h . R), which is what the dry-run's ``StepCounter`` counts over
  the twin's loop.

Every operand is float32 and every output a fresh tensor.  The ops have
no autograd formula: ``models/ssm.py`` calls the twin directly when a
gradient is wanted.

The kernels (source notes in ``csrc/ssm_scan.cu``) run the twin's
sequential recurrence with the state on the chip, one launch for the
whole sequence; they are not the chunked SSD form.  Each takes only
the widths its thread layout divides (:func:`mamba2_supported`,
:func:`mlstm_supported`, :func:`slstm_supported`: every config of the
zoo and its ``reduced()`` forms), and raises on others before any
launch.
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.sroa_bisect import _call, _stream

# S1: ds / 4 state rows a thread (the kernel's templates), at most 1,024
# threads (4 a column of the head dim).
MAMBA2_ROWS = (1, 2, 4, 8, 16, 32)
# S2: hd / 4 rows of C a thread (templates); S3: hd / 4 rows of R.
MLSTM_ROWS = (2, 4, 8, 16, 24, 32, 48)
SLSTM_ROWS = (4, 8, 12, 16, 24, 32, 48, 64)


def _shape_error(what: str, got, want) -> ValueError:
    return ValueError(f"{what}: got {tuple(got)}, expected {tuple(want)}")


def _same(name: str, x: Tensor, shape: tuple) -> None:
    if tuple(x.shape) != tuple(shape):
        raise _shape_error(f"{name}'s shape", x.shape, shape)
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")


def check_mamba2(decay, Bm, Cm, dtx, s0) -> tuple:
    """(B, T, H, ds, hd) of S1's operands; raises on inconsistent shapes
    or a dtype other than float32."""
    if dtx.dim() != 4:
        raise ValueError(f"dtx must be (B, T, H, hd), got {tuple(dtx.shape)}")
    B, T, H, hd = dtx.shape
    ds = Bm.shape[-1]
    for name, x, shape in (("dtx", dtx, (B, T, H, hd)),
                           ("decay", decay, (B, T, H)),
                           ("Bm", Bm, (B, T, ds)), ("Cm", Cm, (B, T, ds)),
                           ("s0", s0, (B, H, ds, hd))):
        _same(name, x, shape)
    return B, T, H, ds, hd


def check_mlstm(q, k, v, log_i, log_f, C0, n0, m0) -> tuple:
    """(B, T, H, hd) of S2's operands."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, hd), got {tuple(q.shape)}")
    B, T, H, hd = q.shape
    for name, x, shape in (("q", q, (B, T, H, hd)), ("k", k, (B, T, H, hd)),
                           ("v", v, (B, T, H, hd)),
                           ("log_i", log_i, (B, T, H)),
                           ("log_f", log_f, (B, T, H)),
                           ("C0", C0, (B, H, hd, hd)), ("n0", n0, (B, H, hd)),
                           ("m0", m0, (B, H))):
        _same(name, x, shape)
    return B, T, H, hd


def check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0) -> tuple:
    """(B, T, H, hd) of S3's operands."""
    if zx.dim() != 4:
        raise ValueError(f"zx must be (B, T, H, hd), got {tuple(zx.shape)}")
    B, T, H, hd = zx.shape
    for name, x, shape in (("zx", zx, (B, T, H, hd)),
                           ("ix", ix, (B, T, H, hd)),
                           ("fx", fx, (B, T, H, hd)),
                           ("ox", ox, (B, T, H, hd)),
                           ("R", R, (H, hd, 4 * hd)), ("c0", c0, (B, H, hd)),
                           ("n0", n0, (B, H, hd)), ("m0", m0, (B, H, hd)),
                           ("h0", h0, (B, H, hd))):
        _same(name, x, shape)
    return B, T, H, hd


def mamba2_supported(ds: int, hd: int) -> bool:
    """S1's thread layout: 4 threads a column of the head dim (whole warps:
    hd a multiple of 8, at most 256), ds / 4 state rows each."""
    return (ds % 4 == 0 and ds // 4 in MAMBA2_ROWS and hd % 8 == 0
            and 0 < hd <= 256)


def mlstm_slice(hd: int) -> int:
    """S2's columns of C a block: 32, or all of them below 32."""
    return 32 if hd % 32 == 0 else hd


def mlstm_supported(hd: int) -> bool:
    """S2's layout: hd / 4 rows of C a thread, column slices of
    :func:`mlstm_slice` (a multiple of 8)."""
    return (hd % 4 == 0 and hd // 4 in MLSTM_ROWS
            and mlstm_slice(hd) % 8 == 0)


def slstm_supported(hd: int) -> bool:
    """S3's layout: hd / 8 state elements a block of the cluster, 16 threads
    each (whole warps: hd a multiple of 16), hd / 4 rows of R a thread."""
    return hd % 16 == 0 and hd // 4 in SLSTM_ROWS


def _refuse(kernel: str, shape: str) -> None:
    raise ValueError(f"{kernel} has no kernel for {shape}; see "
                     f"repro_torch.kernels.ssm_scan's *_supported")


def _launch(name: str, fn, outs, *ins, dims):
    """Launch ``fn`` over contiguous operands, count it, return outs."""
    ins = tuple(x.contiguous() for x in ins)
    dev = ins[0].device
    if any(x.device != dev for x in ins):
        raise ValueError(f"{name}: operands must lie on one device")
    err = _call(dev, fn, *(x.data_ptr() for x in ins),
                *(y.data_ptr() for y in outs), *dims, _stream(ins[0]))
    build.check(err, name)
    ops.LAUNCHES["ssm_scan"] += 1
    ops.LAUNCHES[name] += 1
    return outs


# ------------------------------------------------------------ S1 Mamba2
@torch.library.custom_op("repro_torch::mamba2_scan", mutates_args=(),
                         device_types="cpu")
def mamba2_scan(decay: Tensor, Bm: Tensor, Cm: Tensor, dtx: Tensor,
                s0: Tensor) -> tuple[Tensor, Tensor]:
    """S1: the Mamba2 recurrence (:func:`ref.mamba2_recurrence_plain`) ->
    (y (B, T, H, hd), s_T (B, H, ds, hd))."""
    check_mamba2(decay, Bm, Cm, dtx, s0)
    y, s = ref.mamba2_recurrence_plain(decay, Bm, Cm, dtx, s0)
    return y.contiguous(), s


@mamba2_scan.register_kernel("cuda")
def _mamba2_cuda(decay, Bm, Cm, dtx, s0):
    B, T, H, ds, hd = check_mamba2(decay, Bm, Cm, dtx, s0)
    if not mamba2_supported(ds, hd):
        _refuse("S1 (mamba2_scan)", f"ds {ds}, hd {hd}")
    outs = (torch.empty_like(dtx, memory_format=torch.contiguous_format),
            torch.empty_like(s0, memory_format=torch.contiguous_format))
    return _launch("mamba2_scan", build.load().mamba2_scan, outs, decay, Bm,
                   Cm, dtx, s0, dims=(B, T, H, ds, hd))


@mamba2_scan.register_fake
def _mamba2_fake(decay, Bm, Cm, dtx, s0):
    check_mamba2(decay, Bm, Cm, dtx, s0)
    return dtx.new_empty(dtx.shape), s0.new_empty(s0.shape)


@register_flop_formula(torch.ops.repro_torch.mamba2_scan)
def _mamba2_flops(decay, Bm, Cm, dtx, s0, *args, **kwargs) -> int:
    B, T, H, hd = dtx
    return T * 2 * B * H * Bm[-1] * hd                # C_t . s a step


# ------------------------------------------------------------- S2 mLSTM
@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=(),
                         device_types="cpu")
def mlstm_scan(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
               log_f: Tensor, C0: Tensor, n0: Tensor,
               m0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """S2: the mLSTM recurrence (:func:`ref.mlstm_recurrence_plain`) ->
    (y (B, T, H, hd), C, n, m)."""
    check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    return ref.mlstm_recurrence_plain(q, k, v, log_i, log_f, C0, n0, m0)


@mlstm_scan.register_kernel("cuda")
def _mlstm_cuda(q, k, v, log_i, log_f, C0, n0, m0):
    B, T, H, hd = check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    if not mlstm_supported(hd):
        _refuse("S2 (mlstm_scan)", f"hd {hd}")
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=x.device)
                 for x in (q, C0, n0, m0))
    return _launch("mlstm_scan", build.load().mlstm_scan, outs, q, k, v,
                   log_i, log_f, C0, n0, m0, dims=(B, T, H, hd))


@mlstm_scan.register_fake
def _mlstm_fake(q, k, v, log_i, log_f, C0, n0, m0):
    check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    return tuple(x.new_empty(x.shape) for x in (q, C0, n0, m0))


@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _mlstm_flops(q, *args, **kwargs) -> int:
    B, T, H, hd = q
    return T * 2 * B * H * hd * hd                    # q_t . C a step


# ------------------------------------------------------------- S3 sLSTM
@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=(),
                         device_types="cpu")
def slstm_scan(zx: Tensor, ix: Tensor, fx: Tensor, ox: Tensor, R: Tensor,
               c0: Tensor, n0: Tensor, m0: Tensor,
               h0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """S3: the sLSTM recurrence (:func:`ref.slstm_recurrence_plain`) ->
    (y (B, T, H, hd), c, n, m, h)."""
    check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    return ref.slstm_recurrence_plain(zx, ix, fx, ox, R, c0, n0, m0, h0)


@slstm_scan.register_kernel("cuda")
def _slstm_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0):
    B, T, H, hd = check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    if not slstm_supported(hd):
        _refuse("S3 (slstm_scan)", f"hd {hd}")
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=x.device)
                 for x in (zx, c0, n0, m0, h0))
    return _launch("slstm_scan", build.load().slstm_scan, outs, zx, ix, fx,
                   ox, R, c0, n0, m0, h0, dims=(B, T, H, hd))


@slstm_scan.register_fake
def _slstm_fake(zx, ix, fx, ox, R, c0, n0, m0, h0):
    check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    return tuple(x.new_empty(x.shape) for x in (zx, c0, n0, m0, h0))


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_flops(zx, *args, **kwargs) -> int:
    B, T, H, hd = zx
    return T * 2 * B * H * hd * 4 * hd                # h_{t-1} . R a step
