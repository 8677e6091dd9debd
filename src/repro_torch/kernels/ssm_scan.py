"""The recurrences of the hybrid and xlstm families as one op each: S1
(Mamba2), S2 (mLSTM) and S3 (sLSTM), with their kernels in
``csrc/ssm_scan.cu``, and their backward ops S1b-S3b, with their kernels
in ``csrc/ssm_scan_bwd.cu`` (and the chunked S1, S1b and S2b in
``csrc/ssd_chunked.cu`` and ``csrc/mlstm_chunked.cu``).

The JAX package runs each recurrence as one ``lax.scan`` (its
``models/ssm.py``): one loop that XLA keeps on the device, differentiates
in reverse, and that its dry-run counts once and multiplies by the trip
count.  Here each is one ``torch.library`` op, ``repro_torch::mamba2_scan``,
``::mlstm_scan`` and ``::slstm_scan``, and its gradient another,
``::mamba2_scan_bwd``, ``::mlstm_scan_bwd`` and ``::slstm_scan_bwd``, each
with

* a CPU implementation, the plain twin in :mod:`repro_torch.kernels.ref`
  (the time loop of ``models/ssm.py`` step by step, or its reverse);
* a CUDA implementation that launches the hand-written kernels, counts
  the op once in ``ops.LAUNCHES["ssm_scan"]`` and under the op's own name,
  and raises on a shape the kernels do not take or on a launch error;
* a fake implementation (shapes and dtypes), which ``meta`` tensors and
  the dry-run take;
* a FLOP formula for ``torch.utils.flop_counter``: T times the per-step
  matrix products the twin runs (forward: the Mamba2 read-out, mLSTM's
  q . C, sLSTM's h . R; backward: the contractions of the reverse step),
  which is what the dry-run's ``StepCounter`` counts over the twin's loop.

The backward ops are the forward ops' autograd formulas
(``torch.library.register_autograd``): the forward saves its operands and,
for S2 and S3, its y.  A backward op on a card runs its route's forward
kernel's saving variant (S1: the state every ``S1B_CKPT`` steps, or every
chunk's start state on the chunked route; S2: C, n and m before every
chunk, of ``S2_CHUNK`` steps on the chunked route and of ``S2B_CKPT`` on
the sequential one; S3: every step's c, n, m and pre-activations) into
scratch the wrapper allocates (``*_bwd_scratch``: the shapes it allocates
from, which the dry-run counts through :func:`bwd_scratch`), then the
reverse kernels; the sums over heads (S1's dB and dC), value tiles or
slices (S2's dq and dk) and batch rows (S3's dR) are per-block partials
added here in a fixed order.

Every operand is float32 and every output a fresh tensor.  Each
recurrence and each backward has two kernels, picked from the shapes
alone; ``*_cuda(..., _route=)`` forces one, for timing both on the same
tensors, and raises before any launch where that kernel does not take the
widths.

* S1 and S1b, by :func:`mamba2_route`: sequences of at least
  ``MAMBA2_CHUNKED_MIN_T`` steps at ds and hd in ``MAMBA2_CHUNKED_WIDTHS``
  take the chunked SSD form (``csrc/ssd_chunked.cu``: chunks of
  ``S1_CHUNK`` steps, a chunk's products on the TF32 tensor cores with a
  3xTF32 split; modelled by ``ref.mamba2_chunked_plain`` and
  ``_bwd_plain``), the rest (every decode step) the sequential kernels,
  which run the twin's recurrence step by step with the state on the
  chip.
* S2 by :func:`mlstm_fwd_route` (from ``MLSTM_FWD_CHUNKED_MIN_T`` steps)
  and S2b by :func:`mlstm_route` (from ``MLSTM_CHUNKED_MIN_T``), at hd in
  ``MLSTM_CHUNKED_WIDTHS``: the chunked form (``csrc/mlstm_chunked.cu``:
  given the stabiliser, mLSTM is Mamba2's recurrence with n as an extra
  value column; chunks of ``S2_CHUNK`` steps, the products on the tensor
  cores; modelled by ``ref.mlstm_chunked_plain`` and
  ``ref.mlstm_chunked_bwd_plain``), the rest (every decode step) the
  sequential kernels.
* S3 and S3b on their short steps (an mbarrier handshake instead of a
  cluster barrier, the step's inputs or constants staged off the chain;
  S3b's dR a product of its own afterwards); their barrier kernels run
  only when forced.

:func:`mlstm_bwd_plan` and :func:`slstm_bwd_plan` give each launch of a
backward route, for timing them alone.  Each kernel takes only the widths
its thread layout divides (:func:`mamba2_supported`,
:func:`mlstm_supported`, :func:`slstm_supported`: every config of the zoo
and its ``reduced()`` forms), and raises on others before any launch; a
backward takes the widths its forward takes.  No route is taken because
a build or a launch failed: those raise.
"""
from __future__ import annotations

import math

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
    """S3's layouts: hd / 8 state elements a block of the cluster; on the
    short step a half-warp each (whole warps: hd a multiple of 16), on the
    barrier kernels 16 threads each and hd / 4 rows of R a thread (their
    templates)."""
    return hd % 16 == 0 and hd // 4 in SLSTM_ROWS


def _refuse(kernel: str, shape: str) -> None:
    raise ValueError(f"{kernel} has no kernel for {shape}; see "
                     f"repro_torch.kernels.ssm_scan's *_supported")


def _operands(name: str, ins) -> tuple:
    """The operands, contiguous, on one device (raises otherwise)."""
    ins = tuple(x.contiguous() for x in ins)
    if any(x.device != ins[0].device for x in ins):
        raise ValueError(f"{name}: operands must lie on one device")
    return ins


def _launch(name: str, fn, outs, *ins, dims):
    """Launch ``fn`` over contiguous operands, count it, return outs."""
    ins = _operands(name, ins)
    _run(name, ins[0], (fn, ins + tuple(outs), dims))
    return outs


def _run(name: str, like: Tensor, *calls) -> None:
    """Each call ``(fn, tensors, ints)`` in turn on ``like``'s device and
    current stream, raising at the first launch error (None in
    ``tensors`` passes a null pointer); the op is counted once, after the
    last launch."""
    dev, stream = like.device, _stream(like)
    for fn, tensors, ints in calls:
        build.check(_call(dev, fn, *(None if x is None else x.data_ptr()
                                     for x in tensors), *ints, stream), name)
    ops.LAUNCHES["ssm_scan"] += 1
    ops.LAUNCHES[name] += 1


def _own(outs) -> tuple:
    """A twin's outputs as tensors of their own (S3b's twin returns views
    of one tensor, which an op may not)."""
    return tuple(y.contiguous() for y in outs)


# ------------------------------------------------------------ S1 Mamba2
# S1 and S1b have two kernels each, picked by :func:`mamba2_route`: the
# sequential ones (csrc/ssm_scan.cu, csrc/ssm_scan_bwd.cu: a step at a time)
# and the chunked SSD form (csrc/ssd_chunked.cu: S1_CHUNK steps a chunk,
# the chunk's products on the tensor cores).
S1_CHUNK = ref.S1_CHUNK
MAMBA2_CHUNKED_WIDTHS = (32, 64)          # ds and hd the chunked kernels take
# The shortest T the chunked kernels take: the shortest T of the sweep that
# chip_smoke.py's phase s (g) and tools/ssm_scans.py print at which both
# beat the sequential kernels in device time on an H100 at zamba2-7b's
# widths (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W: T = 32, S1 0.03115
# against 0.0441 ms, S1b 0.09693 against 0.2404; at T = 8 the sequential S1
# still wins, 0.02126 against 0.0275).
MAMBA2_CHUNKED_MIN_T = 32
MAMBA2_ROUTES = ("chunked", "sequential")


def mamba2_route(T: int, ds: int, hd: int) -> str:
    """S1's and S1b's routing rule: "chunked" for sequences of at least
    :data:`MAMBA2_CHUNKED_MIN_T` steps at widths the chunked layout takes
    (ds and hd in :data:`MAMBA2_CHUNKED_WIDTHS`), else "sequential" (every
    decode step, T = 1)."""
    if (T >= MAMBA2_CHUNKED_MIN_T and ds in MAMBA2_CHUNKED_WIDTHS
            and hd in MAMBA2_CHUNKED_WIDTHS):
        return "chunked"
    return "sequential"


def _aligned(ins) -> tuple:
    """The chunked kernels copy 16 bytes at a time: an operand whose data
    does not start on 16 bytes (a view at an odd offset) is copied."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in ins)


def _pick(what: str, picked: str, forced: str | None, ds, hd) -> str:
    """The route: the rule's, or ``forced`` where the forced kernel takes
    the operands (the sequential ones take every width
    :func:`mamba2_supported` takes)."""
    route = picked if forced is None else forced
    if route not in MAMBA2_ROUTES:
        raise ValueError(f"no {what} route {forced!r}")
    if route == "chunked" and not (ds in MAMBA2_CHUNKED_WIDTHS
                                   and hd in MAMBA2_CHUNKED_WIDTHS):
        _refuse(f"{what}'s chunked kernel", f"ds {ds}, hd {hd}")
    if route == "sequential" and not mamba2_supported(ds, hd):
        _refuse(what, f"ds {ds}, hd {hd}")
    return route


@torch.library.custom_op("repro_torch::mamba2_scan", mutates_args=(),
                         device_types="cpu")
def mamba2_scan(decay: Tensor, Bm: Tensor, Cm: Tensor, dtx: Tensor,
                s0: Tensor) -> tuple[Tensor, Tensor]:
    """S1: the Mamba2 recurrence (:func:`ref.mamba2_recurrence_plain`) ->
    (y (B, T, H, hd), s_T (B, H, ds, hd))."""
    check_mamba2(decay, Bm, Cm, dtx, s0)
    y, s = ref.mamba2_recurrence_plain(decay, Bm, Cm, dtx, s0)
    return y.contiguous(), s


def mamba2_scan_cuda(decay, Bm, Cm, dtx, s0, *, _route: str | None = None):
    """S1 on CUDA tensors -> (y, s_T), on :func:`mamba2_route`'s kernel.
    ``_route`` forces one ("chunked" or "sequential"), for timing both on
    the same tensors; it raises where that kernel does not take the
    widths."""
    B, T, H, ds, hd = check_mamba2(decay, Bm, Cm, dtx, s0)
    route = _pick("S1 (mamba2_scan)", mamba2_route(T, ds, hd), _route, ds,
                  hd)
    outs = (torch.empty_like(dtx, memory_format=torch.contiguous_format),
            torch.empty_like(s0, memory_format=torch.contiguous_format))
    lib = build.load()
    if route == "sequential":
        return _launch("mamba2_scan", lib.mamba2_scan, outs, decay, Bm, Cm,
                       dtx, s0, dims=(B, T, H, ds, hd))
    ins = _aligned(_operands("mamba2_scan", (decay, Bm, Cm, dtx, s0)))
    _run("mamba2_scan", ins[0], (lib.mamba2_chunked, ins + outs + (None,),
                                 (B, T, H, ds, hd, S1_CHUNK)))
    ops.LAUNCHES["mamba2_scan_chunked"] += 1
    return outs


@mamba2_scan.register_kernel("cuda")
def _mamba2_cuda(decay, Bm, Cm, dtx, s0):
    return mamba2_scan_cuda(decay, Bm, Cm, dtx, s0)


@mamba2_scan.register_fake
def _mamba2_fake(decay, Bm, Cm, dtx, s0):
    check_mamba2(decay, Bm, Cm, dtx, s0)
    return dtx.new_empty(dtx.shape), s0.new_empty(s0.shape)


@register_flop_formula(torch.ops.repro_torch.mamba2_scan)
def _mamba2_flops(decay, Bm, Cm, dtx, s0, *args, **kwargs) -> int:
    B, T, H, hd = dtx
    return T * 2 * B * H * Bm[-1] * hd                # C_t . s a step


# S1b on the sequential route: the forward's saving variant keeps the state
# every S1B_CKPT steps; the reverse kernel recomputes the S1B_CKPT states of
# a chunk into a scratch of its own.  On the chunked route the saving
# variant keeps every chunk's start state.
S1B_CKPT = 8


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def mamba2_bwd_scratch(B: int, T: int, H: int, ds: int, hd: int,
                       route: str | None = None) -> dict:
    """The f32 scratch S1b's CUDA wrapper allocates on ``route`` (the
    rule's by default), name -> shape: the per-head dB and dC partials, and
    the saved states (chunked: every chunk's start state; sequential: the
    state every S1B_CKPT steps and a block's recompute scratch)."""
    route = route or mamba2_route(T, ds, hd)
    parts = {"dBh": (B, T, H, ds), "dCh": (B, T, H, ds)}
    if route == "chunked":
        parts["starts"] = (B, H, _ceil(T, S1_CHUNK), ds, hd)
    else:
        parts["ckpt"] = (B, H, _ceil(T, S1B_CKPT), ds, hd)
        parts["scratch"] = (B * H, S1B_CKPT, ds * hd)
    return parts


def _scratch(shapes: dict, like: Tensor) -> dict:
    return {k: torch.empty(v, dtype=torch.float32, device=like.device)
            for k, v in shapes.items()}


def scratch_bytes(shapes: dict) -> int:
    """The bytes of f32 scratch of a ``*_bwd_scratch`` dict."""
    return sum(4 * math.prod(s) for s in shapes.values())


@torch.library.custom_op("repro_torch::mamba2_scan_bwd", mutates_args=(),
                         device_types="cpu")
def mamba2_scan_bwd(decay: Tensor, Bm: Tensor, Cm: Tensor, dtx: Tensor,
                    s0: Tensor, dy: Tensor, dsT: Tensor
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """S1b: S1's gradient (:func:`ref.mamba2_recurrence_bwd_plain`) ->
    (d decay, dBm, dCm, d dtx, d s0)."""
    check_mamba2(decay, Bm, Cm, dtx, s0)
    _same("dy", dy, dtx.shape)
    _same("dsT", dsT, s0.shape)
    return _own(ref.mamba2_recurrence_bwd_plain(decay, Bm, Cm, dtx, s0, dy,
                                                dsT))


def mamba2_scan_bwd_cuda(decay, Bm, Cm, dtx, s0, dy, dsT, *,
                         _route: str | None = None):
    """S1b on CUDA tensors -> (d decay, dBm, dCm, d dtx, d s0), on
    :func:`mamba2_route`'s kernels (the saving forward, then the backward
    kernel); ``_route`` forces one route, as for S1."""
    B, T, H, ds, hd = check_mamba2(decay, Bm, Cm, dtx, s0)
    _same("dy", dy, dtx.shape)
    _same("dsT", dsT, s0.shape)
    route = _pick("S1b (mamba2_scan_bwd)", mamba2_route(T, ds, hd), _route,
                  ds, hd)
    ins = _operands("mamba2_scan_bwd", (decay, Bm, Cm, dtx, s0, dy, dsT))
    if route == "chunked":
        ins = _aligned(ins)
    f32 = dict(dtype=torch.float32, device=dtx.device)
    sc = _scratch(mamba2_bwd_scratch(B, T, H, ds, hd, route), dtx)
    ddec, ddtx, ds0 = (torch.empty(x.shape, **f32) for x in (decay, dtx, s0))
    lib, dims = build.load(), (B, T, H, ds, hd)
    grads = (ddec, sc["dBh"], sc["dCh"], ddtx, ds0)
    if route == "sequential":
        _run("mamba2_scan_bwd", dtx,
             (lib.mamba2_scan_ckpt, ins[:5] + (sc["ckpt"],), dims),
             (lib.mamba2_scan_bwd, ins + (sc["ckpt"], sc["scratch"]) + grads,
              dims))
    else:
        _run("mamba2_scan_bwd", dtx,
             (lib.mamba2_chunked, ins[:5] + (None, None, sc["starts"]),
              dims + (S1_CHUNK,)),
             (lib.mamba2_chunked_bwd, ins[:4] + ins[5:] + (sc["starts"],)
              + grads, dims + (S1_CHUNK,)))
        ops.LAUNCHES["mamba2_scan_bwd_chunked"] += 1
    return ddec, sc["dBh"].sum(2), sc["dCh"].sum(2), ddtx, ds0


@mamba2_scan_bwd.register_kernel("cuda")
def _mamba2_bwd_cuda(decay, Bm, Cm, dtx, s0, dy, dsT):
    return mamba2_scan_bwd_cuda(decay, Bm, Cm, dtx, s0, dy, dsT)


@mamba2_scan_bwd.register_fake
def _mamba2_bwd_fake(decay, Bm, Cm, dtx, s0, dy, dsT):
    check_mamba2(decay, Bm, Cm, dtx, s0)
    return tuple(x.new_empty(x.shape) for x in (decay, Bm, Cm, dtx, s0))


@register_flop_formula(torch.ops.repro_torch.mamba2_scan_bwd)
def _mamba2_bwd_flops(decay, Bm, Cm, dtx, *args, **kwargs) -> int:
    B, T, H, hd = dtx
    return T * 8 * B * H * Bm[-1] * hd        # dC, dB, d dtx, d decay a step


def _mamba2_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _mamba2_backward(ctx, dy, dsT):
    # autograd hands a zero gradient for an output that took none
    return mamba2_scan_bwd(*ctx.saved_tensors, dy, dsT)


torch.library.register_autograd("repro_torch::mamba2_scan", _mamba2_backward,
                                setup_context=_mamba2_setup)


# ------------------------------------------------------------- S2 mLSTM
# S2 and S2b have two kernels each, picked by :func:`mlstm_fwd_route` and
# :func:`mlstm_route`: the chunked form (csrc/mlstm_chunked.cu: chunks of
# S2_CHUNK steps, the chunk's products on the tensor cores) and the
# sequential kernels (csrc/ssm_scan.cu, csrc/ssm_scan_bwd.cu: a step at a
# time).  Chunks of 32 steps: S2b 2.367 against 2.56 ms for 16 at
# xlstm-125m's width (PERF.md §6); the kernels take no other length.
S2_CHUNK = ref.S2_CHUNK
MLSTM_CHUNKED_WIDTHS = (32, 64, 192)      # hd the chunked kernels take
# The shortest T each chunked kernel takes: the shortest T of the sweeps
# that chip_smoke.py's phase s (g) and tools/ssm_scans.py print at which it
# beats its sequential kernel in device time at xlstm-125m's width
# (tools/ssm_scans.py, NVIDIA H100 80GB HBM3, 700 W).  S2b: T = 8, 0.08749
# against 0.09135 ms; at T = 1 the sequential kernel wins, 0.04358 against
# 0.07949.  S2: T = 16, 0.02831 against 0.03259 ms; at T = 8 the sequential
# kernel wins, 0.02378 against 0.02787.
MLSTM_CHUNKED_MIN_T = 8
MLSTM_FWD_CHUNKED_MIN_T = 16
MLSTM_ROUTES = ("chunked", "sequential")


def mlstm_route(T: int, hd: int) -> str:
    """S2b's routing rule: "chunked" for sequences of at least
    :data:`MLSTM_CHUNKED_MIN_T` steps at head dims the chunked kernels
    take (:data:`MLSTM_CHUNKED_WIDTHS`), else "sequential"."""
    if T >= MLSTM_CHUNKED_MIN_T and hd in MLSTM_CHUNKED_WIDTHS:
        return "chunked"
    return "sequential"


def mlstm_fwd_route(T: int, hd: int) -> str:
    """S2's routing rule: as :func:`mlstm_route` from
    :data:`MLSTM_FWD_CHUNKED_MIN_T` steps; "sequential" for every decode
    step (T = 1)."""
    if T >= MLSTM_FWD_CHUNKED_MIN_T and hd in MLSTM_CHUNKED_WIDTHS:
        return "chunked"
    return "sequential"


def _mlstm_pick(what: str, op: str, picked: str, forced: str | None,
                hd: int) -> str:
    """S2's or S2b's route: the rule's, or ``forced`` where its kernel
    takes hd (raises before any launch otherwise)."""
    route = picked if forced is None else forced
    if route not in MLSTM_ROUTES:
        raise ValueError(f"no {what} route {forced!r}")
    if route == "chunked" and hd not in MLSTM_CHUNKED_WIDTHS:
        _refuse(f"{what} ({op})'s chunked kernel", f"hd {hd}")
    if not mlstm_supported(hd):
        _refuse(f"{what} ({op})", f"hd {hd}")
    return route


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=(),
                         device_types="cpu")
def mlstm_scan(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
               log_f: Tensor, C0: Tensor, n0: Tensor,
               m0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """S2: the mLSTM recurrence (:func:`ref.mlstm_recurrence_plain`) ->
    (y (B, T, H, hd), C, n, m)."""
    check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    return ref.mlstm_recurrence_plain(q, k, v, log_i, log_f, C0, n0, m0)


def mlstm_scan_cuda(q, k, v, log_i, log_f, C0, n0, m0, *,
                    _route: str | None = None):
    """S2 on CUDA tensors -> (y, C, n, m), on :func:`mlstm_fwd_route`'s
    kernel; ``_route`` forces one ("chunked" or "sequential"), for timing
    both on the same tensors, and raises where that kernel does not take
    hd."""
    B, T, H, hd = check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    route = _mlstm_pick("S2", "mlstm_scan", mlstm_fwd_route(T, hd), _route,
                        hd)
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=x.device)
                 for x in (q, C0, n0, m0))
    lib = build.load()
    if route == "sequential":
        return _launch("mlstm_scan", lib.mlstm_scan, outs, q, k, v, log_i,
                       log_f, C0, n0, m0, dims=(B, T, H, hd))
    ins = _aligned(_operands("mlstm_scan", (q, k, v, log_i, log_f, C0, n0,
                                            m0)))
    _run("mlstm_scan", ins[0], (lib.mlstm_chunked, ins + outs,
                                (B, T, H, hd, S2_CHUNK)))
    ops.LAUNCHES["mlstm_scan_chunked"] += 1
    return outs


@mlstm_scan.register_kernel("cuda")
def _mlstm_cuda(q, k, v, log_i, log_f, C0, n0, m0):
    return mlstm_scan_cuda(q, k, v, log_i, log_f, C0, n0, m0)


@mlstm_scan.register_fake
def _mlstm_fake(q, k, v, log_i, log_f, C0, n0, m0):
    check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    return tuple(x.new_empty(x.shape) for x in (q, C0, n0, m0))


@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _mlstm_flops(q, *args, **kwargs) -> int:
    B, T, H, hd = q
    return T * 2 * B * H * hd * hd                    # q_t . C a step


# S2b: the forward's saving variant keeps C, n and m before every chunk:
# every S2_CHUNK steps on the chunked route (csrc/mlstm_chunked.cu's
# saving forward; the chunked backward walks the chunks last first from
# them), every S2B_CKPT steps on the sequential one (csrc/ssm_scan.cu's;
# csrc/ssm_scan_bwd.cu recomputes each chunk of S2B_CKPT steps into a
# scratch of its own).
S2B_CKPT = 16


def mlstm_tiles(hd: int) -> int:
    """The chunked backward kernel's tiles of 32 value columns of [v | n]:
    hd / 32 of v and one for n."""
    return hd // 32 + 1


@torch.library.custom_op("repro_torch::mlstm_scan_bwd", mutates_args=(),
                         device_types="cpu")
def mlstm_scan_bwd(q: Tensor, k: Tensor, v: Tensor, log_i: Tensor,
                   log_f: Tensor, C0: Tensor, n0: Tensor, m0: Tensor,
                   y: Tensor, dy: Tensor, dC: Tensor, dn: Tensor,
                   dm: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                        Tensor, Tensor, Tensor, Tensor]:
    """S2b: S2's gradient (:func:`ref.mlstm_recurrence_bwd_plain`) ->
    (dq, dk, dv, d log_i, d log_f, dC0, dn0, dm0)."""
    _check_mlstm_bwd(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn, dm)
    return _own(ref.mlstm_recurrence_bwd_plain(q, k, v, log_i, log_f, C0, n0,
                                               m0, y, dy, dC, dn, dm))


def mlstm_bwd_scratch(B: int, T: int, H: int, hd: int,
                      route: str | None = None) -> dict:
    """The f32 scratch S2b's CUDA wrapper allocates on ``route`` (the
    rule's by default), name -> shape: C, n and m before every chunk (of
    S2_CHUNK steps on the chunked route, of S2B_CKPT on the sequential
    one); chunked: m_t and the per-tile dq, dk, d f and d i partials; sequential:
    the slices' recompute scratch and the stabiliser's, and the per-slice
    partials."""
    route = route or mlstm_route(T, hd)
    nC = _ceil(T, S2_CHUNK if route == "chunked" else S2B_CKPT)
    ckpt = {"C": (B, H, nC, hd, hd), "n": (B, H, nC, hd), "m": (B, H, nC)}
    if route == "chunked":
        NT = mlstm_tiles(hd)
        return {**ckpt, "mt": (B, T, H), "dq": (NT, B, T, H, hd),
                "dk": (NT, B, T, H, hd), "dfi": (2, NT, B, T, H)}
    S = hd // mlstm_slice(hd)
    return {**ckpt, "scrC": (B * H * S, S2B_CKPT, hd * mlstm_slice(hd)),
            "scrN": (B * H * S, S2B_CKPT, hd), "scrM": (B, T, H),
            "dq": (S, B, T, H, hd), "dk": (S, B, T, H, hd),
            "dfi": (2, S, B, T, H)}


def _check_mlstm_bwd(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn, dm):
    dims = check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    for name, g, x in (("y", y, q), ("dy", dy, q), ("dC", dC, C0),
                       ("dn", dn, n0), ("dm", dm, m0)):
        _same(name, g, x.shape)
    return dims


def mlstm_bwd_plan(args, route: str | None = None):
    """S2b's launches on CUDA tensors ``args`` (the op's operands) on
    ``route`` (:func:`mlstm_route`'s by default; a forced one raises where
    its kernel does not take the widths, before any launch) -> (the route,
    its launches in order as (kernel, fn, tensors, ints), the scratch (name
    -> tensor), the outputs' buffers before the wrapper's sums)."""
    B, T, H, hd = _check_mlstm_bwd(*args)
    route = _mlstm_pick("S2b", "mlstm_scan_bwd", mlstm_route(T, hd), route,
                        hd)
    ins = _operands("mlstm_scan_bwd", args)
    if route == "chunked":
        ins = _aligned(ins)
    q, k, v, li, lf, C0, n0, m0, y, dy, dC, dn, dm = ins
    f32 = dict(dtype=torch.float32, device=q.device)
    sc = _scratch(mlstm_bwd_scratch(B, T, H, hd, route), q)
    ckpt = (sc["C"], sc["n"], sc["m"])
    outs = tuple(torch.empty(x.shape, **f32)
                 for x in (v, li, lf, C0, n0, m0))
    dv, dli, dlf, dC0, dn0, dm0 = outs
    lib, dims = build.load(), (B, T, H, hd)
    if route == "sequential":
        calls = [("mlstm_scan_kernel<SAVE>", lib.mlstm_scan_ckpt,
                  ins[:8] + ckpt, dims),
                 ("mlstm_scan_bwd_kernel, mlstm_gates_bwd_kernel",
                  lib.mlstm_scan_bwd,
                  ins + ckpt + (sc["scrC"], sc["scrN"], sc["scrM"],
                                sc["dq"], sc["dk"], dv, sc["dfi"], dli, dlf,
                                dC0, dn0, dm0), dims)]
    else:
        calls = [("mlstm_chunked_kernel<SAVE>", lib.mlstm_chunked_ckpt,
                  ins[:8] + ckpt, dims + (S2_CHUNK,)),
                 ("mlstm_chunked_bwd_kernel", lib.mlstm_chunked_bwd,
                  (q, k, v, li, lf, y, dy, dC, dn) + ckpt + (
                      sc["mt"], sc["dq"], sc["dk"], dv, sc["dfi"], dC0,
                      dn0), dims + (S2_CHUNK,)),
                 ("mlstm_gates_chunked_bwd_kernel", lib.mlstm_gates_bwd,
                  (li, lf, m0, dm, sc["mt"], sc["dfi"], dli, dlf, dm0),
                  (B, T, H, mlstm_tiles(hd)))]
    return route, calls, sc, outs


def mlstm_scan_bwd_cuda(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn,
                        dm, *, _route: str | None = None):
    """S2b on CUDA tensors -> (dq, dk, dv, d log_i, d log_f, dC0, dn0,
    dm0), on :func:`mlstm_route`'s kernels (the saving forward, then the
    backward kernels); ``_route`` forces one ("chunked" or "sequential"),
    for timing on the same tensors.  The per-tile (per-slice) dq and dk
    partials are summed here, in order."""
    args = (q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn, dm)
    route, calls, sc, outs = mlstm_bwd_plan(args, _route)
    _run("mlstm_scan_bwd", q, *(c[1:] for c in calls))
    if route == "chunked":
        ops.LAUNCHES["mlstm_scan_bwd_chunked"] += 1
    dv, dli, dlf, dC0, dn0, dm0 = outs
    return sc["dq"].sum(0), sc["dk"].sum(0), dv, dli, dlf, dC0, dn0, dm0


@mlstm_scan_bwd.register_kernel("cuda")
def _mlstm_bwd_cuda(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn, dm):
    return mlstm_scan_bwd_cuda(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC,
                               dn, dm)


@mlstm_scan_bwd.register_fake
def _mlstm_bwd_fake(q, k, v, log_i, log_f, C0, n0, m0, y, dy, dC, dn, dm):
    check_mlstm(q, k, v, log_i, log_f, C0, n0, m0)
    return tuple(x.new_empty(x.shape)
                 for x in (q, k, v, log_i, log_f, C0, n0, m0))


@register_flop_formula(torch.ops.repro_torch.mlstm_scan_bwd)
def _mlstm_bwd_flops(q, *args, **kwargs) -> int:
    B, T, H, hd = q
    return T * 8 * B * H * hd * hd        # dq, k . G_C, G_C v, d f a step


def _mlstm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[0])


def _mlstm_backward(ctx, dy, dC, dn, dm):
    return mlstm_scan_bwd(*ctx.saved_tensors, dy, dC, dn, dm)


torch.library.register_autograd("repro_torch::mlstm_scan", _mlstm_backward,
                                setup_context=_mlstm_setup)


# ------------------------------------------------------------- S3 sLSTM
# S3 and S3b have two kernels each: the short step (csrc/ssm_scan.cu's
# slstm_short_kernel: an mbarrier handshake, the step's input terms staged
# off the chain; csrc/ssm_scan_bwd.cu's slstm_bwd_short_kernel, then dR as
# a product of its own), every call's; and the barrier kernels (a cluster
# barrier a step; S3b's dR on the walk), only when forced.  S3b's saving
# forward is its route's forward kernel: every step's c, n, m and the four
# pre-activations.
SLSTM_ROUTES = ("short", "barrier")
@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=(),
                         device_types="cpu")
def slstm_scan(zx: Tensor, ix: Tensor, fx: Tensor, ox: Tensor, R: Tensor,
               c0: Tensor, n0: Tensor, m0: Tensor,
               h0: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """S3: the sLSTM recurrence (:func:`ref.slstm_recurrence_plain`) ->
    (y (B, T, H, hd), c, n, m, h)."""
    check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    return ref.slstm_recurrence_plain(zx, ix, fx, ox, R, c0, n0, m0, h0)


def _slstm_pick(what: str, op: str, forced: str | None, hd: int) -> str:
    """S3's or S3b's kernel: the short step, or ``forced`` (raises before
    any launch on an unknown route or a width the layouts do not take)."""
    route = forced or "short"
    if route not in SLSTM_ROUTES:
        raise ValueError(f"no {what} route {forced!r}")
    if not slstm_supported(hd):
        _refuse(f"{what} ({op})", f"hd {hd}")
    return route


def slstm_scan_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0, *,
                    _route: str | None = None):
    """S3 on CUDA tensors -> (y, c, n, m, h) on the short step;
    ``_route="barrier"`` forces the cluster-barrier kernel, for timing
    both on the same tensors."""
    B, T, H, hd = check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    route = _slstm_pick("S3", "slstm_scan", _route, hd)
    outs = tuple(torch.empty(x.shape, dtype=torch.float32, device=x.device)
                 for x in (zx, c0, n0, m0, h0))
    lib = build.load()
    if route == "barrier":
        return _launch("slstm_scan", lib.slstm_scan, outs, zx, ix, fx, ox,
                       R, c0, n0, m0, h0, dims=(B, T, H, hd))
    _launch("slstm_scan", lib.slstm_scan_short, outs, zx, ix, fx, ox, R, c0,
            n0, m0, h0, dims=(B, T, H, hd))
    ops.LAUNCHES["slstm_scan_short"] += 1
    return outs


@slstm_scan.register_kernel("cuda")
def _slstm_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0):
    return slstm_scan_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0)


@slstm_scan.register_fake
def _slstm_fake(zx, ix, fx, ox, R, c0, n0, m0, h0):
    check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    return tuple(x.new_empty(x.shape) for x in (zx, c0, n0, m0, h0))


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_flops(zx, *args, **kwargs) -> int:
    B, T, H, hd = zx
    return T * 2 * B * H * hd * 4 * hd                # h_{t-1} . R a step




@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=(),
                         device_types="cpu")
def slstm_scan_bwd(zx: Tensor, ix: Tensor, fx: Tensor, ox: Tensor,
                   R: Tensor, c0: Tensor, n0: Tensor, m0: Tensor, h0: Tensor,
                   y: Tensor, dy: Tensor, dc: Tensor, dn: Tensor, dm: Tensor,
                   dh: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor,
                                        Tensor, Tensor, Tensor, Tensor,
                                        Tensor]:
    """S3b: S3's gradient (:func:`ref.slstm_recurrence_bwd_plain`) ->
    (dzx, dix, dfx, dox, dR, dc0, dn0, dm0, dh0)."""
    _check_slstm_bwd(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm,
                     dh)
    return _own(ref.slstm_recurrence_bwd_plain(zx, ix, fx, ox, R, c0, n0, m0,
                                               h0, y, dy, dc, dn, dm, dh))


def _check_slstm_bwd(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm,
                     dh):
    dims = check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    for name, g in (("y", y), ("dy", dy)):
        _same(name, g, zx.shape)
    for name, g in (("dc", dc), ("dn", dn), ("dm", dm), ("dh", dh)):
        _same(name, g, c0.shape)
    return dims


def slstm_bwd_scratch(B: int, T: int, H: int, hd: int) -> dict:
    """The f32 scratch S3b's CUDA wrapper allocates (both kernels), name ->
    shape: every step's c, n, m and four pre-activations, and the per-b dR
    partials."""
    return {"saved": (7, B, T, H, hd), "dRb": (B, H, hd, 4 * hd)}


def slstm_bwd_plan(args, route: str | None = None):
    """S3b's launches on CUDA tensors ``args`` (the op's operands) on
    ``route`` ("short" by default, or "barrier", the cluster-barrier
    kernels): as :func:`mlstm_bwd_plan`."""
    B, T, H, hd = _check_slstm_bwd(*args)
    route = _slstm_pick("S3b", "slstm_scan_bwd", route, hd)
    ins = _operands("slstm_scan_bwd", args)
    f32 = dict(dtype=torch.float32, device=ins[0].device)
    sc = _scratch(slstm_bwd_scratch(B, T, H, hd), ins[0])
    grads = tuple(torch.empty(ins[0].shape, **f32) for _ in range(4))
    states = tuple(torch.empty(ins[5].shape, **f32) for _ in range(4))
    lib, dims = build.load(), (B, T, H, hd)
    if route == "barrier":
        calls = [("slstm_scan_kernel<SAVE>", lib.slstm_scan_save,
                  ins[:9] + (sc["saved"],), dims),
                 ("slstm_scan_bwd_kernel", lib.slstm_scan_bwd,
                  ins + (sc["saved"],) + grads + (sc["dRb"],) + states,
                  dims)]
    else:
        R, c0, n0, m0, h0, y, dy, dc, dn, dm, dh = ins[4:]
        calls = [("slstm_short_kernel<SAVE>", lib.slstm_scan_short_save,
                  ins[:9] + (sc["saved"],), dims),
                 ("slstm_bwd_short_kernel", lib.slstm_scan_bwd_short,
                  (R, c0, n0, m0, dy, dc, dn, dm, dh, sc["saved"]) + grads
                  + states, dims),
                 ("slstm_dR_kernel", lib.slstm_dR,
                  (y, h0) + grads + (sc["dRb"],), dims)]
    return route, calls, sc, grads + states


def slstm_scan_bwd_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm,
                        dh, *, _route: str | None = None):
    """S3b on CUDA tensors -> (dzx, dix, dfx, dox, dR, dc0, dn0, dm0, dh0):
    the saving forward, then the short reverse step and the dR product
    (``_route="barrier"`` forces the barrier kernel, for timing both on the
    same tensors); the per-b dR partials are summed here, in order."""
    args = (zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm, dh)
    route, calls, sc, outs = slstm_bwd_plan(args, _route)
    _run("slstm_scan_bwd", zx, *(c[1:] for c in calls))
    if route == "short":
        ops.LAUNCHES["slstm_scan_bwd_short"] += 1
    return (*outs[:4], sc["dRb"].sum(0), *outs[4:])


@slstm_scan_bwd.register_kernel("cuda")
def _slstm_bwd_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm,
                    dh):
    return slstm_scan_bwd_cuda(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc,
                               dn, dm, dh)


@slstm_scan_bwd.register_fake
def _slstm_bwd_fake(zx, ix, fx, ox, R, c0, n0, m0, h0, y, dy, dc, dn, dm,
                    dh):
    check_slstm(zx, ix, fx, ox, R, c0, n0, m0, h0)
    return tuple(x.new_empty(x.shape)
                 for x in (zx, ix, fx, ox, R, c0, n0, m0, h0))


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _slstm_bwd_flops(zx, *args, **kwargs) -> int:
    B, T, H, hd = zx
    return T * 24 * B * H * hd * hd   # h . R (recomputed), dR, dpre . R^T


def _slstm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output[0])


def _slstm_backward(ctx, dy, dc, dn, dm, dh):
    return slstm_scan_bwd(*ctx.saved_tensors, dy, dc, dn, dm, dh)


torch.library.register_autograd("repro_torch::slstm_scan", _slstm_backward,
                                setup_context=_slstm_setup)


def bwd_scratch(op: str, args) -> dict:
    """The scratch (name -> shape) the CUDA wrapper of backward op ``op``
    ("mamba2_scan_bwd", "mlstm_scan_bwd" or "slstm_scan_bwd") allocates for
    the operands ``args`` (tensors, or anything with their ``shape``), and
    frees when it returns; {} for any other op.  The dry-run's
    ``StepCounter`` adds it to the live bytes while the op runs."""
    if op == "mamba2_scan_bwd":
        B, T, H, hd = args[3].shape
        return mamba2_bwd_scratch(B, T, H, args[1].shape[-1], hd)
    if op == "mlstm_scan_bwd":
        return mlstm_bwd_scratch(*args[0].shape)
    if op == "slstm_scan_bwd":
        return slstm_bwd_scratch(*args[0].shape)
    return {}
