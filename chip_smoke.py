#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's planning and LM serving paths on one
NVIDIA card.

    python3 chip_smoke.py             # every phase (one card)
    python3 chip_smoke.py --kernels   # build and check the kernels only

Phases, each reported on its own lines:

0. The card (``nvidia-smi``) and the build of ``src/repro_torch/kernels/
   csrc/*.cu`` with nvcc (one process per source, all at once), with
   ``-Xptxas -v``'s registers, spills and static shared memory per kernel,
   K2's two kernels' registers on a line of their own, and the SASS
   instructions of K1's and K2's bisection loops at each depth
   (``cuobjdump -sass``).
1. The branch-free log1pf and division of K1 and K2 against the
   toolkit's (every float of [+0, FLT_MAX]; 2^32 hashed pairs), bitwise.
   K1 (Lemma-1 inversion) against its plain PyTorch version at the fleet's
   flattened shape and at odd shapes: rtol 1e-5, atol 1e-3, and bitwise
   at the fleet's shape at every speculation depth (each timed on the same
   tensors).  K1 with one scalar cap (the TPU's ``_bisect_kernel``) is
   timed apart at n = 56.
2. K2 (the fused Algorithm 2-4 solve) on one engine round of the README
   fleet (128 cells x 9 candidates, N_max users) and at the re-price shape
   (one problem per cell): the one-thread-per-user kernel at every
   speculation depth, PR 11's one-warp-per-problem kernel and the plain
   version give the same bits (the plain version adds in the kernel's warp
   order; feasible identical, R and t to rtol 1e-4 and b to rtol 1e-3 are
   checked too); a problem solved alone equals the same problem inside the
   batch bitwise.  Both kernels are timed on the same tensors at both
   shapes, each depth of the new one too, and every depth on the round's
   first 256, 512 and 768 problems (where the depth rule's crossover
   lies); the blocks an SM holds are printed.
3. K3 (top-k move nomination): the routed call, the one-warp-per-cell
   kernel, the block kernel and the plain version give identical
   user, dst and score at the planning shape (128, N_max, 5) and at
   (128, 128, 4) and (16, 300, 7) (past the warp kernel's cap), k = 8 and
   40, and the two kernels and the plain version at (128, N_max, 5) on
   operands that leave the warp kernel's branch-free ranges (tiny and
   huge gains and H, noise past 2^60 in every other cell).  The two
   kernels are timed on the same tensors in turns, beside ``torch.topk``
   on the twin's score tile (selection only), an empty kernel's launch
   (the floor), the bound and the wrapper's host cost; the warp kernel's
   blocks an SM and K3's ``-Xptxas -v`` lines are printed.
4. K4 (flash attention) against its plain version: at the LM prefill's
   (B, H, T, hd) = (4, 16, 1024, 64) in bf16 and f32, at hd 128
   (llama3.2-3b's heads), at the JAX sweep's odd shapes, non-causal, with
   a window of 16, at Tq = 1 with q_offset = S - 1, at Tq != Tk with
   q_offset 100 and on strided views of one fused QKV tensor: 2e-5 in f32,
   2e-2 in bf16 (exp, P's bf16 rounding and the summation order differ).
   Every bf16 case must take the tensor-core kernel, every f32 case the
   SIMT one.  At the LM shape in bf16 the tensor-core kernel is timed
   beside the SIMT kernel on the same tensors, beside
   ``scaled_dot_product_attention(is_causal=True)`` and against its bound;
   at (1, 24, 1024, 128) beside SDPA.
5. K5 (fused RMSNorm) against its plain version at the LM's hidden-state
   shape (4096, 1024) in bf16 and f32, bitwise (the twin adds in the
   kernel's order and rsqrtf is torch.rsqrt), timed with its f32 scale
   beside ``torch.nn.functional.rms_norm``.  No model calls K5.
6. The planning path: ``PlanningService`` over ``draw_fleet(0, 128)`` with
   the fused solve and top-8 move pruning, driven by ``run_load`` for 3
   ticks.
7. The ``use_pallas`` route: ``solve_batch`` with the inversion on K1,
   against the same call on the eager inversion (rtol 1e-5 on R) and
   against phase 6's fused re-price (rtol 5e-3).
8. The LM path: ``run_lm`` at qwen1.5-0.5b's full width and depth in bf16,
   B = 4, 1024-token prompts, 32 greedy tokens, on ``attn_impl="pallas"``
   (K4: one launch per layer per prefill) and on the default chunked
   route with the same weights; every K4 launch takes the tensor-core
   kernel.  The last-position prefill logits of the two routes agree to
   5e-2 of max |logit| (bf16 rounds each layer's output; both round their
   probabilities to bf16 before the PV product, in other orders).  One
   more prefill on K4 and four decode steps run under ``torch.profiler``
   (lines ``[q]``).
t. TSIA, the RA baselines and the per-cell planner (lines ``[t]``, run
   between phases 8 and 9): (a) ``tsia.solve(draw_scenario(0))`` at the
   paper's N = 50, M = 5 and full caps on K2, one lanes-kernel launch a
   score, its R the trace's minimum and ``evaluate``'s; K2 at TSIA's
   P = 1 and at the host loop's P = 1 + N (M - 1) = 201 (timed in phase 2,
   before any plain twin runs; checked and bounded here); (b) TSIA at
   the serve caps with every score recorded, all the scored patterns then
   solved in one call of K2's plain twin: b, f, p bitwise, R to rtol
   1e-4; (c) HFEL and SROA at the nearest-edge pattern with and without
   ``use_pallas`` (K1 launched, R to rtol 1e-5), SROA below every other
   ``RA_METHODS`` entry (Fig 2); (d) ``serve --no-stream`` over 16 cells
   of up to 50 users on 5 edges with top-8 pruning (K2 and K3, every K3
   launch on the warp kernel), then ``--host-loop`` over 2 cells: every
   assignment in range, every R finite, unchanged cells cache hits.
9. Launch counts of the main paths (every count reset to 0 right before
   a path and read right after it; phase t's path as each kernel's
   ``launches_tsia_path``), each kernel's time beside its plain
   version's, its bound and its library call, then the card and the
   result line; every K3 launch of the planning path must take the warp
   kernel.  Each kernel's time is given twice: CUDA events around
   one call (``ms``: the host's launch overhead included) and the device
   time ``torch.profiler`` records per call (``device_ms``).  K4's and
   K5's wrappers also get ``host_ms``: the host clock over 1,000
   unsynchronised calls at a small shape, where the card outruns the host.

Between phases 7 and 8, two more ticks of phase 6's service run under
``torch.profiler`` (lines ``[p]``): device time by kernel, and the
device's busy share of the traced wall time.  Every trace runs after its
path's launch counts have been read.

Every comparison raises on a mismatch; no phase catches a failure.  The
script exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
L2_FLUSH_BYTES = 2 * 50 * 2 ** 20      # twice the H100's 50 MB L2

# The LM path: qwen1.5-0.5b at full size, B prompts of T tokens.
LM_ARCH, LM_B, LM_T, LM_NEW = "qwen1.5-0.5b", 4, 1024, 32
LM_LOGIT_RTOL = 5e-2

SERVE_CAPS = dict(b_iters=30, f_iters=24, p_iters=20, t_iters=28)
DEVICE_MS_SESSIONS = 3        # profiler sessions before "not measured"
TOP_K = 8


def _check(ok, msg: str) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _time_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` on the card, by CUDA events (ms)."""
    import torch

    fn()                                  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _device_ms(fn, reps: int, cold: bool = False,
               kernel: str | None = None) -> float:
    """Device time of one call of ``fn``: the sum of every device event
    that ``torch.profiler`` records over ``reps`` calls, over ``reps``.
    Unlike :func:`_time_ms` it leaves out the host's time between launches
    (Python, ctypes, argument checks), which dominates a microsecond
    kernel's wall time.  ``cold`` rewrites a buffer of twice the card's
    50 MB L2 before every call (its kernel is left out of the sum), so the
    call reads its inputs from device memory, as a bound assumes.
    ``kernel`` names the one kernel ``fn`` launches: the result is then the
    median of that kernel's device events, which stays right when the
    profiler drops an event of a session of a few long kernels.  Now and
    then a session records no device activity at all (a K5 session did on
    an H100, after 37 phases' sessions had); up to ``DEVICE_MS_SESSIONS``
    sessions are run before the time counts as not measured (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    for _ in range(DEVICE_MS_SESSIONS):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        if kernel is not None:
            times = sorted(evt.time_range.elapsed_us()
                           for evt in prof.events()
                           if evt.device_type != DeviceType.CPU
                           and kernel in evt.name)
            if times:
                return times[len(times) // 2] / 1e3
        rows = prof.key_averages()
        us = sum(evt.self_device_time_total for evt in rows
                 if evt.device_type != DeviceType.CPU
                 and not (cold and "bitwise_not" in evt.key))
        if us > 0:
            return us / 1e3 / reps
        print("chip_smoke: the profiler recorded no device time; its rows: "
              + json.dumps([(evt.key[:60], str(evt.device_type), evt.count,
                             evt.self_device_time_total) for evt in rows]))
    return None


def _fmt(x, spec: str = ".4g") -> str:
    """A measured number, or "not measured" where the profiler recorded
    none (``_device_ms`` returned None)."""
    return "not measured" if x is None else format(x, spec)


def _div(a, b):
    return None if a is None or b is None else a / b


def _sub(a, b):
    return None if a is None or b is None else a - b


def _host_ms(fn, n: int = 1000) -> float:
    """Host time per call of ``fn`` over ``n`` calls that are not
    synchronised (the card must outrun the host: call it at a small
    shape)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def _ptxas(log: str) -> list[str]:
    """One line per kernel of nvcc's ``-Xptxas -v`` report: its name, its
    registers, spills and static shared memory."""
    import re

    def short(mangled: str) -> str:
        # The <length><name> of the mangled symbol that names the kernel,
        # and its template arguments.
        for i in range(len(mangled)):
            for n in (1, 2, 3):
                digits = mangled[i:i + n]
                if not digits.isdigit():
                    break
                ident = mangled[i + n:i + n + int(digits)]
                if ident.endswith("_kernel"):
                    t = re.match(r"I(.*?)E", mangled[i + n + len(ident):])
                    return ident + (f"<{t.group(1)}>" if t else "")
        return mangled

    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short(m.group(1))
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name = None
    return out


def _sass_rounds(sass: str) -> dict:
    """The SASS instructions of the bisection loops of each SROA kernel,
    read from ``cuobjdump -sass`` output: for every function whose name
    holds ``sroa``, the lengths of its innermost loops that hold a
    reciprocal (MUFU.RCP: the step's G / b), each marked "ieee" when it
    also holds FCHK (the IEEE division's slow-path check: PR 11's steps,
    one a loop) and "nb" when it does not (the branch-free rounds: the
    loop is unrolled twice, so it holds 2D steps at depth D)."""
    import re

    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"(sroa_(?:solve_lanes|solve|invert_rate)_kernel)"
                      r"(?:ILi(\d+)E)?", chunk.split("\n", 1)[0])
        if not m:
            continue
        ins = [(int(a, 16), op) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk)]
        loops = []
        for addr, op in ins:
            b = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", op)
            if b and int(b.group(1), 16) < addr:
                loops.append((int(b.group(1), 16), addr))
        found = set()
        for lo, hi in loops:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi)
                   for a, b in loops):
                continue                      # not innermost
            body = [o for a, o in ins if lo <= a <= hi]
            if any("MUFU.RCP" in o for o in body):
                kind = ("ieee" if any(o.startswith("FCHK") for o in body)
                        else "nb")
                found.add(f"{len(body)} {kind}")
        out[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = \
            sorted(found)
    return out


def _bound_ms(nbytes: float, flops: float,
              peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _k2_bound(w: dict, n_prob: int, N: int, caps: dict = SERVE_CAPS):
    """K2's operations (this data's ``work`` from the twin, 8 flop a rate
    step) and its bound: (flops, (ms, "bytes" | "operations"))."""
    flops = N * (8 * caps["b_iters"] * w["inversions"] + 12 * w["f_steps"]
                 + 8 * w["p_steps"] + 20 * w["t_steps"]
                 + 10 * caps["t_iters"] * n_prob)
    nbytes = n_prob * N * 4 * (7 + 3) + n_prob * 4 * (5 + 3) + n_prob
    return flops, _bound_ms(nbytes, flops)


def _max_abs_err(got, want) -> float:
    import torch

    errs = [float((g.double() - w.double()).abs().max())
            for g, w in zip(got, want) if g.dtype.is_floating_point]
    return max(errs) if errs else 0.0


def _profile(tag: str, what: str, fn) -> list:
    """Run ``fn`` once under ``torch.profiler``; print device time by
    kernel and the device's busy share of the traced wall time.  Returns
    the (ms, count, name) rows, largest first."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # Device-side events only: a CPU op's self device time repeats the
        # time of the kernels it launched.
        if evt.device_type == DeviceType.CPU:
            continue
        us = evt.self_device_time_total
        if us > 0:
            rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"{tag} {what}: {wall_ms:.2f} ms wall, {busy_ms:.2f} "
          f"ms device time in {sum(r[1] for r in rows)} device events "
          f"({len(rows)} names); busy share "
          f"{busy_ms / wall_ms if rows else float('nan'):.4f}")
    for ms, n, name in rows[:12]:
        print(f"{tag}   {ms:10.3f} ms  {n:6d} x  {name[:90]}")
    if not rows:
        print(f"{tag}   the trace holds no device time: not measured")
    return rows


def _attn_plain(q, k, v, **kw):
    """K4's plain version in the model layout (B, T, H, hd)."""
    from repro_torch.kernels import ref

    t = lambda x: x.transpose(1, 2)  # noqa: E731
    return t(ref.attention_plain(t(q), t(k), t(v), **kw))


def _check_k4(report: dict, dev) -> None:
    """Phase 4: K4's two kernels against their plain version, and times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(4)

    def qkv(Tq, Tk, B, H, hd, dtype):
        return [torch.randn((B, T, H, hd), generator=gen, device=dev
                            ).to(dtype) for T in (Tq, Tk, Tk)]

    bf16, f32 = torch.bfloat16, torch.float32
    tol = {bf16: 2e-2, f32: 2e-5}
    cases = [((LM_T, LM_T, LM_B, 16, 64), dtype, dict(causal=True))
             for dtype in (bf16, f32)]
    cases.append(((LM_T, LM_T, 1, 24, 128), bf16, dict(causal=True)))
    for B, H, T, hd in ((1, 1, 8, 64), (2, 4, 16, 64), (1, 2, 128, 128),
                        (2, 2, 96, 80), (1, 4, 256, 112)):
        for dtype in (bf16, f32):
            cases.append(((T, T, B, H, hd), dtype, dict(causal=True)))
    for dtype in (bf16, f32):
        cases += [((64, 64, 1, 2, 64), dtype, dict(causal=False)),
                  ((160, 160, 1, 2, 64), dtype,
                   dict(causal=True, window=16)),
                  ((1, 64, 1, 2, 64), dtype, dict(causal=True, q_offset=63)),
                  ((30, 130, 2, 3, 64), dtype,
                   dict(causal=True, q_offset=100))]
    errs = []

    def check(q, k, v, dtype, kw):
        w0 = ops.LAUNCHES["flash_attention_sm90"]
        got = ops.flash_attention(q, k, v, **kw)
        wgmma = ops.LAUNCHES["flash_attention_sm90"] - w0
        _check(wgmma == int(dtype == bf16 and q.shape[-1] <= 128),
               f"K4 took the wrong kernel on {tuple(q.shape)} {dtype}")
        want = _attn_plain(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=tol[dtype], atol=tol[dtype])
        errs.append(_max_abs_err([got.float()], [want.float()]))

    for shape, dtype, kw in cases:
        check(*qkv(*shape, dtype), dtype, kw)
    fused = torch.randn((2, 70, 3, 4, 64), generator=gen, device=dev
                        ).to(bf16)
    check(*fused.unbind(2), bf16, dict(causal=True))
    torch.cuda.synchronize()
    dtypes = [dtype for _, dtype, _ in cases] + [bf16]
    n_bf16 = dtypes.count(bf16)
    bf16_err = max(e for e, dt in zip(errs, dtypes) if dt == bf16)
    print(f"[4] K4 ok on {len(dtypes)} cases ({n_bf16} bf16 on the "
          f"tensor-core kernel at 2e-2, {len(dtypes) - n_bf16} f32 on "
          f"the SIMT kernel at 2e-5: LM prefill shape, hd 128, the JAX "
          f"sweep, non-causal, window 16, decode offset, Tq != Tk, fused "
          f"QKV views): max |err| bf16 LM shape {errs[0]:.3g}, f32 LM shape "
          f"{errs[1]:.3g}, any bf16 case {bf16_err:.3g}")

    B, H, T, hd = LM_B, 16, LM_T, 64
    q, k, v = qkv(T, T, B, H, hd, bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = dict(causal=True, q_offset=0, window=None)
    k4 = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    simt = lambda: fa.flash_attention_cuda(  # noqa: E731
        q, k, v, _route="simt", **kw)
    k4p = lambda: _attn_plain(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib_err = _max_abs_err([sdpa().transpose(1, 2).float()], [k4().float()])
    simt_err = _max_abs_err([simt()[0].float()], [k4p().float()])
    nbytes = 4 * B * T * H * hd * 2
    flops = 4 * hd * B * H * T * (T + 1) // 2
    bound = _bound_ms(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
    small = [torch.randn((1, 64, 1, 64), generator=gen, device=dev).to(bf16)
             for _ in range(3)]
    plain_ms = _time_ms(k4p, 5)
    lib_ms, lib_dev = _time_ms(sdpa, 20), _device_ms(sdpa, 20)
    report["flash_attention_sm90"] = dict(
        name="flash_attention_sm90", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:26",
        max_abs_err=errs[0], ms=_time_ms(k4, 20), plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
        device_ms=_device_ms(k4, 20), library_device_ms=lib_dev,
        device_ms_cold=_device_ms(k4, 20, cold=True),
        library_device_ms_cold=_device_ms(sdpa, 20, cold=True),
        host_ms=_host_ms(lambda: ops.flash_attention(*small, causal=True)))
    # The SIMT kernel (K4's route for f32 and hd > 128) on the same bf16
    # tensors, through the wrapper's private route argument.
    report["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:26",
        max_abs_err=simt_err, ms=_time_ms(simt, 10), plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
        device_ms=_device_ms(simt, 10), library_device_ms=lib_dev)
    r, rs = report["flash_attention_sm90"], report["flash_attention"]
    print(f"[4] K4 at ({B}, {H}, {T}, {hd}) bf16 causal: tensor cores "
          f"{r['ms']:.4g} ms (device {_fmt(r['device_ms'])}); SIMT "
          f"{rs['ms']:.4g} ms (device {_fmt(rs['device_ms'])}), "
          f"{_fmt(_div(rs['device_ms'], r['device_ms']), '.3g')}x the tensor cores' "
          f"device time; plain {r['plain_ms']:.4g} ms; SDPA "
          f"{r['library_ms']:.4g} ms (device {_fmt(r['library_device_ms'])}; "
          f"|K4 - SDPA| max {lib_err:.3g}); bound {bound[0]:.4g} ms by "
          f"{bound[1]} ({flops:.4g} flop, {nbytes} bytes), "
          f"{_fmt(_div(bound[0], r['device_ms']), '.4f')} of it; with a cold L2 "
          f"{_fmt(r['device_ms_cold'])} ms (SDPA "
          f"{_fmt(r['library_device_ms_cold'])}); host "
          f"{r['host_ms']:.4g} ms a call (1,000 unsynchronised at (1, 64, 1, "
          f"64)), events - device {_fmt(_sub(r['ms'], r['device_ms']))} ms")

    B, H, T, hd = 1, 24, LM_T, 128
    q, k, v = qkv(T, T, B, H, hd, bf16)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    k4 = lambda: ops.flash_attention(q, k, v, causal=True)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    b128 = _bound_ms(4 * B * T * H * hd * 2,
                     4 * hd * B * H * T * (T + 1) // 2,
                     BF16_TENSOR_FLOPS_PER_S)
    t = dict(ms=_time_ms(k4, 20), dev=_device_ms(k4, 20),
             lib=_time_ms(sdpa, 20), lib_dev=_device_ms(sdpa, 20))
    r["hd128"] = dict(shape=[B, H, T, hd], ms=t["ms"], device_ms=t["dev"],
                      library_ms=t["lib"], library_device_ms=t["lib_dev"],
                      bound_ms=b128[0], bound_by=b128[1])
    print(f"[4] K4 at ({B}, {H}, {T}, {hd}) bf16 causal: tensor cores "
          f"{t['ms']:.4g} ms (device {_fmt(t['dev'])}); SDPA {t['lib']:.4g} "
          f"ms (device {_fmt(t['lib_dev'])}); bound {b128[0]:.4g} ms by "
          f"{b128[1]}")


def _check_k5(report: dict, dev) -> None:
    """Phase 5: K5 against its plain version, and its times."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    rows, d = LM_B * LM_T, 1024
    bitwise = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
        s = torch.randn((d,), generator=gen, device=dev).to(dtype)
        got, want = ops.fused_rmsnorm(x, s), ref.rmsnorm_plain(x, s)
        bitwise[str(dtype)] = bool(torch.equal(got, want))
        _check(bitwise[str(dtype)], f"K5 differs from its twin in {dtype}")
        if dtype == torch.bfloat16:
            err = _max_abs_err([got.float()], [want.float()])
            xb, sb = x, s
    torch.cuda.synchronize()
    sf = sb.float()          # the kernel's scale: f32, cast once
    k5 = lambda: ops.fused_rmsnorm(xb, sf)  # noqa: E731
    k5p = lambda: ref.rmsnorm_plain(xb, sf)  # noqa: E731
    lib = lambda: F.rms_norm(xb, (d,), weight=sb, eps=1e-6)  # noqa: E731
    bound = _bound_ms(2 * rows * d * 2 + d * 4, 4 * rows * d)
    xs = torch.randn((64, d), generator=gen, device=dev).to(torch.bfloat16)
    report["rmsnorm"] = dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:15",
        max_abs_err=err, ms=_time_ms(k5, 50), plain_ms=_time_ms(k5p, 20),
        bound_ms=bound[0], bound_by=bound[1], library_ms=_time_ms(lib, 50),
        device_ms=_device_ms(k5, 50), library_device_ms=_device_ms(lib, 50),
        device_ms_cold=_device_ms(k5, 50, cold=True),
        library_device_ms_cold=_device_ms(lib, 50, cold=True),
        host_ms=_host_ms(lambda: ops.fused_rmsnorm(xs, sf)))
    r = report["rmsnorm"]
    print(f"[5] K5 ok at ({rows}, {d}): bitwise equal to its twin "
          f"{json.dumps(bitwise)}; bf16 max |err| against the twin {err:.3g}; "
          f"{r['ms']:.4g} ms (device {_fmt(r['device_ms'])}), plain "
          f"{r['plain_ms']:.4g} ms, F.rms_norm {r['library_ms']:.4g} ms "
          f"(device {_fmt(r['library_device_ms'])}), bound {bound[0]:.4g} ms "
          f"by {bound[1]}, {_fmt(_div(bound[0], r['device_ms']), '.4f')} of it (the "
          f"timing loop's {4 * rows * d / 1e6:.3g} MB stay in L2); with a "
          f"cold L2 "
          f"{_fmt(r['device_ms_cold'])} ms (F.rms_norm "
          f"{_fmt(r['library_device_ms_cold'])}), "
          f"{_fmt(_div(bound[0], r['device_ms_cold']), '.4f')} of the bound; host "
          f"{r['host_ms']:.4g} ms a call (1,000 unsynchronised at (64, "
          f"{d})), events - device {_fmt(_sub(r['ms'], r['device_ms']))} ms")


def _check_k3(report: dict, dev, cells, init, mask, sms: int) -> None:
    """Phase 3: K3's warp kernel, its block kernel and the plain twin,
    bitwise at the planning shape and at two synthetic ones; the two
    kernels timed on the same tensors in turns, beside ``torch.topk`` on
    the twin's score tile, an empty kernel's launch and the bound."""
    import torch

    from repro_torch.fleet import engine as fengine
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import topk_moves as tk
    from repro_torch.kernels.sroa_bisect import _stream

    C, N, M = cells.gain.shape
    targs = [cells.gain.contiguous(), fengine._move_H(cells).contiguous(),
             cells.p_max.contiguous(), init.contiguous(), mask.contiguous(),
             cells.N0.contiguous(), cells.B_open.contiguous()]

    def on(route, args, k):
        return lambda: tk.topk_moves_cuda(*args, k, _route=route)[0]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    def synth(P, n, m, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn((P, n, m), generator=g, device=dev).abs() * 1e-7
                + 1e-9, torch.full((P, n), 2.4e5, device=dev),
                torch.full((P, n), 0.2, device=dev),
                torch.randint(0, m, (P, n), generator=g, device=dev,
                              dtype=torch.int32),
                torch.rand((P, n), generator=g, device=dev) < 0.9,
                torch.full((P,), 1e-17, device=dev),
                torch.full((P,), 1e7, device=dev)]

    def off_range(P, n, m, seed):
        """synth's operands sent off the warp kernel's branch-free division
        and log1pf: a tenth of the gains 1e-30, one 1e30, and N0 = 1e-3,
        B = 1e25 (noise past 2^60) in the even cells; in the odd ones user
        1's H 1e30 and user 2's 1e-30 (with ordinary gains)."""
        g, H, pm, a, mk, N0, B = synth(P, n, m, seed)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        g[torch.rand(g.shape, generator=gen, device=dev) < 0.1] = 1e-30
        g[:, 1:3] = 2e-8
        H[1::2, 1], H[1::2, 2] = 1e30, 1e-30
        g[:, n // 2, m - 1] = 1e30
        N0[::2], B[::2] = 1e-3, 1e25
        return [g, H, pm, a, mk, N0, B]

    k3 = lambda: ops.topk_move_scores(*targs, k=TOP_K)  # noqa: E731
    k3p = lambda: ref.topk_moves_plain(*targs, k=TOP_K)  # noqa: E731
    w0 = ops.LAUNCHES["topk_moves_warp"]
    got, want = k3(), k3p()
    _check(ops.LAUNCHES["topk_moves_warp"] == w0 + 1,
           "K3 at the planning shape did not take the warp kernel")
    _check(same(got, want), "K3 differs from its twin")
    _check(same(on("warp", targs, TOP_K)(), want)
           and same(on("block", targs, TOP_K)(), want),
           "K3's warp and block kernels differ from the twin")
    err = _max_abs_err(got[2:], want[2:])
    cases = [f"({C}, {N}, {M}) warp"]
    for P, n, m, seed in ((128, 128, 4, 31), (16, 300, 7, 32)):
        args = synth(P, n, m, seed)
        route = tk.topk_route(n, m, TOP_K)
        for k in (TOP_K, 40):
            want_s = ref.topk_moves_plain(*args, k=k)
            _check(same(ops.topk_move_scores(*args, k=k), want_s)
                   and same(on("block", args, k)(), want_s)
                   and (route == "block" or same(on("warp", args, k)(),
                                                 want_s)),
                   f"K3 at ({P}, {n}, {m}), k = {k} differs from its twin")
        cases.append(f"({P}, {n}, {m}) {route}")
    args = off_range(C, N, M, 33)
    _check(not ref.move_scores_plain(*args).isnan().any(),
           "K3's off-range operands make a NaN score")
    for k in (TOP_K, 40):
        want_s = ref.topk_moves_plain(*args, k=k)
        _check(same(on("warp", args, k)(), want_s)
               and same(on("block", args, k)(), want_s),
               f"K3 off the fast ranges at ({C}, {N}, {M}), k = {k} differs "
               f"from its twin")
    cases.append(f"({C}, {N}, {M}) warp off the fast ranges")
    torch.cuda.synchronize()
    print(f"[3] K3 ok: the routed call, the warp kernel, the block "
          f"kernel and the twin give identical user, dst and score at "
          f"{', '.join(cases)} (k = {TOP_K} and 40); max |score err| {err}")

    # Both kernels on the same tensors, in turns (warp, block, block,
    # warp).
    kname = {"warp": "topk_moves_warp_kernel", "block": "topk_moves_kernel"}
    turns = {r: {"ms": [], "device_ms": []} for r in kname}
    for r in ("warp", "block", "block", "warp"):
        turns[r]["ms"].append(_time_ms(on(r, targs, TOP_K), 50))
        turns[r]["device_ms"].append(_device_ms(on(r, targs, TOP_K), 50,
                                                kernel=kname[r]))
    S = tk.warp_slots(N, M)
    blocks = ctypes.c_int()
    build.check(build.load().topk_moves_warp_occupancy(
        S, N, M, ctypes.byref(blocks)), "topk_moves_warp_occupancy")
    tile = ref.move_scores_plain(*targs)
    lib = lambda: torch.topk(tile, TOP_K, dim=1, largest=False,  # noqa
                             sorted=True)
    _check(torch.equal(lib()[0], want[2]),
           "torch.topk's values differ from the twin's scores")
    empty = lambda: build.check(  # noqa: E731
        build.load().topk_empty(_stream(tile)), "topk_empty")
    nbytes = C * N * M * 4 + C * N * (4 + 4 + 4 + 1) + C * 8 + C * TOP_K * 12
    bound = _bound_ms(nbytes, C * (12 + TOP_K) * N * M)
    plain_ms = _time_ms(k3p, 5)
    common = dict(route="cuda",
                  source="src/repro_torch/kernels/csrc/topk_moves.cu",
                  replaces="src/repro/kernels/topk_moves.py:41",
                  max_abs_err=err, plain_ms=plain_ms, bound_ms=bound[0],
                  bound_by=bound[1], library_ms=_time_ms(lib, 50),
                  library_device_ms=_device_ms(lib, 50),
                  library_is="torch.topk on the twin's (P, N*M) tile: "
                             "selection only; the port never calls it",
                  floor_ms=_time_ms(empty, 50),
                  floor_device_ms=_device_ms(empty, 50, kernel="topk_empty"))

    def mean(x):
        return None if None in x else sum(x) / len(x)

    for r, name in (("warp", "topk_moves_warp"), ("block", "topk_moves")):
        report[name] = dict(common, name=name, ms=mean(turns[r]["ms"]),
                            device_ms=mean(turns[r]["device_ms"]),
                            turns=turns[r])
    rw = report["topk_moves_warp"]
    rw.update(slots=S, blocks_per_sm=blocks.value,
              routed_ms=_time_ms(k3, 50), host_ms=_host_ms(k3))
    rb = report["topk_moves"]
    ptx = [line for line in _ptxas(build.build_log) if "topk" in line]
    print("[3] K3 ptxas (registers; stack frame, spill stores and loads): "
          + " | ".join(ptx))
    print(f"[3] warp kernel at ({C}, {N}, {M}): S = {S} entries a lane, "
          f"one cell (warp) a block, {blocks.value} blocks an SM "
          f"({sms} SMs)")
    print(f"[3] K3 at ({C}, {N}, {M}), k = {TOP_K}, in turns (warp, block, "
          f"block, warp): warp kernel {rw['ms']:.4g} ms (device "
          f"{rw['device_ms']}), the block kernel {rb['ms']:.4g} ms "
          f"(device {rb['device_ms']}); turns {json.dumps(turns)}; plain "
          f"{plain_ms:.4g} ms; torch.topk on the twin's tile (selection "
          f"only) {common['library_ms']:.4g} ms (device "
          f"{common['library_device_ms']}); empty kernel (launch floor) "
          f"{common['floor_ms']:.4g} ms (device "
          f"{common['floor_device_ms']}); bound {bound[0]:.4g} ms by "
          f"{bound[1]} ({nbytes} bytes); ops.topk_move_scores "
          f"{rw['routed_ms']:.4g} ms, host {rw['host_ms']:.4g} ms a call "
          f"(1,000 unsynchronised)")


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 first; returns its
    result and the counts of that run."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def _add(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def _k2_operands(scn, assigns):
    """K2's operands for one scenario's patterns, each pattern's constants
    computed as ``sroa.solve`` computes them: per-user (P, N), per-problem
    (P,)."""
    import torch

    from repro_torch.core.system_model import sroa_constants

    cs = [sroa_constants(scn, a) for a in assigns]
    P, N = len(cs), scn.N
    pu = [torch.stack([getattr(c, k) for c in cs]).contiguous()
          for k in ("A", "J", "H", "delta", "h")]
    pu += [scn.f_max.expand(P, N).contiguous(),
           scn.p_max.expand(P, N).contiguous()]
    one = torch.ones(P, device=scn.device)
    pp = [scn.B_open * one, scn.B_open * one, scn.N0 * one, one,
          torch.stack([c.E_cloud_total for c in cs])]
    return pu, pp


def _k2_tsia_shapes(dev) -> dict:
    """K2 at TSIA's shape (P = 1: ``draw_scenario(0)``'s nearest-edge
    pattern, the first TSIA scores, at full caps) and at the host loop's
    (P = 1 + N (M - 1) = 201: that pattern's neighbourhood, serve caps)."""
    import torch

    from repro_torch.core import sroa, wireless
    from repro_torch.fleet.incremental import candidate_assigns

    scn = wireless.draw_scenario(0, device=dev)
    full = sroa.SroaConfig()
    full_caps = dict(b_iters=full.b_iters, f_iters=full.f_iters,
                     p_iters=full.p_iters, t_iters=full.t_iters)
    nearest = wireless.nearest_edge_assignment(scn)
    nb = torch.as_tensor(candidate_assigns(nearest.cpu().numpy(), scn.M),
                         device=dev)
    return {"tsia_p1": (_k2_operands(scn, [nearest]), full_caps),
            "host_loop_p201": (_k2_operands(scn, list(nb)), SERVE_CAPS)}


def _time_k2_tsia_shapes(shapes: dict) -> dict:
    """K2's events and device time at the shapes of
    :func:`_k2_tsia_shapes`, read before any plain twin runs (phase 2)."""
    from repro_torch.kernels import ops

    out = {}
    for key, ((pu, pp), caps) in shapes.items():
        fn = lambda: ops.sroa_solve_batched(*pu, *pp, **caps)  # noqa: E731
        out[key] = dict(P=pu[0].shape[0], N=pu[0].shape[1], caps=caps,
                        ms=_time_ms(fn, 3),
                        device_ms=_device_ms(fn, 3, kernel="sroa_solve"))
    return out


def _tsia_path(dev, report: dict, k2: dict) -> dict:
    """Phase t: TSIA (Algorithm 5) on K2, the RA baselines on K1 and K2,
    and the per-cell planner (``serve --no-stream``, ``--host-loop``) on K2
    and K3.  Returns the launch counts of the path's runs (timing and
    comparison launches left out)."""
    import numpy as np
    import torch

    from repro_torch.core import baselines, sroa, tsia, wireless
    from repro_torch.core.system_model import evaluate
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve

    path: dict = {}
    scn = wireless.draw_scenario(0, device=dev)
    N, M = scn.N, scn.M
    full = sroa.SroaConfig(fused=True)
    full_caps = dict(b_iters=full.b_iters, f_iters=full.f_iters,
                     p_iters=full.p_iters, t_iters=full.t_iters)
    k2 = {key: dict(t) for key, t in k2.items()}

    # (a) TSIA at the paper's N = 50, M = 5 and full caps: one K2 launch
    # a score.
    scores = []

    def score_full(a):
        scores.append(a.copy())
        return tsia._score(scn, a, 1.0, full)

    t0 = time.perf_counter()
    res, counts = _counted(lambda: tsia.solve(scn, 1.0, full,
                                              score_fn=score_full))
    wall_ms = (time.perf_counter() - t0) * 1e3
    _add(path, counts)
    h = res.history
    n_scores = len(scores)
    _check(n_scores == 2 + h.total_iters,
           f"TSIA scored {n_scores} patterns in {h.total_iters} moves")
    _check(counts["sroa_solve"] == n_scores,
           f"{counts['sroa_solve']} K2 launches for {n_scores} scores")
    _check(counts["sroa_solve_lanes"] == n_scores,
           f"{n_scores - counts['sroa_solve_lanes']} of TSIA's K2 launches "
           f"took PR 11's kernel")
    _check(res.R == min(h.R_trace), "TSIA's R is not its trace's minimum")
    best = torch.as_tensor(res.assign, device=dev)
    R_ev = float(evaluate(scn, best, res.sroa.b, res.sroa.f, res.sroa.p,
                          1.0).R)
    _check(abs(R_ev - res.R) <= 1e-5 * abs(res.R),
           f"evaluate gives {R_ev} for TSIA's R {res.R}")
    _check(all(src != dst for _, _, _, src, dst in h.moves),
           "a TSIA move with src == dst")
    _check(((res.assign >= 0) & (res.assign < M)).all(), "TSIA assignment")

    shapes = _k2_tsia_shapes(dev)
    nearest = wireless.nearest_edge_assignment(scn)
    print(f"[t] (a) TSIA at draw_scenario(0) (N = {N}, M = {M}), caps "
          f"{full_caps}, fused: {n_scores} scores ({h.iters_stage1} + "
          f"{h.iters_stage2} moves) in {wall_ms:.1f} ms, "
          f"{wall_ms / n_scores:.3f} ms a score; {counts['sroa_solve']} K2 "
          f"launches, all on the lanes kernel; R = {res.R:.6g} "
          f"(evaluate {R_ev:.6g}); K2 at P = 1 (phase 2, nearest-edge "
          f"pattern): {_fmt(k2['tsia_p1']['device_ms'])} ms device, "
          f"{k2['tsia_p1']['ms']:.4g} ms events")

    # (b) TSIA at the serve caps, every score recorded; then every scored
    # pattern in ONE call of K2's plain twin: the same bits, so the plain
    # version would have taken the same decisions.
    serve_cfg = sroa.SroaConfig(**SERVE_CAPS, fused=True)
    rec = []

    def score_rec(a):
        out = tsia._score(scn, a, 1.0, serve_cfg)
        rec.append((a.copy(), out[0]))
        return out

    res_b, counts = _counted(lambda: tsia.solve(scn, 1.0, serve_cfg,
                                                score_fn=score_rec))
    _add(path, counts)
    pu, pp = _k2_operands(scn, [torch.as_tensor(a, device=dev)
                                for a, _ in rec])
    t0 = time.perf_counter()
    want = ref.sroa_solve_plain(*pu, *pp, **SERVE_CAPS)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    for i, (_, got) in enumerate(rec):
        for k, name in enumerate(("b", "f", "p")):
            _check(torch.equal(getattr(got, name).reshape(-1), want[k][i]),
                   f"TSIA score {i}: K2's {name} differs from the twin's")
        torch.testing.assert_close(got.R.reshape(()), want[4][i],
                                   rtol=1e-4, atol=0)
    print(f"[t] (b) TSIA at the serve caps: {len(rec)} scores, "
          f"{len(res_b.history.moves)} moves; K2's b, f, p of every scored "
          f"pattern bitwise the twin's in one call at P = {len(rec)} "
          f"({twin_ms:.0f} ms), R to rtol 1e-4")

    # The plain twin at the two timed shapes, with this data's work.
    for key, ((pu, pp), caps) in shapes.items():
        w = {}
        t0 = time.perf_counter()
        plain = ref.sroa_solve_plain(*pu, *pp, **caps, work=w)
        torch.cuda.synchronize()
        k2[key]["plain_ms"] = (time.perf_counter() - t0) * 1e3
        got = ops.sroa_solve_batched(*pu, *pp, **caps)
        _check(all(torch.equal(x, y) for x, y in zip(got, plain)),
               f"K2 at {key} differs from its twin")
        flops, (bms, by) = _k2_bound(w, k2[key]["P"], N, caps)
        k2[key].update(work=w, flops=flops, bound_ms=bms, bound_by=by)
        print(f"[t] K2 at P = {k2[key]['P']}, N = {N} ({key}, caps "
              f"{caps}): device {_fmt(k2[key]['device_ms'])} ms, events "
              f"{k2[key]['ms']:.4g} ms, plain {k2[key]['plain_ms']:.0f} ms "
              f"(bitwise), bound {bms:.3g} ms by {by} (work {w})")
    report["sroa_solve_lanes"].update(k2)

    # (c) The baselines at the nearest-edge pattern, on the serve caps:
    # HFEL's and SROA's inversions on K1 (use_pallas) against the eager
    # inversion; SROA below every other method (Fig 2).
    eager_cfg = sroa.SroaConfig(**SERVE_CAPS)
    k1_cfg = sroa.SroaConfig(**SERVE_CAPS, use_pallas=True)

    def R_of(ra):
        return float(evaluate(scn, nearest, ra.b, ra.f, ra.p, 1.0).R)

    scores_ra = {}
    k1_n = {}
    for name in ("HFEL", "SROA"):
        fn = baselines.RA_METHODS[name]
        R_e = R_of(fn(scn, nearest, 1.0, eager_cfg))
        ra, counts = _counted(lambda: fn(scn, nearest, 1.0, k1_cfg))
        _add(path, counts)
        k1_n[name] = counts["sroa_invert"]
        _check(k1_n[name] > 0, f"{name} on use_pallas launched no K1")
        R_k = R_of(ra)
        _check(abs(R_k - R_e) <= 1e-5 * abs(R_e),
               f"{name}: R on K1 {R_k} against the eager inversion {R_e}")
        scores_ra[name] = R_e
    for name, fn in baselines.RA_METHODS.items():
        if name not in scores_ra:
            scores_ra[name] = R_of(fn(scn, nearest, 1.0, eager_cfg))
    _check(all(math.isfinite(R) for R in scores_ra.values()),
           f"non-finite baseline R: {scores_ra}")
    _check(min(scores_ra, key=scores_ra.get) == "SROA",
           f"SROA does not beat every baseline: {scores_ra}")
    print(f"[t] (c) RA baselines at the nearest-edge pattern: R "
          f"{json.dumps({k: round(v, 3) for k, v in scores_ra.items()})}; "
          f"SROA lowest; K1 launches on use_pallas: {json.dumps(k1_n)}, R "
          f"equal to the eager inversion's to rtol 1e-5")

    # (d) The per-cell planner through the CLI: the engine route at the
    # README fleet's width with top-8 pruning, then the host loop.
    argv = ["--mode", "plan", "--no-stream", "--device", "cuda",
            "--cells", "16", "--cell-users", "50", "--cell-edges", "5",
            "--rounds", "2", "--plan-rounds", "12"]
    runs = {}
    for key, extra in (("no_stream", ["--top-k", str(TOP_K)]),
                       ("host_loop", ["--host-loop", "--cells", "2",
                                      "--rounds", "1"])):
        out, counts = _counted(lambda: serve.main(argv + extra))
        _add(path, counts)
        for i, rnd in enumerate(out["rounds"]):
            for c, r in enumerate(rnd["responses"]):
                a = np.asarray(r["assign"])
                _check(((a >= 0) & (a < 5)).all() and len(a) > 0,
                       f"{key} round {i} cell {c}: assignment off range")
                _check(math.isfinite(r["objective"]),
                       f"{key} round {i} cell {c}: non-finite R")
                if c not in rnd["changed"]:
                    _check(r["cached"], f"{key} round {i}: unchanged cell "
                           f"{c} was not a cache hit")
        _check(counts["sroa_solve"] > 0, f"{key}: no K2 launch")
        _check(counts["sroa_solve_lanes"] == counts["sroa_solve"],
               f"{key}: a K2 launch took PR 11's kernel")
        if key == "no_stream":
            _check(counts["topk_moves"] > 0, "no_stream: no K3 launch")
            block = counts["topk_moves"] - counts["topk_moves_warp"]
            _check(block == 0, f"no_stream: {block} K3 launches took the "
                   f"block kernel")
        n_cells = len(out["rounds"][0]["responses"])
        runs[key] = dict(cold_ms=out["cold_ms"], counts=counts,
                         rounds=[dict(changed=len(r["changed"]),
                                      hits=r["hits"], ms=r["ms"],
                                      plans_per_s=n_cells / r["ms"] * 1e3)
                                 for r in out["rounds"]])
        print(f"[t] (d) serve {' '.join(argv[2:3] + extra)} ({n_cells} "
              f"cells of up to 50 users, M = 5): cold {out['cold_ms']:.1f} "
              f"ms; rounds " + "; ".join(
                  f"{r['changed']} changed, {r['hits']} hits, "
                  f"{r['ms']:.1f} ms, {r['plans_per_s']:.4g} plans/s"
                  for r in runs[key]["rounds"])
              + f"; launches {json.dumps(counts)}")
    return {"counts": path, "tsia": dict(scores=n_scores, wall_ms=wall_ms,
                                         ms_per_score=wall_ms / n_scores),
            "k2": k2, "baselines": scores_ra, "serve": runs}


def _lm_path(dev) -> dict:
    """Phase 8: the LM serving path on K4 and on the chunked route."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import run_lm
    from repro_torch.models import transformer as tf

    chunked = configs.get(LM_ARCH)
    flash = dataclasses.replace(chunked, attn_impl="pallas")
    kw = dict(batch=LM_B, prompt_len=LM_T, seed=0, device=dev)
    run_lm(flash, new_tokens=2, **kw)             # warm-up: cold starts
    torch.cuda.synchronize()
    ops.reset_launches()
    a = run_lm(flash, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    b = run_lm(chunked, new_tokens=LM_NEW, **kw)
    torch.cuda.synchronize()
    _check(counts["flash_attention"] == flash.n_layers,
           f"K4 launched {counts['flash_attention']} times in one prefill "
           f"of {flash.n_layers} layers")
    _check(counts["flash_attention_sm90"] == flash.n_layers,
           f"only {counts['flash_attention_sm90']} of the prefill's K4 "
           f"launches took the tensor-core kernel")
    la, lb = a["logits"].float(), b["logits"].float()
    _check(la.shape == (LM_B, flash.vocab), "prefill logits shape")
    _check(bool(torch.isfinite(la).all() & torch.isfinite(lb).all()),
           "non-finite prefill logits")
    rel = float((la - lb).abs().max() / lb.abs().max())
    _check(rel <= LM_LOGIT_RTOL, f"K4 and chunked prefill logits differ by "
           f"{rel:.3g} of max |logit| (limit {LM_LOGIT_RTOL})")
    for out in (a, b):
        toks = out["tokens"]
        _check(toks.shape == (LM_B, LM_NEW + 1) and (toks >= 0).all()
               and (toks < flash.vocab).all(), "generated tokens")
    agree = float(np.mean(a["tokens"] == b["tokens"]))
    print(f"[8] LM {LM_ARCH} full size ({flash.n_layers} layers, d "
          f"{flash.d_model}, vocab {flash.vocab}, {flash.dtype}), B = {LM_B}, "
          f"prompt {LM_T}, {LM_NEW} new tokens")
    print(f"[8] K4 route: prefill {a['prefill_s'] * 1e3:.3f} ms, decode "
          f"{a['tok_per_s']:.1f} tok/s; chunked route: prefill "
          f"{b['prefill_s'] * 1e3:.3f} ms, decode {b['tok_per_s']:.1f} tok/s")
    print(f"[8] K4 launches in the K4 route's run: "
          f"{counts['flash_attention']} (one per layer of one prefill), "
          f"{counts['flash_attention_sm90']} of them on the tensor cores; "
          f"last-position prefill logits max |delta| {rel:.4g} of max "
          f"|logit| {float(lb.abs().max()):.4g} (limit {LM_LOGIT_RTOL}); "
          f"greedy tokens agree at {agree:.4f} of positions "
          f"(identical: {bool(agree == 1.0)})")

    # One more prefill on K4 under the profiler (counts already read).
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        params = tf.init_params(flash, gen, dev)
        batch = {"tokens": torch.randint(0, flash.vocab, (LM_B, LM_T),
                                         generator=gen, device=dev)}
        prefill = tf.make_prefill_step(flash)
        prefill(params, batch)
        rows = _profile("[q]", "1 traced prefill on K4", lambda: prefill(
            params, batch))
        k4_ms = sum(ms for ms, _, name in rows if "flash_attention" in name)
        k4_n = sum(n for _, n, name in rows if "flash_attention" in name)
        busy = sum(ms for ms, _, _ in rows)
        print(f"[q] K4 share of the traced prefill's device time: "
              f"{k4_ms / busy if busy else float('nan'):.4f} ({k4_ms:.3f} "
              f"of {busy:.3f} ms in {k4_n} launches)")
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        serve_step = tf.make_serve_step(flash)

        def decode(steps=4):
            nonlocal cache, tok
            for _ in range(steps):
                step_logits, cache = serve_step(params, cache, tok)
                tok = torch.argmax(step_logits[:, -1], -1)[:, None]

        decode()
        _profile("[q]", "4 traced decode steps", decode)
    return {"counts": counts, "flash": a, "chunked": b, "rel": rel,
            "agree": agree, "n_layers": flash.n_layers}


def main(argv: list[str]) -> int:
    kernels_only = "--kernels" in argv
    try:
        import numpy as np
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: the port's kernels run only on a card")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"{SRC / 'repro_torch'} not found: run this script "
                     "from a checkout of the repository")
    sys.path.insert(0, str(SRC))

    from repro_torch.core import sroa
    from repro_torch.core.system_model import (expand_scenario,
                                               sroa_constants)
    from repro_torch.fleet import batch as fbatch
    from repro_torch.fleet import engine as fengine
    from repro_torch.fleet.service import (PlanningService, ServiceConfig,
                                           run_load)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sroa_bisect as sb

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[0] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible")

    # ---- phase 0: build every kernel from the checkout's sources --------
    t0 = time.perf_counter()
    build.load(verbose=True)
    print(f"[0] built {len(list(build.CSRC.glob('*.cu')))} sources into "
          f"{build.build_dir()} in {time.perf_counter() - t0:.1f} s")
    ptxas = _ptxas(build.build_log)
    for line in ptxas:
        print(f"[0]   ptxas: {line}")
    print("[0] K2 registers: " + "; ".join(
        line.split(",")[0] for line in ptxas if "sroa_solve" in line))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        rounds = json.dumps(_sass_rounds(subprocess.run(
            [cuobjdump, "-sass", build.load()._name], capture_output=True,
            text=True, check=True).stdout))
    except (OSError, subprocess.CalledProcessError) as exc:
        rounds = f"not measured ({exc})"
    print(f"[0] SASS instructions of the innermost bisection loops (with "
          f"MUFU.RCP; 'nb' branch-free, two rounds of D steps; 'ieee' one "
          f"step with the division's FCHK branch): {rounds}")
    for hd in (64, 128):
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        build.check(build.load().flash_attention_sm90_occupancy(
            hd, ctypes.byref(smem), ctypes.byref(ctas)), "occupancy")
        print(f"[0]   flash_attention_sm90_kernel<{hd}>: {smem.value} bytes "
              f"of dynamic shared memory a CTA of 128 threads, "
              f"{ctas.value} CTAs an SM")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fleet = fbatch.draw_fleet(0, 128, device=dev)
    C, N, M = fleet.C, fleet.N_max, fleet.M
    print(f"[0] fleet: draw_fleet(0, 128): C={C}, N_max={N}, M={M}, "
          f"{int(fleet.n_users.sum())} users")
    cells, mask = fleet.cells, fleet.mask
    init = fbatch.fleet_assignments(fleet)
    report = {}

    # ---- phase 1: K1 against its plain version -------------------------
    c0 = sroa_constants(cells, init, mask)
    G = (cells.p_max * c0.h / cells.N0[:, None]).contiguous()
    frac = torch.rand(G.shape, generator=torch.Generator(device="cpu")
                      .manual_seed(1)).to(dev) * 1.2
    tgt = (frac * G / math.log(2.0)).contiguous()
    bm = cells.B_open
    k1 = lambda: ops.sroa_invert_rate_batched(G, tgt, bm, 42)  # noqa: E731
    k1p = lambda: ref.invert_rate_plain(G, tgt, bm[:, None], 42)  # noqa
    got, want = k1(), k1p()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    _check(torch.equal(got, want), "K1 differs from its twin")
    err = _max_abs_err([got], [want])
    t0 = time.perf_counter()
    bad = sb.math_check(dev)
    _check(bad == (0, 0), f"the branch-free log1pf / division differ from "
           f"the toolkit's on {bad} inputs")
    print(f"[1] branch-free log1pf == log1pf on every float of [+0, "
          f"FLT_MAX] and fast division == IEEE division on 2^32 hashed pairs "
          f"(0 mismatches, {time.perf_counter() - t0:.2f} s)")
    # Every speculation depth gives the twin's bits; each is timed on the
    # same flattened tensors as the routed call.
    flat = [x.reshape(-1).contiguous()
            for x in (G, tgt, torch.broadcast_to(bm[:, None], G.shape))]
    k1_depth = sb.invert_depth(G.numel(), sms)
    k1_depth_ms = {}
    for d in sb.DEPTHS:
        for iters in (42, SERVE_CAPS["b_iters"], 7):
            _check(torch.equal(
                sb.invert_rate_cuda(*flat, iters, _depth=d).reshape(G.shape),
                ref.invert_rate_plain(G, tgt, bm[:, None], iters)),
                f"K1 at depth {d}, {iters} steps differs from its twin")
        k1_depth_ms[d] = _device_ms(
            lambda: sb.invert_rate_cuda(*flat, 42, _depth=d), 50)
    for n in (1, 17, 3 * 17):
        g, t = G.reshape(-1)[:n], tgt.reshape(-1)[:n]
        torch.testing.assert_close(
            ops.sroa_invert_rate(g, t, 1e6, 42),
            ref.invert_rate_plain(g, t, 1e6, 42), rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(
            ops.sroa_invert_rate_batched(g.reshape(1, n), t.reshape(1, n),
                                         bm[:1], 42),
            ref.invert_rate_plain(g.reshape(1, n), t.reshape(1, n),
                                  bm[:1, None], 42), rtol=1e-5, atol=1e-3)
    torch.cuda.synchronize()
    # K1 with one scalar cap (the TPU's `_bisect_kernel`) at one cell's
    # N_max users, timed apart: G and target in, the result out, one cap.
    g56, t56 = G.reshape(-1)[:56], tgt.reshape(-1)[:56]
    k1a = lambda: ops.sroa_invert_rate(g56, t56, 1e6, 42)  # noqa: E731
    k1a_bound = _bound_ms(12 * 56 + 4, 56 * 8 * 43)
    k1a_times = dict(k1a_ms=_time_ms(k1a, 50), k1a_device_ms=_device_ms(
        k1a, 50), k1a_plain_ms=_time_ms(
        lambda: ref.invert_rate_plain(g56, t56, 1e6, 42), 5),
        k1a_bound_ms=k1a_bound[0], k1a_bound_by=k1a_bound[1])
    n_el = G.numel()
    bound = _bound_ms(16 * n_el, n_el * 8 * 43)
    report["sroa_invert"] = dict(
        name="sroa_invert", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:84",
        max_abs_err=err, ms=_time_ms(k1, 50), plain_ms=_time_ms(k1p, 5),
        device_ms=_device_ms(k1, 50),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None,
        depth=k1_depth, depth_device_ms=k1_depth_ms, **k1a_times)
    r = report["sroa_invert"]
    print(f"[1] K1 ok at ({C}, {N}) per-element caps and n = 1, 17, 51: "
          f"max |err| {err:.3g} Hz; bitwise its twin at depths "
          f"{list(sb.DEPTHS)} x 42, {SERVE_CAPS['b_iters']}, 7 steps")
    print(f"[1] K1 at ({C}, {N}), 42 steps: {r['ms']:.4g} ms (device "
          f"{_fmt(r['device_ms'])}) at the picked depth {k1_depth}; device ms "
          f"by depth {json.dumps(k1_depth_ms)}")
    print(f"[1] K1 with a scalar cap (K1a) at n = 56: "
          f"{k1a_times['k1a_ms']:.4g} ms (device "
          f"{_fmt(k1a_times['k1a_device_ms'])}), plain "
          f"{k1a_times['k1a_plain_ms']:.4g} ms, bound {k1a_bound[0]:.3g} ms "
          f"by {k1a_bound[1]}")

    # ---- phase 2: K2 against its plain version on one engine round -----
    cands, valid = fengine._pruned_candidates(cells, init, mask, TOP_K)
    cs = expand_scenario(cells, 1)
    cc = sroa_constants(cs, cands, mask[:, None, :])
    A = cands.shape[1]
    P = C * A

    def flat_u(x):
        return torch.broadcast_to(x, (C, A, N)).reshape(P, N).contiguous()

    def flat_s(x):
        return torch.broadcast_to(x, (C, A)).reshape(P).contiguous()

    ones = torch.ones((), device=dev)
    per_user = [flat_u(x) for x in (cc.A, cc.J, cc.H, cc.delta, cc.h,
                                    cs.f_max, cs.p_max)]
    per_prob = [flat_s(x) for x in (cs.B_open, cs.B_open, cs.N0, ones,
                                    cc.E_cloud_total)]
    k2_kw = dict(SERVE_CAPS, eps0=1e-4, eps1=1e-4, eps2=1e-4, t_low=1.0,
                 t_up=3e7)               # sroa_solve_batched's defaults

    def on(route, pu, pp):
        """K2 on one kernel (and depth), past the routing rule."""
        return lambda: sb.solve_cuda(tuple(pu), tuple(pp), **k2_kw,
                                     _route=route)[0]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    # The re-price shape: one problem per cell (its nearest-edge pattern).
    rp_user = [x.contiguous() for x in (c0.A, c0.J, c0.H, c0.delta, c0.h,
                                        cells.f_max, cells.p_max)]
    rp_prob = [x.contiguous() for x in (cells.B_open, cells.B_open,
                                        cells.N0, ones.expand(C),
                                        c0.E_cloud_total)]
    shapes = {"plan": (per_user, per_prob), "reprice": (rp_user, rp_prob)}
    got, outs, t2 = {}, {}, {}
    for key, (pu, pp) in shapes.items():
        routed = lambda: ops.sroa_solve_batched(  # noqa: E731
            *pu, *pp, **SERVE_CAPS)
        got[key] = routed()
        outs[key] = on(("warp", 0), pu, pp)()
        route = sb.solve_route(pu[0].shape[0], N, sms)
        _check(route[0] == "lanes", f"K2 at {key} took {route}")
        _check(same(got[key], outs[key]), f"K2 at {key}: the routed call "
               f"{route} differs from PR 11's kernel")
        for d in sb.DEPTHS:
            _check(same(on(("lanes", d), pu, pp)(), outs[key]),
                   f"K2 at {key}: the lanes kernel at depth {d} differs "
                   f"from PR 11's kernel")
        # Times first: after the plain twin's 33 s of uninstrumented eager
        # kernels, a profiler session that holds only K2 records no device
        # activity (sessions of K1 still do), so K2's device times are
        # read before the twin runs.
        pr11 = on(("warp", 0), pu, pp)
        t2[key] = dict(
            route=route, ms=_time_ms(routed, 5), device_ms=_device_ms(
                routed, 3, kernel="sroa_solve"), pr11_ms=_time_ms(pr11, 5),
            pr11_device_ms=_device_ms(pr11, 3, kernel="sroa_solve"),
            depth_device_ms={d: _device_ms(on(("lanes", d), pu, pp), 3,
                                           kernel="sroa_solve")
                             for d in sb.DEPTHS})
    # Where the depth rule's crossover lies: the planning batch's first P
    # problems at every depth (2P warps, P / 264 warps a scheduler on 132
    # SMs), timed with the others before the twin runs.
    sweep = {}
    for n_prob in (256, 512, 768):
        pu, pp = ([x[:n_prob].contiguous() for x in xs]
                  for xs in (per_user, per_prob))
        sweep[n_prob] = {d: _device_ms(on(("lanes", d), pu, pp), 3,
                                       kernel="sroa_solve")
                         for d in sb.DEPTHS}
    # K2 at phase t's shapes (TSIA's P = 1, the host loop's P = 201).
    k2_tsia = _time_k2_tsia_shapes(_k2_tsia_shapes(dev))
    torch.cuda.synchronize()
    work, plain_ms = {}, {}
    for key, (pu, pp) in shapes.items():
        work[key] = {}
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = ref.sroa_solve_plain(*pu, *pp, **SERVE_CAPS, work=work[key])
        e1.record()
        e1.synchronize()
        plain_ms[key] = e0.elapsed_time(e1)
        _check(same(got[key], want), f"K2 at {key} differs from its twin")
        if key == "plan":
            _check(torch.equal(got[key][6], want[6]),
                   "K2 feasible flags differ")
            torch.testing.assert_close(got[key][4], want[4], rtol=1e-4,
                                       atol=0)
            torch.testing.assert_close(got[key][3], want[3], rtol=1e-4,
                                       atol=0)
            torch.testing.assert_close(got[key][0], want[0], rtol=1e-3,
                                       atol=1.0)
            err = _max_abs_err(got[key][4:5], want[4:5])
    for q in (0, P // 2 + 3, P - 1):
        alone = ops.sroa_solve_batched(*(x[q:q + 1] for x in per_user),
                                       *(x[q:q + 1] for x in per_prob),
                                       **SERVE_CAPS)
        for x, y in zip(got["plan"], alone):
            _check(torch.equal(x[q:q + 1], y), f"K2 problem {q} not bitwise")
    torch.cuda.synchronize()

    flops, bound = _k2_bound(work["plan"], P, N)
    rp_bound = _k2_bound(work["reprice"], C, N)[1]
    tp, tr = t2["plan"], t2["reprice"]
    reprice = dict(P=C, plain_ms=plain_ms["reprice"], bound_ms=rp_bound[0],
                   bound_by=rp_bound[1], work=work["reprice"])
    report["sroa_solve_lanes"] = dict(
        name="sroa_solve_lanes", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=err, ms=tp["ms"], plain_ms=plain_ms["plan"],
        device_ms=tp["device_ms"], bound_ms=bound[0], bound_by=bound[1],
        library_ms=None, depth=tp["route"][1],
        depth_device_ms=tp["depth_device_ms"],
        reprice=dict(reprice, ms=tr["ms"], device_ms=tr["device_ms"],
                     depth=tr["route"][1],
                     depth_device_ms=tr["depth_device_ms"]))
    # PR 11's kernel (K2's route for N > 512) on the same tensors.
    report["sroa_solve"] = dict(
        name="sroa_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=err, ms=tp["pr11_ms"], plain_ms=plain_ms["plan"],
        device_ms=tp["pr11_device_ms"], bound_ms=bound[0],
        bound_by=bound[1], library_ms=None,
        reprice=dict(reprice, ms=tr["pr11_ms"],
                     device_ms=tr["pr11_device_ms"]))
    worst = fengine.sroa_solve_flops(N, sroa.SroaConfig(**SERVE_CAPS)) * P
    print(f"[2] K2 ok on P = {C} x {A} = {P} problems, N = {N}: the lanes "
          f"kernel at depths {list(sb.DEPTHS)}, PR 11's kernel and the "
          f"twin bitwise equal (feasible {int(got['plan'][6].sum())}/{P}, "
          f"max |dR| {err:.3g}), 3 problems alone == in batch bitwise; this "
          f"data's work {work['plan']} = {flops:.4g} flop (cap model "
          f"{worst:.4g})")
    occ = {}
    for d in sb.DEPTHS:
        blocks = ctypes.c_int()
        build.check(build.load().sroa_solve_lanes_occupancy(
            d, N, ctypes.byref(blocks)), "sroa_solve_lanes_occupancy")
        occ[d] = blocks.value
    report["sroa_solve_lanes"]["blocks_per_sm"] = occ
    report["sroa_solve_lanes"]["depth_sweep_device_ms"] = sweep
    W = math.ceil(N / 32)
    print("[2] lanes kernel device ms by depth on the planning batch's "
          "first P problems: " + "; ".join(
              f"P = {n} ({n * W / (4 * sms):.3g} warps a scheduler) "
              f"{json.dumps(t)}" for n, t in sweep.items()))
    print(f"[2] lanes kernel at N = {N}: one problem a block of "
          f"{32 * math.ceil(N / 32)} threads; blocks an SM by depth "
          f"{json.dumps(occ)} ({sms} SMs)")
    for key, t in t2.items():
        n_prob = shapes[key][0][0].shape[0]
        pr11_dev, dev_ms = t["pr11_device_ms"], t["device_ms"]
        ratio = (f"{pr11_dev / dev_ms:.3g}x" if pr11_dev and dev_ms
                 else "not measured")
        print(f"[2] K2 at P = {n_prob}, N = {N} ({key}): lanes kernel depth "
              f"{t['route'][1]} {t['ms']:.4g} ms (device {dev_ms}); PR 11's "
              f"kernel {t['pr11_ms']:.4g} ms (device {pr11_dev}), {ratio} "
              f"the lanes kernel's device time; device ms by depth "
              f"{json.dumps(t['depth_device_ms'])}; bitwise equal to the "
              f"twin ({plain_ms[key]:.0f} ms)")

    # ---- phase 3: K3's two kernels against their plain version ---------
    _check_k3(report, dev, cells, init, mask, sms)

    # ---- phases 4 and 5: K4 and K5 against their plain versions --------
    _check_k4(report, dev)
    _check_k5(report, dev)
    if kernels_only:
        print(json.dumps({"kernels": list(report.values())}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 6: the planning path ------------------------------------
    cfg = sroa.SroaConfig(**SERVE_CAPS, fused=True)
    svc_cfg = ServiceConfig(top_k=TOP_K, max_rounds=12, escape_iters=2)
    ops.reset_launches()
    t0 = time.perf_counter()
    svc = PlanningService(fbatch.draw_fleet(0, 128, device=dev), lam=1.0,
                          sroa_cfg=cfg, cfg=svc_cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[6] bootstrap: sum R = {float(svc.R_ref.sum()):.6g} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    recs = []

    def on_tick(rec):
        recs.append(rec)
        print(f"[6] tick {rec.tick}: changed {rec.changed}, replanned "
              f"{rec.replanned.size}, served {rec.served}, sum R "
              f"{rec.sum_R:.6g}, {rec.tick_ms:.1f} ms")

    snap = run_load(svc, ticks=3, req_per_tick=2.0, seed=7,
                    on_tick=on_tick)
    torch.cuda.synchronize()
    main_counts = dict(ops.LAUNCHES)
    print(f"[6] telemetry: {json.dumps(snap)}")
    _check(len(recs) == 3 and snap["unserved"] == 0, "unserved requests")
    _check(all(math.isfinite(r.sum_R) for r in recs), "non-finite sum R")
    _check(np.isfinite(svc.alloc.R).all() and np.isfinite(svc.R_ref).all(),
           "non-finite R")
    _check(((svc.assigns >= 0) & (svc.assigns < M)).all(),
           "assignment off the edge range")

    # ---- phase 7: the use_pallas route (K1 inside the eager nest) ------
    assigns = torch.as_tensor(svc.assigns, device=dev)
    pal = sroa.SroaConfig(**SERVE_CAPS, use_pallas=True)
    ops.reset_launches()
    got = fbatch.solve_batch(svc.fleet, assigns, 1.0, pal)
    torch.cuda.synchronize()
    invert_count = ops.LAUNCHES["sroa_invert"]
    want = fbatch.solve_batch(svc.fleet, assigns, 1.0,
                              sroa.SroaConfig(**SERVE_CAPS))
    torch.testing.assert_close(got.R, want.R, rtol=1e-5, atol=0)
    torch.testing.assert_close(got.R.cpu(), torch.as_tensor(svc.alloc.R),
                               rtol=5e-3, atol=0)
    print(f"[7] use_pallas solve_batch ok: {invert_count} K1 launches; R "
          f"== eager nest (rtol 1e-5), == fused re-price (rtol 5e-3)")

    _profile("[p]", "2 traced ticks",
             lambda: [svc.tick() for _ in range(2)])
    del svc

    # ---- phase 8: the LM serving path ----------------------------------
    lm = _lm_path(dev)

    # ---- phase t: TSIA, the baselines and the per-cell planner ---------
    tp = _tsia_path(dev, report, k2_tsia)

    # ---- phase 9: launch counts and times ------------------------------
    # Four kernels lie on no path: K5 (no model calls it), K4's SIMT
    # kernel (the route for f32 and hd > 128; the LM path is bf16, hd 64)
    # and the one-warp-per-problem K2 and the block K3 kernels (the
    # routes for N > 512 and for N*M > 512; the fleet's cells are 56 x 5).
    # Their counts are those of their path's run, 0, and are not held to
    # be positive.  ``flash_attention``, ``sroa_solve`` and ``topk_moves``
    # count every K4, K2 and K3 launch, so those three kernels' launches
    # are the ones that did not take the other kernel.
    lmc = lm["counts"]
    counts = {"sroa_invert": invert_count,
              "sroa_solve_lanes": main_counts["sroa_solve_lanes"],
              "sroa_solve": (main_counts["sroa_solve"]
                             - main_counts["sroa_solve_lanes"]),
              "topk_moves_warp": main_counts["topk_moves_warp"],
              "topk_moves": (main_counts["topk_moves"]
                             - main_counts["topk_moves_warp"]),
              "flash_attention_sm90": lmc["flash_attention_sm90"],
              "flash_attention": (lmc["flash_attention"]
                                  - lmc["flash_attention_sm90"]),
              "rmsnorm": lmc["rmsnorm"]}
    print(f"[9] kernels: {json.dumps(counts)} (ops.LAUNCHES of the LM run: "
          f"{json.dumps(lmc)})")
    _check(main_counts["topk_moves_warp"] == main_counts["topk_moves"] > 0,
           f"{main_counts['topk_moves'] - main_counts['topk_moves_warp']} "
           f"of the planning path's {main_counts['topk_moves']} K3 launches "
           f"took the block kernel")
    tpc = tp["counts"]
    tsia_counts = {"sroa_invert": tpc["sroa_invert"],
                   "sroa_solve_lanes": tpc["sroa_solve_lanes"],
                   "sroa_solve": tpc["sroa_solve"] - tpc["sroa_solve_lanes"],
                   "topk_moves_warp": tpc["topk_moves_warp"],
                   "topk_moves": (tpc["topk_moves"]
                                  - tpc["topk_moves_warp"]),
                   "flash_attention_sm90": tpc["flash_attention_sm90"],
                   "flash_attention": (tpc["flash_attention"]
                                       - tpc["flash_attention_sm90"]),
                   "rmsnorm": tpc["rmsnorm"]}
    print(f"[9] kernels on phase t's path (TSIA, baselines, per-cell "
          f"planner): {json.dumps(tsia_counts)}")
    for name in ("sroa_invert", "sroa_solve_lanes", "topk_moves_warp"):
        _check(tsia_counts[name] > 0, f"{name} never launched on phase "
               f"t's path")
    for name, n in counts.items():
        _check(n > 0 or name in ("rmsnorm", "flash_attention",
                                 "sroa_solve", "topk_moves"),
               f"{name} never launched on its path")
        report[name]["launches"] = n
        report[name]["launches_tsia_path"] = tsia_counts[name]
        r = report[name]
        lib = (f", library {r['library_ms']:.4g} ms"
               if r["library_ms"] is not None else "")
        dev_ms = _fmt(r["device_ms"]) + " ms" * (r["device_ms"] is not None)
        print(f"[9] {name}: {r['ms']:.4g} ms (device {dev_ms}, "
              f"plain {r['plain_ms']:.4g} ms, "
              f"bound {r['bound_ms']:.3g} ms by {r['bound_by']}{lib})")
    rounds = main_counts["sroa_solve"]
    ts, k2t = tp["tsia"], tp["k2"]
    print(f"[9] TSIA path: {ts['scores']} scores at "
          f"{ts['ms_per_score']:.4g} ms a score; K2 at P = 1 (full caps) "
          f"{_fmt(k2t['tsia_p1']['device_ms'])} ms device, at P = "
          f"{k2t['host_loop_p201']['P']} (serve caps) "
          f"{_fmt(k2t['host_loop_p201']['device_ms'])} ms; --no-stream "
          + "; ".join(f"{r['ms']:.1f} ms, {r['plans_per_s']:.4g} plans/s"
                      for r in tp["serve"]["no_stream"]["rounds"]))
    print(f"[9] planning path: {snap['plans_per_s']:.4g} plans/s, tick p50 "
          f"{snap['tick_ms']['p50']:.4g} ms; {rounds} K2 launches "
          f"({main_counts['sroa_solve_lanes']} on the lanes kernel) and "
          f"{main_counts['topk_moves']} K3 launches "
          f"({main_counts['topk_moves_warp']} on the warp kernel)")
    fl = lm["flash"]
    L = lm["n_layers"]
    k4_dev = report["flash_attention_sm90"]["device_ms"]
    k4_share = _div(None if k4_dev is None else L * k4_dev,
                    fl["prefill_s"] * 1e3)
    print(f"[9] LM path: prefill {fl['prefill_s'] * 1e3:.3f} ms, decode "
          f"{fl['tok_per_s']:.1f} tok/s on K4; "
          f"{counts['flash_attention_sm90']} K4 launches on the tensor "
          f"cores; {L} x K4's phase-4 device time is "
          f"{_fmt(k4_share, '.4f')} of the prefill's wall time")
    print(json.dumps({"kernels": [report[k] for k in counts]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
