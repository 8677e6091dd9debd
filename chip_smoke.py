#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's planning path on one NVIDIA card.

    python3 chip_smoke.py             # every phase (one card)
    python3 chip_smoke.py --kernels   # build and check the kernels only

Phases, each reported on its own lines:

0. The card (``nvidia-smi``) and the build of ``src/repro_torch/kernels/
   csrc/*.cu`` with nvcc (one process per source, all at once).
1. K1 (Lemma-1 inversion) against its plain PyTorch version at the fleet's
   flattened shape and at odd shapes: rtol 1e-5, atol 1e-3.
2. K2 (the fused Algorithm 2-4 solve) against its plain version on one
   engine round of the README fleet (128 cells x 9 candidates, N_max
   users): feasible identical, R and t to rtol 1e-4, b to rtol 1e-3 with
   atol 1 Hz (room for a last-bit difference of a library function, which
   can flip a bisection step; the plain version adds in the kernel's warp
   order); a problem solved alone equals the same problem inside the batch
   bitwise.  K2 is also timed at the re-price shape (one problem per cell).
3. K3 (top-k move nomination) against its plain version at
   (128, N_max, 5), k = 8: indices exact, scores to rtol 1e-5.
4. The main path: ``PlanningService`` over ``draw_fleet(0, 128)`` with the
   fused solve and top-8 move pruning, driven by ``run_load`` for 3 ticks.
5. The ``use_pallas`` route: ``solve_batch`` with the inversion on K1,
   against the same call on the eager inversion (rtol 1e-5 on R) and
   against phase 4's fused re-price (rtol 5e-3).
6. Launch counts of the main paths (every count reset to 0 right before
   a path and read right after it), each kernel's time beside its plain
   version's and its bound, then the card and the result line.

Between phases 5 and 6, two more ticks of phase 4's service run under
``torch.profiler`` (lines ``[p]``): device time by kernel, and the
device's busy share of the traced wall time.  They run after every path's
launch counts have been read.

Every comparison raises on a mismatch; no phase catches a failure.  The
script exits non-zero, printing no result, when there is no CUDA device or
when it is not run from a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet), for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SERVE_CAPS = dict(b_iters=30, f_iters=24, p_iters=20, t_iters=28)
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


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _max_abs_err(got, want) -> float:
    import torch

    errs = [float((g.double() - w.double()).abs().max())
            for g, w in zip(got, want) if g.dtype.is_floating_point]
    return max(errs) if errs else 0.0


def _profile_ticks(svc, ticks: int) -> None:
    """Trace ``ticks`` service ticks with ``torch.profiler``; print device
    time by kernel and the device's busy share of the traced wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            svc.tick()
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
    print(f"[p] {ticks} traced ticks: {wall_ms:.2f} ms wall, {busy_ms:.2f} "
          f"ms device time in {sum(r[1] for r in rows)} device events "
          f"({len(rows)} names); busy share "
          f"{busy_ms / wall_ms if rows else float('nan'):.4f}")
    for ms, n, name in rows[:12]:
        print(f"[p]   {ms:10.3f} ms  {n:6d} x  {name[:90]}")
    if not rows:
        print("[p]   the trace holds no device time: not measured")


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
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[0]   ptxas: {line.strip()}")

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
    err = _max_abs_err([got], [want])
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
    n_el = G.numel()
    bound = _bound_ms(16 * n_el, n_el * 8 * 43)
    report["sroa_invert"] = dict(
        name="sroa_invert", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:84",
        max_abs_err=err, ms=_time_ms(k1, 50), plain_ms=_time_ms(k1p, 5),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None)
    print(f"[1] K1 ok at ({C}, {N}) per-element caps and n = 1, 17, 51: "
          f"max |err| {err:.3g} Hz")

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
    k2 = lambda: ops.sroa_solve_batched(*per_user, *per_prob,  # noqa: E731
                                        **SERVE_CAPS)
    got = k2()
    work = {}
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    want = ref.sroa_solve_plain(*per_user, *per_prob, **SERVE_CAPS,
                                work=work)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    _check(torch.equal(got[6], want[6]), "K2 feasible flags differ")
    torch.testing.assert_close(got[4], want[4], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0], want[0], rtol=1e-3, atol=1.0)
    err = _max_abs_err(got[4:5], want[4:5])
    for q in (0, P // 2 + 3, P - 1):
        alone = ops.sroa_solve_batched(*(x[q:q + 1] for x in per_user),
                                       *(x[q:q + 1] for x in per_prob),
                                       **SERVE_CAPS)
        for x, y in zip(got, alone):
            _check(torch.equal(x[q:q + 1], y), f"K2 problem {q} not bitwise")
    torch.cuda.synchronize()
    flops = N * (8 * SERVE_CAPS["b_iters"] * work["inversions"]
                 + 12 * work["f_steps"] + 8 * work["p_steps"]
                 + 20 * work["t_steps"] + 10 * SERVE_CAPS["t_iters"] * P)
    nbytes = P * N * 4 * (7 + 3) + P * 4 * (5 + 3) + P
    bound = _bound_ms(nbytes, flops)
    report["sroa_solve"] = dict(
        name="sroa_solve", route="cuda",
        source="src/repro_torch/kernels/csrc/sroa_bisect.cu",
        replaces="src/repro/kernels/sroa_bisect.py:167",
        max_abs_err=err, ms=_time_ms(k2, 5), plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1], library_ms=None)
    worst = fengine.sroa_solve_flops(N, sroa.SroaConfig(**SERVE_CAPS)) * P
    # The re-price shape: one problem per cell (its nearest-edge pattern).
    rp_user = [x.contiguous() for x in (c0.A, c0.J, c0.H, c0.delta, c0.h,
                                        cells.f_max, cells.p_max)]
    rp_prob = [x.contiguous() for x in (cells.B_open, cells.B_open,
                                        cells.N0, ones.expand(C),
                                        c0.E_cloud_total)]
    reprice_ms = _time_ms(lambda: ops.sroa_solve_batched(
        *rp_user, *rp_prob, **SERVE_CAPS), 5)
    print(f"[2] K2 ok on P = {C} x {A} = {P} problems, N = {N}: feasible "
          f"identical ({int(got[6].sum())}/{P}), max |dR| {err:.3g}, 3 "
          f"problems alone == in batch bitwise; this data's work "
          f"{work} = {flops:.4g} flop (cap model {worst:.4g})")
    print(f"[2] K2 at the re-price shape P = {C}, N = {N}: {reprice_ms:.4g} "
          f"ms (median of 5)")

    # ---- phase 3: K3 against its plain version -------------------------
    H_move = fengine._move_H(cells)
    targs = [cells.gain.contiguous(), H_move.contiguous(),
             cells.p_max.contiguous(), init.contiguous(), mask.contiguous(),
             cells.N0.contiguous(), cells.B_open.contiguous()]
    k3 = lambda: ops.topk_move_scores(*targs, k=TOP_K)  # noqa: E731
    k3p = lambda: ref.topk_moves_plain(*targs, k=TOP_K)  # noqa: E731
    got, want = k3(), k3p()
    _check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
           "K3 nominated other moves")
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    err = _max_abs_err(got[2:], want[2:])
    nbytes = C * N * M * 4 + C * N * (4 + 4 + 4 + 1) + C * 8 + C * TOP_K * 12
    bound = _bound_ms(nbytes, C * (12 + TOP_K) * N * M)
    report["topk_moves"] = dict(
        name="topk_moves", route="cuda",
        source="src/repro_torch/kernels/csrc/topk_moves.cu",
        replaces="src/repro/kernels/topk_moves.py:41",
        max_abs_err=err, ms=_time_ms(k3, 50), plain_ms=_time_ms(k3p, 5),
        bound_ms=bound[0], bound_by=bound[1], library_ms=None)
    print(f"[3] K3 ok at ({C}, {N}, {M}), k = {TOP_K}: indices identical, "
          f"max |score err| {err:.3g}")
    if kernels_only:
        print(json.dumps({"kernels": list(report.values())}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- phase 4: the main path ----------------------------------------
    cfg = sroa.SroaConfig(**SERVE_CAPS, fused=True)
    svc_cfg = ServiceConfig(top_k=TOP_K, max_rounds=12, escape_iters=2)
    ops.reset_launches()
    t0 = time.perf_counter()
    svc = PlanningService(fbatch.draw_fleet(0, 128, device=dev), lam=1.0,
                          sroa_cfg=cfg, cfg=svc_cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[4] bootstrap: sum R = {float(svc.R_ref.sum()):.6g} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    recs = []

    def on_tick(rec):
        recs.append(rec)
        print(f"[4] tick {rec.tick}: changed {rec.changed}, replanned "
              f"{rec.replanned.size}, served {rec.served}, sum R "
              f"{rec.sum_R:.6g}, {rec.tick_ms:.1f} ms")

    snap = run_load(svc, ticks=3, req_per_tick=2.0, seed=7,
                    on_tick=on_tick)
    torch.cuda.synchronize()
    main_counts = dict(ops.LAUNCHES)
    print(f"[4] telemetry: {json.dumps(snap)}")
    _check(len(recs) == 3 and snap["unserved"] == 0, "unserved requests")
    _check(all(math.isfinite(r.sum_R) for r in recs), "non-finite sum R")
    _check(np.isfinite(svc.alloc.R).all() and np.isfinite(svc.R_ref).all(),
           "non-finite R")
    _check(((svc.assigns >= 0) & (svc.assigns < M)).all(),
           "assignment off the edge range")

    # ---- phase 5: the use_pallas route (K1 inside the eager nest) ------
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
    print(f"[5] use_pallas solve_batch ok: {invert_count} K1 launches; R "
          f"== eager nest (rtol 1e-5), == fused re-price (rtol 5e-3)")

    _profile_ticks(svc, 2)

    # ---- phase 6: launch counts and times ------------------------------
    counts = {"sroa_invert": invert_count,
              "sroa_solve": main_counts["sroa_solve"],
              "topk_moves": main_counts["topk_moves"]}
    print(f"[6] kernels: {json.dumps(counts)}")
    for name, n in counts.items():
        _check(n > 0, f"{name} never launched on its path")
        report[name]["launches"] = n
        r = report[name]
        print(f"[6] {name}: {r['ms']:.4g} ms (plain {r['plain_ms']:.4g} ms, "
              f"bound {r['bound_ms']:.3g} ms by {r['bound_by']})")
    rounds = main_counts["sroa_solve"]
    print(f"[6] main path: {snap['plans_per_s']:.4g} plans/s, tick p50 "
          f"{snap['tick_ms']['p50']:.4g} ms; {rounds} K2 and "
          f"{main_counts['topk_moves']} K3 launches")
    print(json.dumps({"kernels": [report[k] for k in
                                  ("sroa_invert", "sroa_solve",
                                   "topk_moves")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
