#!/usr/bin/env python3
"""Time K4's kernels at the operands each owns, beside SDPA and the bound.

    python3 tools/k4_routes.py [--routes simt,tf32,wgmma] [--reps N]

For each shape of ``SHAPES`` (causal self-attention in the model layout
(B, T, H, hd)), every listed route that takes the operands (the SIMT kernel
takes all of them; ``tf32`` and ``wgmma`` only where
``flash_attention.route`` sends them) is held to the plain twin (2e-5 in
f32, 2e-2 in bf16) and timed: median CUDA-event ms of one call and the
device ms of ``chip_smoke._queued_ms``.  Beside them: the bound of
``chip_smoke._k4_bound`` and ``scaled_dot_product_attention`` as PyTorch
picks its backend and with each backend forced.  The card's name and power
limit come first; one JSON line a shape follows.  Runs on a card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (dtype, B, T, H, hd): qwen1.5-0.5b's prefill in f32, llama3.2-3b's
# heads in f32, and 256- and 192-wide heads in bf16 at the same tokens.
SHAPES = (("float32", 4, 1024, 16, 64), ("float32", 1, 1024, 24, 128),
          ("bfloat16", 4, 1024, 8, 256), ("bfloat16", 4, 1024, 8, 192))


def main(argv: list[str]) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import argparse

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    ap = argparse.ArgumentParser()
    ap.add_argument("--routes", default="simt,tf32,wgmma")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_routes: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.load(verbose=True)
    for line in cs._ptxas(build.build_log):
        if "flash" in line:
            print("ptxas:", line, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    routes = args.routes.split(",")
    for dtype_name, B, T, H, hd in SHAPES:
        dt = getattr(torch, dtype_name)
        q, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev
                               ).to(dt) for _ in range(3))
        want = cs._attn_plain(q, k, v, causal=True).float()
        tol = 2e-2 if dt == torch.bfloat16 else 2e-5
        ms, bound_by, nbytes, flops = cs._k4_bound(B, H, T, hd, dt)
        row = dict(dtype=dtype_name, shape=[B, T, H, hd], bound_ms=ms,
                   bound_by=bound_by, bytes=nbytes, flop=flops, routes={})
        for r in routes:
            if r not in ("simt", cs._k4_route_of(dt, hd)):
                continue

            def call(r=r):
                return fa.flash_attention_cuda(
                    q, k, v, causal=True, q_offset=0, window=None,
                    _route=r)[0]

            got = call().float()
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
            row["routes"][r] = dict(
                max_abs_err=float((got - want).abs().max()),
                ms=cs._time_ms(call, args.reps),
                device_ms=cs._queued_ms(call, args.reps))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["sdpa"] = cs._sdpa_times(qt, kt, vt, True, args.reps)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
