"""Serving entry points: LM decode and the streaming fleet planning
endpoint.

``--mode lm`` (default) prefills a batch of prompts and decodes greedily
with the ring-buffer KV cache, for the dense family; a reduced config
unless ``--full-size``:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch qwen1.5-0.5b --batch 4 --prompt-len 32 --new-tokens 16

``--mode plan`` serves the fleet planning endpoint as a streaming control
plane (:mod:`repro_torch.fleet.service`): each tick advances mobility,
fading and churn for the whole fleet, re-prices every cached plan, re-
searches only the cells past the drift threshold, and answers the tick's
coalesced Poisson request load:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode plan \
      --cells 8 --rounds 3 --device cuda

The flags are the JAX entry point's; ``--device`` picks the card (default
``cuda``) or the CPU.  SROA runs fused, one launch of kernel K2 per batch.
The LM path attends with ``ArchConfig.attn_impl`` (``"chunked"``; a caller
of :func:`run_lm` picks K4 with ``"pallas"``).  The planning extensions
that are not ported yet (``--no-stream``, ``--host-loop``, ``--horizon``,
``--switch-cost``, ``--compression``, ``--topology-period``, ``--m-cand``)
exit with a message.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def _parse_tiers(s: str) -> tuple:
    """``--tiers`` grammar: comma-separated
    ``name[:cycle_mult[:size_mult[:f_scale[:prob]]]]`` rungs."""
    from repro_torch.core.wireless import DeviceTier

    tiers = []
    for part in s.split(","):
        fields = part.strip().split(":")
        vals = [float(x) for x in fields[1:]]
        kw = dict(zip(("cycle_mult", "size_mult", "f_scale", "prob"), vals))
        tiers.append(DeviceTier(fields[0], **kw))
    return tuple(tiers)


def _draw_serve_fleet(args):
    from repro_torch.core import sroa
    from repro_torch.core.wireless import ScenarioSpec
    from repro_torch.fleet import draw_fleet

    spec = dataclasses.replace(ScenarioSpec(), N=args.cell_users,
                               M=args.cell_edges,
                               tiers=_parse_tiers(args.tiers)
                               if args.tiers else ())
    n_lo = min(max(4, args.cell_users // 2), args.cell_users)
    fleet = draw_fleet(args.seed, args.cells, spec,
                       n_range=(n_lo, args.cell_users), device=args.device)
    cfg = sroa.SroaConfig(b_iters=30, f_iters=24, p_iters=20, t_iters=28,
                          fused=True)
    return spec, fleet, cfg


def run_service(args) -> dict:
    """The streaming ``--mode plan`` service loop."""
    from repro_torch.fleet.service import (DriftConfig, PlanningService,
                                           ServiceConfig, run_load)

    spec, fleet, cfg = _draw_serve_fleet(args)
    svc_cfg = ServiceConfig(
        drift=DriftConfig(channel_threshold=args.drift_threshold,
                          objective_threshold=args.obj_threshold),
        event_rate=args.event_rate, replan_all=args.replan_all,
        max_rounds=args.plan_rounds, escape_iters=2,
        top_k=args.top_k, n_starts=args.n_starts)
    mode = "replan-all" if args.replan_all else "drift-gated"
    if args.tiers:
        mode += f", {len(spec.tiers)} device tiers"
    print(f"[serve] fleet: {fleet.C} cells, N_max={fleet.N_max}, "
          f"M={fleet.M} (streaming control plane, {mode}, "
          f"device={args.device})")
    t0 = time.time()
    svc = PlanningService(fleet, lam=args.lam, sroa_cfg=cfg, cfg=svc_cfg,
                          spec=spec, seed=args.seed, device=args.device)
    print(f"[serve] bootstrap: sum R={float(svc.R_ref.sum()):.1f} "
          f"in {time.time() - t0:.2f}s")

    def on_tick(rec):
        print(f"[serve] tick {rec.tick}: {rec.changed} changed, "
              f"{rec.replanned.size} replanned, {rec.served} served "
              f"(coalesced {rec.coalesced}), sum R={rec.sum_R:.1f}, "
              f"{rec.tick_ms:.0f}ms")

    snap = run_load(svc, ticks=args.rounds, req_per_tick=args.req_rate,
                    seed=args.seed + 7, on_tick=on_tick)
    print(f"[serve] telemetry: {json.dumps(snap)}")
    return {"sum_R": snap["objective_sum"] / max(snap["ticks"], 1),
            "stats": snap}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_lm(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int,
           device="cuda") -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``new_tokens`` greedy tokens with the ring-buffer KV cache (prefill
    without ``pad_to``, as the JAX entry point does).

    Weights and prompts come from one ``torch.Generator`` seeded with
    ``seed`` on ``device``.  Returns the timings (host clock around
    synchronised work), the prefill's last-position logits (B, V) and the
    generated tokens (B, 1 + new_tokens) as numpy.
    """
    import torch

    from repro_torch.models import transformer as tf

    print(f"[serve] arch={cfg.name} family={cfg.family} "
          f"layers={cfg.n_layers} d={cfg.d_model} attn={cfg.attn_impl} "
          f"dtype={str(cfg.dtype).replace('torch.', '')} device={device}")
    gen = torch.Generator(device=device).manual_seed(seed)
    B, T = batch, prompt_len
    with torch.inference_mode():
        params = tf.init_params(cfg, gen, device)
        prompts = torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                device=device)
        prefill = tf.make_prefill_step(cfg)
        serve = tf.make_serve_step(cfg)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        _sync(device)
        t_prefill = time.perf_counter() - t0
        print(f"[prefill] {B}x{T} tokens in {t_prefill * 1e3:.2f} ms")

        tok = torch.argmax(logits[:, -1], -1)[:, None]
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            step_logits, cache = serve(params, cache, tok)
            tok = torch.argmax(step_logits[:, -1], -1)[:, None]
            out_tokens.append(tok)
        _sync(device)
        dt = time.perf_counter() - t0
    tps = new_tokens * B / dt if dt > 0 else float("nan")
    gen_tokens = torch.cat(out_tokens, 1).cpu().numpy()
    print(f"[decode] {new_tokens} steps x batch {B} in {dt:.3f} s "
          f"-> {tps:.1f} tok/s")
    print(f"[sample] first sequence: {gen_tokens[0][:16].tolist()}")
    return {"tok_per_s": tps, "prefill_s": t_prefill, "decode_s": dt,
            "logits": logits[:, -1], "tokens": gen_tokens}


_NOT_PORTED = {
    "no_stream": "--no-stream (the per-cell request loop needs "
                 "fleet/incremental)",
    "host_loop": "--host-loop (fleet/incremental)",
    "horizon": "--horizon (rolling-horizon planning, DESIGN.md D10)",
    "switch_cost": "--switch-cost (rolling-horizon planning, D10)",
    "compression": "--compression (compression ladders, D11)",
    "topology_period": "--topology-period (topology design, D12)",
    "m_cand": "--m-cand (topology design, D12)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--mode", default="lm", choices=("lm", "plan"))
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain PyTorch versions)")
    # planning endpoint knobs (the JAX entry point's)
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cell-users", type=int, default=12)
    ap.add_argument("--cell-edges", type=int, default=3)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="engine move pruning: score only the k "
                         "kernel-nominated moves per round (0 = full "
                         "neighbourhood)")
    ap.add_argument("--n-starts", type=int, default=1,
                    help="engine restarts per search (<= 2)")
    ap.add_argument("--horizon", type=int, default=1)
    ap.add_argument("--switch-cost", type=float, default=0.0)
    ap.add_argument("--topology-period", type=int, default=0)
    ap.add_argument("--edge-cost", type=float, default=0.0)
    ap.add_argument("--m-cand", type=int, default=0)
    ap.add_argument("--tiers", default="",
                    help="device tiers, comma-separated "
                         "name[:cycle_mult[:size_mult[:f_scale[:prob]]]]")
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--topk-frac", type=float, default=0.05)
    ap.add_argument("--plan-rounds", type=int, default=12,
                    help="engine iteration budget per search")
    ap.add_argument("--event-rate", type=float, default=0.4,
                    help="per-round probability a cell sees dynamics")
    ap.add_argument("--host-loop", action="store_true")
    ap.add_argument("--no-stream", action="store_true")
    ap.add_argument("--replan-all", action="store_true",
                    help="disable drift gating (re-search every cell every "
                         "tick)")
    ap.add_argument("--drift-threshold", type=float, default=0.25)
    ap.add_argument("--obj-threshold", type=float, default=0.02)
    ap.add_argument("--req-rate", type=float, default=2.0,
                    help="Poisson plan requests per tick")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode == "lm":
        from repro_torch import configs

        if args.arch not in configs.ARCHS:
            raise SystemExit(f"unknown arch {args.arch!r}")
        cfg = configs.get(args.arch)
        if not cfg.has_decode:
            raise SystemExit(f"{args.arch} is encoder-only (no decode)")
        if not args.full_size:
            cfg = cfg.reduced()
        return run_lm(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      new_tokens=args.new_tokens, seed=args.seed,
                      device=args.device)
    defaults = ap.parse_args(["--mode", "plan"])
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) != getattr(defaults, name):
            raise SystemExit(f"repro_torch: {what} is not ported yet")
    return run_service(args)


if __name__ == "__main__":
    main()
