"""Serving entry point: the streaming fleet planning endpoint.

``--mode plan`` serves the fleet planning endpoint as a streaming control
plane (:mod:`repro_torch.fleet.service`): each tick advances mobility,
fading and churn for the whole fleet, re-prices every cached plan, re-
searches only the cells past the drift threshold, and answers the tick's
coalesced Poisson request load:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode plan \
      --cells 8 --rounds 3 --device cuda

The flags are the JAX entry point's; ``--device`` picks the card (default
``cuda``) or the CPU.  SROA runs fused, one launch of kernel K2 per batch.
``--mode lm`` and the planning extensions that are
not ported yet (``--no-stream``, ``--host-loop``, ``--horizon``,
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
                    help="torch device to plan on (default cuda; cpu runs "
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
        raise SystemExit("repro_torch: --mode lm (LM serving) is not ported "
                         "yet; use python -m repro.launch.serve --mode lm")
    defaults = ap.parse_args(["--mode", "plan"])
    for name, what in _NOT_PORTED.items():
        if getattr(args, name) != getattr(defaults, name):
            raise SystemExit(f"repro_torch: {what} is not ported yet")
    return run_service(args)


if __name__ == "__main__":
    main()
