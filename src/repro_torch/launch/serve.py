"""Serving entry points: LM decode and the streaming fleet planning
endpoint.

``--mode lm`` (default) prefills a batch of prompts and decodes greedily
from the decode cache, for the dense and moe families (the moe family:
llama4-scout-17b-a16e and kimi-k2-1t-a32b, top-k routed experts with
capacity dispatch and a shared expert; a ring-buffer KV cache) and the
hybrid and xlstm families (zamba2-7b: Mamba2 layers and a shared
sliding-window attention block; xlstm-125m: mLSTM/sLSTM pairs; recurrent
states, and the shared block's ring buffer) and the dense family's
``mixed`` frontend (internvl2-76b: the run draws patch embeddings and
prefills them before the prompt's tokens); a reduced config unless
``--full-size``.  The encoder (hubert-xlarge) has no decode and is
refused; drive it through ``models.transformer.forward``:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch llama4-scout-17b-a16e --batch 4 --prompt-len 32 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
      --arch zamba2-7b --batch 2 --prompt-len 16 --new-tokens 4 --device cpu

``--mode plan`` serves the fleet planning endpoint as a streaming control
plane (:mod:`repro_torch.fleet.service`): each tick advances mobility,
fading and churn for the whole fleet, re-prices every cached plan, re-
searches only the cells past the drift threshold, and answers the tick's
coalesced Poisson request load:

  PYTHONPATH=src python -m repro_torch.launch.serve --mode plan \
      --cells 8 --rounds 3 --device cuda

``--no-stream`` serves the per-cell request loop instead (warm-started
``FleetPlanner.plan`` calls, :func:`run_planner`); ``--host-loop`` plans
through the host-driven batched-TSIA loop rather than the engine (and
implies ``--no-stream``).

The planner's extended decision space takes the JAX entry point's flags:
``--n-starts`` restarts, ``--horizon K --switch-cost c`` (rolling-horizon
planning), ``--compression [--topk-frac f]`` (per-user compression
ladders, usually with ``--tiers``) and ``--m-cand M --topology-period P
--edge-cost e`` (M candidate sites a cell, ``--cell-edges`` of them open,
redesigned every P ticks):

  PYTHONPATH=src python -m repro_torch.launch.serve --mode plan \
      --cells 8 --rounds 4 --horizon 4 --switch-cost 100 --device cuda

``--device`` picks the card (default ``cuda``) or the CPU.  SROA runs
fused at the caps 30/24/20/28, one launch of kernel K2 per batch, where the
JAX entry point runs the jnp nest at the same caps.  The LM path attends
with ``ArchConfig.attn_impl`` (``"chunked"``; a caller of :func:`run_lm`
picks K4 with ``"pallas"``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def plan_request(planner, scn, warm_assign=None, new_users=None,
                 mask=None) -> dict:
    """One planning request -> JSON-able response (the endpoint contract)."""
    plan = planner.plan(scn, warm_assign=warm_assign, new_users=new_users,
                        mask=mask)
    return {
        "assign": plan.assign.tolist(),
        "b_hz": plan.b.tolist(),
        "f_hz": plan.f.tolist(),
        "p_w": plan.p.tolist(),
        "objective": plan.R,
        "deadline_s": plan.t,
        "cached": plan.cached,
        "solve_calls": plan.solve_calls,
        "plan_ms": plan.plan_ms,
    }


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


def _serve_ladder(args):
    if not args.compression:
        return None
    from repro_torch.fed.compression import default_ladder
    return default_ladder(args.topk_frac)


def _draw_serve_fleet(args, fleet=None):
    """(spec, fleet, SROA config) of ``--mode plan``; a given ``fleet`` (of
    the flags' edge count) replaces the draw."""
    from repro_torch.core import sroa
    from repro_torch.core.wireless import ScenarioSpec
    from repro_torch.fleet import draw_fleet

    # Topology mode (D12): draw M_cand candidate sites a cell but open only
    # --cell-edges of them; the service's periodic redesign decides which
    # (and how many) stay open.
    m_cand = max(args.m_cand, args.cell_edges)
    spec = dataclasses.replace(ScenarioSpec(), N=args.cell_users,
                               M=m_cand,
                               tiers=_parse_tiers(args.tiers)
                               if args.tiers else ())
    n_lo = min(max(4, args.cell_users // 2), args.cell_users)
    if fleet is None:
        fleet = draw_fleet(args.seed, args.cells, spec,
                           n_range=(n_lo, args.cell_users),
                           device=args.device)
    if m_cand > args.cell_edges or args.topology_period:
        from repro_torch.fleet import topology as ftopo
        fleet = ftopo.with_edge_mask(
            fleet, ftopo.uniform_mask(fleet.C, m_cand, args.cell_edges))
    cfg = sroa.SroaConfig(b_iters=30, f_iters=24, p_iters=20, t_iters=28,
                          fused=True)
    return spec, fleet, cfg


def build_service(args, fleet=None):
    """The ``--mode plan`` service as the CLI builds it: (spec, service).
    ``fleet`` serves a given fleet instead of the flags' draw."""
    from repro_torch.fleet.service import (DriftConfig, PlanningService,
                                           ServiceConfig)

    spec, fleet, cfg = _draw_serve_fleet(args, fleet)
    ladder = _serve_ladder(args)
    topo = None
    if args.topology_period:
        from repro_torch.fleet.topology import TopologyConfig
        topo = TopologyConfig(edge_cost=args.edge_cost)
    svc_cfg = ServiceConfig(
        drift=DriftConfig(channel_threshold=args.drift_threshold,
                          objective_threshold=args.obj_threshold),
        event_rate=args.event_rate, replan_all=args.replan_all,
        max_rounds=args.plan_rounds, escape_iters=2,
        top_k=args.top_k, n_starts=args.n_starts,
        horizon=args.horizon, switch_cost=args.switch_cost,
        ladder=ladder, topology_period=args.topology_period,
        topology=topo)
    mode = "replan-all" if args.replan_all else "drift-gated"
    if args.horizon > 1 or args.switch_cost:
        mode += (f", horizon K={args.horizon}"
                 f" switch_cost={args.switch_cost:g}")
    if args.tiers:
        mode += f", {len(spec.tiers)} device tiers"
    if ladder is not None:
        mode += f", compression ladder ({len(ladder)} rungs)"
    if args.topology_period:
        mode += (f", topology redesign every {args.topology_period} ticks "
                 f"(M_cand={fleet.M}, edge_cost={args.edge_cost:g})")
    print(f"[serve] fleet: {fleet.C} cells, N_max={fleet.N_max}, "
          f"M={fleet.M} (streaming control plane, {mode}, "
          f"device={args.device})")
    svc = PlanningService(fleet, lam=args.lam, sroa_cfg=cfg, cfg=svc_cfg,
                          spec=spec, seed=args.seed, device=args.device)
    return spec, svc


def run_service(args) -> dict:
    """The streaming ``--mode plan`` service loop."""
    from repro_torch.fleet.service import run_load

    t0 = time.time()
    _, svc = build_service(args)
    print(f"[serve] bootstrap: sum R={float(svc.R_ref.sum()):.1f} "
          f"in {time.time() - t0:.2f}s")

    def on_tick(rec):
        topo = (f", {rec.topo_moves} topo moves" if rec.topo_moves else "")
        print(f"[serve] tick {rec.tick}: {rec.changed} changed, "
              f"{rec.replanned.size} replanned, {rec.served} served "
              f"(coalesced {rec.coalesced}), sum R={rec.sum_R:.1f}, "
              f"{rec.tick_ms:.0f}ms{topo}")

    snap = run_load(svc, ticks=args.rounds, req_per_tick=args.req_rate,
                    seed=args.seed + 7, on_tick=on_tick)
    print(f"[serve] telemetry: {json.dumps(snap)}")
    return {"sum_R": snap["objective_sum"] / max(snap["ticks"], 1),
            "stats": snap}


def run_planner(args) -> dict:
    """The ``--no-stream`` driver: the per-cell request loop.

    A cold round plans every cell; each of ``--rounds`` rounds then moves
    and churns a random subset of cells (per-cell dynamics) and sends one
    warm-started request per cell.  Unchanged cells come back as cache
    hits.  Returns the last round's ``sum_R``, the cache ``stats`` and a
    record per round (``rounds``: cells changed, cache hits, wall ms and
    the responses).
    """
    import numpy as np

    from repro_torch.fleet import FleetPlanner, dynamics

    spec, fleet, cfg = _draw_serve_fleet(args)
    planner = FleetPlanner(lam=args.lam, cfg=cfg,
                           max_rounds=args.plan_rounds, escape_iters=2,
                           use_engine=not args.host_loop,
                           top_k=args.top_k, n_starts=args.n_starts,
                           ladder=_serve_ladder(args))

    route = "host loop" if args.host_loop else "engine"
    print(f"[plan] fleet: {fleet.C} cells, N_max={fleet.N_max}, "
          f"M={fleet.M} (route: {route}, device={args.device})")
    t0 = time.perf_counter()
    plans = planner.plan_fleet(fleet)
    _sync(args.device)
    cold_ms = (time.perf_counter() - t0) * 1e3
    total_R = sum(p.R for p in plans)
    print(f"[plan] cold round: sum R={total_R:.1f} in {cold_ms:.0f}ms "
          f"({sum(p.solve_calls for p in plans)} batched solves)")

    cells = [fleet.cell(i) for i in range(fleet.C)]
    states = [dynamics.init_state(c, seed=args.seed + i)
              for i, c in enumerate(cells)]
    warm = [p.assign for p in plans]
    rng = np.random.default_rng(args.seed)
    records = []
    for rnd in range(args.rounds):
        # A random subset of cells sees a dynamics event; the rest are
        # unchanged and must come back as cache hits.
        moved = rng.uniform(size=fleet.C) < args.event_rate
        events = [None] * fleet.C
        for i in np.flatnonzero(moved):
            cells[i], states[i] = dynamics.mobility_step(
                cells[i], states[i], rng)
            cells[i], states[i], events[i] = dynamics.churn_step(
                cells[i], states[i], rng, spec)
        t0 = time.perf_counter()
        responses = [
            plan_request(planner, cells[i],
                         warm_assign=warm[i],
                         new_users=None if events[i] is None
                         else events[i].arrived,
                         mask=states[i].active)
            for i in range(fleet.C)
        ]
        _sync(args.device)
        ms = (time.perf_counter() - t0) * 1e3
        # Each round's assignments seed the next round's warm starts.
        warm = [np.asarray(r["assign"], np.int32) for r in responses]
        hits = sum(r["cached"] for r in responses)
        total_R = sum(r["objective"] for r in responses)
        records.append({"changed": np.flatnonzero(moved).tolist(),
                        "hits": hits, "ms": ms, "sum_R": total_R,
                        "responses": responses})
        print(f"[plan] round {rnd}: {int(moved.sum())} cells changed, "
              f"{hits}/{fleet.C} cache hits, sum R={total_R:.1f}, "
              f"{ms:.0f}ms")
    print(f"[plan] cache stats: {planner.stats}")
    return {"sum_R": total_R, "stats": planner.stats, "cold_ms": cold_ms,
            "rounds": records}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_lm(cfg, *, batch: int, prompt_len: int, new_tokens: int, seed: int,
           device="cuda") -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens and decode
    ``new_tokens`` greedy tokens from the decode cache (prefill without
    ``pad_to``, as the JAX entry point does: the first decode step evicts
    the oldest token of a ring buffer).

    Weights and prompts come from one ``torch.Generator`` seeded with
    ``seed`` on ``device``.  For ``mixed`` input (internvl2) the same
    generator then draws ``patches`` (B, ``cfg.n_patches``, d), standard
    normal in ``cfg.dtype``, and the prompt is the patches followed by the
    ``prompt_len`` tokens: the prefill cache holds ``n_patches +
    prompt_len`` positions.  (The JAX entry point passes only tokens and
    stops with ``KeyError: 'patches'``; ROADMAP queue 3.)  Returns the
    timings (host clock around synchronised work), the prefill's
    last-position logits (B, V) and the generated tokens (B, 1 +
    new_tokens) as numpy.
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
        batch_in = {"tokens": prompts}
        if cfg.input_mode == "mixed":
            batch_in["patches"] = torch.randn(
                (B, cfg.n_patches, cfg.d_model), generator=gen,
                device=device, dtype=cfg.dtype)
        prefill = tf.make_prefill_step(cfg)
        serve = tf.make_serve_step(cfg)

        _sync(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch_in)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        patches = (f" after {cfg.n_patches} patches"
                   if "patches" in batch_in else "")
        print(f"[prefill] {B}x{T} tokens{patches} in "
              f"{t_prefill * 1e3:.2f} ms")

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
                    help="engine multi-start restarts per search")
    ap.add_argument("--horizon", type=int, default=1,
                    help="rolling-horizon slots per plan: score candidates "
                         "against K predicted channel slots (1 = snapshot "
                         "planning; D10)")
    ap.add_argument("--switch-cost", type=float, default=0.0,
                    help="weighted-cost charge per handover off the "
                         "deployed assignment (rolling-horizon mode)")
    ap.add_argument("--topology-period", type=int, default=0,
                    help="streaming mode: redesign edge placement/"
                         "activation every P ticks (0 = fixed topology; "
                         "D12)")
    ap.add_argument("--edge-cost", type=float, default=0.0,
                    help="weighted-cost charge per OPEN edge site in the "
                         "topology design objective (D12)")
    ap.add_argument("--m-cand", type=int, default=0,
                    help="candidate edge sites per cell; --cell-edges of "
                         "them start open (0 = M = --cell-edges)")
    ap.add_argument("--tiers", default="",
                    help="device tiers, comma-separated "
                         "name[:cycle_mult[:size_mult[:f_scale[:prob]]]]")
    ap.add_argument("--compression", action="store_true",
                    help="optimize per-user upload compression jointly "
                         "with assignment (none/int8/top-k ladder; D11)")
    ap.add_argument("--topk-frac", type=float, default=0.05,
                    help="top-k fraction of the ladder's highest rung")
    ap.add_argument("--plan-rounds", type=int, default=12,
                    help="engine iteration budget per search")
    ap.add_argument("--event-rate", type=float, default=0.4,
                    help="per-round probability a cell sees dynamics")
    ap.add_argument("--host-loop", action="store_true",
                    help="plan via the host-driven batched-TSIA loop "
                         "instead of the engine (implies --no-stream)")
    ap.add_argument("--no-stream", action="store_true",
                    help="serve via the per-cell request loop instead of "
                         "the streaming control plane")
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
    if args.no_stream or args.host_loop:
        return run_planner(args)
    return run_service(args)


if __name__ == "__main__":
    main()
