"""End-to-end HFL training driver — the paper's full pipeline (Fig 1):

  1. draw the wireless scenario,
  2. plan:   TSIA user assignment + SROA resource allocation,
  3. train:  Algorithm 1 on the (synthetic) dataset with deadline-based
             straggler mitigation driven by the planned per-user delays,
  4. report: accuracy + the eq-15 objective + simulated wall-clock/energy,
  with atomic checkpointing and resume-after-crash.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --dataset fashionmnist \
      --iters 10 --users 20 --edges 4 [--resume] [--ckpt-dir out/ckpt] \
      [--device cpu]

The flags are the JAX entry point's, plus ``--device`` (default
``cuda``; a missing card raises, the CPU runs only when asked for).  The
plan runs fused: TSIA scores each pattern with one launch of kernel K2
(``SroaConfig(fused=True)`` at the default caps 42/40/36/48), where the
JAX entry point runs the jnp nest at the same caps; the eager nest is
bound by per-op overhead on a card.  On the CPU the same config runs K2's
plain version.  The participation masks come from one generator seeded
at start, as in the JAX entry point, so a resumed run draws its first
round's mask anew.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core import sroa, tsia, wireless
from repro_torch.core.system_model import evaluate
from repro_torch.data import make_dataset, partition_to_users
from repro_torch.data.synthetic import DATASET_SHAPES
from repro_torch.fed import straggler
from repro_torch.fed.hfl import HflConfig, run_hfl
from repro_torch.models import cnn
from repro_torch.runtime import fault


class TrainRun(NamedTuple):
    report: dict              # the ``[result]`` line's content
    scenario: wireless.Scenario
    plan: tsia.TsiaResult
    deadline: float           # per-edge-iteration straggler deadline (s)
    weights: dict             # the final global model
    history: dict             # run_hfl's {"acc", "iter"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fashionmnist",
                    choices=list(cnn.PAPER_CNNS))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--users", type=int, default=20)
    ap.add_argument("--edges", type=int, default=4)
    ap.add_argument("--L", type=int, default=2)
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="out/ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-quantile", type=float, default=0.9)
    ap.add_argument("--noniid-alpha", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to plan and train on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    return ap


def main(argv=None, *, w0=None, sroa_cfg: sroa.SroaConfig | None = None
         ) -> TrainRun:
    """Run the pipeline for the command line ``argv``.

    ``w0`` (a parameter dict with numpy or JAX leaves) replaces the
    initial model drawn from ``--seed``, and ``sroa_cfg`` the plan's
    ``SroaConfig(fused=True)``: with them a test holds the pipeline to the
    JAX package's on its weights and at reduced caps.
    """
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    cfg = cnn.PAPER_CNNS[args.dataset]

    # ---- 1. scenario -------------------------------------------------
    spec = dataclasses.replace(
        wireless.ScenarioSpec(), N=args.users, M=args.edges,
        D_range=(50, 90), s_bytes=float(cnn.param_bytes(cfg)))
    scn = wireless.draw_scenario(args.seed, spec, device=dev)
    print(f"[scenario] N={scn.N} M={scn.M} "
          f"B_total={float(scn.B_total)/1e6:.2f} MHz "
          f"s={float(scn.s_bits)/8e3:.0f} KB")

    # ---- 2. plan ------------------------------------------------------
    t0 = time.perf_counter()
    plan = tsia.solve(scn, lam=args.lam,
                      cfg=sroa_cfg or sroa.SroaConfig(fused=True))
    plan_s = time.perf_counter() - t0
    res = plan.sroa
    assign = torch.as_tensor(plan.assign, device=dev)
    cb = evaluate(scn, assign, res.b, res.f, res.p, args.lam)
    print(f"[plan] TSIA+SROA in {plan_s:.1f}s: "
          f"R={plan.R:.1f} (E={float(cb.E_sum):.1f} J, "
          f"T={float(cb.T_sum):.1f} s), "
          f"assign_iters={plan.history.total_iters}")

    delays = straggler.per_user_delay(scn, plan.assign, res.b, res.f, res.p)
    deadline = straggler.over_provision_deadline(
        delays, args.straggler_quantile)
    participate = straggler.jittered_participation(delays, deadline,
                                                   seed=args.seed)
    print(f"[straggler] per-edge-iter deadline={deadline:.2f}s "
          f"(keeps ~{100*args.straggler_quantile:.0f}% of users)")

    # ---- 3. data ------------------------------------------------------
    ds = make_dataset(args.dataset, n_train=4000, n_test=800,
                      shape=DATASET_SHAPES[args.dataset], seed=args.seed)
    sizes = np.asarray(scn.D.cpu().numpy(), int)
    x_u, y_u, mask, sizes = partition_to_users(
        ds.x_train, ds.y_train, sizes, alpha=args.noniid_alpha,
        seed=args.seed)

    # ---- 4. train (with resume) ----------------------------------------
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    if w0 is None:
        w0 = cnn.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    else:
        w0 = cnn.params_from_numpy(w0, cfg, dev)
    start = 0
    if args.resume:
        tree, step = fault.recover_from_checkpoint(mgr, w0)
        if tree is not None:
            w0, start = tree, int(step)
            print(f"[resume] from checkpoint step {start}")

    hcfg = HflConfig(L=args.L, K=args.K, I=args.iters, lr=args.lr,
                     seed=args.seed)
    t0 = time.perf_counter()
    w, hist = run_hfl(cfg, w0, x_u, y_u, mask, sizes, plan.assign, hcfg,
                      x_test=ds.x_test, y_test=ds.y_test,
                      participate_fn=participate, ckpt_manager=mgr,
                      start_iter=start, device=dev)
    wall = time.perf_counter() - t0

    # ---- 5. report -----------------------------------------------------
    report = {
        "dataset": args.dataset,
        "acc": hist["acc"],
        "final_acc": hist["acc"][-1] if hist["acc"] else None,
        "objective_R": float(plan.R),
        "energy_J": float(cb.E_sum),
        "delay_s": float(cb.T_sum),
        "plan_s": plan_s,
        "train_wall_s": wall,
        "global_iters": args.iters - start,
        "device": str(dev),
    }
    print("[result] " + json.dumps(report))
    return TrainRun(report, scn, plan, deadline, w, hist)


if __name__ == "__main__":
    main()
