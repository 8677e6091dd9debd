"""The readings a cell's limits are set from, on the card, in one process.

    python bench/readings.py --workload <cell> --seeds 1,2,... \\
        --seconds <s> [--control-seeds 3] [--fault-seeds 3] \\
        [--faults rounds1,moves,caps,objective] [--out FILE]

For each seed it runs the cell as ``bench/run.py`` does (untraced) and
prints the judge's numbers: their largest over the seeds is each number's
lower reading.  Then, on the first ``--control-seeds`` seeds, the control:
the reference in bfloat16 put in the program's place (``judge.control``);
and on the first ``--fault-seeds`` seeds the planted faults:

* ``rounds1``: the program's search cut to one round;
* ``moves``: the move-score kernel's nominations replaced by random
  single-user moves;
* ``caps``: the program's SROA run at half the configuration's iteration
  caps (consistent plans, dearer ones);
* ``objective``: the program's drift gate blind to objective drift (for a
  traffic whose gate reads it).

The smallest reading of a number under each is an upper reading.  A
summary line closes the output; ``--out`` also writes every reading as
JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

import cell  # noqa: E402
import judge  # noqa: E402
import session  # noqa: E402
import system  # noqa: E402

FAULTS = ("rounds1", "moves", "caps", "objective")


@contextlib.contextmanager
def random_moves(seed: int):
    """The move-score kernel's k nominations replaced by random moves: a
    random user (an inactive one is no legal move) to a random other edge,
    all scored alike."""
    import torch
    from repro_torch.kernels import ops

    real = ops.topk_move_scores
    gen = torch.Generator().manual_seed(seed)

    def fake(gain, H, p_max, assign, mask, N0, B, k):
        P, N, M = gain.shape
        user = torch.randint(0, N, (P, k), generator=gen)
        off = torch.randint(1, M, (P, k), generator=gen)
        user = user.to(gain.device)
        dst = (assign.long().gather(1, user) + off.to(gain.device)) % M
        score = torch.where(mask.gather(1, user), 0.0, 1e30)
        return user.to(torch.int32), dst.to(torch.int32), score

    ops.topk_move_scores = fake
    try:
        yield
    finally:
        ops.topk_move_scores = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python bench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    c = cell.load(args.workload, ROOT)
    cfg, tr = c.config, c.traffic
    caps = system.caps(cfg)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    out = {kind: {} for kind in ("program", "control", *FAULTS)}
    half = {k: max(1, v // 2) for k, v in caps.items()}

    def control(seed):
        def after(cells0, mask0, log):
            judge.control(cfg, tr, cells0, mask0, seed, log, caps,
                          args.device)
        return dict(after_window=after)

    planted = {"rounds1": dict(solver={"max_rounds": 1}), "moves": {},
               "caps": dict(solver=half),
               "objective": dict(drift={"use_objective": False})}
    plan = ([("program", s, {}) for s in seeds]
            + [("control", s, control(s))
               for s in seeds[:args.control_seeds]]
            + [(f, s, planted[f]) for f in faults
               for s in seeds[:args.fault_seeds]])
    for kind, seed, kw in plan:
        t0 = time.perf_counter()
        ctx = (random_moves(seed) if kind == "moves"
               else contextlib.nullcontext())
        with ctx:
            res = session.run(c, seed, args.seconds, False, args.device,
                              **kw)
        out[kind][seed] = res["numbers"]
        print(f"{kind} seed {seed} correct {res['correct']} "
              f"ticks {len(res['run']['tick_ms'])} "
              f"{time.perf_counter() - t0:.1f}s "
              f"{json.dumps(res['numbers'])}", flush=True)
    names = sorted({n for r in out["program"].values() for n in r})
    summary = {}
    for n in names:
        summary[n] = {
            "lower": max(r[n] for r in out["program"].values()),
            "control": min((r[n] for r in out["control"].values()
                            if n in r), default=None),
            **{kind: min((r[n] for r in out[kind].values() if n in r),
                         default=None) for kind in FAULTS}}
    print("summary " + json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"readings": out,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
