"""The benchmark of the port's planning service: one run of one cell.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The cell, its configuration, traffic, limits and metrics are
looked up by name (``bench/cell.py``).  A run builds or loads the port's
kernel library, draws the fleet from the seed, starts the service (its
bootstrap search and warm-up ticks are the set-up), runs ticks back to
back for ``--seconds`` under Poisson plan requests, and judges the run
against the plain reference (every tick, and a sample of ticks whole).  With ``--trace 1`` it also times the
program's layers by spans and traces a few more ticks on the device, and
reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` also
``breakdown``) and ``checks``, each number compared beside its limit; the
checks are also the last lines of standard error.  Without a CUDA card, or
with fewer than the cell asks for, it prints no result and exits 2; if the
JAX package or JAX itself was loaded, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = ROOT / "build" / "bench-cache"
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# Few threads: one process drives the card; the host's spare cores keep
# the runs steady.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "4"
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.partition(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def metric_values(entries: list, run: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of the metrics whose reader finds
    something to read in ``run``."""
    import cell

    out = {}
    for m in entries:
        value = cell.reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import cell
    c = cell.load(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {c.chips} CUDA card(s), this "
              f"machine has {n}", file=sys.stderr)
        return 2

    import session
    out = session.run(c, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    found = loaded_forbidden()
    if found:
        print(f"bench: the run loaded {found}: the benchmark runs the port "
              "alone", file=sys.stderr)
        return 3

    run = out["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": c.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        tr = run["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["metrics"] = metric_values(c.per_layer, run, c.root)
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in tr["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in tr["idle_gaps"][:10]]}
    else:
        result["metrics"] = metric_values(c.end_to_end, run, c.root)
    result["device"] = device
    result["checks"] = out["checks"]
    for name, chk in out["checks"].items():
        print(f"check {name} {chk['value']!r} limit {chk['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
