#!/usr/bin/env python3
"""Time K2's cluster kernel on the large-cell shapes of ``chip_smoke.py``'s
phase x, for two checkouts in turns on one card.

    python3 tools/ab_k2_cluster.py PARENT_ROOT CHANGE_ROOT

The turns run parent, change, change, parent, each in a process of its
own with that checkout's ``src`` and ``chip_smoke.py`` first on the path
(each checkout builds its own kernels).  A turn solves the first round of
the large-cell search (P = 34, N = 2,048) and one problem at N = 600 and
4,096 on the cluster kernel at every depth and prints one JSON line of
median CUDA-event ms.  The card's name and power limit come first, and
last whether the two checkouts gave the same bits.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPS = 5


def _turn(root: Path) -> dict:
    sys.path[:0] = [str(root / "src"), str(root)]
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch.core import sroa, wireless
    from repro_torch.fleet import engine
    from repro_torch.kernels import sroa_bisect as sb

    dev = torch.device("cuda", 0)
    spec = dataclasses.replace(wireless.ScenarioSpec(), N=cs.X_N, M=cs.X_M)
    scn = wireless.draw_scenario(1, spec, device=dev)
    cfg = sroa.SroaConfig(**cs.X_CAPS, fused=True)
    with cs._first_operands(cs.X_STARTS * (1 + cs.X_TOP_K)) as first:
        engine.solve_assignment(scn, cfg=cfg, max_rounds=1, top_k=cs.X_TOP_K,
                                n_starts=cs.X_STARTS)
    shapes = {"round": first["k2"][:2]}
    for n in (600, 4096):
        s1 = wireless.draw_scenario(n, dataclasses.replace(spec, N=n),
                                    device=dev)
        shapes[f"N{n}"] = cs._k2_operands(
            s1, [wireless.nearest_edge_assignment(s1)])
    kw = first["k2"][2]
    out, bits = {}, {}
    for key, (pu, pp) in shapes.items():
        for d in sb.DEPTHS:
            def call(d=d, pu=pu, pp=pp):
                return sb.solve_cuda(tuple(pu), tuple(pp), **kw,
                                     _route=("cluster", d))[0]
            res = call()
            bits[f"{key}/{d}"] = [x.cpu() for x in res]
            out[f"{key}/{d}"] = cs._time_ms(call, REPS)
    torch.save(bits, root / "build" / "ab_k2_bits.pt")
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--turn"]:
        print(json.dumps(_turn(Path(argv[1]).resolve())))
        return 0
    import torch

    parent, change = (Path(a).resolve() for a in argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for name, root in (("parent", parent), ("change", change),
                       ("change", change), ("parent", parent)):
        run = subprocess.run([sys.executable, __file__, "--turn", str(root)],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        print(name, run.stdout.strip().splitlines()[-1], flush=True)
    a = torch.load(parent / "build" / "ab_k2_bits.pt")
    b = torch.load(change / "build" / "ab_k2_bits.pt")
    same = all(torch.equal(x, y) for k in a for x, y in zip(a[k], b[k]))
    print("bitwise equal:", same)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
