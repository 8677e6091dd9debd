#!/usr/bin/env python3
"""Hold the recurrence kernels S1-S3 (``csrc/ssm_scan.cu``, and S1's
chunked kernel ``csrc/ssd_chunked.cu``) and their backward kernels
S1b-S3b (``csrc/ssm_scan_bwd.cu``, S1b's chunked kernel in
``ssd_chunked.cu``, S2b's in ``mlstm_chunked.cu``) to their plain twins
on a card, and time them.

    python3 tools/ssm_scans.py [--no-time]

Builds the kernels with ``-Xptxas -v`` and prints the scan kernels'
registers and spills, then, on seeded operands with a state carried in:
S1 and S1b on both routes (``chip_smoke._mamba2_rows``: the chunked and
the sequential kernels on the same tensors, against the sequential twins
and the chunked model, with the T sweep), and S2, S3 and their backward
(``chip_smoke._ssm_kernel_row``, ``_ssm_bwd_rows``: S2b's chunked and
sequential kernels and S3b's short step and barrier kernel on the same
tensors, seeded upstream gradients of every output, each launch timed
alone, S2b's T sweep and S3b's latency floor, its walk's handshake alone
under the cluster barrier and under the mbarrier): phase s's shapes
(zamba2-7b's Mamba2 at (B, T, H, ds, hd) = (4, 1024, 112, 64, 64),
xlstm-125m's mLSTM and sLSTM at (4, 1024, 4, 192)) timed beside the
plain version and the bound, and smaller widths untimed (the reduced
configs' ds 16 and hd 16, which only the sequential kernels take; ds 32
and hd 64 on both; hd 32). The card's name and power limit come first;
one JSON line a case follows. Runs on a card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (op, B, T, H, hd, ds, timed)
CASES = (("mamba2_scan", 4, 1024, 112, 64, 64, True),
         ("mlstm_scan", 4, 1024, 4, 192, 0, True),
         ("slstm_scan", 4, 1024, 4, 192, 0, True),
         ("mamba2_scan", 2, 64, 16, 16, 16, False),
         ("mamba2_scan", 2, 100, 4, 64, 32, False),
         ("mlstm_scan", 2, 64, 4, 32, 0, False),
         ("slstm_scan", 2, 64, 4, 32, 0, False))


def operands(name: str, B: int, T: int, H: int, hd: int, ds: int, gen):
    """Seeded float32 operands of one op in its argument order, at the
    magnitudes the models give them (decays in (0, 1), log forget gates
    below 0, scaled q and k, R at 1/sqrt(hd))."""
    import torch

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    if name == "mamba2_scan":
        return (torch.exp(-torch.rand((B, T, H), generator=gen,
                                      device="cuda")),
                rn(B, T, ds), rn(B, T, ds), rn(B, T, H, hd, scale=0.1),
                rn(B, H, ds, hd))
    if name == "mlstm_scan":
        s = hd ** -0.5
        return (rn(B, T, H, hd, scale=s), rn(B, T, H, hd, scale=s),
                rn(B, T, H, hd), rn(B, T, H),
                torch.nn.functional.logsigmoid(rn(B, T, H) + 2.0),
                rn(B, H, hd, hd, scale=0.1), rn(B, H, hd), rn(B, H))
    return (*(rn(B, T, H, hd) for _ in range(4)),
            rn(H, hd, 4 * hd, scale=hd ** -0.5),
            *(rn(B, H, hd) for _ in range(4)))


def main(argv: list[str]) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("ssm_scans: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    build.load(verbose=True)
    for line in cs._ptxas(build.build_log):
        if any(k in line for k in ("_scan_kernel", "_scan_bwd_kernel",
                                   "_gates_bwd_kernel", "_chunked_",
                                   "_bwd_short_kernel", "slstm_dR_kernel",
                                   "_handshake_kernel")):
            print("ptxas:", line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(25)
    with torch.inference_mode():
        for name, B, T, H, hd, ds, timed in CASES:
            args = operands(name, B, T, H, hd, ds, gen)
            time_it = timed and "--no-time" not in argv
            if name == "mamba2_scan":
                rows = cs._mamba2_rows(args, "[ssm]", time_it=time_it)
                for row in rows.values():
                    print(json.dumps(row), flush=True)
                continue
            row = cs._ssm_kernel_row(name, args, "[ssm]", time_it=time_it)
            print(json.dumps(row), flush=True)
            rows = cs._ssm_bwd_rows(name + "_bwd", args, "[ssm]",
                                    time_it=time_it)
            for key, row in rows.items():
                print(json.dumps({key: row} if key in ("sweep", "floor")
                                 else row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
