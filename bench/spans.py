"""Spans around the program's entry points, installed from ``spans.json``.

Each entry names a function or method of the port by its import path
(``module:attribute.path``).  In a traced run
the harness replaces each with a wrapper that times the call on the host
clock, opens a ``torch.profiler.record_function`` range named
``bench.<span>`` (so the device trace can be cut by span), and, where the
entry asks for it, reads a field of the result (``"result"``) or keeps the
call's operands (``"operands"``).  A name that no longer resolves raises
before the run starts: a renamed entry point fails the traced run loudly,
it does not read zero.
"""
from __future__ import annotations

import functools
import importlib
import json
import math
import time
from pathlib import Path

import torch

TABLE = Path(__file__).resolve().parent / "spans.json"

K2_OPERANDS = ("A", "J", "H", "delta", "h", "f_max", "p_max", "B", "b_max",
               "N0", "lam", "E_cloud_total")
K2_SETTINGS = ("b_iters", "f_iters", "p_iters", "t_iters", "eps0", "eps1",
               "eps2", "t_low", "t_up")


def resolve(target: str):
    """(owner, attribute name) of ``module:attr.path``; raises LookupError
    when any part is missing."""
    module, _, path = target.partition(":")
    try:
        owner = importlib.import_module(module)
    except ImportError as e:
        raise LookupError(f"span target {target}: {e}") from e
    parts = path.split(".")
    for part in parts[:-1]:
        if not hasattr(owner, part):
            raise LookupError(f"span target {target}: no {part!r}")
        owner = getattr(owner, part)
    if not callable(getattr(owner, parts[-1], None)):
        raise LookupError(f"span target {target}: no callable "
                          f"{parts[-1]!r}")
    return owner, parts[-1]


def k2_operands(args: tuple, kw: dict) -> dict:
    """The fused solve's operands as its wrapper flattens them: per-user
    (P, N) and per-problem (P,) float32 copies, and the solve's settings."""
    vals = dict(zip(K2_OPERANDS, args))
    vals.update({k: kw[k] for k in K2_OPERANDS if k in kw})
    dev = vals["A"].device
    shape = torch.broadcast_shapes(*(torch.as_tensor(vals[k]).shape
                                     for k in K2_OPERANDS[:7]))
    lead, N = shape[:-1], shape[-1]
    P = math.prod(lead)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    ops = {k: torch.broadcast_to(f32(vals[k]), shape).reshape(P, N).clone()
           for k in K2_OPERANDS[:7]}
    ops.update({k: torch.broadcast_to(f32(vals[k]), lead).reshape(P).clone()
                for k in K2_OPERANDS[7:]})
    return {"operands": ops,
            "settings": {k: kw[k] for k in K2_SETTINGS if k in kw}}


class Spans:
    """Host spans a tick, values read from results, and kept operands."""

    def __init__(self, table: dict | None = None):
        self.table = table if table is not None else json.loads(
            TABLE.read_text())
        self.ms: dict[str, list] = {name: [] for name in self.table}
        self.values: dict[str, list] = {name: [] for name in self.table}
        self.kept: dict[str, list] = {name: [] for name in self.table}
        self.keep = False          # keep operands (the traced stretch)
        self.tick = -1
        self._undo = []

    def install(self) -> None:
        targets = {name: resolve(spec["target"])
                   for name, spec in self.table.items()}
        for name, (owner, attr) in targets.items():
            orig = getattr(owner, attr)
            setattr(owner, attr, self._wrap(name, self.table[name], orig))
            self._undo.append((owner, attr, orig))

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def _wrap(self, name: str, spec: dict, orig):
        field = spec.get("result")
        operands = spec.get("operands")

        @functools.wraps(orig)
        def wrapper(*args, **kw):
            if name == "tick":
                self.tick = args[0].tick_idx
            if operands == "k2" and self.keep:
                self.kept[name].append(k2_operands(args, kw))
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench." + name):
                out = orig(*args, **kw)
            self.ms[name].append((self.tick, (time.perf_counter() - t0)
                                  * 1e3))
            if field is not None:
                self.values[name].append(
                    (self.tick, float(getattr(out, field).float().mean())))
            return out

        return wrapper

    def per_tick(self, name: str, ticks) -> list[float]:
        """The span's summed ms in each of ``ticks`` in which it ran."""
        ticks = set(ticks)
        total: dict[int, float] = {}
        for tick, ms in self.ms[name]:
            if tick in ticks:
                total[tick] = total.get(tick, 0.0) + ms
        return list(total.values())
