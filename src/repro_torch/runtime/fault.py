"""Fault tolerance & elastic scaling for the HFL runtime.

Components:
* ``FailureDetector`` — heartbeat bookkeeping; marks workers dead after a
  missed-deadline budget (simulated clock, unit-tested).
* ``elastic_remesh`` — on device loss, the largest (data, model) mesh the
  surviving devices fill (integer arithmetic only); TSIA (the paper's own
  algorithm) re-balances the client -> edge assignment for the surviving
  edge set.
* ``recover_from_checkpoint`` — resume training state from the newest
  intact checkpoint (pairs with ckpt.CheckpointManager).
"""
from __future__ import annotations

import dataclasses
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import sroa, tsia
from repro_torch.core.wireless import Scenario


@dataclasses.dataclass
class FailureDetector:
    """Deadline-based failure detection over worker heartbeats."""

    timeout_s: float = 30.0
    max_missed: int = 3
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)
    _missed: Dict[int, int] = dataclasses.field(default_factory=dict)
    _dead: set = dataclasses.field(default_factory=set)

    def heartbeat(self, worker: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self._last[worker] = now
        self._missed[worker] = 0
        self._dead.discard(worker)

    def sweep(self, now: Optional[float] = None):
        """Advance the detector; returns newly-dead workers."""
        now = time.monotonic() if now is None else now
        newly = []
        for w, t in self._last.items():
            if w in self._dead:
                continue
            if now - t > self.timeout_s:
                self._missed[w] = self._missed.get(w, 0) + 1
                self._last[w] = now
                if self._missed[w] >= self.max_missed:
                    self._dead.add(w)
                    newly.append(w)
        return newly

    @property
    def dead(self):
        return set(self._dead)

    def alive(self):
        return [w for w in self._last if w not in self._dead]


def elastic_remesh(n_devices_alive: int, prefer_model: int = 16):
    """Largest (data, model) mesh fitting the surviving device count."""
    model = prefer_model
    while model > 1 and n_devices_alive % model:
        model //= 2
    data = n_devices_alive // model
    return (data, model)


def reassign_after_edge_loss(scn: Scenario, assign: np.ndarray,
                             dead_edges: set, lam: float = 1.0,
                             quick: bool = True,
                             cfg: sroa.SroaConfig = sroa.SroaConfig(
                                 fused=True)):
    """Re-balance users of dead edges with TSIA (the paper's own algorithm
    doubles as the elastic re-assignment policy).

    Each user of a dead edge first moves to its best-gain live edge; unless
    ``quick``, TSIA then runs from that pattern under ``cfg``.  The
    default scores on kernel K2 (``fused``), where the reference runs the
    eager nest at the same caps.
    """
    alive = [m for m in range(scn.M) if m not in dead_edges]
    if not alive:
        raise RuntimeError("no edge servers left")
    assign = np.array(assign.cpu() if isinstance(assign, torch.Tensor)
                      else assign)
    gains = scn.gain.cpu().numpy()
    for n in np.flatnonzero(np.isin(assign, list(dead_edges))):
        assign[n] = alive[int(np.argmax(gains[n, alive]))]
    if quick:
        return assign
    res = tsia.solve(scn, lam=lam, cfg=cfg, init_assign=assign,
                     max_iters_per_stage=16)
    return res.assign


def recover_from_checkpoint(manager, template):
    """Latest intact checkpoint -> (tree, step); tolerates a torn newest file
    by falling back to the previous one."""
    steps = manager.steps()
    for step in reversed(steps):
        try:
            tree, meta = manager.restore(template, step=step)
            return tree, (meta or {}).get("step", step)
        except (OSError, EOFError, KeyError, ValueError,
                zipfile.BadZipFile):    # torn or foreign file: try older
            continue
    return None, None
