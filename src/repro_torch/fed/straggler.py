"""Straggler mitigation: deadline-based participation from the wireless model.

Couples the paper's delay model to training: a client participates in a
round iff its per-edge-iteration delay (T_cmp + T_com from the SROA
solution) meets the deadline.  Dropped clients are excluded from the
aggregation weights (fed/hfl.py `participate`); their data re-enters when
channel conditions / resources allow.  This is the deadline variant of
partial aggregation; `over_provision` keeps the expected participation rate
at `target` by inflating the deadline.

The delays come from the port's cost model on the scenario's device and
are returned as numpy; the deadline and the participation masks are numpy
with the JAX package's ``default_rng`` call order, so equal delays give
equal masks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.system_model import evaluate
from repro_torch.core.wireless import Scenario


def per_user_delay(scn: Scenario, assign, b, f, p) -> np.ndarray:
    a = torch.tensor(np.array(assign.cpu() if isinstance(
        assign, torch.Tensor) else assign), dtype=torch.int32,
        device=scn.device)
    cb = evaluate(scn, a, b, f, p, lam=1.0)
    return (cb.T_cmp + cb.T_com).cpu().numpy()      # per edge iteration


def deadline_mask(delays: np.ndarray, deadline: float) -> np.ndarray:
    return (delays <= deadline).astype(np.float32)


def over_provision_deadline(delays: np.ndarray, target: float = 0.95):
    """Smallest deadline keeping `target` fraction of clients."""
    return float(np.quantile(delays, target))


def jittered_participation(delays: np.ndarray, deadline: float,
                           jitter: float = 0.2, seed: int = 0):
    """Round-wise participation with log-normal delay jitter (fading etc.).

    The masks come from one generator in call order, whatever round index
    is passed (as in the reference): a resumed run draws its first round's
    mask anew from the seed.
    """
    rng = np.random.default_rng(seed)

    def fn(round_idx: int) -> np.ndarray:
        noisy = delays * rng.lognormal(0.0, jitter, size=delays.shape)
        mask = (noisy <= deadline).astype(np.float32)
        if mask.sum() == 0:                          # never stall a round
            mask[np.argmin(noisy)] = 1.0
        return mask

    return fn
