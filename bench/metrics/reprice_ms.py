"""Host ms of one re-price of the whole fleet (span ``reprice``: the fused
SROA solve and the host's read of its result), the mean over the window's
calls."""
import numpy as np


def read(run: dict):
    spans = run["spans"]
    if spans is None:
        return None
    ticks = set(run["ticks"])
    vals = [ms for t, ms in spans.ms["reprice"] if t in ticks]
    return float(np.mean(vals)) if vals else None
