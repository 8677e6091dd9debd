"""Host ms of a tick's re-search (span ``search``, to the host's read of
its result), the mean over the window's ticks that searched."""
import numpy as np


def read(run: dict):
    spans = run["spans"]
    if spans is None:
        return None
    per_tick = spans.per_tick("search", run["ticks"])
    return float(np.mean(per_tick)) if per_tick else None
