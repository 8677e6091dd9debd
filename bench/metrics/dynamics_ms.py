"""Host ms a tick in the dynamics step and the drift scores (spans
``dynamics`` and ``drift``), the mean over the window's ticks."""
import numpy as np


def read(run: dict):
    spans = run["spans"]
    if spans is None:
        return None
    ticks = run["ticks"]
    per_tick = {t: 0.0 for t in ticks}
    seen = set()
    for name in ("dynamics", "drift"):
        for t, ms in spans.ms[name]:
            if t in per_tick:
                per_tick[t] += ms
                seen.add(t)
    if not seen:
        return None
    return float(np.mean([per_tick[t] for t in seen]))
