"""The 90th percentile of the tick's wall time over every tick of the
window (host clock): how stale a plan can grow."""
import numpy as np


def read(run: dict):
    if not run["tick_ms"]:
        return None
    return float(np.percentile(np.asarray(run["tick_ms"]), 90))
