"""Rounds a re-search ran (the engine's ``rounds``, the mean over its
cells), the mean over the window's searches."""
import numpy as np


def read(run: dict):
    spans = run["spans"]
    if spans is None:
        return None
    ticks = set(run["ticks"])
    vals = [v for t, v in spans.values["engine"] if t in ticks]
    return float(np.mean(vals)) if vals else None
