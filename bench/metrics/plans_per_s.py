"""Cell-plans kept fresh per second: cells x ticks completed in the window
over the window's seconds (host clock)."""


def read(run: dict):
    if not run["tick_ms"]:
        return None
    return run["cells"] * len(run["tick_ms"]) / run["window_s"]
