"""Cells re-searched over cells planned in the window, from the service's
own telemetry counters."""


def read(run: dict):
    c = run["counters"]
    if not c["cells"]:
        return None
    return c["cells_replanned"] / c["cells"]
