"""The share of the traced ticks in which no operation ran on the device."""


def read(run: dict):
    tr = run["trace"]
    if tr is None or tr["window_s"] <= 0.0 or not tr["device_events"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
