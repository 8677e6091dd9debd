"""Seconds from the process start to the first measured tick: the kernel
library's load (or build), the fleet's draw, the service's bootstrap
search and the warm-up ticks."""


def read(run: dict):
    return run["setup_s"]
