"""Shared set-up of the benchmark's tests: the harness's modules and the
port on the path, and a cell cut to a size the CPU runs in seconds."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import cell as bench_cell  # noqa: E402

# A few small cells, the served caps' inner bisection (b) kept whole so the
# plans are as tight as the card's, the outer loops cut.
TINY_CONFIG = dict(cells=3, users_max=8, users_min=6, edges=3)
TINY_SOLVER = dict(b_iters=30, f_iters=10, p_iters=8, t_iters=12, top_k=3,
                   max_rounds=2, escape_iters=1)


def tiny(name: str, **traffic) -> bench_cell.Cell:
    """The cell ``name`` of BENCHMARK.json cut to :data:`TINY_CONFIG`,
    with its limits as committed."""
    c = copy.deepcopy(bench_cell.load(name, ROOT))
    c.config.update(TINY_CONFIG, solver=dict(TINY_SOLVER))
    c.traffic.update(warmup_ticks=1, trace_ticks=1, check_ticks=2,
                     **traffic)
    return c


@pytest.fixture
def stream_cell() -> bench_cell.Cell:
    """paper-stream, every cell advancing and a low drift threshold, so
    each tick re-searches."""
    c = tiny("paper-stream", event_rate=1.0)
    c.traffic["drift"] = dict(c.traffic["drift"], channel_threshold=0.02)
    return c
