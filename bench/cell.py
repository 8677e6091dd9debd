"""A cell of the benchmark, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix, the limits of its comparisons and
the readers of its metrics.

Everything is looked up by the names ``BENCHMARK.json`` gives: a new cell,
configuration, traffic mix or metric is a new file and a new entry, with
no edit to a file that is there.

* configuration ``<config>``: the file the entry of ``configs`` names;
* traffic ``<traffic>``: ``bench/workloads/<traffic>.json``;
* limits of cell ``<workload>``: ``bench/limits/<workload>.json``;
* metric ``<metric>``: ``bench/metrics/<metric>.py``, whose ``read(run)``
  returns the value or None when the run holds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list    # BENCHMARK.json metric entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    name it does not list."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / BENCH.name
    traffic = json.loads((bench_dir / "workloads"
                          / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
    return Cell(name=name, root=root, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric: str, root: Path = BENCH.parent):
    """The ``read`` function of ``bench/metrics/<metric>.py`` under
    ``root``."""
    path = root / BENCH.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
