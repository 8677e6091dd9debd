"""Guards on the harness: it is driven by names, it loads no JAX, its
``BENCHMARK.json`` keeps the benchmark's contract, and it prints no result
where it cannot measure."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

import cell as bench_cell
import session
from conftest import BENCH, ROOT, TINY_CONFIG, TINY_SOLVER

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _copy_bench(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def _digest(root) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_config_traffic_and_metric_run_by_name(tmp_path):
    root = _copy_bench(tmp_path)
    before = _digest(root / "bench")
    cfg = json.loads((root / "bench/configs/paper-fleet.json").read_text())
    cfg.update(TINY_CONFIG, name="tiny-fleet", solver=dict(TINY_SOLVER))
    (root / "bench/configs/tiny-fleet.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "bench/workloads/reprice.json").read_text())
    traffic.update(name="still", warmup_ticks=1, check_ticks=1)
    (root / "bench/workloads/still.json").write_text(json.dumps(traffic))
    limits = json.loads((root / "bench/limits/paper-reprice.json")
                        .read_text())
    (root / "bench/limits/tiny-still.json").write_text(json.dumps(limits))
    (root / "bench/metrics/ticks_run.py").write_text(
        "def read(run):\n    return float(len(run['tick_ms']))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-fleet", "source": "test",
                             "file": "bench/configs/tiny-fleet.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-still", "config": "tiny-fleet",
                               "traffic": "still", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "ticks_run", "unit": "ticks",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-still"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = bench_cell.load("tiny-still", root)
    assert c.config["cells"] == TINY_CONFIG["cells"]
    names = [m["name"] for m in c.end_to_end]
    assert "ticks_run" in names and "tick_p90_ms" not in names
    out = session.run(c, 3, 0.0, False, "cpu", ticks=2)
    assert out["correct"], out["checks"]
    values = {m["name"]: bench_cell.reader(m["name"], root)(out["run"])
              for m in c.end_to_end}
    assert values["ticks_run"] == 2.0 and values["plans_per_s"] > 0
    after = _digest(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = f"""
import sys
sys.argv = ["run.py"]
sys.path[:0] = [{str(BENCH)!r}]
import run
import cell, session
import conftest
c = conftest.tiny("paper-reprice")
session.run(c, 5, 0.0, True, "cpu", ticks=1)
print("LOADED", run.loaded_forbidden())
print("TOP", sorted({{m.partition(".")[0] for m in sys.modules}}))
"""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
           "PYTHONPATH": str(BENCH / "tests")}
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("LOADED")]
    assert line == ["LOADED []"]
    top = [x for x in res.stdout.splitlines() if x.startswith("TOP")][0]
    assert "'repro_torch'" in top
    for name in ("'jax'", "'jaxlib'", "'flax'", "'repro'"):
        assert name not in top


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import run
    base = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "reprox", sys)
    assert run.loaded_forbidden() == base
    monkeypatch.setitem(sys.modules, "repro.fleet", sys)
    assert "repro" in run.loaded_forbidden()


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench"]
    assert bench["command"] == ["python3", "bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = 2 + 14 * 24
    assert cells * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               and m["source"] in SOURCES for m in metrics)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/")
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "workloads" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        c = bench_cell.load(w["name"], ROOT)
        e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e and len(e) >= 2 and c.per_layer
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and (BENCH / "metrics"
                                      / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            cell_e2e = [x["name"] for x in
                        bench_cell.load(w, ROOT).end_to_end]
            assert m["moves"] in cell_e2e
    for m in e2e.values():
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for name in ("sroa_roofline", "tick_mfu"):
        assert [m["unit"] for m in bench["per_layer"]
                if m["name"] == name] == ["%"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_without_a_card_prints_no_result():
    res = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "paper-stream",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not taken")
    assert res.returncode != 0 and "{" not in res.stdout


def test_the_benchmark_alone_cannot_run(tmp_path):
    root = _copy_bench(tmp_path)
    res = subprocess.run(
        [sys.executable, "bench/readings.py", "--workload", "paper-reprice",
         "--seeds", "1", "--seconds", "0", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0 and "summary" not in res.stdout
    assert "repro_torch" in res.stderr


def test_trace_readers_are_silent_without_a_trace():
    run = {"trace": None, "work": None, "peaks": None, "spans": None,
           "ticks": [], "tick_ms": [], "counters": {"cells": 0}}
    for name in ("sroa_roofline", "tick_mfu", "device_idle", "dynamics_ms",
                 "search_ms", "search_rounds", "reprice_ms",
                 "replan_share"):
        assert bench_cell.reader(name)(run) is None


def test_trace_readers_arithmetic():
    peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    run = {"trace": {"window_s": 2.0, "busy_s": 1.5, "device_events": 10,
                     "in_span": {"k2": 1.0}},
           "work": {"flops": 6.7e11, "bytes": 3.35e9, "calls": 3},
           "peaks": peaks}
    assert bench_cell.reader("sroa_roofline")(run) == pytest.approx(1.0)
    assert bench_cell.reader("tick_mfu")(run) == pytest.approx(0.5)
    assert bench_cell.reader("device_idle")(run) == pytest.approx(0.25)
    run["work"]["bytes"] = 6.7e10          # bytes bound the least time
    assert bench_cell.reader("sroa_roofline")(run) == pytest.approx(2.0)
