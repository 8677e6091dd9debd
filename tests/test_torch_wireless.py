"""Port parity: the scenario model (``core/wireless.py``) and the fleet draw.

The JAX package draws every scenario with numpy in float64 and casts to
float32 at the end, so the port's draw must be BITWISE equal, leaf by leaf,
for homogeneous and tiered specs and for a whole fleet.
"""
import dataclasses
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import (assert_bitwise, fleet_to_torch, host,  # noqa: E402
                           scenario_to_torch, to_numpy)
from repro.core import wireless as jw  # noqa: E402
from repro.fleet import batch as jb  # noqa: E402
from repro_torch.core import wireless as tw  # noqa: E402
from repro_torch.fleet import batch as tb  # noqa: E402

TIERS = (("lo", 1.5, 1.0, 0.6, 0.3), ("mid", 1.0, 1.0, 1.0, 0.4),
         ("hi", 0.7, 1.2, 1.4, 0.3))


def _specs(tiered: bool, **kw):
    jt = tuple(jw.DeviceTier(*t) for t in TIERS) if tiered else ()
    tt = tuple(tw.DeviceTier(*t) for t in TIERS) if tiered else ()
    return (dataclasses.replace(jw.ScenarioSpec(), tiers=jt, **kw),
            dataclasses.replace(tw.ScenarioSpec(), tiers=tt, **kw))


def _assert_scenario_bitwise(got, want):
    assert got.edge_mask is None and want.edge_mask is None
    for name in tw.Scenario._fields:
        if name == "edge_mask":
            continue
        assert_bitwise(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("tiered", [False, True], ids=["homog", "tiered"])
@pytest.mark.parametrize("seed,N,M", [(0, 50, 5), (3, 10, 3), (11, 6, 2)])
def test_draw_scenario_bitwise(seed, N, M, tiered):
    jspec, tspec = _specs(tiered, N=N, M=M)
    want = jw.draw_scenario(seed, jspec)
    got = tw.draw_scenario(seed, tspec, device="cpu")
    _assert_scenario_bitwise(got, want)
    if tiered:
        assert len(set(host(got.tier).tolist())) > 1


def test_scenario_from_numpy_carries_jax_leaves_bitwise():
    """The weights-carried-across function: JAX leaves -> port tensors."""
    jspec, _ = _specs(True, N=12, M=4)
    want = jw.draw_scenario(5, jspec)
    got = scenario_to_torch(want)
    _assert_scenario_bitwise(got, want)
    assert got.tier.dtype == torch.int32 and got.gain.dtype == torch.float32


@pytest.mark.parametrize("C,spec_kw,n_range", [
    (4, dict(N=8, M=2), (5, 8)),
    (16, {}, (24, 56)),     # the README fleet's spec and user range
], ids=["small", "default_spec"])
def test_draw_fleet_bitwise(C, spec_kw, n_range):
    jspec, tspec = _specs(False, **spec_kw)
    want = jb.draw_fleet(0, C, jspec, n_range=n_range)
    got = tb.draw_fleet(0, C, tspec, n_range=n_range, device="cpu")
    _assert_scenario_bitwise(got.cells, want.cells)
    assert_bitwise(got.mask, want.mask, "mask")
    assert_bitwise(got.n_users, want.n_users, "n_users")
    carried = fleet_to_torch(want)
    _assert_scenario_bitwise(carried.cells, want.cells)
    # A cell cut back out of the fleet is the standalone scenario.
    i = C // 2
    _assert_scenario_bitwise(got.cell(i), want.cell(i))


def test_stack_scenarios_pads_by_replicating_last_user():
    jspec, tspec = _specs(False, M=3)
    jcells = [jw.draw_scenario(s, dataclasses.replace(jspec, N=n))
              for s, n in ((1, 4), (2, 7))]
    tcells = [scenario_to_torch(c) for c in jcells]
    want = jb.fleet_from_scenarios(jcells)
    got = tb.fleet_from_scenarios(tcells)
    _assert_scenario_bitwise(got.cells, want.cells)
    assert_bitwise(got.mask, want.mask, "mask")
    with pytest.raises(ValueError):
        tb.stack_scenarios([tcells[0],
                            tw.draw_scenario(0, dataclasses.replace(
                                tspec, N=3, M=2), device="cpu")])


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_nearest_edge_assignment_matches(seed):
    jspec, tspec = _specs(False, N=20, M=4)
    want = jw.nearest_edge_assignment(jw.draw_scenario(seed, jspec))
    got = tw.nearest_edge_assignment(tw.draw_scenario(seed, tspec,
                                                      device="cpu"))
    assert_bitwise(got, want)


def test_cloud_terms_and_budgets_match():
    jspec, _ = _specs(False, N=10, M=3)
    want = jw.draw_scenario(4, jspec)
    got = scenario_to_torch(want)
    for name in ("rate_cloud", "T_cloud", "E_cloud"):
        np.testing.assert_allclose(host(getattr(got, name)()),
                                   host(getattr(want, name)()), rtol=1e-6,
                                   err_msg=name)
    assert_bitwise(got.B_total, want.B_total)
    assert_bitwise(got.B_open, want.B_open)
    assert (got.N, got.M) == (want.N, want.M)


def test_constants_and_path_loss_match():
    d = np.array([0.0, 1e-5, 0.05, 0.3, 0.7])
    np.testing.assert_array_equal(tw.path_loss_db(d), jw.path_loss_db(d))
    assert tw.LN2 == jw.LN2
    assert tw.dbm_to_watt(23.0) == jw.dbm_to_watt(23.0)


def _mutations():
    return {
        "ok": {},
        "gain_shape": {"gain": lambda x: x[:, :-1]},
        "c_negative": {"c": lambda x: -x},
        "alpha_zero": {"alpha": lambda x: x * 0},
        "tier_shape": {"tier": lambda x: x[:-1]},
    }


@pytest.mark.parametrize("case", list(_mutations()))
def test_validate_scenario_agrees(case):
    jspec, _ = _specs(False, N=6, M=2)
    jscn = jw.draw_scenario(2, jspec)
    leaves = to_numpy(jscn)
    for name, fn in _mutations()[case].items():
        leaves[name] = fn(leaves[name])
    jbad = jscn._replace(**{k: leaves[k] for k in _mutations()[case]})
    tbad = tw.scenario_from_numpy(leaves, "cpu")
    outcomes = []
    for validate, scn in ((jw.validate_scenario, jbad),
                          (tw.validate_scenario, tbad)):
        try:
            validate(scn)
            outcomes.append("ok")
        except ValueError:
            outcomes.append("ValueError")
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] == "ok") == (case == "ok")


@pytest.mark.parametrize("kw", [
    dict(N=0), dict(alpha=-1.0), dict(c_range=(5.0, 1.0)),
    dict(tiers=("not-a-tier",)),
])
def test_scenario_spec_validation_agrees(kw):
    for mod in (jw, tw):
        with pytest.raises(ValueError):
            mod.ScenarioSpec(**kw)
    for mod in (jw, tw):
        with pytest.raises(ValueError):
            mod.ScenarioSpec(tiers=(mod.DeviceTier("x", prob=0.0),))


def test_edge_mask_crosses_and_prices_as_jax():
    """A JAX scenario with an edge mask arrives bitwise; its open
    bandwidth and nearest-open-edge seeding equal the JAX ones."""
    jscn = jw.draw_scenario(0, _specs(False, N=6, M=3)[0])._replace(
        edge_mask=jnp.asarray([True, False, True]))
    d = to_numpy(jscn)
    tscn = tw.scenario_from_numpy(d, "cpu")
    assert tscn.edge_mask.dtype == torch.bool
    assert_bitwise(tscn.edge_mask, d["edge_mask"])
    assert_bitwise(tscn.B_open, jscn.B_open)
    assert_bitwise(tw.nearest_edge_assignment(tscn),
                   jw.nearest_edge_assignment(jscn))
    tw.validate_scenario(tscn)


def test_entry_points_default_to_cuda():
    """The CPU is used only when asked for."""
    from repro_torch.fleet.service import PlanningService
    from repro_torch.launch import serve

    for fn in (tw.draw_scenario, tw.scenario_from_numpy, tb.draw_fleet,
               tb.fleet_from_numpy, PlanningService.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    args = serve.build_parser().parse_args(["--mode", "plan"])
    assert args.device == "cuda"


def test_port_imports_neither_jax_nor_repro():
    """``repro_torch`` stands alone: importing every module of it pulls in
    no JAX and nothing of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "repro" or n.startswith("repro."))
print("LOADED", len([n for n in sys.modules if n.startswith("repro_torch")]))
print("BAD", bad)
"""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 20
