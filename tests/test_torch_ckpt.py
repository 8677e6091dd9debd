"""The port's checkpoints (``repro_torch.ckpt``) and fault tolerance
(``repro_torch.runtime.fault``): ``tests/test_ckpt_fault.py``'s seven
contracts re-stated on torch, checkpoints crossing between the packages
bit for bit in both directions, and ``reassign_after_edge_loss`` giving
the JAX package's assignment (the quick re-homing, and through TSIA at
trimmed caps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_bitwise, cnn_params_numpy,  # noqa: E402
                           scenario_to_torch)
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import tsia as jtsia  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro_torch.ckpt import (CheckpointManager, restore_tree,  # noqa: E402
                              save_tree)
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(5, dtype=torch.int32)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"]]


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_tree(tmp_path / "x.npz", t, step=7)
    got, meta = restore_tree(tmp_path / "x.npz", template=t)
    assert meta["step"] == 7
    for a, b in zip(_leaves(t), _leaves(got)):
        assert_bitwise(b, a)
    # Without a template: the flat key paths, as numpy.
    flat, _ = restore_tree(tmp_path / "x.npz")
    assert sorted(flat) == ["a", "b/c"]


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        m.save(s, _tree(s))
    assert m.steps() == [3, 4]
    assert m.latest_step() == 4
    got, meta = m.restore(template=_tree())
    assert meta["step"] == 4
    assert_bitwise(got["a"], _tree(4)["a"])


def test_resume_after_simulated_crash(tmp_path):
    """Training resumes from the newest intact checkpoint after a crash."""
    m = CheckpointManager(tmp_path, keep=3)
    state = _tree(1)
    for step in range(3):
        state = {"a": state["a"] + 1.0, "b": state["b"]}
        m.save(step + 1, state)
    # crash: newest file is torn
    newest = m._path(3)
    data = newest.read_bytes()
    newest.write_bytes(data[: len(data) // 2])
    tree, step = fault.recover_from_checkpoint(m, _tree())
    assert step == 2            # fell back to the intact one
    assert tree is not None
    assert_bitwise(tree["a"], _tree(1)["a"] + 1.0 + 1.0)


def test_failure_detector_marks_dead():
    det = fault.FailureDetector(timeout_s=10.0, max_missed=2)
    det.heartbeat(0, now=0.0)
    det.heartbeat(1, now=0.0)
    assert det.sweep(now=5.0) == []
    det.heartbeat(0, now=12.0)
    det.sweep(now=15.0)          # worker 1 missed once
    newly = det.sweep(now=30.0)  # worker 1 missed twice -> dead
    assert 1 in det.dead and 1 in newly
    assert 0 in det.alive()


@pytest.mark.parametrize("n", [256, 240, 244, 7, 1, 96, 33])
def test_elastic_remesh_shapes(n):
    assert fault.elastic_remesh(n) == jfault.elastic_remesh(n)
    assert fault.elastic_remesh(n, prefer_model=4) \
        == jfault.elastic_remesh(n, prefer_model=4)
    if n == 256:
        assert fault.elastic_remesh(256) == (16, 16)
        assert fault.elastic_remesh(240, prefer_model=16) == (15, 16)
        assert fault.elastic_remesh(244, prefer_model=16) == (61, 4)
        assert fault.elastic_remesh(7) == (7, 1)


def test_reassign_after_edge_loss():
    scn = jw.draw_scenario(0)
    tscn = scenario_to_torch(scn)
    assign = np.asarray(jw.nearest_edge_assignment(scn))
    for dead in ({int(assign[0])}, {0, 2}, {1, 2, 3, 4}):
        new = fault.reassign_after_edge_loss(tscn, assign, dead)
        assert not np.isin(new, list(dead)).any()
        assert new.shape == assign.shape
        np.testing.assert_array_equal(
            new, jfault.reassign_after_edge_loss(scn, assign, dead))
    with pytest.raises(RuntimeError, match="no edge"):
        fault.reassign_after_edge_loss(tscn, assign, set(range(5)))


def test_reassign_through_tsia_matches_jax():
    """quick=False: TSIA from the re-homed pattern; the JAX side composes
    the same two steps at the same trimmed caps (its function has no caps
    argument)."""
    scn = jw.draw_scenario(1, dataclasses.replace(jw.ScenarioSpec(), N=6,
                                                  M=3))
    assign = np.asarray(jw.nearest_edge_assignment(scn))
    dead = {int(assign[0])}
    quick = jfault.reassign_after_edge_loss(scn, assign, dead)
    want = jtsia.solve(scn, lam=1.0, cfg=jsroa.SroaConfig(**CAPS),
                       init_assign=quick, max_iters_per_stage=16).assign
    got = fault.reassign_after_edge_loss(
        scenario_to_torch(scn), assign, dead, quick=False,
        cfg=tsroa.SroaConfig(**CAPS))
    np.testing.assert_array_equal(got, want)


def test_atomic_save_never_leaves_partial(tmp_path):
    """A save either fully lands or leaves the old file intact."""
    p = tmp_path / "c.npz"
    save_tree(p, _tree(0), step=1)
    before = p.read_bytes()
    # the temp-write-rename protocol means p always parses
    save_tree(p, _tree(1), step=2)
    got, meta = restore_tree(p)
    assert meta["step"] == 2
    assert len(before) > 0
    assert list(tmp_path.iterdir()) == [p]        # no temp file left


@pytest.fixture(scope="module")
def cnn_weights():
    cfg = jcnn.PAPER_CNNS["cifar10"]
    return cfg, cnn_params_numpy(cfg, 3)


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path, cnn_weights):
    cfg, w = cnn_weights
    jckpt.CheckpointManager(tmp_path).save(5, jax.tree.map(jnp.asarray, w))
    tcfg = tcnn.PAPER_CNNS["cifar10"]
    template = tcnn.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got, step = fault.recover_from_checkpoint(CheckpointManager(tmp_path),
                                              template)
    assert step == 5
    for layer in w:
        for k in w[layer]:
            assert_bitwise(got[layer][k], w[layer][k], f"{layer}/{k}")


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, cnn_weights):
    cfg, w = cnn_weights
    tw = tcnn.params_from_numpy(w, tcnn.PAPER_CNNS["cifar10"], "cpu")
    CheckpointManager(tmp_path).save(9, tw, extra={"by": "port"})
    template = jax.tree.map(jnp.zeros_like, w)
    got, step = jfault.recover_from_checkpoint(
        jckpt.CheckpointManager(tmp_path), template)
    assert step == 9
    for layer in w:
        for k in w[layer]:
            assert_bitwise(got[layer][k], w[layer][k], f"{layer}/{k}")
