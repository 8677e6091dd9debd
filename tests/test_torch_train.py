"""The port's training pipeline (``python -m repro_torch.launch.train``)
against the same steps composed from the JAX package's functions.

The port's ``main`` runs on the CPU on the JAX side's initial weights
(``w0=``, in the JAX package's layout) and plans at trimmed caps with the fused solve (``sroa_cfg=``); the JAX side
composes ``repro.launch.train``'s steps at the same caps on the jnp nest
(its CLI has no caps flag).  The assignment must be identical and R within
the reference's fused-vs-nest rtol 5e-3; the deadline to that rtol, the
participation masks equal, the accuracy history within one test sample.
A run stopped after 2 iterations and resumed to 4 must end bitwise equal
to an uninterrupted run with the same participation masks.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_bitwise, cnn_params_numpy  # noqa: E402
from repro.core import sroa as jsroa  # noqa: E402
from repro.core import tsia as jtsia  # noqa: E402
from repro.core import wireless as jw  # noqa: E402
from repro.core.system_model import evaluate as jevaluate  # noqa: E402
from repro.data import make_dataset, partition_to_users  # noqa: E402
from repro.fed import hfl as jhfl  # noqa: E402
from repro.fed import straggler as jst  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.core import sroa as tsroa  # noqa: E402
from repro_torch.core.system_model import evaluate  # noqa: E402
from repro_torch.fed import hfl as thfl  # noqa: E402
from repro_torch.fed import straggler as tst  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

CAPS = dict(b_iters=16, f_iters=10, p_iters=8, t_iters=10)
USERS, EDGES, ITERS = 6, 3, 2
ARGV = ["--dataset", "fashionmnist", "--users", str(USERS), "--edges",
        str(EDGES), "--device", "cpu", "--seed", "0"]
RTOL_FUSED = 5e-3


@pytest.fixture(scope="module")
def jax_pipeline():
    """``repro.launch.train.main``'s steps at trimmed caps."""
    cfg = jcnn.PAPER_CNNS["fashionmnist"]
    spec = dataclasses.replace(
        jw.ScenarioSpec(), N=USERS, M=EDGES, D_range=(50, 90),
        s_bytes=float(jcnn.param_bytes(cfg)))
    scn = jw.draw_scenario(0, spec)
    plan = jtsia.solve(scn, lam=1.0, cfg=jsroa.SroaConfig(**CAPS))
    res = plan.sroa
    cb = jevaluate(scn, plan.assign, res.b, res.f, res.p, 1.0)
    delays = jst.per_user_delay(scn, plan.assign, res.b, res.f, res.p)
    deadline = jst.over_provision_deadline(delays, 0.9)
    draw = jst.jittered_participation(delays, deadline, seed=0)
    masks = []

    def participate(i):
        masks.append(draw(i))
        return masks[-1]

    ds = make_dataset("fashionmnist", n_train=4000, n_test=800,
                      shape=(28, 28, 1), seed=0)
    x_u, y_u, mask, sizes = partition_to_users(
        ds.x_train, ds.y_train, np.asarray(np.asarray(scn.D), int), seed=0)
    w0 = cnn_params_numpy(cfg, bias=0.0)       # as init_params draws them
    w, hist = jhfl.run_hfl(cfg, w0, x_u, y_u, mask, sizes, plan.assign,
                           jhfl.HflConfig(L=2, K=2, I=ITERS, lr=0.2),
                           x_test=ds.x_test, y_test=ds.y_test,
                           participate_fn=participate)
    return dict(plan=plan, E=float(cb.E_sum), deadline=deadline,
                masks=masks, hist=hist, w=jax.tree.map(np.asarray, w),
                w0=w0, n_test=len(ds.y_test))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("train_ckpt")


@pytest.fixture(scope="module")
def port_run(jax_pipeline, ckpt_dir):
    return ttrain.main(ARGV + ["--iters", str(ITERS), "--ckpt-dir",
                               str(ckpt_dir)], w0=jax_pipeline["w0"],
                       sroa_cfg=tsroa.SroaConfig(**CAPS, fused=True))


def test_plan_matches_jax(port_run, jax_pipeline):
    want = jax_pipeline["plan"]
    np.testing.assert_array_equal(port_run.plan.assign, want.assign)
    np.testing.assert_allclose(port_run.plan.R, want.R, rtol=RTOL_FUSED)
    np.testing.assert_allclose(port_run.report["objective_R"], want.R,
                               rtol=RTOL_FUSED)
    np.testing.assert_allclose(port_run.report["energy_J"], jax_pipeline["E"],
                               rtol=RTOL_FUSED)
    # The plan's R is the cost model's at its own (assign, b, f, p).
    res = port_run.plan.sroa
    cb = evaluate(port_run.scenario, torch.as_tensor(port_run.plan.assign),
                  res.b, res.f, res.p, 1.0)
    np.testing.assert_allclose(float(cb.R), port_run.plan.R, rtol=1e-5)


def test_deadline_masks_and_training_match_jax(port_run, jax_pipeline):
    np.testing.assert_allclose(port_run.deadline, jax_pipeline["deadline"],
                               rtol=RTOL_FUSED)
    res = port_run.plan.sroa
    delays = tst.per_user_delay(port_run.scenario, port_run.plan.assign,
                                res.b, res.f, res.p)
    draw = tst.jittered_participation(delays, port_run.deadline, seed=0)
    for i, want in enumerate(jax_pipeline["masks"]):
        np.testing.assert_array_equal(draw(i), want, err_msg=f"round {i}")
    hist = port_run.history
    assert hist["iter"] == jax_pipeline["hist"]["iter"] == [0, 1]
    np.testing.assert_allclose(hist["acc"], jax_pipeline["hist"]["acc"],
                               atol=1.0 / jax_pipeline["n_test"])
    assert port_run.report["acc"] == hist["acc"]
    assert port_run.report["global_iters"] == ITERS
    for layer, leaves in jax_pipeline["w"].items():
        for k, want in leaves.items():
            np.testing.assert_allclose(port_run.weights[layer][k].numpy(),
                                       want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{layer}/{k}")


def test_resume_ends_bitwise_an_uninterrupted_run(port_run, jax_pipeline,
                                                  ckpt_dir):
    """Stopped after 2 iterations, resumed to 4.  The resumed run draws
    its participation masks anew from the seed (as the JAX entry point
    does), so the uninterrupted run replays masks 0, 1, 0, 1."""
    saved, meta = CheckpointManager(ckpt_dir).restore(port_run.weights)
    assert meta["step"] == ITERS
    for a, b in zip(tcnn.tree_leaves(saved),
                    tcnn.tree_leaves(port_run.weights)):
        assert_bitwise(a, b)
    resumed = ttrain.main(
        ARGV + ["--iters", "4", "--resume", "--ckpt-dir", str(ckpt_dir)],
        w0=jax_pipeline["w0"], sroa_cfg=tsroa.SroaConfig(**CAPS, fused=True))
    assert resumed.report["global_iters"] == 2
    assert resumed.history["iter"] == [2, 3]
    assert CheckpointManager(ckpt_dir).steps() == [2, 3, 4]

    res = port_run.plan.sroa
    delays = tst.per_user_delay(port_run.scenario, port_run.plan.assign,
                                res.b, res.f, res.p)
    draw = tst.jittered_participation(delays, port_run.deadline, seed=0)
    masks = [draw(0), draw(1)] * 2
    cfg = tcnn.PAPER_CNNS["fashionmnist"]
    ds = make_dataset("fashionmnist", n_train=4000, n_test=800,
                      shape=(28, 28, 1), seed=0)
    x_u, y_u, mask, sizes = partition_to_users(
        ds.x_train, ds.y_train,
        np.asarray(port_run.scenario.D.numpy(), int), seed=0)
    w, hist = thfl.run_hfl(
        cfg, tcnn.params_from_numpy(jax_pipeline["w0"], cfg, "cpu"), x_u,
        y_u, mask, sizes, port_run.plan.assign,
        thfl.HflConfig(L=2, K=2, I=4, lr=0.2), x_test=ds.x_test,
        y_test=ds.y_test, participate_fn=lambda i: masks[i], device="cpu")
    assert hist["acc"][2:] == resumed.history["acc"]
    for a, b in zip(tcnn.tree_leaves(resumed.weights), tcnn.tree_leaves(w)):
        assert_bitwise(a, b)


def test_main_refuses_a_missing_card(tmp_path):
    """``--device cuda`` (the default) never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    with pytest.raises((AssertionError, RuntimeError)):
        ttrain.main(["--users", "4", "--edges", "2", "--iters", "1",
                     "--ckpt-dir", str(tmp_path)])
