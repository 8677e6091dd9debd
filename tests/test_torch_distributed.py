"""Port parity on real ranks (gloo, CPU): Algorithm 1 with the clients
split over 4 processes (``repro_torch.fed.distributed``) against JAX's and
the port's single-process ``global_iteration``; the sharded prefill of a
dense, a moe and an xlstm model (with a decode step from its cache, the
loss and its gradient) on a 2 x 2 (data, model) mesh against the
unsharded port.

The reference's own test (``tests/test_fed_distributed.py``: fashionmnist,
800 samples, 16 users over 4 edges, L = 1, K = 2, lr 0.1) runs 8 forced
host devices over (pod 2, data 4); here 4 ranks over (pod 2, data 2),
within its bound of 2e-5 absolute, with every user and with one user
dropped.  The sharded prefill's logits and the decode step's lie within
1e-5 of max |logit| of the unsharded ones in f32, the loss within 1e-5
and each parameter's gradient within 1e-5 of its max |g|; the moe model
runs under the dry-run's ``moe_local`` variant, so its group-local
dispatch sees real data.  Each test spawns its ranks once.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import cnn_params_numpy  # noqa: E402
from _torch_dist_ranks import sharded_prefill  # noqa: E402
from repro.data import make_dataset, partition_to_users  # noqa: E402
from repro.fed import hfl as jhfl  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.fed import distributed as tdist  # noqa: E402
from repro_torch.fed import hfl as thfl  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

N, M, WORLD = 16, 4, 4
HFL_ATOL = 2e-5                  # tests/test_fed_distributed.py's bound
LOGIT_RTOL = 1e-5


def test_distributed_hfl_matches_jax_and_the_single_process_port():
    ds = make_dataset("fashionmnist", n_train=800, n_test=100)
    x_u, y_u, mask, sizes = partition_to_users(ds.x_train, ds.y_train,
                                               np.full(N, 40))
    jcfg = jcnn.PAPER_CNNS["fashionmnist"]
    tcfg = tcnn.PAPER_CNNS["fashionmnist"]
    w0 = cnn_params_numpy(jcfg, bias=0.0)
    assign = np.arange(N) % M
    onehot = np.eye(M, dtype=np.float32)[assign]
    hcfg = jhfl.HflConfig(L=1, K=2, I=1, lr=0.1)
    tcfg_h = thfl.HflConfig(**dataclasses.asdict(hcfg))
    szs = np.asarray(sizes, np.float32)
    dropped = np.ones(N, np.float32)
    dropped[5] = 0.0
    parts = [np.ones(N, np.float32), dropped]

    data = tuple(torch.tensor(a) for a in (x_u, y_u, mask, szs, onehot))
    w = tcnn.params_from_numpy(w0, tcfg, "cpu")
    ranks = tdist.run_ranks(
        WORLD, "gloo", tdist.global_iteration_on_ranks, tcfg, tcfg_h, M,
        True, w, data, [torch.tensor(p) for p in parts], 0, device="cpu")

    for i, part in enumerate(parts):
        want_jax = jhfl.global_iteration(
            jcfg, hcfg, w0, jnp.asarray(x_u), jnp.asarray(y_u),
            jnp.asarray(mask), jnp.asarray(szs), jnp.asarray(onehot),
            jnp.asarray(part))
        want_port = thfl.global_iteration(tcfg, tcfg_h, w, *data,
                                          torch.tensor(part))
        for r, out in enumerate(ranks):
            got = out["w"][i]
            for layer in want_port:
                for k in want_port[layer]:
                    g = got[layer][k].numpy()
                    np.testing.assert_allclose(
                        g, np.asarray(want_jax[layer][k]), rtol=0,
                        atol=HFL_ATOL, err_msg=f"rank {r} {layer}/{k} jax")
                    np.testing.assert_allclose(
                        g, want_port[layer][k].numpy(), rtol=0,
                        atol=HFL_ATOL, err_msg=f"rank {r} {layer}/{k} port")
    assert ranks[0]["bytes"] == 3 * 4 * M * (
        sum(t.numel() for t in tcnn.tree_leaves(w)) + 1)


RUNS = (("qwen1.5-0.5b", "baseline"), ("llama4-scout-17b-a16e", "moe_local"),
        ("xlstm-125m", "baseline"))


def test_sharded_prefill_matches_the_unsharded_port():
    ranks = tdist.run_ranks(WORLD, "gloo", sharded_prefill, RUNS,
                            device="cpu")
    for i, run in enumerate(RUNS):
        for r, outs in enumerate(ranks):
            out = outs[i]
            want = out["want"]
            err = float((out["logits"] - want).abs().max())
            assert err <= LOGIT_RTOL * float(want.abs().max()), (run, r, err)
            err = float((out["step"] - out["want_step"]).abs().max())
            assert err <= LOGIT_RTOL * float(out["want_step"].abs().max()), \
                (run, r, err)
            assert abs(float(out["loss"]) - float(out["want_loss"])) <= \
                LOGIT_RTOL * abs(float(out["want_loss"])), (run, r)
            for j, (g, w) in enumerate(zip(out["grads"],
                                           out["want_grads"])):
                err = float((g - w).abs().max())
                assert err <= LOGIT_RTOL * float(w.abs().max()), \
                    (run, r, j, err)
            assert len(out["grads"]) == len(out["want_grads"]) > 0
            # the logits leave sharded: batch over data, vocab over model
            assert out["placements"] == [("Shard", 0), ("Shard", 2)], run
            # every rank computed the same model
            torch.testing.assert_close(want, ranks[0][i]["want"], rtol=0,
                                       atol=0)
