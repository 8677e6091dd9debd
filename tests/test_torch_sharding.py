"""Port parity: the mesh, sharding and dry-run layer
(``repro_torch.runtime.sharding``, ``launch/mesh``, ``configs/shapes``,
``launch/dryrun``, ``fed.hfl_lm``'s stacked structures) against the JAX
package.

The JAX side runs once, in a subprocess that forces 512 host devices in
its own environment and imports ``repro.launch.dryrun`` there (that
module sets ``XLA_FLAGS`` at import; no pytest worker imports it), and
returns JSON.  Held exactly: every parameter's and optimizer-state leaf's
spec and shard shape on both production meshes for every arch at full
size, the argument bytes of every applicable cell at 16 x 16, the shape
sets and abstract structures, and the local slices of a dim split over two
mesh axes (2 x 2 x 2).  The FLOP and byte arithmetic to 1e-12 relative.
Then the port's own: ``run_cell`` on a fake 2 x 4 mesh (dense and moe,
train and prefill), the dispatch-mode counter on a loop of collectives,
the FLOPs of a 1 x 1 mesh against the unsharded count, and the cells that
are skipped (the encoder's decode; a train cell whose backward
recurrences would run too many time steps as Python loops) beside one
that runs (zamba2-7b's prefill_32k, its recurrences one op a layer).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.fed import hfl_lm  # noqa: E402
from repro_torch.launch import dryrun as d  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.runtime import sharding as sh  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}

JAX_SCRIPT = textwrap.dedent("""
    import json
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import configs, optim
    from repro.configs import shapes as shp
    from repro.fed import hfl_lm
    from repro.launch import dryrun as d
    from repro.launch import mesh as ml
    from repro.models import transformer as tf
    from repro.runtime import sharding as sh

    def path_str(path):
        return "/".join(str(getattr(k, "key", k)) for k in path)

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    def shard_info(mesh, rules, axes, abstract):
        shs = d.shardings_for(mesh, rules, axes, abstract)
        leaves = jax.tree_util.tree_flatten_with_path(abstract)[0]
        out = {}
        for (path, a), s in zip(leaves, jax.tree.leaves(shs)):
            out[path_str(path)] = {
                "spec": [entry(e) for e in s.spec] + [None] * (
                    len(a.shape) - len(s.spec)),
                "shard": list(s.shard_shape(a.shape)),
                "dtype": str(a.dtype), "shape": list(a.shape)}
        return out

    def tree_json(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))[0]
        return {path_str(p): (list(map(entry, v)) if isinstance(v, tuple)
                              else [list(v.shape), str(v.dtype)])
                for p, v in leaves}

    out = {"specs": {}, "bytes": {}, "terms": {}, "applicable": {},
           "batch": {}, "abstract": {}}
    out["shapes"] = {k: [s.name, s.kind, s.seq_len, s.global_batch]
                     for k, s in shp.SHAPES.items()}
    for mp in (False, True):
        mesh = ml.make_production_mesh(multi_pod=mp)
        rules = sh.default_rules(multi_pod=mp)
        tag = "multipod" if mp else "singlepod"
        for arch, cfg in configs.ARCHS.items():
            p_axes, p_abs = tf.logical_axes(cfg), tf.abstract_params(cfg)
            opt = optim.get_optimizer(cfg.optimizer)
            o_abs = jax.eval_shape(opt.init, p_abs)
            o_axes = d.opt_state_axes(cfg.optimizer, p_axes)
            out["specs"][f"{tag}/{arch}"] = {
                "params": shard_info(mesh, rules, p_axes, p_abs),
                "opt_state": shard_info(mesh, rules, o_axes, o_abs)}
            for name, shape in shp.SHAPES.items():
                ok, reason = shp.applicable(cfg, shape)
                out["applicable"][f"{arch}/{name}"] = [ok, reason]
                if not ok:
                    continue
                for n in (256, 512):
                    mf, tot, act = d.model_flops(cfg, shape)
                    t = d.analytic_terms(cfg, shape, n)
                    out["terms"][f"{arch}/{name}/{n}"] = dict(
                        t, model_flops=mf, total=tot, active=act)
                if mp:
                    continue
                b_abs = shp.batch_specs(cfg, shape)
                b_axes = shp.batch_logical_axes(cfg, shape)
                out["batch"][f"{arch}/{name}"] = {
                    "specs": tree_json(b_abs), "axes": tree_json(b_axes)}
                infos = [shard_info(mesh, rules, p_axes, p_abs),
                         shard_info(mesh, rules, b_axes, b_abs)]
                if shape.kind == "train":
                    infos.append(shard_info(mesh, rules, o_axes, o_abs))
                out["bytes"][f"{arch}/{name}"] = sum(
                    int(np.prod(i["shard"])) * np.dtype(i["dtype"]).itemsize
                    for info in infos for i in info.values())
            if not mp:
                out["abstract"][arch] = {
                    "params": tree_json(p_abs), "axes": tree_json(p_axes),
                    "stacked": tree_json(hfl_lm.stacked_abstract(cfg, 2)),
                    "stacked_axes": tree_json(hfl_lm.stacked_axes(cfg))}

    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    ids = {dev.id: tuple(int(c) for c in np.argwhere(mesh.devices == dev)[0])
           for dev in mesh.devices.flat}
    out["slices"] = {}
    for spec in ((("pod", "data"), "model"), ("data", ("pod", "model")),
                 (None, ("pod", "data", "model"))):
        m = NamedSharding(mesh, P(*spec)).devices_indices_map((16, 8))
        out["slices"][json.dumps(spec)] = [
            [list(ids[dev.id]), [[s.start or 0, s.stop or n]
                                 for s, n in zip(idx, (16, 8))]]
            for dev, idx in m.items()]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ref():
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", "/root"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=512"}
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT],
                         capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _paths(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict, keys sorted (JAX's order)."""
    out = {}
    for k in sorted(tree):
        p = f"{prefix}{k}"
        if isinstance(tree[k], dict):
            out.update(_paths(tree[k], p + "/"))
        else:
            out[p] = tree[k]
    return out


def _entry(e):
    return list(e) if isinstance(e, tuple) else e


def _dtype(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["singlepod", "multipod"])
def test_specs_and_shard_shapes_match_jax(ref, multi_pod):
    sizes = MESHES[multi_pod]
    rules = sh.default_rules(multi_pod=multi_pod)
    tag = "multipod" if multi_pod else "singlepod"
    for arch, cfg in configs.ARCHS.items():
        p_axes, p_abs = tf.logical_axes(cfg), tf.abstract_params(cfg)
        opt = d.optim.get_optimizer(cfg.optimizer)
        trees = {"params": (p_axes, p_abs),
                 "opt_state": (d.opt_state_axes(cfg.optimizer, p_axes),
                               opt.init(p_abs))}
        for part, (axes, abstract) in trees.items():
            want = ref["specs"][f"{tag}/{arch}"][part]
            axes, abstract = _paths(axes), _paths(abstract)
            assert sorted(axes) == sorted(want), (arch, part)
            for path, a in axes.items():
                t = abstract[path]
                spec = rules.spec(a, sizes, t.shape)
                got = {"spec": [_entry(e) for e in spec],
                       "shard": list(d.local_shape(sizes, spec, t.shape)),
                       "dtype": _dtype(t), "shape": list(t.shape)}
                assert got == want[path], (arch, part, path)


def test_argument_bytes_match_jax(ref):
    rules = sh.default_rules()
    n = 0
    for arch, cfg in configs.ARCHS.items():
        for name, shape in shp.SHAPES.items():
            if not shp.applicable(cfg, shape)[0]:
                continue
            got = d.argument_bytes(cfg, shape, MESHES[False], rules)
            assert got == ref["bytes"][f"{arch}/{name}"], (arch, name)
            n += 1
    assert n == len(ref["bytes"]) > 0


def _tree_json(tree):
    return {p: (list(map(_entry, v)) if isinstance(v, tuple)
                else [list(v.shape), _dtype(v)])
            for p, v in _paths(tree).items()}


def test_shapes_and_abstract_structures_match_jax(ref):
    assert {k: [s.name, s.kind, s.seq_len, s.global_batch]
            for k, s in shp.SHAPES.items()} == ref["shapes"]
    assert configs.SHAPES is shp.SHAPES
    for arch, cfg in configs.ARCHS.items():
        for name, shape in shp.SHAPES.items():
            ok, reason = shp.applicable(cfg, shape)
            assert [ok, reason] == ref["applicable"][f"{arch}/{name}"]
            if ok:
                want = ref["batch"][f"{arch}/{name}"]
                assert _tree_json(shp.batch_specs(cfg, shape)) == \
                    want["specs"], (arch, name)
                assert _tree_json(shp.batch_logical_axes(cfg, shape)) == \
                    want["axes"], (arch, name)
        want = ref["abstract"][arch]
        assert _tree_json(tf.abstract_params(cfg)) == want["params"]
        assert _tree_json(tf.logical_axes(cfg)) == want["axes"]
        assert _tree_json(hfl_lm.stacked_abstract(cfg, 2)) == \
            want["stacked"]
        assert _tree_json(hfl_lm.stacked_axes(cfg)) == want["stacked_axes"]
        assert all(t.device.type == "meta"
                   for t in _paths(tf.abstract_params(cfg)).values())


def test_arithmetic_matches_jax(ref):
    keys = ("flops_model_global", "flops_executed_global",
            "flops_executed_per_device", "hbm_bytes_per_device")
    for key, want in ref["terms"].items():
        arch, name, n = key.split("/")
        cfg, shape = configs.get(arch), shp.SHAPES[name]
        mf, total, active = d.model_flops(cfg, shape)
        assert (total, active) == (want["total"], want["active"]), key
        np.testing.assert_allclose(mf, want["model_flops"], rtol=1e-12)
        t = d.analytic_terms(cfg, shape, int(n))
        for k in keys:
            np.testing.assert_allclose(t[k], want[k], rtol=1e-12,
                                       err_msg=f"{key} {k}")
        assert t["compute_term_s"] == t["flops_executed_per_device"] / \
            mesh_lib.PEAK_FLOPS_BF16
        assert t["memory_term_s"] == t["hbm_bytes_per_device"] / \
            mesh_lib.HBM_BW
    assert (mesh_lib.PEAK_FLOPS_BF16, mesh_lib.HBM_BW, mesh_lib.NET_BW,
            mesh_lib.NVLINK_BW) == (989e12, 3.35e12, 50e9, 450e9)


def test_multi_axis_slices_match_jax(ref):
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_and_offset

    names = ("pod", "data", "model")
    rules = sh.ShardingRules(batch=None, ff=None, heads=None, qkv=None,
                             vocab=None, expert=None, expert_cap=None,
                             kv_batch=None, hfl_pod=None)

    class Mesh:                       # what placements() reads of a mesh
        mesh_dim_names = names
        mesh = torch.empty((2, 2, 2), device="meta")

    for key, want in ref["slices"].items():
        spec = tuple(tuple(e) if isinstance(e, list) else e
                     for e in json.loads(key))
        r = dataclasses.replace(rules, batch=spec[0], ff=spec[1])
        pl = r.placements(Mesh, ("batch", "ff"), (16, 8))
        for coord, slices in want:
            shape, off = local_and_offset((16, 8), (2, 2, 2), coord, pl)
            got = [[o, o + s] for o, s in zip(off, shape)]
            assert got == slices, (key, coord)


@pytest.fixture(scope="module")
def fake_cells():
    """run_cell on a fake 2 x 4 mesh at reduced() size: (dense, moe) x
    (train, prefill), with the argument bytes the spec arithmetic gives."""
    import torch.distributed as dist

    sizes = {"data": 2, "model": 4}
    out = {}
    for arch in ("qwen1.5-0.5b", "llama4-scout-17b-a16e"):
        cfg = configs.get(arch).reduced()
        for kind in ("train", "prefill"):
            shape = shp.ShapeSpec("small", kind, 16, 4)
            rec = d.run_cell(arch, shape, False, device_type="cpu", cfg=cfg,
                             mesh_shape=((2, 4), ("data", "model")))
            assert not dist.is_initialized()
            out[arch, kind] = rec, d.argument_bytes(
                cfg, shape, sizes, sh.default_rules())
    return out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_run_cell_on_a_fake_mesh(fake_cells, arch, kind):
    rec, arg_bytes = fake_cells[arch, kind]
    assert rec["status"] == "ok" and rec["n_devices"] == 8
    assert rec["mesh"] == "2x4"
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == arg_bytes > 0
    assert mem["output_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    for k in ("alias_size_in_bytes", "generated_code_size_in_bytes"):
        assert mem[k] is None
    assert rec["compile_s"] is None and rec["trace_s"] > 0
    coll = rec["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k != "total") > 0
    # FSDP: every step gathers its weights over data; a train step also
    # reduces its gradients back (reduce-scatter) and all-reduces norms
    assert rec["collective_counts"]["all-gather"] > 0
    if kind == "train":
        assert rec["collective_counts"]["reduce-scatter"] > 0
        assert rec["collective_counts"]["all-reduce"] > 0
        # the optimizer's state and the new parameters are outputs
        assert mem["output_size_in_bytes"] >= mem[
            "argument_size_in_bytes"] // 2
    assert rec["flops_per_device"] > 0
    assert rec["fits_80gb"] is True
    terms = rec["roofline"]
    assert terms["collective_term_s"] == coll["total"] / mesh_lib.NET_BW
    assert set(terms) >= {"compute_term_s", "memory_term_s"}


def test_step_counter_counts_a_collective_in_a_loop():
    """The counterpart of ``test_collective_bytes_loop_aware``: eager
    torch issues the loop's collective on every trip."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with d.fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.empty((8, 16), device="meta"), mesh,
                               (Partial(),), run_check=False)
        counter = d.StepCounter()
        with counter:
            for _ in range(4):
                x.redistribute(mesh, (Replicate(),))
    assert counter.collective_count == {"all-reduce": 4}
    assert counter.collectives() == {
        "all-gather": 0, "all-reduce": 4 * 8 * 16 * 4, "reduce-scatter": 0,
        "all-to-all": 0, "collective-permute": 0, "total": 4 * 8 * 16 * 4}


def test_flops_on_a_1x1_mesh_equal_the_unsharded_count():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = configs.get("qwen1.5-0.5b").reduced()
    shape = shp.ShapeSpec("small", "train", 16, 4)
    rec = d.run_cell("qwen1.5-0.5b", shape, False, device_type="cpu",
                     cfg=cfg, mesh_shape=((1, 1), ("data", "model")))
    args, _ = d.cell_arguments(cfg, shape)
    step = tf.make_train_step(cfg, d.optim.get_optimizer(cfg.optimizer))
    with FlopCounterMode(display=False) as fc:
        step(args["params"], args["opt_state"], args["batch"])
    assert rec["flops_per_device"] == fc.get_total_flops() > 0
    assert rec["collectives"]["total"] == 0


def test_cells_that_do_not_run():
    rec = d.run_cell("hubert-xlarge", "decode_32k", False, device_type="cpu")
    assert rec["status"] == "skipped" and "encoder" in rec["reason"]
    # the forward recurrences are one op a layer: the prefill runs
    rec = d.run_cell("zamba2-7b", "prefill_32k", False, device_type="cpu")
    assert rec["status"] == "ok" and rec["flops_per_device"] > 0
    assert d.scan_steps(configs.get("zamba2-7b"), shp.SHAPES[
        "long_500k"]) == 81


def test_the_dryrun_module_sets_nothing_at_import():
    code = ("import os, json; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.fed.distributed; "
            "import torch.distributed as dist; "
            "print(json.dumps([before == dict(os.environ), "
            "dist.is_initialized()]))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [True, False]


def test_an_open_process_group_stays_as_it_was(tmp_path):
    """The fake group refuses to replace a caller's default group, and
    ``run_cell`` then runs the cell in a child process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError):
            with d.fake_process_group(4):
                pass
        rec = d.run_cell("qwen1.5-0.5b", shp.ShapeSpec("small", "prefill",
                                                       16, 4),
                         False, device_type="cpu",
                         cfg=configs.get("qwen1.5-0.5b").reduced(),
                         mesh_shape=((1, 1), ("data", "model")))
        assert rec["status"] == "ok" and rec["n_devices"] == 1
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_tree_placements_follow_the_rules():
    from torch.distributed.tensor import Replicate, Shard

    cfg = configs.get("qwen1.5-0.5b")
    pl = sh.tree_placements(_FakeMesh, tf.logical_axes(cfg),
                            sh.default_rules(), _paths_to_tree(
                                tf.abstract_params(cfg)))
    # wq: (layers, d_model -> data, qkv -> model)
    assert pl["blocks"]["attn"]["wq"] == (Shard(1), Shard(2))
    # the embedding: (vocab 151,936 -> model, d_model 1,024 -> data)
    assert pl["embed"] == (Shard(1), Shard(0))
    assert pl["final_ln"] == (Shard(0), Replicate())
    # hubert's vocab of 504 does not divide over 16: replicated
    hub = sh.tree_placements(_FakeMesh, tf.logical_axes(configs.get(
        "hubert-xlarge")), sh.default_rules(), _paths_to_tree(
        tf.abstract_params(configs.get("hubert-xlarge"))))
    assert hub["lm_head"] == (Shard(0), Replicate())


class _FakeMesh:
    """What the placements read of a 16 x 16 ``DeviceMesh``."""
    mesh_dim_names = ("data", "model")
    mesh = torch.empty((16, 16), device="meta")


def _paths_to_tree(tree):
    """The shapes of a tree of tensors."""
    return {k: _paths_to_tree(v) if isinstance(v, dict) else v.shape
            for k, v in tree.items()}


def test_sharder_is_the_identity_without_a_mesh():
    shard = sh.make_sharder(None, sh.default_rules())
    x = torch.arange(6.0)
    assert shard(x, "batch") is x
    assert shard.mesh is None and shard.rules == sh.default_rules()
    assert sh.cell_mesh(None) is None and sh.cell_mesh(["cpu"]) is None
    assert sh.cell_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert mesh_lib.mesh_shape(True) == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert mesh_lib.mesh_device_count(True) == 512 == 2 * math.prod(
        mesh_lib.mesh_shape(False)[0])
