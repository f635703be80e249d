"""Sharded checkpoints on a mesh of gloo ranks, against the JAX package's
laws (tests/test_resilience.py:219-309; ``tests/torch_ckpt_pairs.py``
runs the ranks):

* a save and restore under dp = 2, dp = 2 x tp = 2 and dp = 2 with its
  weights split over the data axis gives the saved params bit for bit,
  and the next step of both models is bitwise the same
  (``test_roundtrip_dp_tp_sharded``);
* each distinct shard is written once, by the lowest rank that holds it:
  the pieces of every tensor tile it exactly, and a replica is in one file;
* ``strategy.json`` is the JAX package's ``Strategy.to_json`` of the same
  strategy, and ``meta.json`` records the real mesh with the checksums of
  every rank's files;
* a restore onto another topology is host-staged and bitwise: dp 2 and
  FSDP dp 2 to one device, one device to dp 2, dp 2 to dp 2 x tp 2;
* a pipeline model (pp 2) saves its synced-back params, and the next fit
  of the saved and the restored model agrees within 1e-6
  (``test_roundtrip_pipeline``);
* a corrupt shard file is refused before any state is touched;
* a pipeline ``fit`` still refuses ``--checkpoint-dir``, ``--resume`` and
  ``--max-bad-steps`` by name (the JAX package ignores them there).
"""
import json
import os
import shutil

import numpy as np
import pytest

import torch_ckpt_pairs as cp
import torch_dist_pairs as tp
from torch_mesh_pairs import assert_trees_equal, data, jax_build

BERT = dict(model="bert", batch=8, optimizer="adam")


def _case(root, name, x, y, weights, **extra):
    np.savez(os.path.join(root, f"{name}_in.npz"), x=x, y=y,
             **tp.flat("w", weights), **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from flexflow_tpu_torch.execution.checkpoint import save_checkpoint

    root = str(tmp_path_factory.mktemp("mesh_ckpt"))
    weights = tp.build("bert", None, 8, seed=5).get_params_numpy()
    x, y = data("bert", 8, n=16)
    one = tp.build(**BERT, strategy=None)
    one.set_params_numpy(weights)
    one.fit(x, y, shuffle=False)
    one_path = save_checkpoint(one, os.path.join(root, "one"), step=2)
    sx = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    sy = np.random.default_rng(1).integers(0, 10, (16,)).astype(np.int32)
    cases2 = []
    for name, strat in (("dp", "dp:2"), ("fsdp", "fsdp:2")):
        _case(root, name, x, y, weights, path=os.path.join(root, name))
        cases2.append((name, "ckpt_rt", dict(BERT, strategy=strat)))
    _case(root, "one_to_dp", x, y, weights, path=one_path)
    cases2.append(("one_to_dp", "ckpt_restore", dict(BERT, strategy="dp:2")))
    pipe_w = _pipe_weights()
    _case(root, "pipe", sx, sy, pipe_w, path=os.path.join(root, "pipe"))
    cases2.append(("pipe", "pipe_rt", dict(model="small", strategy="pp:2")))
    _case(root, "pipe_refuse", sx, sy, pipe_w)
    cases2.append(("pipe_refuse", "pipe_refuse",
                   dict(model="small", strategy="pp:2")))
    tp.finish(cp.start(2, root, cases2), root)
    dp_path = os.path.join(root, "dp", "step_8")
    cases4 = []
    _case(root, "hybrid", x, y, weights, path=os.path.join(root, "hybrid"))
    cases4.append(("hybrid", "ckpt_rt", dict(BERT, strategy="hybrid:2:2")))
    _case(root, "dp_to_hybrid", x, y, weights, path=dp_path)
    cases4.append(("dp_to_hybrid", "ckpt_restore",
                   dict(BERT, strategy="hybrid:2:2")))
    procs = cp.start(4, root, cases4)
    # meanwhile: several ranks onto one device, in this process
    from flexflow_tpu_torch.execution.checkpoint import restore_checkpoint

    back = tp.build(**BERT, strategy=None)
    restore_checkpoint(back, dp_path)
    refs = {"one": one.get_params_numpy(),
            "dp_to_one": back.get_params_numpy(), "jax": {}}
    restore_checkpoint(back, os.path.join(root, "fsdp", "step_8"))
    refs["fsdp_to_one"] = back.get_params_numpy()
    for key, strat in (("dp", "dp:2"), ("hybrid", "hybrid:2:2")):
        jff = jax_build("bert", strat, 8)
        refs["jax"][key] = json.loads(jff.strategy.to_json(jff.pcg))
    tp.finish(procs, root)
    return root, refs


def _pipe_weights():
    """The pipeline model's weights, drawn by a one-device build."""
    import flexflow_tpu_torch as ft

    c = ft.FFConfig()
    c.batch_size = cp.BATCH
    ff = ft.FFModel(c, device="cpu")
    x = ff.create_tensor((cp.BATCH, 16), name="x")
    t = ff.relu(ff.dense(x, 32, name="d1"))
    t = ff.relu(ff.dense(t, 32, name="d2"))
    ff.dense(t, 10, name="d3")
    ff.compile(optimizer=ft.SGDOptimizer(None, lr=0.05))
    return ff.get_params_numpy()


@pytest.mark.parametrize("name,world", [("dp", 2), ("hybrid", 4),
                                        ("fsdp", 2)])
def test_round_trip_and_next_step_are_bitwise(runs, name, world):
    root, _refs = runs
    for rank in range(world):
        got = tp.load(root, name, rank)
        assert int(got["step"]) == 8
        assert_trees_equal(tp.unflat("a", got), tp.unflat("b", got))
        assert_trees_equal(tp.unflat("a2", got), tp.unflat("b2", got))
    if name != "dp":  # the split kernels came back split
        local = {s.split(":")[0]: s.split(":")[1]
                 for s in tp.load(root, name, 0)["local"]}
        wq = [v for k, v in local.items() if k.endswith("/wq")][0]
        assert wq == ("(64, 2, 16)" if name == "hybrid" else
                      "(32, 4, 16)"), local


@pytest.mark.parametrize("name,world", [("dp", 2), ("hybrid", 4),
                                        ("fsdp", 2)])
def test_each_distinct_shard_is_written_once(runs, name, world):
    root, _refs = runs
    path = os.path.join(root, name, "step_8")
    pieces = {}
    for r in range(world):
        with open(os.path.join(path, f"index.r{r}.json")) as f:
            for e in json.load(f):
                pieces.setdefault((e["tree"], tuple(e["path"])), []).append(
                    (r, tuple(e["offset"]), tuple(e["shape"])))
    import torch

    writers = set()
    for key, ps in pieces.items():
        shape = ps[0][2]
        offsets = [p[1] for p in ps]
        assert len(set(offsets)) == len(offsets), key  # no replica twice
        writers.update(p[0] for p in ps)
        n = sum(torch.load(os.path.join(path, f"{key[0]}.r{r}.pt"),
                           weights_only=True)[i].numel()
                for r, i in _indices(path, key, ps))
        assert n == int(np.prod(shape)), key
    # replicas are written by the lowest rank only: rank 0 alone under dp;
    # under dp 2 x tp 2 the ranks of data index 0 (0 and 1); a weight
    # split over the data axis by each of its holders
    assert writers == ({0} if name == "dp" else {0, 1})


def _indices(path, key, ps):
    out = []
    for r, off, _shape in ps:
        with open(os.path.join(path, f"index.r{r}.json")) as f:
            for e in json.load(f):
                if (e["tree"], tuple(e["path"])) == key and \
                        tuple(e["offset"]) == off:
                    out.append((r, e["index"]))
    return out


@pytest.mark.parametrize("name,world,mesh", [
    ("dp", 2, [2]), ("hybrid", 4, [2, 2])])
def test_strategy_and_meta_record_the_mesh(runs, name, world, mesh):
    root, refs = runs
    path = os.path.join(root, name, "step_8")
    with open(os.path.join(path, "strategy.json")) as f:
        assert json.load(f) == refs["jax"][name]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["mesh_shape"] == mesh and meta["n_devices"] == world
    assert meta["axis_names"] == refs["jax"][name]["axis_names"]
    files = set(meta["checksums"])
    for r in range(world):
        assert {f"params.r{r}.pt", f"opt_state.r{r}.pt",
                f"index.r{r}.json"} <= files
    assert {"strategy.json", "train_state.json"} <= files


@pytest.mark.parametrize("case", ["dp_to_one", "fsdp_to_one", "one_to_dp",
                                  "dp_to_hybrid"])
def test_restore_onto_another_topology_is_bitwise(runs, case):
    root, refs = runs
    src = case.split("_")[0]
    saved = refs["one"] if src == "one" else \
        tp.unflat("a", tp.load(root, src, 0))
    if case.endswith("_to_one"):
        assert_trees_equal(saved, refs[case])
        return
    world = 2 if case == "one_to_dp" else 4
    for rank in range(world):
        got = tp.load(root, case, rank)
        assert int(got["step"]) == (2 if case == "one_to_dp" else 8)
        assert_trees_equal(saved, tp.unflat("p", got))


def test_pipeline_round_trip_and_next_fit(runs):
    root, _refs = runs
    for rank in range(2):
        got = tp.load(root, "pipe", rank)
        assert_trees_equal(tp.unflat("saved", got), tp.unflat("b", got))
        a2, b2 = tp.unflat("a2", got), tp.unflat("b2", got)
        for n in a2:
            for w in a2[n]:
                np.testing.assert_allclose(b2[n][w], a2[n][w], rtol=1e-6,
                                           atol=1e-6)


def test_a_corrupt_shard_is_refused_before_any_state_is_touched(
        runs, tmp_path):
    from flexflow_tpu_torch.execution.checkpoint import (
        CheckpointCorruptError, restore_checkpoint)

    root, _refs = runs
    path = str(tmp_path / "step_8")
    shutil.copytree(os.path.join(root, "hybrid", "step_8"), path)
    with open(os.path.join(path, "params.r1.pt"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    ff = tp.build(**BERT, strategy=None)
    before = ff.get_params_numpy()
    with pytest.raises(CheckpointCorruptError, match="params.r1.pt"):
        restore_checkpoint(ff, path)
    assert_trees_equal(before, ff.get_params_numpy())


def test_a_pipeline_fit_still_refuses_the_checkpoint_flags_by_name(runs):
    root, _refs = runs
    for rank in range(2):
        got = tp.load(root, "pipe_refuse", rank)
        for field, flag in (("checkpoint_dir", "--checkpoint-dir"),
                            ("resume", "--resume"),
                            ("max_bad_steps", "--max-bad-steps")):
            msg = str(got[field])
            assert flag in msg and "pipeline" in msg, msg
