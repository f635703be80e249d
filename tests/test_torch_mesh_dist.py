"""The port's strategies on two gloo ranks against the JAX package and the
port's one-device path (``tests/torch_dist_pairs.py`` runs the ranks,
``tests/torch_mesh_pairs.py`` the references; tolerances there).

One spawn of two CPU ranks for the module runs every case:

* the tiny BERT proxy under the hybrid strategy at dp = 1 x tp = 2
  (attention over local heads, Megatron's column- then row-parallel MLP,
  the column-parallel head): one Adam step's loss, grads and params
  against the JAX package's step under the same strategy on its virtual
  mesh and against the one-device port; ``wq`` is held as a head shard
  (data parallelism: tests/test_torch_mesh_data.py);
* a ``CommDebugMode`` census of one tp = 2 step: per block two
  all-reduces forward (attention's output projection and the MLP's row
  half) and two backward (Megatron's ``f`` at the attention and MLP
  inputs; the first block's attention reads the model input, which needs
  no grad), one at the head's input backward, the data axis's grad sum,
  and one all-gather (the head's column-parallel output before the
  softmax): no weight is ever gathered.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close, data,
                              jax_build, jax_step, jax_weights,
                              port_one_device, write_case)

WORLD = 2
STEPS = {"tp2": ("bert", 8, "hybrid:1:2")}  # name: (model, batch, strategy)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX models' weights go to the ranks first; the JAX steps and
    the one-device port run while the ranks do."""
    root = str(tmp_path_factory.mktemp("mesh2"))
    cases, models = [], {}
    for name, (model, batch, strat) in STEPS.items():
        x, y = data(model, batch)
        jff = jax_build(model, strat, batch)
        write_case(root, name, x, y, jax_weights(jff))
        cases.append((name, "step", dict(model=model, strategy=strat,
                                         batch=batch)))
        models[name] = (jff, model, batch, x, y)
    write_case(root, "census", *data("bert", 8),
               jax_weights(models["tp2"][0]))
    cases.append(("census", "census", dict(model="bert",
                                           strategy="hybrid:1:2", batch=8)))
    procs = tp.start(WORLD, root, cases)
    refs = {}
    for name, (jff, model, batch, x, y) in models.items():
        ref = jax_step(jff, x, y)
        refs[name] = (ref, port_one_device(model, batch, ref["weights"],
                                           x, y))
    tp.finish(procs, root)
    return root, refs


@pytest.mark.parametrize("name", sorted(STEPS))
def test_one_step_matches_jax_and_one_device(runs, name):
    root, refs = runs
    (ref, (p_loss, p_grads, p_params)) = refs[name]
    for rank in range(WORLD):
        got = tp.load(root, name, rank)
        loss = float(got["loss"])
        np.testing.assert_allclose(loss, p_loss, **TOL)
        np.testing.assert_allclose(loss, ref["step_loss"], **TOL)
        assert_trees_close(p_grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(ref["grads"], tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(p_params, tp.unflat("p", got), **TOL)
        assert_trees_close(ref["params"], tp.unflat("p", got), **TOL)


def test_tensor_parallel_holds_wq_as_a_head_shard(runs):
    root, _ = runs
    got = tp.load(root, "tp2")
    # tiny BERT: wq (64, 4 heads, 16); tp = 2 keeps 2 heads a rank
    assert tuple(got["wq_local_shape"]) == (64, 2, 16)
    assert str(got["wq_placement"]) == "(Replicate(), Shard(dim=1))"


def test_tensor_parallel_collective_census(runs):
    root, _ = runs
    got = tp.load(root, "census")
    counts = dict(zip((str(k) for k in got["kinds"]),
                      (int(c) for c in got["counts"])))
    layers = 2
    all_reduces = 2 * layers + (2 * layers - 1) + 1 + 1
    assert counts == {"c10d.allreduce_": all_reduces,
                      "c10d._allgather_base_": 1}
