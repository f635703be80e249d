"""Data parallelism on two gloo ranks against the JAX package and the
port's one-device path (``tests/torch_dist_pairs.py`` runs the ranks,
``tests/torch_mesh_pairs.py`` the references; tolerances there): the tiny
BERT proxy under ``data_parallel_strategy(pcg, 2)``, each rank on its
half of the batch with replicated weights, one Adam step's loss, grads
and params against the JAX package's step under the same strategy on its
virtual mesh and against the one-device port (tensor parallelism:
tests/test_torch_mesh_dist.py). Then a step on a split batch followed by
one on a batch that does not divide by the data axis (run whole on every
rank, so no grad is summed over it) against the same two steps on one
device.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close, data,
                              jax_build, jax_step, jax_weights,
                              port_one_device, write_case)

WORLD = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_data"))
    x, y = data("bert", 8)
    jff = jax_build("bert", "dp:2", 8)
    write_case(root, "dp2", x, y, jax_weights(jff))
    write_case(root, "two", x, y, jax_weights(jff))
    procs = tp.start(WORLD, root, [
        ("dp2", "step", dict(model="bert", strategy="dp:2", batch=8)),
        ("two", "two_steps", dict(model="bert", strategy="dp:2",
                                  batch=8))])
    ref = jax_step(jff, x, y)
    one = port_one_device("bert", 8, ref["weights"], x, y)
    ff = tp.build("bert", None, 8)
    ff.set_params_numpy(ref["weights"])
    two = [tp.one_step(ff, x[:rows], y[:rows]) for rows in (8, 7)]
    tp.finish(procs, root)
    return root, ref, one, two


def test_data_parallel_step_matches_jax_and_one_device(runs):
    root, ref, (p_loss, p_grads, p_params), _ = runs
    for rank in range(WORLD):
        got = tp.load(root, "dp2", rank)
        loss = float(got["loss"])
        np.testing.assert_allclose(loss, p_loss, **TOL)
        np.testing.assert_allclose(loss, ref["step_loss"], **TOL)
        assert_trees_close(p_grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(ref["grads"], tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(p_params, tp.unflat("p", got), **TOL)
        assert_trees_close(ref["params"], tp.unflat("p", got), **TOL)
        # replicated weights: the data-parallel mesh has one axis
        assert str(got["wq_placement"]) == "(Replicate(),)"
        assert tuple(got["wq_local_shape"]) == (64, 4, 16)


def test_whole_batch_step_after_a_split_one_sums_no_grad(runs):
    root, _, _, two = runs
    for rank in range(WORLD):
        got = tp.load(root, "two", rank)
        for i, (loss, grads, params) in enumerate(two):
            np.testing.assert_allclose(float(got[f"loss{i}"]), loss, **TOL)
            assert_trees_close(grads, tp.unflat(f"g{i}", got), **GRAD_TOL)
            assert_trees_close(params, tp.unflat(f"p{i}", got), **TOL)
