"""The port's pipeline schedules on four gloo ranks against the JAX
package's ``PipelineTrainer`` and the port's one-device step
(``tests/torch_pipeline_pairs.py`` runs the ranks,
``tests/torch_pipeline_refs.py`` the references; tolerances there).

One spawn of four CPU ranks for the module runs ``tests/test_pipeline.py``'s
MLP, the tiny BERT proxy and the tiny GPT-2 LM (its position ids baked for
the whole batch, cut to each microbatch) at pp 2 x dp 2 and pp 4 x dp 1,
four microbatches, under gpipe, 1f1b and interleaved (v 2, where the
graph has pp * 2 compute nodes): two SGD steps each from the same
weights. The three schedules' losses and params are bitwise equal; each
is within 1e-5 of the JAX trainer's gpipe run on the same weights and grid,
and the first step within 1e-5 of the one-device port's.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
import torch_pipeline_pairs as pairs
from torch_pipeline_refs import (TOL, assert_trees_close,
                                 assert_trees_equal, jax_pipeline,
                                 port_one_device, weights, write_case)

WORLD = 4
MODELS = ("mlp", "bert", "gpt2")
GRIDS = ((2, 2), (4, 1))
SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))
N_MICRO = 4
# compute nodes of each model: interleaved needs pp * v of them
NODES = {"mlp": 6}


def runs_of():
    for model in MODELS:
        for pp, dp in GRIDS:
            for sched, v in SCHEDULES:
                if pp * v <= NODES.get(model, 64):
                    yield model, pp, dp, sched, v


def name_of(model, pp, dp, sched):
    return f"{model}_{pp}x{dp}_{sched}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline"))
    ws = {m: weights(m) for m in MODELS}
    cases = []
    for model, pp, dp, sched, v in runs_of():
        x, y = pairs.data(model)
        name = name_of(model, pp, dp, sched)
        write_case(root, name, x, y, ws[model])
        cases.append((name, "train", dict(
            model=model, pp=pp, dp=dp, n_micro=N_MICRO, schedule=sched,
            virtual_stages=v)))
    procs = pairs.start(WORLD, root, cases)
    refs = {}
    for model in MODELS:
        x, y = pairs.data(model)
        one = port_one_device(model, ws[model], x, y)
        for pp, dp in GRIDS:
            refs[(model, pp, dp)] = (jax_pipeline(
                model, ws[model], x, y, pp, dp, N_MICRO), one)
    tp.finish(procs, root, timeout=300)
    return root, refs


@pytest.mark.parametrize("model,pp,dp", [(m, p, d) for m in MODELS
                                         for p, d in GRIDS])
def test_schedules_bitwise_equal(runs, model, pp, dp):
    root, _ = runs
    scheds = [s for m, p, d, s, _v in runs_of()
              if (m, p, d) == (model, pp, dp)]
    assert len(scheds) >= 2
    for rank in range(WORLD):
        want = tp.load(root, name_of(model, pp, dp, "gpipe"), rank)
        for sched in scheds[1:]:
            got = tp.load(root, name_of(model, pp, dp, sched), rank)
            for s in range(2):
                assert got[f"loss{s}"] == want[f"loss{s}"], (sched, s)
                assert_trees_equal(tp.unflat(f"p{s}", want),
                                   tp.unflat(f"p{s}", got))


@pytest.mark.parametrize("model,pp,dp,sched", [
    (m, p, d, s) for m, p, d, s, _v in runs_of()])
def test_matches_jax_trainer_and_one_device(runs, model, pp, dp, sched):
    root, refs = runs
    ref, (one_loss, _g, one_params) = refs[(model, pp, dp)]
    for rank in range(WORLD):
        got = tp.load(root, name_of(model, pp, dp, sched), rank)
        for s in range(2):
            np.testing.assert_allclose(float(got[f"loss{s}"]),
                                       ref[f"loss{s}"], **TOL)
            assert_trees_close(ref[f"p{s}"], tp.unflat(f"p{s}", got), **TOL)
        np.testing.assert_allclose(float(got["loss0"]), one_loss, **TOL)
        assert_trees_close(one_params, tp.unflat("p0", got), **TOL)
