"""Laws of the port's mesh path on two gloo ranks, against the port itself
(``tests/torch_dist_pairs.py`` runs the ranks):

* ``--collective-overlap on`` (each remat block's grads all-reduced
  asynchronously as its backward completes) gives loss, grads and params
  BITWISE equal to the synchronous flat all-reduce, under dp = 2 and
  under tp = 2 (the JAX law: tests/test_pipeline_schedules.py);
* the dropout law: with attention dropout 0.1, a step under dp = 2 and
  under tp = 2 draws the one-device port's masks for the same seed (the
  counter hash keys on global batch and head coordinates), so its loss,
  grads and params equal the one-device step's within 1e-5;
* ``--remat full`` on the mesh (collectives inside checkpointed blocks,
  run again in the recompute) gives the one-device step;
* ``fit`` over 2 shuffled epochs under dp = 2, then ``eval`` and
  ``predict``: the same losses, metrics, predictions and full params
  (``get_params_numpy``) on every rank, and the one-device fit's;
* the channel-out convolution and the vocab-sharded embedding under
  tp = 2 (a small CNN and an embedding MLP) give the one-device step, and
  so do L1/L2 kernel regularizers under dp = 2 and tp = 2 (the penalty of
  a split kernel summed over its shards, its grad counted once across
  the data axis), and the batched Experts op split by expert at ep = 2;
* checkpoints at a world size above 1 are refused by name;
* with no strategy and ``--only-data-parallel`` the world's two ranks
  train data parallel, rank 0 alone writes the telemetry and trace files,
  and ``eval`` over 21 samples (a last batch of 5, run whole on every
  rank) gives the one-device metrics.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close,
                              assert_trees_equal, data, port_one_device,
                              write_case)

WORLD = 2
BERT = dict(model="bert", batch=8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("laws"))
    weights = tp.build("bert", None, 8, seed=5).get_params_numpy()
    x, y = data("bert", 8)
    xf, yf = data("bert", 8, n=24, seed=1)
    cases, ops = [], {}
    for strat in ("dp:2", "hybrid:1:2"):
        key = strat.split(":")[0]
        for name, kw in ((f"{key}_sync", {}), (f"{key}_overlap",
                                                dict(overlap=True)),
                         (f"{key}_dropout", dict(dropout=0.1)),
                         (f"{key}_remat", dict(remat="full"))):
            write_case(root, name, x, y, weights)
            cases.append((name, "step", dict(BERT, strategy=strat, **kw)))
    for model, strat in (("cnn", "hybrid:1:2"), ("emb", "hybrid:1:2"),
                         ("reg", "dp:2"), ("reg", "hybrid:1:2"),
                         ("moe_experts", "experts_op:1:2")):
        name = f"{model}_{strat.split(':')[0]}"
        batch = 16 if model == "moe_experts" else 8
        w = tp.build(model, None, batch).get_params_numpy()
        mx, my = data(model, batch)
        write_case(root, name, mx, my, w)
        cases.append((name, "step", dict(model=model, batch=batch,
                                         strategy=strat)))
        ops[name] = port_one_device(model, batch, w, mx, my)
    write_case(root, "fit", xf, yf, weights)
    cases.append(("fit", "fit", dict(BERT, strategy="dp:2", epochs=2)))
    xe, ye = data("bert", 8, n=21, seed=2)
    np.savez(f"{root}/flow_in.npz", x=xf, y=yf, xe=xe, ye=ye,
             **tp.flat("w", weights))
    cases.append(("flow", "flow", dict(BERT, strategy=None)))
    write_case(root, "refuse", x, y, weights)
    cases.append(("refuse", "refuse", dict(BERT, strategy="dp:2")))
    procs = tp.start(WORLD, root, cases)
    refs = {"plain": port_one_device("bert", 8, weights, x, y),
            "dropout": port_one_device("bert", 8, weights, x, y,
                                       dropout=0.1)}
    one = tp.build("bert", None, 8, epochs=2)
    one.set_params_numpy(weights)
    one.fit(xf, yf)
    perf = one.eval(xf, yf)
    flow = tp.build("bert", None, 8)
    flow.fit(xf, yf)
    eperf = flow.eval(xe, ye)
    refs["flow"] = dict(losses=np.array(flow.fit_history.loss),
                        train_all=eperf.train_all,
                        train_correct=eperf.train_correct)
    refs["fit"] = dict(losses=np.array(one.fit_history.loss),
                       train_all=perf.train_all,
                       train_correct=perf.train_correct,
                       pred=one.predict(xf), params=one.get_params_numpy())
    refs.update(ops)
    tp.finish(procs, root)
    return root, refs


@pytest.mark.parametrize("key", ["dp", "hybrid"])
def test_collective_overlap_is_bitwise_the_synchronous_sum(runs, key):
    root, _ = runs
    for rank in range(WORLD):
        sync = tp.load(root, f"{key}_sync", rank)
        ovl = tp.load(root, f"{key}_overlap", rank)
        assert float(ovl["loss"]) == float(sync["loss"])
        assert_trees_equal(tp.unflat("g", sync), tp.unflat("g", ovl))
        assert_trees_equal(tp.unflat("p", sync), tp.unflat("p", ovl))


@pytest.mark.parametrize("key", ["dp", "hybrid"])
@pytest.mark.parametrize("kind", ["dropout", "remat"])
def test_mesh_step_is_the_one_device_step(runs, key, kind):
    root, refs = runs
    loss, grads, params = refs["dropout" if kind == "dropout" else "plain"]
    if kind == "dropout":  # the masks moved the step: they are live
        assert abs(loss - refs["plain"][0]) > 1e-4
    for rank in range(WORLD):
        got = tp.load(root, f"{key}_{kind}", rank)
        np.testing.assert_allclose(float(got["loss"]), loss, **TOL)
        assert_trees_close(grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(params, tp.unflat("p", got), **TOL)


@pytest.mark.parametrize("model", ["cnn_hybrid", "emb_hybrid", "reg_dp",
                                   "reg_hybrid", "moe_experts_experts_op"])
def test_conv_embedding_and_regularizer_shards_give_the_one_device_step(
        runs, model):
    root, refs = runs
    loss, grads, params = refs[model]
    for rank in range(WORLD):
        got = tp.load(root, model, rank)
        np.testing.assert_allclose(float(got["loss"]), loss, **TOL)
        assert_trees_close(grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(params, tp.unflat("p", got), **TOL)


def test_fit_eval_predict_agree_on_every_rank_and_with_one_device(runs):
    root, refs = runs
    want = refs["fit"]
    r0 = tp.load(root, "fit", 0)
    for rank in range(WORLD):
        got = tp.load(root, "fit", rank)
        np.testing.assert_array_equal(got["losses"], r0["losses"])
        np.testing.assert_array_equal(got["pred"], r0["pred"])
        assert int(got["train_all"]) == want["train_all"] == 24
        assert int(got["train_correct"]) == want["train_correct"]
        assert_trees_equal(tp.unflat("p", r0), tp.unflat("p", got))
    np.testing.assert_allclose(r0["losses"], want["losses"], **TOL)
    np.testing.assert_allclose(r0["pred"], want["pred"], **TOL)
    assert_trees_close(want["params"], tp.unflat("p", r0), **TOL)


def test_only_data_parallel_flow_and_rank_zero_files(runs):
    root, refs = runs
    want = refs["flow"]
    for rank in range(WORLD):
        got = tp.load(root, "flow", rank)
        assert [tuple(r) for r in got["mesh"]] == [("data", "2")]
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
        assert int(got["train_all"]) == want["train_all"] == 21
        assert int(got["train_correct"]) == want["train_correct"]
        assert list(got["wrote"]) == ([True, True] if rank == 0
                                      else [False, False])


def test_checkpoints_on_several_ranks_are_refused_by_name(runs):
    root, _ = runs
    msg = str(tp.load(root, "refuse")["message"])
    assert "ported in a later slice" in msg and "A.5, third part" in msg
