"""The loss on the rank's rows (ROADMAP C.8) on two gloo ranks
(``tests/torch_dist_pairs.py`` runs the ranks, ``tests/torch_mesh_pairs.py``
the references; tolerances there).

Under ``data_parallel_strategy(pcg, 2)`` the tiny GPT-2 LM ((B, S, vocab)
logits, token-level targets) and the tiny BERT proxy keep the final output
split over the data axis: each rank's loss reads its (B/2, ...) rows, and a
``CommDebugMode`` census of a train step finds no all-gather of the logits
or the labels (they stay where they are; the step's all-reduces are the
grads' sum and the loss's value). One Adam step's loss, grads and params match the
one-device port and the JAX package's step under the same strategy; the
BERT proxy's eval (accuracy counts and loss) matches both, and
``predict`` returns the whole output on every rank.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close, data,
                              jax_build, jax_step, jax_weights,
                              port_one_device, write_case)

WORLD = 2
BATCH = 8
MODELS = ("gpt2", "bert")
# each model's logits on one rank: half the batch
LOCAL = {"gpt2": (BATCH // 2, 16, 100), "bert": (BATCH // 2, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loss_sharded"))
    cases, jffs = [], {}
    for model in MODELS:
        x, y = data(model, BATCH)
        jff = jffs[model] = jax_build(model, "dp:2", BATCH)
        for kind in ("step", "census") + (("metrics",) if model == "bert"
                                          else ()):
            write_case(root, f"{kind}_{model}", x, y, jax_weights(jff))
            cases.append((f"{kind}_{model}", kind, dict(
                model=model, strategy="dp:2", batch=BATCH)))
    procs = tp.start(WORLD, root, cases)
    refs = {}
    for model in MODELS:
        x, y = data(model, BATCH)
        ref = jax_step(jffs[model], x, y)
        refs[model] = (ref, port_one_device(model, BATCH, ref["weights"],
                                            x, y))
    x, y = data("bert", BATCH)
    jperf = jax_build("bert", "dp:2", BATCH)
    jperf.params = jax_build_params(jperf, refs["bert"][0]["weights"])
    jeval = jperf.eval(x, y)
    one = tp.build("bert", None, BATCH)
    one.set_params_numpy(refs["bert"][0]["weights"])
    perf = one.eval(x, y)
    import torch

    ex = one.executor
    loss, _m = ex.make_eval_step()(one.params, [torch.tensor(x)],
                                   torch.tensor(one._prep_label(y)))
    refs["eval"] = dict(train_all=perf.train_all,
                        train_correct=perf.train_correct, loss=float(loss),
                        jax_correct=jeval.train_correct,
                        pred=one.predict(x))
    tp.finish(procs, root)
    return root, refs


def jax_build_params(jff, weights):
    """``weights`` placed as ``jff``'s params are (its shardings)."""
    import jax

    return {n: {w: jax.device_put(weights[n][w], a.sharding)
                for w, a in ws.items()} for n, ws in jff.params.items()}


@pytest.mark.parametrize("model", MODELS)
def test_loss_reads_the_rank_rows(runs, model):
    root, _ = runs
    for rank in range(WORLD):
        got = tp.load(root, f"step_{model}", rank)
        assert tuple(got["logits_shape"]) == LOCAL[model]


# what a data-parallel step gathers: BERT nothing; GPT-2 the cotangent
# of its position embedding (B, S, hidden), which runs on the position ids
# whole on every rank (a constant, not a batch shard) and is cut to the
# rank's rows at the residual add
GATHERED = {"gpt2": [f"{BATCH},16,64"], "bert": []}


@pytest.mark.parametrize("model", MODELS)
def test_census_gathers_no_logits(runs, model):
    root, _ = runs
    for rank in range(WORLD):
        got = tp.load(root, f"census_{model}", rank)
        counts = dict(zip((str(k) for k in got["kinds"]),
                          (int(c) for c in got["counts"])))
        gathered = [str(s) for s in got["gathered"]]
        assert gathered == GATHERED[model], gathered
        # the grads' flat sum and the loss's value
        assert counts.get("c10d.allreduce_") == 2, counts
        assert counts.get("c10d._allgather_base_", 0) == len(gathered)


@pytest.mark.parametrize("model", MODELS)
def test_step_matches_jax_and_one_device(runs, model):
    root, refs = runs
    ref, (p_loss, p_grads, p_params) = refs[model]
    for rank in range(WORLD):
        got = tp.load(root, f"step_{model}", rank)
        loss = float(got["loss"])
        np.testing.assert_allclose(loss, p_loss, **TOL)
        np.testing.assert_allclose(loss, ref["step_loss"], **TOL)
        assert_trees_close(p_grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(ref["grads"], tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(p_params, tp.unflat("p", got), **TOL)
        assert_trees_close(ref["params"], tp.unflat("p", got), **TOL)


def test_eval_metrics_and_predict_match_one_device_and_jax(runs):
    root, refs = runs
    want = refs["eval"]
    for rank in range(WORLD):
        got = tp.load(root, "metrics_bert", rank)
        assert int(got["train_all"]) == want["train_all"] == BATCH
        assert int(got["train_correct"]) == want["train_correct"] == \
            want["jax_correct"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"], **TOL)
        np.testing.assert_allclose(float(got["loss"]),
                                   refs["bert"][0]["loss"], **TOL)
        assert got["pred"].shape == want["pred"].shape == (BATCH, 2)
        np.testing.assert_allclose(got["pred"], want["pred"], **TOL)
