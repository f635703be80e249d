"""Long-context training on four gloo ranks against the JAX package.

The tiny BERT proxy (``BertConfig.tiny``, seq 16, batch 4) and the tiny
causal GPT-2 (seq 16, batch 4, token-level targets) compile under
``long_context_strategy`` at dp 2 x sp 2 and dp 1 x sp 4, in ``ring`` and
in ``alltoall`` mode (``tests/torch_seqpar_pairs.py`` runs the ranks). The
SPMD plan keeps the activations split over the sequence axis between the
attention ops: dense, layer norm, embedding lookups, elementwise ops and
the softmax run on each rank's positions, the attention on the ring or
Ulysses schedule, and GPT-2's loss on each rank's own tokens; only BERT's
mean pool, which mixes positions, gathers them. The JAX package trains
the same graph under the same strategy on its virtual mesh from the same
weights. Held:

* one Adam step: the loss within 1e-5, the grads within the mesh files'
  ``GRAD_TOL``, on every rank, and every param after the update within
  1e-5 plus what the grads' own difference moves it by. Adam's first
  update is ``alpha * g / (|g| + eps')`` with ``eps' = eps / sqrt(1 -
  beta2)`` = 3.2e-7: for a grad near that scale it is steep, with a gain
  of up to ``alpha / eps'`` = 3e3, so fp32 noise in such a grad (a 7e-8
  element of GPT-2's fc1 reads 6.2e-8 in the port's one-device step and
  7.0e-8 in the JAX package's) moves its param by 2e-5 whatever the
  schedule. Each param is held within 1e-5 plus the update's gain over
  the segment between the two grads times their difference (a bound on
  the update's difference); for a grad well above ``eps'`` that term is
  nil and the bound is 1e-5;
* GPT-2's loss read this rank's positions of the logits, never the whole
  (b, s, vocab);
* a ``CommDebugMode`` census of one step: over the sequence axis only
  the ring's point-to-point rotations or Ulysses' all-to-alls (3 in and 1
  out a layer forward, as many backward), the gradient and loss sums, and
  the gathers at position-mixing ops (BERT's pool, once): no all-gather of
  a (b, s, hidden) activation around a dense or a norm (GPT-2's constant
  position ids add one gather over the data axis at dp > 1, of the
  position embedding's grad). One whole train
  step (the metrics and the optimizer too) gathers nothing more: GPT-2's
  (b, s, vocab) output is gathered neither for its loss nor for its
  metrics, and the one-hot GPT-2 (``gpt2_dense``: categorical
  cross-entropy, with accuracy, cross-entropy, MSE, RMSE and MAE) takes
  each metric on its own positions;
* ``eval`` (its counts and metric sums), the eval step's loss and
  ``predict`` match the JAX package's under the same strategy on the same
  weights, and the port's one-device numbers.
"""
import numpy as np
import pytest

import torch_dist_pairs as tp
import torch_seqpar_pairs as sq
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close, data,
                              jax_build, jax_step, jax_weights, write_case)

WORLD = 4
BATCH = 4
LAYERS = 2
SEQ = 16
HIDDEN = 64
STRATEGIES = ("ring:2:2", "ring:1:4", "alltoall:2:2", "alltoall:1:4")
STEPS = [(model, strat) for model in ("bert", "gpt2")
         for strat in STRATEGIES]
CENSUS = (("gpt2", "ring:1:4"), ("gpt2", "alltoall:1:4"),
          ("bert", "ring:2:2"), ("gpt2_dense", "ring:2:2"))
METRICS = (("bert", "ring:2:2"), ("gpt2", "alltoall:1:4"),
           ("gpt2_dense", "ring:2:2"), ("gpt2_dense", "alltoall:1:4"))
VOCAB = 100


# Adam's first step (alpha 1e-3, beta2 0.999, eps 1e-8): the update is
# alpha * g / (|g| + ADAM_EPS)
ADAM_ALPHA = 1e-3
ADAM_EPS = 1e-8 / np.sqrt(1 - 0.999)


def assert_params_close(want, got, want_grads, got_grads):
    """Every param after the Adam step within ``TOL`` plus the bound that
    the grads' difference puts on the updates' (module doc): the update's
    slope ``alpha * eps' / (|g| + eps')**2`` is steepest at the smallest
    ``|g|`` between the two grads (0 where their signs differ)."""
    assert set(want) == set(got)
    for n in want:
        for w in want[n]:
            gw = np.asarray(want_grads[n][w], np.float64)
            gg = np.asarray(got_grads[n][w], np.float64)
            low = np.where(np.sign(gw) == np.sign(gg),
                           np.minimum(np.abs(gw), np.abs(gg)), 0.0)
            gain = ADAM_ALPHA * ADAM_EPS / (low + ADAM_EPS) ** 2
            pw = np.asarray(want[n][w], np.float64)
            pg = np.asarray(got[n][w], np.float64)
            bound = TOL["atol"] + TOL["rtol"] * np.abs(pw) + \
                gain * np.abs(gw - gg)
            bad = np.abs(pg - pw) > bound
            assert not bad.any(), (f"{n}.{w}", int(bad.sum()),
                                   float(np.abs(pg - pw)[bad].max()))


def _name(case, kind="step"):
    model, strat = case
    return f"{kind}_{model}_{strat.replace(':', '_')}"


def jax_metrics(jff, x, y):
    """The JAX package's ``eval`` (its counts and metric sums), its eval
    step's loss and ``predict`` under its strategy."""
    import jax.numpy as jnp

    perf = jff.eval(x, y)
    loss, _m = jff.executor.make_eval_step()(
        jff.params, [jnp.asarray(x)], jnp.asarray(jff._prep_label(y)))
    return {"train_all": int(perf.train_all),
            "train_correct": int(perf.train_correct),
            **{f: float(getattr(perf, f)) for f in tp.PERF_SUMS},
            "loss": float(loss), "pred": np.asarray(jff.predict(x))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("longctx"))
    cases, models = [], {}
    for case in STEPS:
        model, strat = case
        x, y = data(model, BATCH)
        jff = jax_build(model, strat, BATCH)
        write_case(root, _name(case), x, y, jax_weights(jff))
        cases.append((_name(case), "step", dict(model=model, strategy=strat,
                                                batch=BATCH)))
        models[_name(case)] = (jff, x, y)
    # the metrics cases' JAX models stay apart from the steps' (a step
    # donates its params)
    metric_models = {}
    for kind, group in (("census", CENSUS), ("metrics", METRICS)):
        for case in group:
            model, strat = case
            x, y = data(model, BATCH)
            jff = jax_build(model, strat, BATCH)
            if kind == "metrics":
                metric_models[case] = (jff, x, y)
            write_case(root, _name(case, kind), x, y, jax_weights(jff))
            cases.append((_name(case, kind), kind,
                          dict(model=model, strategy=strat, batch=BATCH)))
    procs = tp.start(WORLD, root, cases, main=sq.rank_main)
    refs = {name: jax_step(jff, x, y) for name, (jff, x, y) in models.items()}
    one, jax_eval = {}, {}
    for case, (jff, x, y) in metric_models.items():
        model, _strat = case
        one[case] = tp.CASES["metrics"](
            dict(model=model, strategy=None, batch=BATCH),
            dict(x=x, y=y, **tp.flat("w", jax_weights(jff))))
        jax_eval[case] = jax_metrics(jff, x, y)
    tp.finish(procs, root, timeout=240)
    return root, refs, one, jax_eval


@pytest.mark.parametrize("case", STEPS, ids=_name)
def test_step_matches_the_jax_package(runs, case):
    root, refs, *_ = runs
    ref = refs[_name(case)]
    for rank in range(WORLD):
        got = tp.load(root, _name(case), rank)
        np.testing.assert_allclose(float(got["loss"]), ref["step_loss"],
                                   **TOL)
        assert_params_close(ref["params"], tp.unflat("p", got),
                            ref["grads"], tp.unflat("g", got))


@pytest.mark.parametrize("case", STEPS, ids=_name)
def test_grads_match_the_jax_package(runs, case):
    root, refs, *_ = runs
    ref = refs[_name(case)]
    for rank in range(WORLD):
        got = tp.load(root, _name(case), rank)
        np.testing.assert_allclose(float(got["loss"]), ref["loss"], **TOL)
        assert_trees_close(ref["grads"], tp.unflat("g", got), **GRAD_TOL)


@pytest.mark.parametrize("strat", STRATEGIES)
def test_gpt2_loss_reads_the_ranks_own_positions(runs, strat):
    root, *_ = runs
    dp, sp = (int(s) for s in strat.split(":")[1:])
    got = tp.load(root, _name(("gpt2", strat)))
    assert tuple(got["logits_shape"]) == (BATCH // dp, SEQ // sp, 100)


def _census(root, case):
    got = tp.load(root, _name(case, "census"))
    counts = dict(zip((str(k) for k in got["kinds"]),
                      (int(c) for c in got["counts"])))
    return counts, [str(s) for s in got["gathered"]], int(got["p2p_sends"])


def _activation_gathers(model, strat):
    """The all-gathers a step of ``model`` may hold: BERT's mean pool
    mixes positions and gathers its (b/dp, s, hidden) input over the
    sequence axis, once. GPT-2's position ids are a constant, whole on
    every rank: at dp > 1 its position embedding's output is chunked over
    the data axis, whose backward gathers the grads of the chunks over
    that axis, (b, s/sp, hidden); never over the sequence axis."""
    dp, sp = (int(n) for n in strat.split(":")[1:])
    if model == "bert":
        return [f"{BATCH // dp},{SEQ},{HIDDEN}"]
    return [f"{BATCH},{SEQ // sp},{HIDDEN}"] if dp > 1 else []


@pytest.mark.parametrize("case", CENSUS, ids=lambda c: _name(c, "census"))
def test_census_gathers_no_activation_around_a_per_token_op(runs, case):
    root, *_ = runs
    counts, gathered, sends = _census(root, case)
    model, strat = case
    mode, _dp, sp = strat.split(":")
    sp = int(sp)
    assert gathered == _activation_gathers(model, strat), gathered
    assert counts.get("c10d._allgather_base_", 0) == len(gathered)
    if mode == "ring":
        # forward: sp - 1 rotations of k and v; backward: sp - 1 of k and
        # v, sp of their dK / dV accumulators (the last one brings them
        # home)
        assert sends == LAYERS * 2 * ((sp - 1) + (sp - 1) + sp)
        assert "c10d.alltoall_base_" not in counts
    else:
        assert sends == 0
        assert counts["c10d.alltoall_base_"] == LAYERS * 4 * 2
    # the rest: gradient and loss sums only
    assert set(counts) <= {"c10d.allreduce_", "c10d._allgather_base_",
                           "c10d.alltoall_base_"}, counts


@pytest.mark.parametrize("case", CENSUS, ids=lambda c: _name(c, "census"))
def test_train_step_gathers_no_output(runs, case):
    """One whole train step (loss, grads, metrics, optimizer) gathers what
    the loss's census does and nothing more: no (b, s, vocab) output."""
    root, *_ = runs
    model, strat = case
    for rank in range(WORLD):
        got = tp.load(root, _name(case, "census"), rank)
        gathered = [str(s) for s in got["step_gathered"]]
        assert gathered == _activation_gathers(model, strat), gathered
        assert not any(g.endswith(f",{VOCAB}") for g in gathered)
        assert int(got["step_allgathers"]) == len(gathered)


def _assert_metrics_equal(got, want):
    assert int(got["train_all"]) == int(want["train_all"])
    assert int(got["train_correct"]) == int(want["train_correct"])
    for f in tp.PERF_SUMS + ("loss",):
        np.testing.assert_allclose(float(got[f]), float(want[f]), **TOL,
                                   err_msg=f)
    np.testing.assert_allclose(got["pred"], want["pred"], **TOL)


@pytest.mark.parametrize("case", METRICS, ids=lambda c: _name(c, "metrics"))
def test_eval_and_predict_match_the_jax_package(runs, case):
    root, _refs, _one, jax_eval = runs
    for rank in range(WORLD):
        _assert_metrics_equal(tp.load(root, _name(case, "metrics"), rank),
                              jax_eval[case])


@pytest.mark.parametrize("case", METRICS, ids=lambda c: _name(c, "metrics"))
def test_eval_and_predict_give_the_one_device_numbers(runs, case):
    root, _refs, one, _jax = runs
    for rank in range(WORLD):
        _assert_metrics_equal(tp.load(root, _name(case, "metrics"), rank),
                              one[case])
