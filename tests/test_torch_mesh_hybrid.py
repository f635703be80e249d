"""The hybrid strategy on four gloo ranks (dp = 2 x tp = 2), against the
JAX package under the same strategy on its virtual mesh and the port's
one-device path (``tests/torch_dist_pairs.py`` runs the ranks,
``tests/torch_mesh_pairs.py`` the references; tolerances there):

* one Adam step of the tiny BERT proxy: loss, grads and params, ``wq``
  held as a head shard on every rank;
* the same step with attention dropout 0.1 equals the one-device port's
  (the masks hash global coordinates), and with ``--collective-overlap
  on`` bitwise the synchronous one;
* ``fit`` over 2 shuffled epochs, ``eval`` and ``predict``: the same on
  every rank and the one-device fit's; ``get_params_numpy`` is the full
  arrays on every rank;
* in bf16 (fp32 masters): the BERT step's loss and grads against the JAX
  package's bf16 step under the same strategy (``BF16_JAX``: the port's
  one-device bf16 step is itself 4.2e-4 in the loss and 7.3e-3 in the
  grads' relative norm off it) and against the one-device port's
  (``BF16_ONE_LOSS``: the sums that cross ranks are fp32, rounded once;
  rounding each rank's partial to bf16 first moves the loss by 1.2e-4).
"""
import numpy as np
import pytest

import flexflow_tpu_torch as ft
import torch_dist_pairs as tp
from torch_mesh_pairs import (GRAD_TOL, TOL, assert_trees_close,
                              assert_trees_equal, data, jax_build, jax_step,
                              jax_weights, port_one_device, write_case)

WORLD = 4
HYB = dict(model="bert", batch=8, strategy="hybrid:2:2")
BF16 = dict(compute_dtype=ft.DataType.DT_BFLOAT16)
# bf16 against the JAX package: the loss's absolute and the grads' relative
# norm difference; against the one-device port: the loss's
BF16_JAX = dict(loss=2e-3, grads=2e-2)
BF16_ONE_LOSS = 1e-5


def rel_norm(want, got):
    num = sum(float(np.sum((np.asarray(got[n][w], np.float64)
                            - np.asarray(want[n][w], np.float64)) ** 2))
              for n in want for w in want[n])
    den = sum(float(np.sum(np.asarray(want[n][w], np.float64) ** 2))
              for n in want for w in want[n])
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hybrid"))
    x, y = data("bert", 8)
    xf, yf = data("bert", 8, n=24, seed=1)
    jff = jax_build("bert", "hybrid:2:2", 8)
    jbf = jax_build("bert", "hybrid:2:2", 8, bf16=True)
    weights = jax_weights(jff)
    cases = []
    for name, kind, kw in (("step", "step", {}),
                           ("dropout", "step", dict(dropout=0.1)),
                           ("overlap", "step", dict(overlap=True)),
                           ("fit", "fit", dict(epochs=2)),
                           ("bf16", "step", BF16)):
        write_case(root, name, *((xf, yf) if kind == "fit" else (x, y)),
                   weights)
        cases.append((name, kind, dict(HYB, **kw)))
    procs = tp.start(WORLD, root, cases)
    refs = {"jax": jax_step(jff, x, y),
            "plain": port_one_device("bert", 8, weights, x, y),
            "dropout": port_one_device("bert", 8, weights, x, y,
                                       dropout=0.1),
            "jax_bf16": jax_step(jbf, x, y),
            "bf16": port_one_device("bert", 8, weights, x, y, **BF16)}
    one = tp.build("bert", None, 8, epochs=2)
    one.set_params_numpy(weights)
    one.fit(xf, yf)
    perf = one.eval(xf, yf)
    refs["fit"] = dict(losses=np.array(one.fit_history.loss),
                       train_correct=perf.train_correct,
                       pred=one.predict(xf), params=one.get_params_numpy())
    tp.finish(procs, root)
    return root, refs


def test_hybrid_step_matches_jax_and_one_device(runs):
    root, refs = runs
    jax_ref, (p_loss, p_grads, p_params) = refs["jax"], refs["plain"]
    for rank in range(WORLD):
        got = tp.load(root, "step", rank)
        loss = float(got["loss"])
        np.testing.assert_allclose(loss, jax_ref["step_loss"], **TOL)
        np.testing.assert_allclose(loss, p_loss, **TOL)
        for want in (jax_ref["grads"], p_grads):
            assert_trees_close(want, tp.unflat("g", got), **GRAD_TOL)
        for want in (jax_ref["params"], p_params):
            assert_trees_close(want, tp.unflat("p", got), **TOL)
        assert tuple(got["wq_local_shape"]) == (64, 2, 16)
        assert str(got["wq_placement"]) == "(Replicate(), Shard(dim=1))"


def test_hybrid_dropout_draws_the_one_device_masks(runs):
    root, refs = runs
    loss, grads, params = refs["dropout"]
    for rank in range(WORLD):
        got = tp.load(root, "dropout", rank)
        np.testing.assert_allclose(float(got["loss"]), loss, **TOL)
        assert_trees_close(grads, tp.unflat("g", got), **GRAD_TOL)
        assert_trees_close(params, tp.unflat("p", got), **TOL)


def test_hybrid_overlap_is_bitwise_the_synchronous_step(runs):
    root, _ = runs
    for rank in range(WORLD):
        sync, ovl = (tp.load(root, n, rank) for n in ("step", "overlap"))
        assert float(sync["loss"]) == float(ovl["loss"])
        assert_trees_equal(tp.unflat("g", sync), tp.unflat("g", ovl))
        assert_trees_equal(tp.unflat("p", sync), tp.unflat("p", ovl))


def test_hybrid_fit_agrees_on_every_rank_and_with_one_device(runs):
    root, refs = runs
    want = refs["fit"]
    r0 = tp.load(root, "fit", 0)
    for rank in range(1, WORLD):
        got = tp.load(root, "fit", rank)
        np.testing.assert_array_equal(got["losses"], r0["losses"])
        np.testing.assert_array_equal(got["pred"], r0["pred"])
        assert int(got["train_correct"]) == int(r0["train_correct"])
        assert_trees_equal(tp.unflat("p", r0), tp.unflat("p", got))
    np.testing.assert_allclose(r0["losses"], want["losses"], **TOL)
    np.testing.assert_allclose(r0["pred"], want["pred"], **TOL)
    assert int(r0["train_correct"]) == want["train_correct"]
    assert_trees_close(want["params"], tp.unflat("p", r0), **TOL)


def test_hybrid_bf16_step_matches_jax_and_one_device(runs):
    root, refs = runs
    jax_ref, (p_loss, p_grads, _p) = refs["jax_bf16"], refs["bf16"]
    for rank in range(WORLD):
        got = tp.load(root, "bf16", rank)
        loss, grads = float(got["loss"]), tp.unflat("g", got)
        assert abs(loss - jax_ref["loss"]) <= BF16_JAX["loss"]
        assert rel_norm(jax_ref["grads"], grads) <= BF16_JAX["grads"]
        assert abs(loss - p_loss) <= BF16_ONE_LOSS

