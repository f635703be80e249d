"""The port's manual-loop API (``flexflow_tpu_torch/model.py`` ``forward``
/ ``zero_gradients`` / ``backward`` / ``update`` / ``set_batch``, the
``Tensor`` staging calls) and ``Optimizer.set_learning_rate`` against the
JAX package's (flexflow_tpu/model.py:1398-1520, 1589-1625;
flexflow_tpu/tensor.py:76-118), on the small model of
``torch_resilience_pairs``:

* each of three manual steps equals JAX's manual step from the same
  params (``STEP_TOL``), and the three equal the port's own ``fit`` over
  the same batches bit for bit;
* ``backward`` refuses the zero label placeholder that input-only staging
  binds; ``forward`` runs on it;
* ``create_data_loader`` / ``next_batch`` give JAX's batches, and the
  attach-style loop (``next_batch`` -> ``set_tensor`` -> ``forward`` ...)
  trains as ``set_batch`` does;
* ``set_tensor`` / ``get_tensor`` / ``attach_numpy_array`` /
  ``get_array`` of inputs, labels, weights and activations, and the
  no-op ``inline_map`` family;
* ``get_layer_by_id`` / ``get_layer_by_name`` / ``get_tensor_by_id`` name
  JAX's layers and weights;
* ``set_learning_rate`` between two fits takes effect in the next step, as
  JAX's does after its step cache is dropped, and costs the port one
  capture.
"""
import numpy as np
import pytest

import flexflow_tpu_torch as ft
from torch_resilience_pairs import (BATCH, STEP_TOL, assert_params, data,
                                    fj, params_of, seed_params, small_model)


def _pair(**cfg):
    tff = small_model(**cfg)
    jff = small_model(fj, **cfg)
    seed_params(jff, params_of(tff))
    return tff, jff


def _manual(ff, x, y, steps=3):
    for k in range(steps):
        sl = slice(k * BATCH, (k + 1) * BATCH)
        ff.set_batch(x[sl], y[sl])
        ff.forward()
        ff.zero_gradients()
        ff.backward()
        ff.update()


def test_manual_loop_equals_jax_and_fit():
    x, y = data()
    tff, jff = _pair()
    init = params_of(tff)
    for k in range(3):
        seed_params(jff, params_of(tff))
        sl = slice(k * BATCH, (k + 1) * BATCH)
        _manual(tff, x[sl], y[sl], steps=1)
        _manual(jff, x[sl], y[sl], steps=1)
        assert_params(params_of(tff), params_of(jff), **STEP_TOL)
    assert int(tff.opt_state["step"]) == 3
    fit = small_model()
    seed_params(fit, init)
    fit.fit(x[:3 * BATCH], y[:3 * BATCH], epochs=1, shuffle=False)
    assert_params(params_of(tff), params_of(fit))
    # the staged logits are predict's on the last batch
    np.testing.assert_allclose(
        tff._staged["logits"].numpy(), np.asarray(jff._staged["logits"]),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tff._staged["loss"]),
                               float(jff._staged["loss"]), rtol=1e-5)


def test_backward_refuses_the_label_placeholder():
    x, _y = data()
    ff = small_model()
    ff._input_tensors[0].set_tensor(ff, x[:BATCH])
    ff.forward()  # inference runs on input-only staging
    assert ff._staged["logits"].shape == (BATCH, 10)
    with pytest.raises(RuntimeError, match="real label"):
        ff.backward()
    with pytest.raises(RuntimeError, match="backward"):
        ff.update()
    with pytest.raises(RuntimeError, match="bind a batch"):
        small_model().forward()
    np.testing.assert_array_equal(ff.label_tensor.get_tensor(ff),
                                  np.zeros((BATCH, 1), np.int32))


def test_data_loader_and_attach_loop():
    x, y = data()
    tff, jff = _pair()
    fit = small_model()
    seed_params(fit, params_of(tff))
    loaders = {}
    for ff in (tff, jff):
        loaders[ff] = (ff.create_data_loader(ff._input_tensors[0], x),
                       ff.create_data_loader(ff.label_tensor,
                                             y.reshape(-1, 1)))
    tx, ty = loaders[tff]
    jx, jy = loaders[jff]
    assert tx.num_batches == jx.num_batches == 8
    for _ in range(9):  # past the end wraps to the start, as in JAX
        np.testing.assert_array_equal(tx.next_batch(tff),
                                      np.asarray(jx.next_batch(jff)))
        np.testing.assert_array_equal(ty.next_batch(tff),
                                      np.asarray(jy.next_batch(jff)))
    tx.reset(), ty.reset()
    for _ in range(2):
        tff._input_tensors[0].set_tensor(tff, tx.next_batch(tff))
        tff.label_tensor.set_tensor(tff, ty.next_batch(tff))
        tff.forward()
        tff.zero_gradients()
        tff.backward()
        tff.update()
    fit.fit(x[:2 * BATCH], y[:2 * BATCH], epochs=1, shuffle=False)
    assert_params(params_of(tff), params_of(fit))


def test_tensor_staging_calls():
    x, y = data()
    tff, jff = _pair()
    for ff in (tff, jff):
        inp = ff._input_tensors[0]
        inp.attach_numpy_array(ff, ff.config, x[:BATCH])  # long form
        ff.label_tensor.attach_numpy_array(ff, y[:BATCH].reshape(-1, 1))
        assert inp.inline_map(ff, ff.config) is None
        assert inp.inline_unmap(ff, ff.config) is None
        assert inp.detach_numpy_array(ff.config) is None
        np.testing.assert_array_equal(inp.get_array(ff, ff.config),
                                      x[:BATCH])
        np.testing.assert_array_equal(ff.label_tensor.get_tensor(ff),
                                      y[:BATCH].reshape(-1, 1))
    layers = [tff.get_layer_by_name("d1_0"), jff.get_layer_by_name("d1_0")]
    kernels = [layer.weights[0] for layer in layers]
    np.testing.assert_array_equal(kernels[0].get_tensor(tff),
                                  np.asarray(kernels[1].get_tensor(jff)))
    acts = [layer.outputs[0].get_tensor(ff)
            for layer, ff in zip(layers, (tff, jff))]
    assert acts[0].shape == (BATCH, 32)
    np.testing.assert_allclose(acts[0], np.asarray(acts[1]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="activation output"):
        layers[0].outputs[0].set_tensor(tff, acts[0])
    # a weight through set_tensor: the next step starts from it
    new = np.full(kernels[0].dims, 0.01, np.float32)
    kernels[0].set_tensor(tff, new)
    np.testing.assert_array_equal(kernels[0].get_weights(tff), new)
    np.testing.assert_array_equal(tff.get_params_numpy()["d1_0"]["kernel"],
                                  new)


def test_layer_and_tensor_lookups_match_jax():
    tff, jff = _pair()
    for i in range(len(jff._layers)):
        assert tff.get_layer_by_id(i).name == jff.get_layer_by_id(i).name
    assert tff.get_layer_by_name("d2_2").name == "d2_2"
    assert tff.get_layer_by_name("nope") is None
    for i in range(4):
        assert tff.get_tensor_by_id(i).name == jff.get_tensor_by_id(i).name
    tff.init_operators()
    tff.init_layers()


def test_set_learning_rate_takes_effect_in_the_next_step():
    """Two fits with a rate change between: the port's second fit steps
    at the new rate (its captured step is dropped and captured once more)
    and equals JAX's, whose jitted step is dropped the same way."""
    x, y = data()
    tff, jff = _pair()
    ref = small_model()
    seed_params(ref, params_of(tff))
    for ff in (tff, jff, ref):
        ff.fit(x[:2 * BATCH], y[:2 * BATCH], epochs=1, shuffle=False)
    seed_params(jff, params_of(tff))
    program = tff.executor.make_train_step().program
    assert program.captures == 0  # the CPU captures nothing
    for ff in (tff, jff):
        ff.optimizer.set_learning_rate(0.01)
        assert ff.optimizer.lr == 0.01 and ff.optimizer._lr_changed
    jff.executor.invalidate_jit_cache()
    for ff in (tff, jff):
        ff.fit(x[2 * BATCH:3 * BATCH], y[2 * BATCH:3 * BATCH], epochs=1,
               shuffle=False)
    assert not tff.optimizer._lr_changed
    assert tff.executor.make_train_step().program is not program
    assert_params(params_of(tff), params_of(jff), **STEP_TOL)
    # the manual update reads the rate directly: the same step
    ref.optimizer.set_learning_rate(0.01)
    _manual_from(ref, x[2 * BATCH:3 * BATCH], y[2 * BATCH:3 * BATCH])
    assert_params(params_of(ref), params_of(tff))
    adam = ft.AdamOptimizer(None, alpha=1e-3)
    adam.set_learning_rate(5e-4)
    assert adam.alpha == 5e-4


def _manual_from(ff, x, y):
    ff.set_batch(x, y)
    ff.backward()
    ff.update()
