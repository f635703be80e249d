"""``--debug-nans`` in the port against the JAX package's
(tests/test_aux_subsystems.py:137-164).

The JAX package sets ``jax_debug_nans``, so any jitted op that produces a
NaN raises ``FloatingPointError``. A captured CUDA graph cannot raise
mid-program, so under the flag the port runs its steps eagerly, checks
each node's forward outputs (``torch.isnan``) and hooks each node's
backward, inside ``torch.autograd.detect_anomaly(check_nan=True)``: it
raises ``FloatingPointError`` naming the node whose output or input grad
holds the NaN. Both packages raise on the same models; a clean model
trains under the flag to the losses it trains to without it.
"""
import numpy as np
import pytest
import torch

import jax
import jax.random as jrandom

import flexflow_tpu as fj
import flexflow_tpu_torch as ft


def _model(pkg, backward: bool, debug: bool = True):
    """``log`` of the input (forward NaN on negative inputs), or a dense
    layer, ``pow 0.5`` and a multiply by zero (NaN only in the backward:
    0 x inf at a zero activation)."""
    c = pkg.FFConfig()
    if debug:
        c.parse_args(["--debug-nans"])
        assert c.debug_nans
    c.batch_size = 4
    ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
    x = ff.create_tensor((4, 8))
    if backward:
        t = ff.dense(x, 8, name="d0")
        t = ff.pow(t, 0.5, name="sq")
        t = ff.scalar_multiply(t, 0.0, name="zero")
    else:
        t = ff.log(x, name="lg")
    ff.dense(t, 3, name="head")
    ff.compile(loss_type=pkg.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    return ff


def _inputs(backward):
    rng = np.random.default_rng(0)
    x = (np.zeros((4, 8), np.float32) if backward else
         -np.abs(rng.normal(size=(4, 8))).astype(np.float32) - 1.0)
    return x, rng.normal(size=(4, 3)).astype(np.float32)


def _jax_raises(backward):
    jff = _model(fj, backward)
    if backward:  # the JAX dense's zero bias: d0's output is exactly 0
        w = jff.params
        assert not np.asarray(w["d0_0"]["bias"]).any()
    x, y = _inputs(backward)
    try:
        step = jff.executor.make_train_step()
        with pytest.raises(FloatingPointError):
            out = step(jff.params, jff.opt_state, [x], y,
                       jrandom.PRNGKey(0))
            jax.block_until_ready(out)
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_both_packages_raise_naming_the_node(backward):
    _jax_raises(backward)
    ff = _model(ft, backward)
    x, y = _inputs(backward)
    step = ff.executor.make_train_step()
    assert getattr(step, "program", None) is None  # eager under the flag
    with pytest.raises(FloatingPointError) as e:
        step(ff.params, ff.opt_state, [torch.tensor(x)], torch.tensor(y),
             torch.Generator().manual_seed(0))
    node = "sq_1" if backward else "lg_0"
    assert f"'{node}'" in str(e.value)
    assert ("input grad" if backward else "forward output") in str(e.value)
    with pytest.raises(FloatingPointError, match=node):
        ff.fit(x, y, epochs=1)


def test_eval_and_predict_check_the_forward():
    ff = _model(ft, backward=False)
    x, y = _inputs(False)
    with pytest.raises(FloatingPointError, match="lg_0"):
        ff.predict(x)
    with pytest.raises(FloatingPointError, match="lg_0"):
        ff.eval(x, y)


def test_a_clean_model_trains_alike_under_the_flag():
    """Positive inputs: no NaN anywhere; the eager steps under the flag
    give the losses the captured steps give without it."""
    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(size=(16, 8))).astype(np.float32) + 0.5
    y = rng.normal(size=(16, 3)).astype(np.float32)
    losses = []
    for debug in (False, True):
        ff = _model(ft, backward=False, debug=debug)
        ff.fit(x, y, epochs=2, shuffle=False)
        losses.append(ff.fit_history.loss)
    assert len(losses[0]) == 8 and np.isfinite(losses[0]).all()
    np.testing.assert_array_equal(losses[1], losses[0])
