"""``kernel_regularizer`` of the port against the JAX package's, on the CPU.

A dense layer with ``kernel_regularizer=("l1"|"l2", lam)`` adds ``lam *
sum|W|`` or ``lam * sum W^2`` of its compute-dtype kernel to the training
loss through the ops' aux-loss hook (flexflow_tpu/ops/linear.py:74-89,
flexflow_tpu/execution/executor.py:554-555); eval and predict leave it
out. The same small MLP (16 -> 32 relu -> 4, softmax, both dense layers
regularized) is built in both packages with the JAX weights carried over.
Checked (fp32; the two sides differ in summation order only):

* one train step's loss within 1e-5 of JAX's, its grads and the params
  after one Adam step within 1e-4;
* the penalty is really in the loss: the training loss exceeds the eval
  loss by exactly the penalty of the weights;
* eval loss and predict match JAX's without the penalty (1e-5);
* a tiny GPT-2 with regularized dense layers generates JAX's greedy
  streams (the serving path runs no training forward);
* an unknown kind raises ``ValueError``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.execution.losses import loss_value as jax_loss_value
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.ops.base import OpContext as JaxOpContext
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from torch_training_pairs import assert_trees_close

B, IN, HID, OUT = 8, 16, 32, 4
LAM = 1e-3
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _mlp(pkg, reg):
    config = pkg.FFConfig()
    config.batch_size, config.seed = B, 5
    ff = pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")
    x = ff.create_tensor([B, IN], pkg.DataType.DT_FLOAT)
    h = ff.dense(x, HID, pkg.ActiMode.AC_MODE_RELU, kernel_regularizer=reg)
    h = ff.dense(h, OUT, kernel_regularizer=reg)
    ff.softmax(h)
    ff.compile(optimizer=pkg.AdamOptimizer(ff, alpha=1e-2),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[])
    return ff


def _pair(reg):
    jff, tff = _mlp(fj, reg), _mlp(ft, reg)
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    y = rng.integers(0, OUT, (B, 1)).astype(np.int32)
    return x, y


def _penalty(params, kind):
    ws = [np.asarray(p["kernel"], np.float64) for p in params.values()
          if "kernel" in p]
    f = np.abs if kind == "l1" else np.square
    return LAM * sum(float(f(w).sum()) for w in ws)


def _jax_loss_and_grads(jff, x, y):
    """The JAX train step's loss_fn with its aux losses
    (executor.py:538-556), under ``jax.value_and_grad``."""
    ex = jff.executor

    def loss_fn(params):
        params_c, xs = ex._cast_for_compute(params, [jnp.asarray(x)])
        ctx = JaxOpContext(training=True, rng=jax.random.PRNGKey(0),
                           aux_losses=[])
        values = ex.forward_outputs(params_c, ex._bind_inputs(xs), ctx)
        logits = ex._logits_f32(values[ex.final_guid][ex.final_out_idx])
        loss = jax_loss_value(ex.loss_type, logits,
                              jnp.asarray(jff._prep_label(y)))
        for aux in ctx.aux_losses:
            loss = loss + aux
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jff.params)
    return float(loss), jax.device_get(grads)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_train_step_matches_jax(kind):
    jff, tff = _pair((kind, LAM))
    x, y = _data()
    lab = jff._prep_label(y)
    jl, jg = _jax_loss_and_grads(jff, x, y)
    tl, _logits, tg = tff.executor.loss_and_grads(
        tff.params, [torch.tensor(x)], torch.tensor(lab))
    assert abs(float(tl) - jl) <= 1e-5, (float(tl), jl)
    assert_trees_close(jg, {n: {w: g.numpy() for w, g in ws.items()}
                            for n, ws in tg.items()}, **STEP_TOL)

    # the penalty is in the training loss and not in the eval loss
    pen = _penalty(jax.device_get(jff.params), kind)
    el, _m = tff.executor.make_eval_step()(tff.params, [torch.tensor(x)],
                                           torch.tensor(lab))
    assert pen > 1e-3
    assert abs((float(tl) - float(el)) - pen) <= 1e-5, (tl, el, pen)

    # one Adam step: loss and updated params
    jp, _js, jsl, _ = jff.executor.make_train_step()(
        jff.params, jff.opt_state, [jnp.asarray(x)], jnp.asarray(lab),
        jax.random.PRNGKey(0))
    tp, _ts, tsl, _ = tff.executor.make_train_step()(
        tff.params, tff.opt_state, [torch.tensor(x)], torch.tensor(lab),
        torch.Generator().manual_seed(0))
    assert abs(float(tsl) - float(jsl)) <= 1e-5
    assert_trees_close(jax.device_get(jp),
                       {n: {w: t.numpy() for w, t in ws.items()}
                        for n, ws in tp.items()}, **STEP_TOL)


@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_eval_and_predict_leave_the_penalty_out(kind):
    jff, tff = _pair((kind, LAM))
    x, y = _data(1)
    lab = jff._prep_label(y)
    jl, _ = jff.executor.make_eval_step()(jff.params, [jnp.asarray(x)],
                                          jnp.asarray(lab))
    tl, _ = tff.executor.make_eval_step()(tff.params, [torch.tensor(x)],
                                          torch.tensor(lab))
    assert abs(float(tl) - float(jl)) <= 1e-5, (float(tl), float(jl))
    # the eval loss is the plain cross-entropy of predict's probabilities
    probs = tff.predict(x)
    np.testing.assert_allclose(probs, np.asarray(jff.predict(x)), rtol=1e-5,
                               atol=1e-5)
    xent = -np.mean(np.log(probs[np.arange(B), y[:, 0]]))
    assert abs(float(tl) - xent) <= 1e-5
    assert tff.eval(x, y).train_all == B


def test_generate_with_regularized_dense_layers():
    cfg = dict(batch_size=2, seq_len=32, hidden=64, num_heads=4,
               num_layers=2, intermediate=128, vocab_size=100)
    models = []
    for pkg, gcfg, build in ((fj, JaxGPT2Config, jax_build_gpt2),
                             (ft, GPT2Config, build_gpt2)):
        config = pkg.FFConfig()
        config.batch_size, config.seed = 2, 42
        ff = pkg.FFModel(config) if pkg is fj else \
            pkg.FFModel(config, device="cpu")
        build(ff, gcfg(**cfg))
        dense = [layer for layer in ff._layers
                 if layer.op_type == pkg.OperatorType.OP_LINEAR]
        assert dense
        for layer in dense:
            layer.attrs["kernel_regularizer"] = ("l2", LAM)
        ff.compile(optimizer=pkg.SGDOptimizer(ff),
                   loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        models.append(ff)
    jff, tff = models
    tff.set_params_numpy(jax.device_get(jff.params))
    prompts = [[3, 14, 15, 92, 65], [35, 89, 79]]
    got = tff.generate(prompts, max_new_tokens=6, max_decode_len=32)
    assert got == jff.generate(prompts, max_new_tokens=6, max_decode_len=32)


def test_unknown_kind_raises():
    _jff, tff = _pair(("l3", LAM))
    x, y = _data()
    with pytest.raises(ValueError, match="unknown regularizer kind"):
        tff.executor.loss_and_grads(tff.params, [torch.tensor(x)],
                                    torch.tensor(tff._prep_label(y)))
    # outside training the kind is never read
    assert tff.predict(x).shape == (B, OUT)
