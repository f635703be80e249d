"""Shared fixtures of the training parity tests (tests/test_torch_training.py,
test_torch_fit.py, test_torch_losses_optim.py): the same tiny models built
in both packages with the same weights, their data, and each package's
loss and grads of one step.

Both packages build the same tiny BERT proxy (batch 4, seq 128, hidden
128, 2 heads so head_dim is 64, 2 layers, intermediate 256, 2 classes) and
the same tiny causal GPT-2 (same widths, vocab 64, a softmax head, token
labels). Every attention layer carries ``use_flash=True``: JAX then runs
its Pallas flash kernels in interpret mode and the port its flash plain
versions, so the whole forward and backward go through both packages'
flash paths. The JAX params are carried over with ``set_params_numpy``.

Tolerances (fp32; the two sides differ in summation order only):
* loss within 1e-5, every grad within rtol 1e-4 / atol 1e-5, and the
  params after one Adam, SGD-momentum or SGD-nesterov step within 1e-5;
* ``fit`` with ``shuffle=True`` over 2 epochs: the per-step losses within
  1e-5 and the ``PerfMetrics`` counts equal;
* ``eval`` and ``predict`` within 1e-5;
* bf16 compute: the loss within 2e-2 of JAX's bf16 loss (the frameworks
  round activations at different points; each side's bf16 loss is itself
  within that band of the fp32 one).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.execution.losses import loss_value as jax_loss_value
from flexflow_tpu.models.bert import BertConfig as JaxBertConfig
from flexflow_tpu.models.bert import build_bert as jax_build_bert
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.ops.base import OpContext as JaxOpContext
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

# parallel test workers share one host with timing-based tests; two
# intra-op threads keep these CPU-heavy files from oversubscribing it
# (they run no slower: the JAX side dominates their time)
torch.set_num_threads(2)

B, S, HID, HEADS, LAYERS, INTER, VOCAB = 4, 128, 128, 2, 2, 256, 64
N_SAMPLES = 12
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _optimizers(kind):
    if kind == "adam":
        return (fj.AdamOptimizer(None, alpha=1e-3),
                ft.AdamOptimizer(None, alpha=1e-3))
    if kind == "momentum":
        return (fj.SGDOptimizer(None, lr=0.05, momentum=0.9,
                                weight_decay=1e-3),
                ft.SGDOptimizer(None, lr=0.05, momentum=0.9,
                                weight_decay=1e-3))
    return (fj.SGDOptimizer(None, lr=0.05, momentum=0.9, nesterov=True),
            ft.SGDOptimizer(None, lr=0.05, momentum=0.9, nesterov=True))


def _build(pkg, model, compute_bf16=False, optimizer=None, metrics=None):
    config = pkg.FFConfig()
    config.batch_size, config.seed = B, 3
    if compute_bf16:
        config.compute_dtype = pkg.DataType.DT_BFLOAT16
    ff = pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")
    if model == "bert":
        cfg = (JaxBertConfig if pkg is fj else BertConfig)(
            batch_size=B, seq_len=S, hidden=HID, num_heads=HEADS,
            num_layers=LAYERS, intermediate=INTER)
        (jax_build_bert if pkg is fj else build_bert)(ff, cfg)
    else:
        cfg = (JaxGPT2Config if pkg is fj else GPT2Config)(
            batch_size=B, seq_len=S, hidden=HID, num_heads=HEADS,
            num_layers=LAYERS, intermediate=INTER, vocab_size=VOCAB)
        _ids, logits = (jax_build_gpt2 if pkg is fj else build_gpt2)(ff, cfg)
        ff.softmax(logits)
    for layer in ff._layers:
        if layer.op_type == pkg.OperatorType.OP_MULTIHEAD_ATTENTION:
            layer.attrs["use_flash"] = True
    ff.compile(optimizer=optimizer,
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=metrics or [])
    return ff


def build_pair(model, compute_bf16=False, opt="adam", accuracy=False):
    jopt, topt = _optimizers(opt)
    jm = [fj.MetricsType.METRICS_ACCURACY] if accuracy else []
    tm = [ft.MetricsType.METRICS_ACCURACY] if accuracy else []
    jff = _build(fj, model, compute_bf16, jopt, jm)
    tff = _build(ft, model, compute_bf16, topt, tm)
    tff.set_params_numpy(jax.device_get(jff.params))
    return jff, tff


def data(model, n=B, seed=0):
    rng = np.random.default_rng(seed)
    if model == "bert":
        x = rng.standard_normal((n, S, HID)).astype(np.float32)
        y = rng.integers(0, 2, (n, 1)).astype(np.int32)
    else:
        x = rng.integers(0, VOCAB, (n, S)).astype(np.int32)
        y = rng.integers(0, VOCAB, (n, S)).astype(np.int32)
    return x, y


def jax_loss_and_grads(jff, x, y):
    """The JAX train step's ``loss_fn`` (executor.py:538-556) under
    ``jax.value_and_grad``, without the update."""
    ex = jff.executor

    def loss_fn(params):
        params_c, xs = ex._cast_for_compute(params, [jnp.asarray(x)])
        ctx = JaxOpContext(training=True, rng=jax.random.PRNGKey(0))
        values = ex.forward_outputs(params_c, ex._bind_inputs(xs), ctx)
        logits = ex._logits_f32(values[ex.final_guid][ex.final_out_idx])
        return jax_loss_value(ex.loss_type, logits,
                              jnp.asarray(jff._prep_label(y)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jff.params)
    return float(loss), jax.device_get(grads)


def port_loss_and_grads(tff, x, y):
    loss, _logits, grads = tff.executor.loss_and_grads(
        tff.params, [torch.tensor(x)], torch.tensor(tff._prep_label(y)))
    return float(loss), {n: {w: g.numpy() for w, g in ws.items()}
                         for n, ws in grads.items()}


def assert_trees_close(want, got, **tol):
    assert set(want) == set(got)
    for n in want:
        assert set(want[n]) == set(got[n]), n
        for w in want[n]:
            np.testing.assert_allclose(np.asarray(got[n][w]),
                                       np.asarray(want[n][w]), **tol,
                                       err_msg=f"{n}.{w}")


