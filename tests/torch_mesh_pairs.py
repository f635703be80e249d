"""The test-process side of the port's mesh tests (tests/test_torch_mesh_*.py):
the JAX package's run of each case under the same strategy on its virtual
8-device mesh (tests/conftest.py), the port's one-device run, and the
spawn of the port's gloo ranks (``torch_dist_pairs``, which imports no
JAX) on the JAX weights.

Tolerances (fp32 on the CPU; the sides differ in summation order only):
the loss and the params after one Adam step within 1e-5, the grads within
rtol 1e-4 / atol 1e-5 (the training parity files' ``GRAD_TOL``).
"""
import os

import numpy as np

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.execution.losses import loss_value as jax_loss_value
from flexflow_tpu.models.bert import BertConfig as JaxBertConfig
from flexflow_tpu.models.bert import build_bert as jax_build_bert
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.models.transformer import build_moe_mlp as jax_moe_mlp
from flexflow_tpu.ops.base import OpContext as JaxOpContext
from flexflow_tpu.parallel import strategies as jax_strategies
from flexflow_tpu.parallel.strategy import \
    data_parallel_strategy as jax_dp_strategy

import torch_dist_pairs as tp

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def jax_strategy(name: str):
    kind, *sizes = name.split(":")
    a, b = ([int(x) for x in sizes] + [1, 1])[:2]
    if kind == "dp":
        return lambda pcg: jax_dp_strategy(pcg, a)
    if kind == "hybrid":
        return lambda pcg: jax_strategies.hybrid_data_tensor_strategy(
            pcg, dp=a, tp=b)
    return lambda pcg: jax_strategies.expert_parallel_strategy(pcg, dp=a,
                                                               ep=b)


def jax_build(model: str, strategy: str, batch: int, bf16: bool = False):
    """The JAX package's twin of ``torch_dist_pairs.build`` (``bf16``: the
    bf16 compute dtype over fp32 masters)."""
    c = fj.FFConfig()
    c.batch_size, c.seed = batch, 3
    if bf16:
        c.compute_dtype = fj.DataType.DT_BFLOAT16
    ff = fj.FFModel(c)
    if model == "bert":
        jax_build_bert(ff, JaxBertConfig.tiny(batch_size=batch))
    elif model == "gpt2":
        _ids, logits = jax_build_gpt2(ff, JaxGPT2Config(
            batch_size=batch, seq_len=16, hidden=64, num_heads=4,
            num_layers=2, intermediate=128, vocab_size=100))
        ff.softmax(logits)
    elif model == "moe":
        jax_moe_mlp(ff, batch_size=batch, in_dim=32, num_classes=4,
                    num_exp=4, num_select=2, expert_hidden=16)
    else:
        x = ff.create_tensor((batch, 32), name="lin_in")
        h = ff.dense(x, 64, fj.ActiMode.AC_MODE_RELU, use_bias=False,
                     name="col")
        ff.dense(h, 8, use_bias=False, name="row")
    loss = (fj.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
            if model == "linear"
            else fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    ff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3), loss_type=loss,
               metrics=[] if model == "gpt2" else
               [fj.MetricsType.METRICS_ACCURACY],
               strategy_fn=jax_strategy(strategy))
    return ff


def jax_weights(jff):
    return {n: {w: np.asarray(a) for w, a in ws.items()}
            for n, ws in jax.device_get(jff.params).items()}


def jax_step(jff, x, y) -> dict:
    """The JAX package's step under its strategy: the weights it started
    from, the loss and grads of its ``loss_fn`` (the aux terms aside), and
    the loss and params of its jitted, donated train step."""
    ex = jff.executor
    weights = jax_weights(jff)
    lab = jff._prep_label(y)

    def loss_fn(params):
        params_c, xs = ex._cast_for_compute(params, [jnp.asarray(x)])
        ctx = JaxOpContext(training=True, rng=jax.random.PRNGKey(0))
        values = ex.forward_outputs(params_c, ex._bind_inputs(xs), ctx)
        logits = ex._logits_f32(values[ex.final_guid][ex.final_out_idx])
        return jax_loss_value(ex.loss_type, logits, jnp.asarray(lab))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jff.params)
    step = ex.make_train_step()
    xs = [jax.device_put(x, ex.batch_sharding(x.ndim))]
    ys = jax.device_put(lab, ex.batch_sharding(lab.ndim))
    params, _state, step_loss, _m = step(jff.params, jff.opt_state, xs, ys,
                                         jax.random.PRNGKey(0))
    return dict(weights=weights, loss=float(loss),
                grads=jax.device_get(grads), step_loss=float(step_loss),
                params=jax.device_get(params))


def data(model: str, batch: int, n: int = 0, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = n or batch
    if model == "bert":
        x = rng.standard_normal((n, 16, 64)).astype(np.float32)
        y = rng.integers(0, 2, (n, 1)).astype(np.int32)
    elif model in ("moe", "moe_experts"):
        x = rng.standard_normal((n, 32)).astype(np.float32)
        y = rng.integers(0, 4, (n, 1)).astype(np.int32)
    elif model == "cnn":
        x = rng.standard_normal((n, 3, 8, 8)).astype(np.float32)
        y = rng.integers(0, 4, (n, 1)).astype(np.int32)
    elif model in ("reg", "mlp"):
        x = rng.standard_normal((n, 32)).astype(np.float32)
        y = rng.integers(0, 4, (n, 1)).astype(np.int32)
    elif model == "gpt2":
        x = rng.integers(0, 100, (n, 16)).astype(np.int32)
        y = rng.integers(0, 100, (n, 16)).astype(np.int32)
    elif model == "emb":
        x = rng.integers(0, 64, (n, 4)).astype(np.int32)
        y = rng.integers(0, 4, (n, 1)).astype(np.int32)
    else:
        x = rng.standard_normal((n, 32)).astype(np.float32)
        y = rng.standard_normal((n, 8)).astype(np.float32)
    return x, y


def write_case(root, name: str, x, y, weights) -> None:
    np.savez(os.path.join(root, f"{name}_in.npz"), x=x, y=y,
             **tp.flat("w", weights))


def port_one_device(model: str, batch: int, weights, x, y, **kw):
    """The port's one-device step on the same weights: (loss, grads,
    params after it)."""
    ff = tp.build(model, None, batch, **kw)
    ff.set_params_numpy(weights)
    return tp.one_step(ff, x, y)


def assert_trees_close(want, got, **tol):
    assert set(want) == set(got)
    for n in want:
        assert set(want[n]) == set(got[n]), n
        for w in want[n]:
            np.testing.assert_allclose(np.asarray(got[n][w]),
                                       np.asarray(want[n][w]), **tol,
                                       err_msg=f"{n}.{w}")


def assert_trees_equal(want, got):
    for n in want:
        for w in want[n]:
            np.testing.assert_array_equal(got[n][w], want[n][w],
                                          err_msg=f"{n}.{w}")
