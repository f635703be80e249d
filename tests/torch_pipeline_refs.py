"""The test-process side of the port's pipeline tests
(tests/test_torch_pipeline*.py): the JAX package's twin of each model of
``torch_pipeline_pairs`` and its ``PipelineTrainer`` on the same weights
and grid (the conftest's 8 virtual CPU devices), the port's one-device
step, and the weights every side starts from (the port's one-device
init, which both packages load by name).

Tolerances: fp32 on the CPU, the sides differ in summation order only —
losses and params within 1e-5.
"""
import os

import numpy as np

import flexflow_tpu as fj
from flexflow_tpu.models.bert import BertConfig as JaxBertConfig
from flexflow_tpu.models.bert import build_bert as jax_build_bert
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
from flexflow_tpu.parallel.pipeline import PipelineTrainer as JaxTrainer

import torch_dist_pairs as tp
import torch_pipeline_pairs as pairs

TOL = dict(rtol=1e-5, atol=1e-5)


def jax_build(model: str, batch: int = pairs.BATCH):
    """The JAX package's twin of ``torch_pipeline_pairs.build``."""
    c = fj.FFConfig()
    c.batch_size, c.seed = batch, 3
    ff = fj.FFModel(c)
    if model == "mlp":
        x = ff.create_tensor((batch, 16), name="x")
        t = ff.relu(ff.dense(x, 32, name="d1"))
        t = ff.relu(ff.dense(t, 32, name="d2"))
        ff.softmax(ff.dense(t, 10, name="d3"))
    elif model == "skip":
        x = ff.create_tensor((batch, 16), name="x")
        t1 = t = ff.dense(x, 32, name="s1")
        for i in range(3):
            t = ff.dense(ff.relu(t), 32, name=f"m{i}")
        ff.softmax(ff.dense(ff.add(t, t1), 10, name="out"))
    elif model == "bert":
        jax_build_bert(ff, JaxBertConfig.tiny(batch_size=batch))
    else:
        _ids, logits = jax_build_gpt2(ff, JaxGPT2Config(
            batch_size=batch, seq_len=16, hidden=64, num_heads=4,
            num_layers=2, intermediate=128, vocab_size=100))
        ff.softmax(logits)
    return ff


def jax_optimizer(kind: str):
    if kind == "adam":
        return fj.AdamOptimizer(None, alpha=1e-3)
    return fj.SGDOptimizer(None, lr=float(kind.split(":")[1]))


def weights(model: str, batch: int = pairs.BATCH):
    """The port's one-device initial weights of ``model`` (numpy)."""
    import flexflow_tpu_torch as ft

    ff = pairs.build(model, batch)
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.1),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff.get_params_numpy()


def jax_pipeline(model: str, w, x, y, pp: int, dp: int, n_micro: int,
                 opt: str = "sgd:0.1", steps: int = 2, **kw) -> dict:
    """The JAX ``PipelineTrainer``'s losses and params after each step."""
    tr = JaxTrainer(jax_build(model, len(x)), pp=pp, dp=dp, n_micro=n_micro,
                    optimizer=jax_optimizer(opt), init_params=False, **kw)
    tr.load_params(w)
    out = {}
    for s in range(steps):
        out[f"loss{s}"] = float(tr.train_step(x, y, rng_seed=s))
        out[f"p{s}"] = tr.export_params()
    return out


def port_one_device(model: str, w, x, y, opt: str = "sgd:0.1"):
    """The port's one-device step on the same weights: (loss, grads,
    params after it)."""
    import flexflow_tpu_torch as ft

    ff = pairs.build(model, len(x))
    ff.compile(optimizer=pairs.optimizer(opt),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    ff.set_params_numpy(w)
    return tp.one_step(ff, x, y)


def write_case(root, name: str, x, y, w, **extra) -> None:
    np.savez(os.path.join(root, f"{name}_in.npz"), x=x, y=y,
             **tp.flat("w", w), **extra)


def assert_trees_close(want, got, **tol):
    assert set(want) == set(got)
    for n in want:
        assert set(want[n]) == set(got[n]), n
        for w in want[n]:
            np.testing.assert_allclose(np.asarray(got[n][w]),
                                       np.asarray(want[n][w]), **tol,
                                       err_msg=f"{n}.{w}")


def assert_trees_equal(want, got):
    assert set(want) == set(got)
    for n in want:
        for w in want[n]:
            np.testing.assert_array_equal(got[n][w], want[n][w],
                                          err_msg=f"{n}.{w}")
