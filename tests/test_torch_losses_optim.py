"""Losses, metrics and optimizers of the port against the JAX package's.

Array level: every loss type and every metric on the same random arrays
(probabilities, sparse and dense labels) in both packages, within 1e-6
(fp32; summation order only); every optimizer (SGD plain, momentum with
weight decay, nesterov; Adam plain, with weight decay and with bf16
moments) updating the same params with the same grads for three steps,
within 1e-6 (bf16 moments: 1e-3, one bf16 rounding of m and v per step).

Model level: one Adam, SGD-momentum and SGD-nesterov train step of the
tiny BERT proxy of ``torch_training_pairs`` (flash attention on every
layer) twice in a row, the params within 1e-5 of JAX's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.execution.losses import loss_value as jax_loss_value
from flexflow_tpu.execution.metrics import Metrics as JaxMetrics
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.execution.losses import loss_value
from flexflow_tpu_torch.execution.metrics import Metrics
from torch_training_pairs import TOL, assert_trees_close, build_pair, data

LT, MT = ft.LossType, ft.MetricsType


def _probs(rng, shape):
    z = rng.standard_normal(shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _arrays(seed=0, b=6, c=5):
    rng = np.random.default_rng(seed)
    p = _probs(rng, (b, c))
    sparse = rng.integers(0, c, (b, 1)).astype(np.int32)
    dense = _probs(rng, (b, c))
    return p, sparse, dense


@pytest.mark.parametrize("loss", list(LT))
def test_loss_values_match_jax(loss):
    p, sparse, dense = _arrays()
    y = sparse if loss == LT.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY else dense
    want = float(jax_loss_value(fj.LossType(int(loss)), jnp.asarray(p),
                                jnp.asarray(y)))
    got = float(loss_value(loss, torch.tensor(p), torch.tensor(y)))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_token_level_sparse_cce_matches_jax():
    rng = np.random.default_rng(1)
    p = _probs(rng, (3, 7, 11))
    y = rng.integers(0, 11, (3, 7)).astype(np.int32)
    lt = LT.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    want = float(jax_loss_value(fj.LossType(int(lt)), jnp.asarray(p),
                                jnp.asarray(y)))
    got = float(loss_value(lt, torch.tensor(p), torch.tensor(y)))
    assert abs(got - want) <= 1e-6


@pytest.mark.parametrize("loss", [LT.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                                  LT.LOSS_CATEGORICAL_CROSSENTROPY,
                                  LT.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE])
def test_metrics_match_jax(loss):
    p, sparse, dense = _arrays(2)
    y = sparse if loss == LT.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY else dense
    measures = list(MT)
    if loss != LT.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        measures.remove(MT.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY)
    want = JaxMetrics(fj.LossType(int(loss)),
                      [fj.MetricsType(int(m)) for m in measures]).compute(
        jnp.asarray(p), jnp.asarray(y))
    got = Metrics(loss, measures).compute(torch.tensor(p), torch.tensor(y))
    assert set(got) == set(want)
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * max(
            1.0, abs(float(want[k]))), k
    jperf, tperf = fj.execution.metrics.PerfMetrics(), ft.PerfMetrics()
    jperf.update(jax.device_get(want))
    tperf.update({k: float(v) for k, v in got.items()})
    assert tperf.train_all == jperf.train_all
    assert tperf.train_correct == jperf.train_correct
    assert tperf.accuracy() == jperf.accuracy()


OPTIMIZERS = [
    ("sgd", dict(lr=0.1), 1e-6),
    ("sgd", dict(lr=0.1, momentum=0.9, weight_decay=0.01), 1e-6),
    ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True), 1e-6),
    ("adam", dict(alpha=0.01), 1e-6),
    ("adam", dict(alpha=0.01, weight_decay=0.01, beta2=0.99), 1e-6),
    ("adam", dict(alpha=0.01, moment_dtype="bf16"), 1e-3),
]


@pytest.mark.parametrize("kind,kwargs,tol", OPTIMIZERS)
def test_optimizer_updates_match_jax(kind, kwargs, tol):
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                    "b": rng.standard_normal(3).astype(np.float32)}}
    grads = [{"a": {w: rng.standard_normal(p.shape).astype(np.float32)
                    for w, p in params["a"].items()}} for _ in range(3)]
    jk, tk = dict(kwargs), dict(kwargs)
    if kwargs.get("moment_dtype"):
        jk["moment_dtype"], tk["moment_dtype"] = jnp.bfloat16, torch.bfloat16
    cls = {"sgd": (fj.SGDOptimizer, ft.SGDOptimizer),
           "adam": (fj.AdamOptimizer, ft.AdamOptimizer)}[kind]
    jopt, topt = cls[0](None, **jk), cls[1](None, **tk)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = {n: {w: torch.tensor(a) for w, a in ws.items()}
          for n, ws in params.items()}
    js, ts = jopt.init_state(jp), topt.init_state(tp)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.update(tp, {n: {w: torch.tensor(a)
                                      for w, a in ws.items()}
                                  for n, ws in g.items()}, ts)
    assert ts["step"] == 3
    for w in params["a"]:
        np.testing.assert_allclose(tp["a"][w].numpy(),
                                   np.asarray(jp["a"][w]), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("opt", ["adam", "momentum", "nesterov"])
def test_updated_params_match_jax(opt):
    jff, tff = build_pair("bert", opt=opt)
    x, y = data("bert")
    jstep = jff.executor.make_train_step()
    tstep = tff.executor.make_train_step()
    jp, js = jff.params, jff.opt_state
    tp, ts = tff.params, tff.opt_state
    # two steps: the second reads the first's moments
    for i in range(2):
        jp, js, jl, _ = jstep(jp, js, [jnp.asarray(x)],
                              jnp.asarray(jff._prep_label(y)),
                              jax.random.PRNGKey(i))
        tp, ts, tl, _ = tstep(tp, ts, [torch.tensor(x)],
                              torch.tensor(tff._prep_label(y)),
                              torch.Generator().manual_seed(i))
        assert abs(float(tl) - float(jl)) <= 1e-5
    assert ts["step"] == 2
    assert_trees_close(jax.device_get(jp),
                       {n: {w: t.numpy() for w, t in ws.items()}
                        for n, ws in tp.items()}, **TOL)
