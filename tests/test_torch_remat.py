"""The port's ``--remat`` (``flexflow_tpu_torch/execution/remat.py``,
``Executor._forward_remat``) against the JAX package's
(``tests/test_remat.py:49-75, 117-147``), on the tiny BERT proxy:

* ``remat_segments`` cuts the same node names as JAX's, and the PCG's
  bottlenecks are JAX's;
* one Adam step under each level gives the port's no-remat step bit for
  bit, and JAX's step at that level within rtol 1e-6 (loss) and
  ``ADAM_STEP_TOL`` (params);
* with attention dropout 0.1 remat gives the no-remat
  step bit for bit, eagerly and through the step program (a block's
  seeds are drawn once and replayed on its recompute), as is a dropout
  op's mask, and a regularizer's aux loss is counted once;
* node forward calls per level: ``none`` runs each node once;
  ``selective`` runs the saveable nodes (dense, attention) once and
  recomputes only the others; ``full`` recomputes attention as well.
"""
import collections

import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.execution.remat import \
    REMAT_SAVEABLE_OPS as JAX_SAVEABLE_OPS
from flexflow_tpu.execution.remat import remat_segments as jax_segments
from flexflow_tpu.models.bert import BertConfig as JaxBertConfig
from flexflow_tpu.models.bert import build_bert as jax_build_bert
from flexflow_tpu_torch.execution.remat import (REMAT_LEVELS,
                                                REMAT_SAVEABLE_OPS, RematPlan,
                                                remat_segments,
                                                resolve_remat_plan)
from flexflow_tpu_torch.models.bert import BertConfig, build_bert

torch.set_num_threads(2)

B = 4
# the params after one Adam step of either package: test_remat.py holds
# JAX's levels to its own none at rtol 1e-5 / atol 1e-6, but across the
# packages Adam's first update alpha * g / (|g| + eps) turns the grads'
# summation-order difference into up to a visible fraction of alpha (1e-3)
# where an element of g is near eps: 6.9e-6 on 1 of 8192 elements of
# l0_fc2's kernel, measured
ADAM_STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _bert(pkg, level="", dropout=0.0, init=None):
    config = pkg.FFConfig()
    config.batch_size = B
    config.remat = level
    cfg = (BertConfig if pkg is ft else JaxBertConfig).tiny(batch_size=B)
    cfg.dropout = dropout
    if pkg is ft:
        ff = pkg.FFModel(config, device="cpu")
        build_bert(ff, cfg)
    else:
        ff = pkg.FFModel(config)
        jax_build_bert(ff, cfg)
    ff.compile(optimizer=pkg.AdamOptimizer(ff, alpha=1e-3),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    if init is not None:
        if pkg is ft:
            ff.set_params_numpy(init)
        else:
            ff.params = jax.tree_util.tree_map(jax.device_put, init)
    return ff, cfg


def _batch(cfg):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, cfg.seq_len, cfg.hidden)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, size=(B, 1)).astype(np.int32)
    return x, y


def _names(pcg, segs):
    return [[pcg.nodes[g].name for g in seg] for seg in segs]


@pytest.mark.parametrize("size", [2, 4, 8])
def test_segments_and_bottlenecks_match_jax(size):
    tff, _ = _bert(ft)
    jff, _ = _bert(fj)
    got = _names(tff.pcg, remat_segments(tff.pcg, size))
    assert got == _names(jff.pcg, jax_segments(jff.pcg, size))
    assert [g for seg in got for g in seg] == [
        n.name for n in tff.pcg.compute_nodes()]  # an ordered cover
    assert len(got) >= 2
    assert [tff.pcg.nodes[g].name for g in tff.pcg.bottlenecks()] == [
        jff.pcg.nodes[g].name for g in jff.pcg.bottlenecks()]


def _port_step(ff, x, y, seed=7, capture=False, steps=1):
    """``steps`` train steps of the port from its current state: (losses,
    host params)."""
    step = ff.executor.make_train_step(capture=capture)
    losses = []
    for k in range(steps):
        _p, _s, loss, _m = step(ff.params, ff.opt_state, [torch.tensor(x)],
                                torch.tensor(y),
                                torch.Generator().manual_seed(seed + k))
        losses.append(float(loss))
    return losses, ff.get_params_numpy()


def _assert_same(a, b):
    for n in a:
        for w in a[n]:
            np.testing.assert_array_equal(a[n][w], b[n][w],
                                          err_msg=f"{n}.{w}")


def test_levels_equal_no_remat_and_jax():
    """One Adam step under each level: the port's none bit for bit, and
    JAX's step at the same level within its own remat test's bands."""
    import jax.random as jr

    base, cfg = _bert(fj)
    init = jax.device_get(base.params)
    x, y = _batch(cfg)
    port = {}
    for level in REMAT_LEVELS:
        tff, _ = _bert(ft, "" if level == "none" else level, init=init)
        port[level] = _port_step(tff, x, y)
        assert (tff.executor.remat_plan is None) == (level == "none")
        jff, _ = _bert(fj, "" if level == "none" else level, init=init)
        step = jff.executor.make_train_step()
        p, _o, jloss, _m = step(jff.params, jff.opt_state, [x], y,
                                jr.PRNGKey(7))
        np.testing.assert_allclose(port[level][0][0], float(jloss),
                                   rtol=1e-6)
        jp = jax.device_get(p)
        for n in jp:
            for w in jp[n]:
                np.testing.assert_allclose(port[level][1][n][w],
                                           np.asarray(jp[n][w]),
                                           err_msg=f"{n}.{w}",
                                           **ADAM_STEP_TOL)
    for level in ("selective", "full"):
        assert port[level][0] == port["none"][0]
        _assert_same(port[level][1], port["none"][1])


@pytest.mark.parametrize("capture", [False, True])
def test_dropout_under_remat_equals_no_remat(capture):
    """Attention dropout 0.1, two steps: the recompute replays the block's
    seeds, so every level gives the no-remat
    losses and params bit for bit (eagerly, and through the step program's
    fed seed buffer on its second call)."""
    res = {}
    for level in REMAT_LEVELS:
        ff, cfg = _bert(ft, "" if level == "none" else level, dropout=0.1)
        x, y = _batch(cfg)
        res[level] = _port_step(ff, x, y, capture=capture, steps=2)
    assert res["none"][0][0] != res["none"][0][1]
    for level in ("selective", "full"):
        assert res[level][0] == res["none"][0], level
        _assert_same(res[level][1], res["none"][1])


def test_regularizer_and_dropout_op_under_remat():
    """A ``kernel_regularizer`` adds its penalty to the loss inside a remat
    block; the block hands it out as an output, so the recompute does not
    add it again. The dropout op's mask replays on the recompute."""
    def run(level):
        c = ft.FFConfig()
        c.batch_size, c.remat, c.remat_segment_size = 4, level, 1
        ff = ft.FFModel(c, device="cpu")
        x = ff.create_tensor((4, 8))
        t = ff.relu(ff.dense(x, 16, kernel_regularizer=("l2", 0.1)))
        t = ff.dropout(t, 0.3)
        t = ff.tanh(ff.dense(t, 16, kernel_regularizer=("l1", 0.05)))
        ff.dense(t, 3)
        ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.1))
        xs = np.random.default_rng(1).standard_normal((4, 8)).astype(
            np.float32)
        ys = np.array([[0], [1], [2], [1]], np.int32)
        return _port_step(ff, xs, ys)

    base = run("")
    for level in ("selective", "full"):
        got = run(level)
        assert got[0] == base[0]
        _assert_same(got[1], base[1])


def test_node_forward_calls_per_level():
    """Forward calls of each node in one step: every node once under
    none; under selective the saveable nodes (attention, dense) once and
    no node more than twice; under full attention twice (its forward
    kernel runs again in the backward) and no node more than twice."""
    calls = collections.Counter()

    def counted(op):
        f = op.forward

        def forward(params, inputs, ctx):
            calls[op.name] += 1
            return f(params, inputs, ctx)
        return forward

    for level in REMAT_LEVELS:
        ff, cfg = _bert(ft, "" if level == "none" else level)
        nodes = ff.pcg.compute_nodes()
        for n in nodes:
            n.op.forward = counted(n.op)
        calls.clear()
        _port_step(ff, *_batch(cfg))
        saveable = [n.name for n in nodes
                    if n.op.op_type in REMAT_SAVEABLE_OPS]
        attn = [n.name for n in nodes if n.op.op_type ==
                ft.OperatorType.OP_MULTIHEAD_ATTENTION]
        assert set(calls) == {n.name for n in nodes}
        assert max(calls.values()) == (1 if level == "none" else 2)
        if level == "selective":
            assert all(calls[n] == 1 for n in saveable)
        if level == "full":
            assert all(calls[n] == 2 for n in attn)


def test_remat_plan_resolution_and_validation():
    config = ft.FFConfig()
    assert resolve_remat_plan(config) == RematPlan("none", 8)
    strategy = type("S", (), {"remat": "selective"})()
    assert resolve_remat_plan(config, strategy).level == "selective"
    config.remat, config.remat_segment_size = "full", 3
    assert resolve_remat_plan(config, strategy) == RematPlan("full", 3)
    with pytest.raises(ValueError, match="remat level"):
        RematPlan("everything")
    assert {t.name for t in REMAT_SAVEABLE_OPS} == {
        t.name for t in JAX_SAVEABLE_OPS}
