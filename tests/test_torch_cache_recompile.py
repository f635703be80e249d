"""The port's cache op and dynamic recompile (``ops/moe_ops.CacheOp``,
``Executor.init_cache``, ``execution/recompile.py``, ``FFModel.fit(
recompile_state=)``) against the JAX package's (``tests/test_cache_op.py``,
``tests/test_aux_subsystems.py:51-74``), on the MoE model with a cached
top-k assignment:

* the scores ``score_fn`` sees, step by step, equal the JAX run's on the
  same weights and batches (the assignments are integers: exact);
* the step reads the cache: with ``__use_cache__`` set the loss is the
  JAX step's on the same cache state (``CACHE_TOL``), the fresh value is
  the step's own assignment, and flipping the flag or rewriting the cache
  in place reuses the step program's one entry (no new buffers, which on
  the card would be a recapture); the op alone blends as the JAX op does;
* the recompile fires once, at the same step as in the JAX run, keeps
  every param whose name and shape match (the widened layer takes its new
  shape), drops the old executor's programs, and the model trains on.
"""
import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from flexflow_tpu.execution.recompile import \
    RecompileState as JaxRecompileState
from flexflow_tpu_torch.execution.recompile import RecompileState
from flexflow_tpu_torch.ffconst import ActiMode, OperatorType
from torch_resilience_pairs import params_of, seed_params

torch.set_num_threads(2)

# one MoE step's loss across the packages from equal params and cache
# state: summation order only
CACHE_TOL = dict(rtol=1e-5, atol=1e-6)


def build(pkg, score_fn=None, batch=32, num_exp=4):
    """``tests/test_cache_op.py``'s MoE model in ``pkg``."""
    c = pkg.FFConfig()
    c.batch_size = batch
    if pkg is fj:
        c.only_data_parallel = True
    ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
    x = ff.create_tensor((batch, 64), name="in")
    gate = ff.softmax(ff.dense(x, num_exp, name="gate"))
    vals, assign = ff.top_k(gate, 2)[:2]
    if score_fn is not None:
        assign = ff.cache(assign, num_batches=2, score_fn=score_fn,
                          name="assign_cache")
    grouped = ff.group_by(x, assign, num_exp, alpha=2.0)
    experts = [ff.dense(g, 32, activation=ActiMode.AC_MODE_RELU,
                        name=f"exp_{i}") for i, g in enumerate(grouped)]
    out = ff.aggregate(vals, assign, assign, gate, experts, num_exp,
                       lambda_bal=0.01)
    ff.softmax(ff.dense(out, 4, name="cls"))
    ff.compile(optimizer=pkg.AdamOptimizer(ff, alpha=1e-3),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(96, 64)).astype(np.float32)
    w = rng.normal(size=(64, 4)).astype(np.float32)
    ys = np.argmax(xs @ w, axis=1)[:, None].astype(np.int32)
    return xs, ys


def _recording(seen):
    """A ``score_fn`` that keeps each score it gives in ``seen``."""
    def score(old, new):
        seen.append(float((old == new).mean()))
        return seen[-1]
    return score


def test_cache_scores_equal_jax():
    xs, ys = _data()
    scores = {ft: [], fj: []}
    tff = build(ft, _recording(scores[ft]))
    jff = build(fj, _recording(scores[fj]))
    seed_params(jff, params_of(tff))
    assert len(tff.executor.cache_nodes) == 1
    for ff in (tff, jff):
        ff.fit(xs, ys, epochs=2, shuffle=False)
        (name,) = ff.cache_scores
        assert name.startswith("assign_cache")
    # six steps, scored after steps 2, 4 and 6
    assert len(scores[ft]) == 3 and all(0.0 <= v <= 1.0
                                        for v in scores[ft])
    assert scores[ft] == scores[fj]
    assert tff.cache_scores == jff.cache_scores


def _step_with_cache(ff, xs, ys, assign, use):
    """One train step of ``ff`` (either package) from its current state
    with the cache holding ``assign`` and ``__use_cache__ = use``: (loss,
    the fresh assignment)."""
    bx, by = xs[:32], ys[:32]
    ex = ff.executor
    name = ex.cache_nodes[0].name
    if ff.__class__ is fj.FFModel:
        import jax.numpy as jnp

        cache = {"__use_cache__": jnp.asarray(use), name: jnp.asarray(assign)}
        out = ex.make_train_step()(ff.params, ff.opt_state,
                                   [jax.device_put(bx)], jax.device_put(by),
                                   jax.random.PRNGKey(0), cache)
        ff.params, ff.opt_state = out[0], out[1]
        return float(out[2]), np.asarray(out[4][name])
    cache = ex.init_cache()
    cache["__use_cache__"].fill_(use)
    cache[name].copy_(torch.tensor(assign))
    out = ex.make_train_step()(ff.params, ff.opt_state, [torch.tensor(bx)],
                               torch.tensor(by), None, cache)
    return float(out[2]), out[4][name].numpy()


def test_use_cache_blend_in_the_step_equals_jax():
    xs, ys = _data()
    tff, jff = build(ft, lambda a, b: 0.0), build(fj, lambda a, b: 0.0)
    seed_params(jff, params_of(tff))
    # a cached assignment every token sends to experts 0 and 1
    cached = np.tile(np.asarray([[0, 1]], np.int32), (32, 1))
    got, want = {}, {}
    for use in (False, True):
        got[use] = _step_with_cache(tff, xs, ys, cached, use)
        want[use] = _step_with_cache(jff, xs, ys, cached, use)
        np.testing.assert_allclose(got[use][0], want[use][0], **CACHE_TOL)
        np.testing.assert_array_equal(got[use][1], want[use][1])
    assert got[True][0] != got[False][0]  # the cached routing was used


def test_cache_flag_and_values_change_in_place():
    """Flipping ``__use_cache__`` and rewriting the cache with ``copy_``
    keep the program's one entry (its stamp holds the same tensors)."""
    xs, ys = _data()
    tff = build(ft, lambda a, b: 0.0)
    ex = tff.executor
    name = ex.cache_nodes[0].name
    cache = ex.init_cache()
    assert cache[name].dtype == torch.int32 and \
        tuple(cache[name].shape) == (32, 2)
    assert cache["__use_cache__"].dtype == torch.bool and \
        not bool(cache["__use_cache__"])
    step = ex.make_train_step()
    losses = []
    for use, fill in ((False, 0), (True, 0), (True, 3), (False, 3)):
        cache["__use_cache__"].fill_(use)
        cache[name].fill_(fill)
        out = step(tff.params, tff.opt_state, [torch.tensor(xs[:32])],
                   torch.tensor(ys[:32]), None, cache)
        losses.append(float(out[2]))
    assert len(step.program._entries) == 1
    assert len(set(losses)) == 4


def test_cache_op_blends_the_cached_value():
    from flexflow_tpu_torch.ops.base import OpContext
    from flexflow_tpu_torch.ops.moe_ops import CacheOp

    op = CacheOp("c", {"num_batches": 2}, None, num_inputs=1)
    fresh = torch.tensor([1, 2, 3], dtype=torch.int32)
    cached = torch.tensor([7, 8, 9], dtype=torch.int32)
    sink = {}
    ctx = OpContext(training=True, cache_in={"c": cached, "__use_cache__":
                                             torch.tensor(True)},
                    cache_out=sink)
    (got,) = op.forward({}, [fresh], ctx)
    assert got.tolist() == [7, 8, 9] and sink["c"].tolist() == [1, 2, 3]
    ctx2 = OpContext(training=True, cache_in={"c": cached, "__use_cache__":
                                              torch.tensor(False)},
                     cache_out={})
    assert op.forward({}, [fresh], ctx2)[0].tolist() == [1, 2, 3]


def test_cache_recompile_flow_equals_jax():
    """``tests/test_cache_op.py``'s flow: the routing's score passes 0.5,
    the capacity factor is altered, the model recompiles once — at the
    same step in both packages — and trains on from the kept weights."""
    xs, ys = _data()
    xs, ys = xs[:32], ys[:32]

    def score(old, new):
        return float((old == new).mean())

    def alter(rs):
        for layer in rs.ffmodel._layers:
            if layer.op_type == OperatorType.OP_GROUP_BY:
                layer.attrs["alpha"] = 1.0

    tff, jff = build(ft, score), build(fj, score)
    seed_params(jff, params_of(tff))
    old_step = tff.executor.make_train_step()
    fired = {}
    for ff, rs_cls in ((tff, RecompileState), (jff, JaxRecompileState)):
        checks = fired.setdefault(ff, [])

        def trigger(rs, checks=checks):
            checks.append(len(checks))
            scores = list(rs.ffmodel.cache_scores.values())
            return rs.recompilations == 0 and bool(scores) and \
                scores[0] > 0.5

        rs = rs_cls(trigger, alter, ff)
        ff.fit(xs, ys, epochs=6, recompile_state=rs, shuffle=False)
        assert rs.recompilations == 1
        (gb,) = [n for n in ff.pcg.compute_nodes()
                 if n.op.op_type.name == "OP_GROUP_BY"]
        assert gb.op.attrs["alpha"] == 1.0
    # the trigger fired at the same check: the step after the same score
    assert len(fired[tff]) == len(fired[jff]) == 7  # 6 steps + the rerun
    assert old_step.program._entries == {}  # dropped with its executor
    assert tff.executor.make_train_step() is not old_step
    assert np.isfinite(tff.fit_history.loss).all()


def _small_model(pkg, batch=8):
    c = pkg.FFConfig()
    c.batch_size = batch
    ff = pkg.FFModel(c, device="cpu") if pkg is ft else pkg.FFModel(c)
    t = ff.dense(ff.create_tensor((batch, 16)), 32, ActiMode.AC_MODE_RELU)
    t = ff.dense(t, 4)
    ff.softmax(t)
    ff.compile(optimizer=pkg.AdamOptimizer(ff, alpha=0.01),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


@pytest.mark.parametrize("pkg", [ft, fj], ids=["torch", "jax"])
def test_recompile_state_keeps_matching_params(pkg):
    ff = _small_model(pkg)
    fired = {"n": 0}

    def trigger(rs):
        fired["n"] += 1
        return fired["n"] == 1  # fire once

    def alter(rs):
        ff._layers[0].attrs["out_dim"] = 64  # widen the first dense

    before = params_of(ff)
    rs = (RecompileState if pkg is ft else JaxRecompileState)(trigger,
                                                              alter, ff)
    assert ff.recompile_on_condition(rs)
    assert rs.recompilations == 1
    after = params_of(ff)
    first, second = ff._layers[0].name, ff._layers[1].name
    assert after[first]["kernel"].shape == (16, 64)
    assert after[second]["kernel"].shape == (64, 4)
    # the head's bias kept its shape, so its value
    np.testing.assert_array_equal(after[second]["bias"],
                                  before[second]["bias"])
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16)).astype(np.float32)
    y = rng.integers(0, 4, size=16).astype(np.int32)
    ff.fit(x, y, epochs=1)  # trains at the new width
    assert params_of(ff)[first]["kernel"].shape == (16, 64)
    assert not ff.recompile_on_condition(rs)  # fires only once
