"""The MoE ops and MoE MLPs of the port against the JAX package, on the
CPU.

* The capacity dispatch: ``dispatch_indices`` gives the same (dest, keep)
  as the JAX function, as integers, over random assignments (hypothesis),
  overflowing ones included, and ``dispatch_mask`` the same dense tensor;
  tokens past capacity are dropped in scan order; the scatter path's
  output and grads equal the dense dispatch's einsum within 1e-6.
* GroupBy (stacked and not), Experts, Aggregate and AggregateSpec alone:
  outputs within 1e-5 absolute and the grads of the weights and of every
  float input within 1e-5 relative norm (fp32; the two sides differ in
  summation order only), on assignments that overflow the capacity.
* The load-balance aux loss against the hand-computed value of
  ``tests/test_moe_scale.py`` (all k assignments count).
* The MoE MLP of ``moe.cc`` built with ``moe`` (``build_moe_mlp``) and
  with ``moe_experts``, at capacity factors 2.0 and 0.5 (the latter drops
  tokens): one step's loss within 1e-4 relative, every grad within 1e-4
  relative norm, and one ``make_train_step`` (SGD 0.1) in each package,
  the params after it within 1e-5. A dropped token kept by mistake moves
  the loss. The gates are drawn without ties: ``torch.topk`` does not
  order ties as ``lax.top_k`` does (lowest index first).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.models.transformer import build_moe_mlp as jax_moe_mlp
from flexflow_tpu.ops import moe_ops as jm
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models.transformer import build_moe_mlp
from flexflow_tpu_torch.ops import moe_ops as tm
from flexflow_tpu_torch.ops.base import OpContext
from torch_seq_pairs import (build_pair, check_loss_grads, check_one_step,
                             op_pair, rel, run_op_pair)

OUT_ATOL = 1e-5
GRAD_RTOL = 1e-5


# ------------------------------------------------------------- dispatch
# JAX's dispatch, jitted per (tokens, n, capacity): run op by op, every
# new shape compiles each op anew
_jax_dispatch = jax.jit(
    lambda a, n, cap: (jm.dispatch_indices(a, n, cap)
                       + (jm.dispatch_mask(a, n, cap),)),
    static_argnums=(1, 2))


@settings(max_examples=60, deadline=None)
@given(st.tuples(st.integers(1, 6), st.integers(1, 8),
                 st.sampled_from([1, 7, 40])).flatmap(
    lambda c: st.tuples(st.just(c[0]), st.just(c[1]),
                        st.lists(st.integers(0, c[0] - 1), min_size=c[2],
                                 max_size=c[2]))))
def test_dispatch_indices_equal_jax(case):
    n, capacity, assign = case
    a = np.asarray(assign, np.int32)
    jd, jk, jmask = _jax_dispatch(jnp.asarray(a), n, capacity)
    td, tk = tm.dispatch_indices(torch.tensor(a), n, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(
        tm.dispatch_mask(torch.tensor(a), n, capacity).numpy(),
        np.asarray(jmask))


def test_dispatch_drops_overflow_tokens_in_scan_order():
    dest, keep = tm.dispatch_indices(torch.tensor([0, 0, 0, 1]), n=2,
                                     capacity=2)
    assert keep.tolist() == [True, True, False, True]
    # the dropped token is clipped to its expert's last slot
    assert dest.tolist() == [0, 1, 1, 2]
    assert tm.moe_capacity(2, 64, 2.0, 8) == jm.moe_capacity(2, 64, 2.0,
                                                             8) == 32


def test_scatter_dispatch_matches_dense_dispatch():
    rng = np.random.default_rng(0)
    t, d, n, cap = 24, 8, 4, 5
    x = torch.tensor(rng.normal(size=(t, d)).astype(np.float32),
                     requires_grad=True)
    assign = torch.tensor(rng.integers(0, n, size=(t,)).astype(np.int32))
    scat = tm._scatter_group(x, assign, n, cap)
    dense = torch.einsum("td,tnc->ncd", x,
                         tm.dispatch_mask(assign, n, cap).float())
    torch.testing.assert_close(scat, dense, atol=1e-6, rtol=0)
    g1, = torch.autograd.grad(torch.sin(scat).sum(), x)
    g2, = torch.autograd.grad(torch.sin(dense).sum(), x)
    torch.testing.assert_close(g1, g2, atol=1e-6, rtol=0)


# ---------------------------------------------------------- ops alone
BATCH, K, N, D, OUT = 12, 2, 4, 5, 6


def _assign(rng, batch=BATCH):
    """Distinct experts per row, skewed to expert 0 so it overflows."""
    rows = []
    for _ in range(batch):
        first = 0 if rng.random() < 0.7 else int(rng.integers(1, N))
        rest = [e for e in rng.permutation(N) if e != first]
        rows.append([first] + rest[:K - 1])
    return np.asarray(rows, np.int32)


def _check(jres, tres):
    (jout, jgp, jgx), (tout, tgp, tgx) = jres, tres
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, atol=OUT_ATOL, rtol=0)
    assert set(tgp) == set(jgp)
    for w in jgp:
        assert rel(tgp[w], jgp[w]) <= GRAD_RTOL, w
    for i, (a, b) in enumerate(zip(tgx, jgx)):
        assert rel(a, b) <= GRAD_RTOL, f"input {i}"


@pytest.mark.parametrize("stacked", [False, True])
def test_group_by_matches_jax(stacked):
    rng = np.random.default_rng(1)
    ins = [rng.standard_normal((BATCH, D)).astype(np.float32), _assign(rng)]
    attrs = {"n": N, "alpha": 1.0, "stacked": stacked}
    jop, top = op_pair(jm.GroupByOp, tm.GroupByOp, attrs, "DT_FLOAT", 2)
    shapes = top.infer_output_shapes([x.shape for x in ins])
    assert shapes == jop.infer_output_shapes([x.shape for x in ins])
    cap = tm.moe_capacity(K, BATCH, 1.0, N)
    assert shapes == ([(N, cap, D)] if stacked else [(cap, D)] * N)
    _, keep = tm.dispatch_indices(torch.tensor(ins[1].reshape(-1)), N, cap)
    assert not bool(keep.all()), "the case must drop tokens"
    cots = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    _check(*run_op_pair(jop, top, {}, ins, cots))


def test_experts_matches_jax():
    rng = np.random.default_rng(2)
    cap = 7
    ins = [rng.standard_normal((N, cap, D)).astype(np.float32)]
    params = {"kernel": rng.normal(0, 0.5, (N, D, OUT)).astype(np.float32),
              "bias": rng.normal(0, 0.5, (N, OUT)).astype(np.float32)}
    attrs = {"n": N, "out_dim": OUT,
             "activation": ft.ActiMode.AC_MODE_RELU, "use_bias": True}
    jop, top = op_pair(jm.ExpertsOp, tm.ExpertsOp,
                       dict(attrs, activation=fj.ActiMode.AC_MODE_RELU),
                       "DT_FLOAT", 1)
    top.attrs = attrs
    shapes = [x.shape for x in ins]
    assert {w: s for w, (s, _, _) in top.weight_specs(shapes).items()} == \
        {w: s for w, (s, _, _) in jop.weight_specs(shapes).items()}
    outs = top.infer_output_shapes(shapes)
    assert top.flops(shapes, outs) == jop.flops(shapes, outs)
    cots = [rng.standard_normal(outs[0]).astype(np.float32)]
    _check(*run_op_pair(jop, top, params, ins, cots))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("spec", [False, True])
def test_aggregate_matches_jax(spec, stacked):
    rng = np.random.default_rng(3)
    cap = tm.moe_capacity(K, BATCH, 1.0, N)
    assign = _assign(rng)
    gate = rng.dirichlet(np.ones(N), BATCH).astype(np.float32)
    preds = np.take_along_axis(gate, assign, 1)
    exps = rng.standard_normal((N, cap, OUT)).astype(np.float32)
    exp_ins = [exps] if stacked else list(exps)
    ins = [preds, assign, assign, gate] + exp_ins
    classes = ((jm.AggregateSpecOp, tm.AggregateSpecOp) if spec
               else (jm.AggregateOp, tm.AggregateOp))
    jop, top = op_pair(*classes, {"n": N, "lambda_bal": 0.0}, "DT_FLOAT",
                       len(ins))
    shapes = top.infer_output_shapes([x.shape for x in ins])
    assert shapes == jop.infer_output_shapes([x.shape for x in ins])
    assert shapes == [(BATCH * K, OUT) if spec else (BATCH, OUT)]
    cots = [rng.standard_normal(shapes[0]).astype(np.float32)]
    _check(*run_op_pair(jop, top, {}, ins, cots))


@pytest.mark.parametrize("spec", [False, True])
def test_load_balance_aux_covers_all_k(spec):
    """``tests/test_moe_scale.py``'s hand-computed case: top-1 always
    expert 0, the second choice spread over 1..3, so the all-k load is
    [.5, .1875, .1875, .125] and the term n * sum(load * 0.25)."""
    n, batch, k, cap, d = 4, 8, 2, 8, 4
    gate_assign = torch.stack(
        [torch.zeros(batch, dtype=torch.int32),
         torch.tensor([1, 2, 3, 1, 2, 3, 1, 2], dtype=torch.int32)], dim=1)
    cls = tm.AggregateSpecOp if spec else tm.AggregateOp
    op = cls("agg", {"n": n, "lambda_bal": 1.0}, ft.DataType.DT_FLOAT,
             num_inputs=5)
    aux = []
    op.forward({}, [torch.full((batch, k), 0.5), gate_assign, gate_assign,
                    torch.full((batch, n), 0.25), torch.ones(n, cap, d)],
               OpContext(training=True, aux_losses=aux))
    load = np.asarray([0.5, 3 / 16, 3 / 16, 2 / 16])
    assert len(aux) == 1
    np.testing.assert_allclose(float(aux[0]), n * float(np.sum(load * 0.25)),
                               rtol=1e-6)
    # no aux term outside training
    op.forward({}, [torch.full((batch, k), 0.5), gate_assign, gate_assign,
                    torch.full((batch, n), 0.25), torch.ones(n, cap, d)],
               OpContext(training=False, aux_losses=aux))
    assert len(aux) == 1


# ---------------------------------------------------------- MoE MLPs
MLP = dict(batch_size=16, in_dim=20, num_classes=5, num_exp=4,
           num_select=2, expert_hidden=8, lambda_bal=0.04)


def _mlp(builder, alpha):
    def build(ff, pkg):
        if builder == "moe":
            fn = jax_moe_mlp if pkg is fj else build_moe_mlp
            return fn(ff, alpha=alpha, **MLP)
        x = ff.create_tensor((MLP["batch_size"], MLP["in_dim"]),
                             name="moe_input")
        t = ff.dense(x, 64, pkg.ActiMode.AC_MODE_RELU)
        t = ff.moe_experts(t, MLP["num_exp"], MLP["num_select"],
                           MLP["expert_hidden"], alpha=alpha,
                           lambda_bal=MLP["lambda_bal"])
        return x, ff.softmax(ff.dense(t, MLP["num_classes"]))
    return build


@pytest.mark.parametrize("alpha", [2.0, 0.5])
@pytest.mark.parametrize("builder", ["moe", "moe_experts"])
def test_moe_mlp_loss_grads_and_one_step_match_jax(builder, alpha):
    jff, tff = build_pair(_mlp(builder, alpha), MLP["batch_size"])
    # node names carry the layer's index after the builder's name
    names = {n.name.rsplit("_", 1)[0] for n in tff.pcg.compute_nodes()}
    assert "moe_gate" in names
    if builder == "moe":
        assert {f"moe_expert_{i}" for i in range(MLP["num_exp"])} <= names
    else:
        assert {"moe_group_by", "moe_experts"} <= names
    assert set(tff.get_params_numpy()) == set(jff.params)
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((MLP["batch_size"], MLP["in_dim"])).astype(
        np.float32)]
    y = rng.integers(0, MLP["num_classes"], (MLP["batch_size"], 1)).astype(
        np.int32)
    check_loss_grads(jff, tff, xs, y)
    check_one_step(jff, tff, xs, y)


def test_moe_and_moe_experts_compute_the_same_function():
    """The same weights in both layouts give the same output: the stacked
    experts' kernel is the per-expert kernels stacked."""
    outs = {}
    rng = np.random.default_rng(5)
    x = rng.standard_normal((MLP["batch_size"], MLP["in_dim"])).astype(
        np.float32)
    for builder in ("moe", "moe_experts"):
        c = ft.FFConfig()
        c.batch_size, c.seed = MLP["batch_size"], 1
        ff = ft.FFModel(c, device="cpu")
        _mlp(builder, 0.5)(ff, ft)
        ff.compile()
        outs[builder] = ff
    a, b = outs["moe"], outs["moe_experts"]
    pa = a.get_params_numpy()
    by_base = {}
    for name in pa:  # in graph order
        by_base.setdefault(name.rsplit("_", 1)[0], []).append(name)
    pb = {}
    for name in b.get_params_numpy():
        base = name.rsplit("_", 1)[0]
        if base == "moe_experts":
            experts = [pa[by_base[f"moe_expert_{i}"][0]]
                       for i in range(MLP["num_exp"])]
            pb[name] = {w: np.stack([e[w] for e in experts])
                        for w in ("kernel", "bias")}
        else:
            pb[name] = pa[by_base[base].pop(0)]
    b.set_params_numpy(pb)
    np.testing.assert_allclose(b.predict(x), a.predict(x), atol=1e-6,
                               rtol=0)
