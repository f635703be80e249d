"""Shared parts of the model-zoo parity tests (tests/test_torch_model_zoo.py,
tests/test_torch_model_zoo_cnn.py): a zoo model built in both packages from
the same builder call with the same weights, seeded data, each
package's loss and grads of one training step, and the comparison.

The comparison, fp32 (the two sides differ in summation order only):

* the inference forward's final output within 1e-5 absolute and the
  training step's loss within 1e-5 relative;
* every grad within 1e-4 relative norm of JAX's. The bias of a convolution
  that feeds batch norms only (``chip_smoke.shift_free_biases``) has an
  exact grad of zero, the norm removing any per-channel shift, so each
  side's is rounding noise: those are held only in the relative norm of
  all grads together (1e-4 as well);
* where a ReLU output is 0 on one side and not on the other (a
  pre-activation within fp32 rounding of the kink), that element's grad
  moves whole and the grads of the whole step differ by 1e-3 and more
  between any two correct fp32 implementations (the port's own CPU path
  reads the same against itself in float64). Then each conv, dense,
  batch-norm and batched-matmul node is held alone instead: fed JAX's
  forward activations, without its fused activation, with a seeded
  cotangent, its output and every grad within 1e-4 relative norm of JAX's
  node's. The test reports which of the two held.
"""
from unittest import mock

import numpy as np
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
from flexflow_tpu.execution.losses import loss_value as jax_loss_value
from flexflow_tpu.ops.base import OpContext as JaxOpContext
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.ops.base import OpContext
from chip_smoke import shift_free_biases

torch.set_num_threads(2)

OUT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NODE_TYPES = ("OP_CONV2D", "OP_LINEAR", "OP_BATCHNORM", "OP_BATCHMATMUL")


def build_pair(build, batch, loss="LOSS_SPARSE_CATEGORICAL_CROSSENTROPY"):
    """``build(ff, pkg)`` — the builder call of the package ``pkg``
    (``"jax"`` or ``"torch"``) — in both packages, compiled with Adam and
    ``loss``, with the same weights: the port's, carried into the JAX model
    as its initial params (``get_params_numpy``). JAX's own random init
    compiles one program per weight shape on the CPU, 14 s for
    InceptionV3; the weights' origin does not matter to the comparison."""
    from flexflow_tpu.execution.executor import Executor as JaxExecutor

    c = ft.FFConfig()
    c.batch_size, c.seed = batch, 1
    tff = ft.FFModel(c, device="cpu")
    build(tff, "torch")
    tff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-3),
                loss_type=getattr(ft.LossType, loss))
    weights = tff.get_params_numpy()

    def init_params(self, seed=0):
        params = jax.tree.map(jnp.asarray, weights)
        if self.mesh is not None:
            params = jax.device_put(params, self.param_shardings())
        return params

    c = fj.FFConfig()
    c.batch_size, c.seed = batch, 1
    jff = fj.FFModel(c)
    build(jff, "jax")
    with mock.patch.object(JaxExecutor, "init_params", init_params):
        jff.compile(optimizer=fj.AdamOptimizer(None, alpha=1e-3),
                    loss_type=getattr(fj.LossType, loss))
    return jff, tff


def data(tff, n, classes=1000, seed=0, vocab=None):
    """Inputs and labels for ``tff``'s input tensors: normal floats, ids
    below ``vocab``, labels below ``classes`` (regression targets in
    [0, 1) for an MSE model)."""
    rng = np.random.default_rng(seed)
    xs = []
    for t in tff._input_tensors:
        shape = (n,) + tuple(t.dims[1:])
        if t.dtype in (ft.DataType.DT_INT32, ft.DataType.DT_INT64):
            dt = np.int64 if t.dtype == ft.DataType.DT_INT64 else np.int32
            xs.append(rng.integers(0, vocab, shape).astype(dt))
        else:
            xs.append(rng.standard_normal(shape).astype(np.float32))
    if tff.loss_type == ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        y = rng.integers(0, classes, (n, 1)).astype(np.int32)
    else:
        out = tff.pcg.nodes[tff.final_guid].out_shapes[0]
        y = rng.random((n,) + tuple(out[1:])).astype(np.float32)
    return xs, y


def _names(ff, values):
    return {ff.pcg.nodes[g].name: vs for g, vs in values.items()}


def jax_step(jff, xs, y):
    """JAX's loss, grads and every node's forward values (by node name) of
    one training step (``loss_fn`` of flexflow_tpu/execution/executor.py
    :538-556, without the update)."""
    ex = jff.executor
    label = jnp.asarray(jff._prep_label(y))

    def forward(params):
        params_c, ins = ex._cast_for_compute(params,
                                             [jnp.asarray(x) for x in xs])
        ctx = JaxOpContext(training=True, rng=jax.random.PRNGKey(0))
        return ex.forward_outputs(params_c, ex._bind_inputs(ins), ctx)

    def loss_fn(params):
        values = forward(params)
        logits = ex._logits_f32(values[ex.final_guid][ex.final_out_idx])
        return jax_loss_value(ex.loss_type, logits, label), values

    (loss, values), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jff.params)
    values = {g: [np.asarray(v) for v in vs] for g, vs in values.items()}
    return float(loss), jax.device_get(grads), _names(jff, values)


def port_step(tff, xs, y):
    ex = tff.executor
    tx = [torch.tensor(x) for x in xs]
    loss, _logits, grads = ex.loss_and_grads(
        tff.params, tx, torch.tensor(tff._prep_label(y)))
    with torch.no_grad():
        values = ex.forward_outputs(tff.params, ex._bind_inputs(tx),
                                    OpContext(device=torch.device("cpu")))
    values = {g: [v.numpy() for v in vs] for g, vs in values.items()}
    return (float(loss),
            {n: {w: g.numpy() for w, g in ws.items()}
             for n, ws in grads.items()}, _names(tff, values))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def kink_flips(jvals, tvals):
    """Elements of the op outputs that are 0 on one side only."""
    n = 0
    for name, outs in tvals.items():
        for a, b in zip(outs, jvals[name]):
            if np.issubdtype(a.dtype, np.floating):
                n += int(np.count_nonzero((a == 0) != (np.asarray(b) == 0)))
    return n


def _bare(op):
    """``op`` without its fused activation (and batch norm's ReLU)."""
    attrs = dict(op.attrs, relu=False)
    if attrs.get("activation") is not None:
        attrs["activation"] = type(attrs["activation"]).AC_MODE_NONE
    return type(op)(op.name, attrs, op.data_type, op.num_inputs)


def node_errors(jff, tff, jvals, seed=0):
    """Each ``NODE_TYPES`` node alone in both packages, fed JAX's forward
    activations, without its fused activation, with a seeded cotangent:
    the worst relative norm error of an output or a grad, and where. JAX's
    side runs as one jitted program over all the nodes."""
    rng = np.random.default_rng(seed)
    tnodes = {n.name: n for n in tff.pcg.compute_nodes()}
    cases = []
    for node in jff.pcg.compute_nodes():
        if node.op.op_type.name in NODE_TYPES:
            ins = [jvals[jff.pcg.nodes[g].name][i] for g, i in node.inputs]
            cot = rng.standard_normal(node.out_shapes[0]).astype(np.float32)
            cases.append((node.name, _bare(node.op), ins, cot))

    @jax.jit
    def jax_vjps(params, ins, cots):
        outs = []
        for (name, op, _, _), p, x, cot in zip(cases, params, ins, cots):
            def f(p, x, op=op):
                return op.forward(p, list(x), JaxOpContext(training=True))[0]

            out, vjp = jax.vjp(f, p, x)
            outs.append((out,) + vjp(cot))
        return outs

    want = jax_vjps([jff.params.get(name, {}) for name, *_ in cases],
                    [[jnp.asarray(a) for a in ins] for _, _, ins, _ in cases],
                    [jnp.asarray(cot) for *_, cot in cases])
    worst, where = 0.0, None
    for (name, _, ins, cot), (out, jgp, jgx) in zip(cases, want):
        top = _bare(tnodes[name].op)
        tp = {w: torch.tensor(np.asarray(v), requires_grad=True)
              for w, v in jff.params.get(name, {}).items()}
        tx = [torch.tensor(np.asarray(a), requires_grad=True) for a in ins]
        tout = top.forward(tp, tx, OpContext(training=True))[0]
        grads = torch.autograd.grad(tout, list(tp.values()) + tx,
                                    torch.tensor(cot))
        pairs = [("out", tout.detach().numpy(), out)]
        pairs += [(w, g.numpy(), jgp[w]) for w, g in zip(tp, grads)]
        pairs += [(f"in{i}", g.numpy(), h)
                  for i, (g, h) in enumerate(zip(grads[len(tp):], jgx))]
        for what, got, ref in pairs:
            e = _rel(got, ref)
            if e > worst:
                worst, where = e, f"{name}.{what}"
    return worst, where


def check_forward(jff, tff, xs):
    np.testing.assert_allclose(tff.predict(xs), np.asarray(jff.predict(xs)),
                               atol=OUT_ATOL, rtol=0)


def check_step(jff, tff, xs, y):
    """The comparison of the module doc; returns "whole step" or "each
    node alone" (which one held the grads)."""
    jl, jg, jvals = jax_step(jff, xs, y)
    tl, tg, tvals = port_step(tff, xs, y)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for n in jg:
        assert set(tg[n]) == set(jg[n]), n
    skip = shift_free_biases(tff)
    total = _rel(np.concatenate([tg[n][w].ravel() for n in jg for w in jg[n]]),
                 np.concatenate([np.asarray(jg[n][w]).ravel()
                                 for n in jg for w in jg[n]]))
    if kink_flips(jvals, tvals):
        worst, where = node_errors(jff, tff, jvals)
        assert worst <= GRAD_RTOL, (where, worst)
        return "each node alone"
    assert total <= GRAD_RTOL, total
    for n in jg:
        for w in jg[n]:
            if (n, w) not in skip:
                e = _rel(tg[n][w], jg[n][w])
                assert e <= GRAD_RTOL, (n, w, e)
    return "whole step"
