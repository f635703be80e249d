"""Shared parts of the recurrent, MoE and Transformer parity tests
(tests/test_torch_recurrent.py, test_torch_moe.py,
test_torch_transformer.py): a model built in both packages from the same
builder call with the same weights, one op run alone in both packages,
and each package's loss and grads of one training step with the ops' aux
terms (the MoE load-balance loss) included, as each package's train step
adds them.

The weights go from the port to JAX (``get_params_numpy``, patched in as
JAX's initial params): JAX's own random init compiles one program per
weight shape; the weights' origin does not matter to a comparison.
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

torch.set_num_threads(2)

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4


def build_pair(build, batch):
    """``build(ff, pkg)`` in both packages (``pkg`` is ``fj`` or ``ft``),
    compiled with SGD 0.1 (one step's params then differ by the rate times
    the grads' difference) and sparse categorical cross-entropy, with the
    port's weights."""
    from flexflow_tpu.execution.executor import Executor as JaxExecutor

    def config(pkg):
        c = pkg.FFConfig()
        c.batch_size, c.seed = batch, 1
        return c

    tff = ft.FFModel(config(ft), device="cpu")
    build(tff, ft)
    tff.compile(optimizer=ft.SGDOptimizer(None, lr=0.1),
                loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    weights = tff.get_params_numpy()

    def init_params(self, seed=0):
        params = jax.tree.map(jnp.asarray, weights)
        if self.mesh is not None:
            params = jax.device_put(params, self.param_shardings())
        return params

    jff = fj.FFModel(config(fj))
    build(jff, fj)
    with mock.patch.object(JaxExecutor, "init_params", init_params):
        jff.compile(optimizer=fj.SGDOptimizer(None, lr=0.1),
                    loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return jff, tff


def jax_loss_grads(jff, xs, y):
    """JAX's training loss (aux terms added, as its ``loss_fn`` adds them,
    flexflow_tpu/execution/executor.py:538-556) and its grads."""
    ex = jff.executor
    label = jnp.asarray(jff._prep_label(y))

    def loss_fn(params):
        params_c, ins = ex._cast_for_compute(params,
                                             [jnp.asarray(x) for x in xs])
        ctx = JaxOpContext(training=True, rng=jax.random.PRNGKey(0),
                           aux_losses=[])
        values = ex.forward_outputs(params_c, ex._bind_inputs(ins), ctx)
        logits = ex._logits_f32(values[ex.final_guid][ex.final_out_idx])
        loss = jax_loss_value(ex.loss_type, logits, label, ex.repl_labels)
        for aux in ctx.aux_losses:
            loss = loss + aux
        return loss

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jff.params)
    return float(loss), jax.device_get(grads)


def port_loss_grads(tff, xs, y):
    loss, _logits, grads = tff.executor.loss_and_grads(
        tff.params, [torch.tensor(x) for x in xs],
        torch.tensor(tff._prep_label(y)))
    return float(loss), {n: {w: g.numpy() for w, g in ws.items()}
                         for n, ws in grads.items()}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def check_loss_grads(jff, tff, xs, y):
    """One training step's loss (``LOSS_RTOL``) and every grad
    (``GRAD_RTOL``) of the port against JAX's."""
    jl, jg = jax_loss_grads(jff, xs, y)
    tl, tg = port_loss_grads(tff, xs, y)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
    assert set(tg) == set(jg)
    for n in jg:
        assert set(tg[n]) == set(jg[n]), n
        for w in jg[n]:
            e = rel(tg[n][w], jg[n][w])
            assert e <= GRAD_RTOL, (n, w, e)


def check_one_step(jff, tff, xs, y, tol=1e-5):
    """One ``make_train_step`` in both packages (SGD): the step's loss
    within ``LOSS_RTOL`` and every param after it within ``tol`` of
    JAX's."""
    jstep = jff.executor.make_train_step()
    jp = jax.tree.map(jnp.array, jff.params)
    jp, _js, jl, _m = jstep(jp, jff.opt_state, [jnp.asarray(x) for x in xs],
                            jnp.asarray(jff._prep_label(y)),
                            jax.random.PRNGKey(0))
    tstep = tff.executor.make_train_step()
    tp, _ts, tl, _m = tstep(tff.params, tff.opt_state,
                            [torch.tensor(x) for x in xs],
                            torch.tensor(tff._prep_label(y)),
                            torch.Generator().manual_seed(0))
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    jp = jax.device_get(jp)
    for n, ws in jp.items():
        for w, v in ws.items():
            np.testing.assert_allclose(tp[n][w].numpy(), v, atol=tol,
                                       rtol=0, err_msg=f"{n}.{w}")


def op_pair(jax_cls, torch_cls, attrs, dtype, num_inputs):
    """The same op in both packages."""
    return (jax_cls("op", dict(attrs), getattr(fj.DataType, dtype),
                    num_inputs=num_inputs),
            torch_cls("op", dict(attrs), getattr(ft.DataType, dtype),
                      num_inputs=num_inputs))


def run_op_pair(jop, top, params, ins, cots, compute="fp32"):
    """``op.forward`` of both packages on the same params and inputs (the
    float ones cast to ``compute``), then each package's vector-Jacobian
    product with the cotangents ``cots`` (one per output). Returns
    ((JAX outputs, JAX param grads, JAX float-input grads), the port's
    likewise), all as float32 numpy."""
    jdt = jnp.bfloat16 if compute == "bf16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bf16" else torch.float32
    fidx = [i for i, x in enumerate(ins) if x.dtype == np.float32]

    def jax_f(p, fx):
        full = [jnp.asarray(x) for x in ins]
        for i, v in zip(fidx, fx):
            full[i] = v.astype(jdt)
        p = {w: v.astype(jdt) for w, v in p.items()}
        outs = jop.forward(p, full, JaxOpContext())
        return [o.astype(jnp.float32) for o in outs]

    jp = {w: jnp.asarray(v) for w, v in params.items()}
    jfx = [jnp.asarray(ins[i]) for i in fidx]
    jout, vjp = jax.vjp(jax_f, jp, jfx)
    jgp, jgx = vjp([jnp.asarray(c) for c in cots])

    tp = {w: torch.tensor(v, requires_grad=True) for w, v in params.items()}
    tfull = [torch.tensor(x, requires_grad=x.dtype == np.float32)
             for x in ins]
    cast = [t.to(tdt) if t.is_floating_point() else t for t in tfull]
    touts = top.forward({w: v.to(tdt) for w, v in tp.items()}, cast,
                        OpContext(device=torch.device("cpu")))
    touts = [o.float() for o in touts]
    leaves = list(tp.values()) + [tfull[i] for i in fidx]
    grads = torch.autograd.grad(touts, leaves,
                                [torch.tensor(c) for c in cots],
                                allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    tgp = {w: g.numpy() for w, g in zip(tp, grads)}
    tgx = [g.numpy() for g in grads[len(tp):]]
    j = ([np.asarray(o) for o in jout],
         {w: np.asarray(g) for w, g in jgp.items()},
         [np.asarray(g) for g in jgx])
    return j, ([o.detach().numpy() for o in touts], tgp, tgx)
