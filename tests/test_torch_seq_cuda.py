"""The LSTM and MoE ops and the Transformer proxy on the card. Every test
here needs an NVIDIA GPU and skips without one (``test_torch_recurrent.py``,
``test_torch_moe.py`` and ``test_torch_transformer.py`` hold the same code
against the JAX package on the CPU).

* The LSTM op (batch 16, seq 24, in 96, hidden 128, with and without an
  initial state) on the card against the port's CPU path: outputs, final
  state and every grad within 1e-5 relative norm (fp32 in IEEE on both
  sides: ``addmm`` follows ``torch.backends.cuda.matmul.allow_tf32``,
  which is off here, as the smoke leaves it).
* The MoE dispatch on the card: ``dispatch_indices`` equal to the CPU's as
  integers over overflowing assignments; GroupBy (stacked) and Aggregate
  forward and grads against the CPU path within 1e-5 relative norm.
* A Transformer proxy step (hidden 256, 4 heads of 64, 2 layers with
  layer norm, seq 128, batch 4, fp32) on the card against the port's CPU
  path from the same weights and batch: loss within 1e-4 relative, every
  grad within 1e-4 relative norm; the step launches the fp32 flash
  forward (B1) and the fused backward (B2) once per layer, and nothing
  else of the flash kernels.
* The MoE MLP's captured train step (``moe`` and ``moe_experts``): two
  replays from the same state give the same loss and params bitwise (the
  scatter's atomics add one non-zero value per slot).

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_seq_cuda.py
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.execution.graphs import _tensors_of
from flexflow_tpu_torch.kernels import flash_attention as fa
from flexflow_tpu_torch.models import (TransformerConfig, build_moe_mlp,
                                       build_transformer)
from flexflow_tpu_torch.ops import moe_ops as tm
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.recurrent import LSTMOp

pytestmark = pytest.mark.cuda

TOL = 1e-5
STEP_TOL = 1e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card side of the LSTM, MoE "
                    "and flash paths)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _op_both(op, params, ins, cots, dev):
    """``op`` forward and its grads under ``cots`` on the CPU and on
    ``dev``: two lists (outputs, then grads of params and float inputs)."""
    res = []
    for d in (torch.device("cpu"), dev):
        p = {w: torch.tensor(v, device=d, requires_grad=True)
             for w, v in params.items()}
        x = [torch.tensor(a, device=d,
                          requires_grad=a.dtype == np.float32) for a in ins]
        outs = op.forward(p, x, OpContext(training=True, device=d))
        leaves = list(p.values()) + [t for t in x if t.requires_grad]
        grads = torch.autograd.grad(outs, leaves,
                                    [torch.tensor(c, device=d)
                                     for c in cots], allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves)]
        res.append(list(outs) + grads)
    return res


@pytest.mark.parametrize("initial", [False, True])
def test_lstm_on_the_card_matches_the_cpu(initial):
    dev = _cuda()
    b, s, d, h = 16, 24, 96, 128
    rng = np.random.default_rng(0)
    params = {"wx": rng.uniform(-0.1, 0.1, (d, 4 * h)).astype(np.float32),
              "wh": rng.uniform(-0.1, 0.1, (h, 4 * h)).astype(np.float32),
              "bias": rng.normal(0, 0.1, (4 * h,)).astype(np.float32)}
    ins = [rng.standard_normal((b, s, d)).astype(np.float32)]
    if initial:
        ins.append(rng.normal(0, 0.5, (b, 2 * h)).astype(np.float32))
    cots = [rng.standard_normal((b, s, h)).astype(np.float32),
            rng.standard_normal((b, 2 * h)).astype(np.float32)]
    op = LSTMOp("lstm", {"hidden_size": h}, ft.DataType.DT_FLOAT,
                num_inputs=len(ins))
    cpu, card = _op_both(op, params, ins, cots, dev)
    for i, (a, w) in enumerate(zip(card, cpu)):
        assert _rel(a, w) <= TOL, (i, _rel(a, w))


def test_moe_dispatch_on_the_card_matches_the_cpu():
    dev = _cuda()
    rng = np.random.default_rng(1)
    n, k, batch, d = 8, 2, 256, 64
    cap = tm.moe_capacity(k, batch, 1.0, n)
    # skewed: expert 0 overflows
    assign = np.where(rng.random((batch, k)) < 0.4, 0,
                      rng.integers(0, n, (batch, k))).astype(np.int32)
    flat = torch.tensor(assign.reshape(-1))
    dc, kc = tm.dispatch_indices(flat, n, cap)
    dg, kg = tm.dispatch_indices(flat.to(dev), n, cap)
    assert not bool(kc.all())
    assert torch.equal(dg.cpu(), dc) and torch.equal(kg.cpu(), kc)
    gate = rng.dirichlet(np.ones(n), batch).astype(np.float32)
    x = rng.standard_normal((batch, d)).astype(np.float32)
    group = tm.GroupByOp("g", {"n": n, "alpha": 1.0, "stacked": True},
                         ft.DataType.DT_FLOAT, num_inputs=2)
    cpu, card = _op_both(group, {}, [x, assign],
                         [rng.standard_normal((n, cap, d)).astype(
                             np.float32)], dev)
    for a, w in zip(card, cpu):
        assert _rel(a, w) <= TOL
    agg = tm.AggregateOp("a", {"n": n, "lambda_bal": 0.0},
                         ft.DataType.DT_FLOAT, num_inputs=5)
    exps = rng.standard_normal((n, cap, d)).astype(np.float32)
    cpu, card = _op_both(agg, {}, [np.take_along_axis(gate, assign, 1),
                                   assign, assign, gate, exps],
                         [rng.standard_normal((batch, d)).astype(
                             np.float32)], dev)
    for a, w in zip(card, cpu):
        assert _rel(a, w) <= TOL


def _proxy(device, cfg):
    c = ft.FFConfig()
    c.batch_size, c.seed = cfg.batch_size, 0
    ff = ft.FFModel(c, device=device)
    build_transformer(ff, cfg)
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.01))
    return ff


def test_transformer_step_on_the_card_matches_the_cpu():
    dev = _cuda()
    # with its layer norms: without them the proxy's activations shrink
    # about 25x a layer at these weights and the query and key grads of
    # every layer past the first fall below fp32's normal range
    cfg = TransformerConfig(batch_size=4, seq_len=128, hidden=256,
                            num_heads=4, num_layers=2, use_layernorm=True)
    card, cpu = _proxy(dev, cfg), _proxy("cpu", cfg)
    cpu.set_params_numpy(card.get_params_numpy())
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 128, 256)).astype(np.float32)
    y = rng.integers(0, 2, (4, 1)).astype(np.int32)
    fa.reset_launch_count()
    lg, _, gg = card.executor.loss_and_grads(
        card.params, [torch.tensor(x, device=dev)],
        torch.tensor(y, device=dev))
    torch.cuda.synchronize()
    counts = {n: fa.launch_count(n) for n in fa.KERNELS
              if fa.launch_count(n)}
    assert counts == {"flash_fwd": 2, "flash_bwd_fused": 2}, counts
    lc, _, gc = cpu.executor.loss_and_grads(cpu.params, [torch.tensor(x)],
                                            torch.tensor(y))
    assert abs(float(lg) - float(lc)) <= STEP_TOL * abs(float(lc))
    for n, ws in gc.items():
        for w, g in ws.items():
            assert _rel(gg[n][w], g) <= STEP_TOL, (n, w)


@pytest.mark.parametrize("builder", ["moe", "moe_experts"])
def test_captured_moe_step_replays_bitwise(builder):
    dev = _cuda()
    c = ft.FFConfig()
    c.batch_size, c.seed = 64, 0
    ff = ft.FFModel(c, device=dev)
    if builder == "moe":
        build_moe_mlp(ff)
    else:
        x = ff.create_tensor((64, 784))
        t = ff.dense(x, 64, ft.ActiMode.AC_MODE_RELU)
        t = ff.moe_experts(t, 8, 2, 64, alpha=2.0, lambda_bal=0.04)
        ff.softmax(ff.dense(t, 10))
    ff.compile(optimizer=ft.AdamOptimizer(ff, alpha=1e-3))
    rng = np.random.default_rng(3)
    xs = [torch.tensor(rng.standard_normal((64, 784)).astype(np.float32),
                       device=dev)]
    y = torch.tensor(rng.integers(0, 10, (64, 1)).astype(np.int32),
                     device=dev)
    step = ff.executor.make_train_step()
    for _ in range(2):  # the eager first call, then the capture
        step(ff.params, ff.opt_state, xs, y, None)
    state = _tensors_of([ff.params, ff.opt_state])
    snap = [t.clone() for t in state]
    runs = []
    for _ in range(2):
        for t, v in zip(state, snap):
            t.copy_(v)
        _p, _s, loss, _m = step(ff.params, ff.opt_state, xs, y, None)
        torch.cuda.synchronize()
        runs.append((loss.clone(), [t.clone() for t in state]))
    assert step.program.captures == 1
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert bool(torch.isfinite(runs[0][0]))
