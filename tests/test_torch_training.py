"""One training step of the port against the JAX package's, on the CPU.

The tiny BERT proxy and the tiny causal GPT-2 of ``torch_training_pairs``
(batch 4, seq 128, hidden 128, 2 heads so head_dim is 64, 2 layers,
intermediate 256) run with ``use_flash=True`` on every attention layer:
JAX runs its Pallas flash kernels in interpret mode, the port its flash
plain versions. Checked, with the JAX weights carried over:

* fp32 loss within 1e-5 and every grad within rtol 1e-4 / atol 1e-5 (the
  two sides differ in summation order only);
* bf16 compute: the loss within 2e-2 of JAX's bf16 loss (the frameworks
  round activations at different points), grads finite fp32 on every
  master leaf; the GPT-2 step with both packages' backward forced onto the
  two-pass schedule (dK/dV walk, then dQ walk): loss within 2e-2, every
  grad within 2e-2 of its largest element and all grads within a relative
  norm of 5e-2 of JAX's (the bands of the flash kernels against their
  plain versions and of a kernel step against the einsum core);
* the compute-dtype cast runs inside each step's graph (step 2 sees step
  1's update) and the inference programs' cast cache follows in-place
  param updates;
* an MLP learns through ``fit`` (the verify recipe).
"""
import numpy as np
import pytest
import torch

import flexflow_tpu.kernels.flash_attention  # noqa: F401
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.flash_attention as fa
from torch_training_pairs import (GRAD_TOL, assert_trees_close, build_pair,
                                  data, jax_loss_and_grads,
                                  port_loss_and_grads)


@pytest.mark.parametrize("model", ["bert", "gpt2"])
def test_one_step_loss_and_grads_match_jax(model):
    jff, tff = build_pair(model)
    x, y = data(model)
    jl, jg = jax_loss_and_grads(jff, x, y)
    tl, tg = port_loss_and_grads(tff, x, y)
    assert abs(tl - jl) <= 1e-5, (tl, jl)
    assert_trees_close(jg, tg, **GRAD_TOL)


def test_bf16_compute_loss_in_band():
    jff, tff = build_pair("bert", compute_bf16=True)
    x, y = data("bert")
    jl, jg = jax_loss_and_grads(jff, x, y)
    tl, tg = port_loss_and_grads(tff, x, y)
    assert abs(tl - jl) <= 2e-2, (tl, jl)
    # grads reach every fp32 master leaf
    for n, ws in tg.items():
        for w, g in ws.items():
            assert g.dtype == np.float32 and np.isfinite(g).all(), (n, w)
    assert any(np.abs(g).max() > 0 for ws in tg.values() for g in ws.values())


def test_bf16_two_pass_step_matches_jax(monkeypatch):
    """Both packages' residency budget set to 0, so each attention layer's
    backward runs the two-pass schedule (the one the CUDA dK/dV and dQ
    kernels serve on the card) in bf16 compute."""
    import sys

    jfa = sys.modules["flexflow_tpu.kernels.flash_attention"]
    calls = {"jax": 0, "port": 0}

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jfa, "FUSED_BWD_RESIDENT_BUDGET", 0)
    monkeypatch.setattr(fa, "FUSED_BWD_RESIDENT_BUDGET", 0)
    monkeypatch.setattr(jfa, "_flash_bwd_dq_kernel",
                        counted("jax", jfa._flash_bwd_dq_kernel))
    monkeypatch.setattr(fa, "flash_bwd_q_plain",
                        counted("port", fa.flash_bwd_q_plain))
    jff, tff = build_pair("gpt2", compute_bf16=True)
    x, y = data("gpt2")
    jl, jg = jax_loss_and_grads(jff, x, y)
    tl, tg = port_loss_and_grads(tff, x, y)
    # one dQ walk per attention layer on each side
    assert calls == {"jax": 2, "port": 2}
    assert abs(tl - jl) <= 2e-2, (tl, jl)
    num = den = 0.0
    for n, ws in jg.items():
        for w, want in ws.items():
            want = np.asarray(want, np.float32)
            got = tg[n][w]
            err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
            assert err <= 2e-2, (n, w, err)
            num += float(np.sum((got - want) ** 2))
            den += float(np.sum(want ** 2))
    assert (num / den) ** 0.5 <= 5e-2


def test_bf16_steps_see_the_updated_masters():
    """The compute-dtype cast runs inside every step's graph: step 2's loss
    is the loss of the params step 1 wrote, and each step's grads land on
    the fp32 masters (no cast copy from before the update survives)."""
    _jff, tff = build_pair("bert", compute_bf16=True, opt="momentum")
    x, y = data("bert")
    xs, lab = [torch.tensor(x)], torch.tensor(tff._prep_label(y))
    step = tff.executor.make_train_step()
    before = {n: {w: t.clone() for w, t in ws.items()}
              for n, ws in tff.params.items()}
    _p, _s, loss1, _m = step(tff.params, tff.opt_state, xs, lab, None)
    moved = [(n, w) for n, ws in tff.params.items() for w, t in ws.items()
             if not torch.equal(t, before[n][w])]
    assert len(moved) == sum(len(ws) for ws in tff.params.values())
    assert all(t.dtype == torch.float32
               for ws in tff.params.values() for t in ws.values())
    want2, _, _ = tff.executor.loss_and_grads(tff.params, xs, lab)
    _p, _s, loss2, _m = step(tff.params, tff.opt_state, xs, lab, None)
    assert float(loss2) == float(want2)
    assert float(loss2) != float(loss1)


def test_serving_cast_cache_follows_param_updates():
    """The inference programs cache the bf16 copy of the params, and drop
    it as soon as a param changes in place."""
    _jff, tff = build_pair("bert", compute_bf16=True)
    x, _y = data("bert")
    fwd = tff.executor.make_forward()
    a = fwd(tff.params, [torch.tensor(x)]).float()
    assert torch.equal(fwd(tff.params, [torch.tensor(x)]).float(), a)
    with torch.no_grad():
        next(ws for n, ws in tff.params.items()
             if n.startswith("cls"))["bias"].add_(1.0)
    b = fwd(tff.params, [torch.tensor(x)]).float()
    assert not torch.equal(a, b)


def test_mlp_fit_learns():
    """The verify recipe's MLP: y = argmax(x @ w) is learnable; loss falls
    from ~ln(10) to below 0.5 within 6 epochs of SGD."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 32)).astype(np.float32)
    y = np.argmax(x @ rng.standard_normal((32, 10)), axis=1).astype(np.int32)
    config = ft.FFConfig()
    config.batch_size, config.seed = 64, 0
    ff = ft.FFModel(config, device="cpu")
    t = ff.create_tensor((64, 32))
    t = ff.dense(t, 64, ft.ActiMode.AC_MODE_RELU)
    ff.softmax(ff.dense(t, 10))
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.1, momentum=0.9),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ft.MetricsType.METRICS_ACCURACY])
    perf = ff.fit(x, y, epochs=6)
    losses = ff.fit_history.loss
    assert losses[0] > 1.5 and np.mean(losses[-8:]) < 0.5, losses
    assert perf.train_all == 6 * 512
    assert ff.eval(x, y).accuracy() > 0.85



def test_training_dropout_draws_one_mask_on_both_routes():
    """Attention dropout in training: the seed comes from the step's
    generator, and the flash route and the einsum-core route mask with
    the same counter hash, so one generator seed gives one loss on both;
    another seed gives another loss."""
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    config = ft.FFConfig()
    config.batch_size, config.seed = 2, 0
    ff = ft.FFModel(config, device="cpu")
    build_bert(ff, BertConfig(batch_size=2, seq_len=128, hidden=128,
                              num_heads=2, num_layers=1, intermediate=128,
                              dropout=0.1))
    ff.compile()
    x, y = data("bert", n=2)
    xs, lab = [torch.tensor(x)], torch.tensor(ff._prep_label(y))

    def loss(use_flash, seed):
        for node in ff.pcg.compute_nodes():
            if node.op.op_type == ft.OperatorType.OP_MULTIHEAD_ATTENTION:
                node.op.attrs["use_flash"] = use_flash
        gen = torch.Generator().manual_seed(seed)
        return float(ff.executor.loss_and_grads(ff.params, xs, lab, gen)[0])

    flash, core = loss(True, 7), loss(False, 7)
    assert abs(flash - core) <= 1e-5
    assert loss(True, 7) == flash
    assert abs(loss(True, 8) - flash) > 1e-6
