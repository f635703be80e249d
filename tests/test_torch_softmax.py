"""Row softmax in the PyTorch port against the JAX package.

* ``softmax_plain`` / ``softmax_bwd_plain`` (the CPU path of the port's
  kernel wrappers) against the JAX Pallas kernels ``pallas_softmax`` in
  interpret mode and its ``jax.vjp``: fp32 atol 1e-6 (probabilities and
  grads of magnitude <= 1; summation order only). bf16: both sides compute
  in fp32 from the same bf16 inputs and round once, so they differ by at
  most one bf16 ulp of the value (at most 2**-7 of it).
* ``SoftmaxOp`` with ``use_pallas``: the kernel route where the gate is
  open, ``torch.softmax`` where it is closed (no raise at dim < 1024 or on
  another axis), and without ``use_pallas`` as before.
* one training step of a tiny GPT-2 with vocab 1024 and
  ``ff.softmax(logits, use_pallas=True)`` in both packages, same weights:
  loss within 1e-5, grads rtol 1e-4 / atol 1e-5, and the params after one
  Adam step through ``fit``. Once as the gates stand on the CPU (both
  packages then compute the library softmax) and once with both gates
  forced open, so JAX runs its Pallas kernels in interpret mode and the
  port its kernel route's autograd Function on the plain versions.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flexflow_tpu as fj
import flexflow_tpu.kernels.softmax as jsm
from flexflow_tpu.models.gpt2 import GPT2Config as JaxGPT2Config
from flexflow_tpu.models.gpt2 import build_gpt2 as jax_build_gpt2
import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.softmax as sm
from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.normalization import SoftmaxOp
from torch_training_pairs import (GRAD_TOL, TOL, assert_trees_close,
                                  jax_loss_and_grads, port_loss_and_grads)

SHAPES = [(8, 1024), (4, 16, 2048), (3, 1280)]


def _xg(shape, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * 4.0).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_backward_match_jax_interpret_fp32(shape):
    x, g = _xg(shape)
    jp, vjp = jax.vjp(lambda a: jsm.pallas_softmax(a, interpret=True),
                      jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    tp = sm.softmax(xt)
    (tdx,) = torch.autograd.grad(tp, xt, torch.tensor(g))
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_forward_and_backward_match_jax_interpret_bf16(shape):
    x, g = _xg(shape, seed=1)
    bf = jnp.bfloat16
    jp, vjp = jax.vjp(lambda a: jsm.pallas_softmax(a, interpret=True),
                      jnp.asarray(x, bf))
    (jdx,) = vjp(jnp.asarray(g, bf))
    xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    tp = sm.softmax(xt)
    (tdx,) = torch.autograd.grad(tp, xt, torch.tensor(g).to(torch.bfloat16))
    assert tp.dtype == tdx.dtype == torch.bfloat16
    for got, want in ((tp.detach(), jp), (tdx, jdx)):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=1e-30)


def test_backward_reads_the_saved_output():
    """The plain backward is p * (g - sum(p * g)) on the forward's p."""
    x, g = _xg((2, 1024), seed=2)
    p = sm.softmax_plain(torch.tensor(x))
    want = p * (torch.tensor(g) - (p * torch.tensor(g)).sum(-1,
                                                            keepdim=True))
    torch.testing.assert_close(sm.softmax_bwd_plain(p, torch.tensor(g)),
                               want, rtol=0, atol=1e-7)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    x, g = _xg((4, 1024), seed=3)
    sm.reset_launch_count()
    xt = torch.tensor(x, requires_grad=True)
    p = sm.softmax(xt)
    torch.autograd.grad(p, xt, torch.tensor(g))
    assert sm.launch_count("softmax_fwd") == sm.launch_count(
        "softmax_bwd") == 0
    torch.testing.assert_close(p.detach(), sm.softmax_plain(torch.tensor(x)),
                               rtol=0, atol=0)


# ------------------------------------------------------------- SoftmaxOp
def _shape_gate(x, axis, opt_in=False):
    """The kernel gate without its CUDA clause: the gate as it stands on a
    card, applied to CPU tensors."""
    if not opt_in or axis not in (-1, x.dim() - 1):
        return False
    return x.shape[-1] >= 1024 and x.shape[-1] % 128 == 0 and x.numel() > 0


@pytest.mark.parametrize("shape,axis,use_pallas,kernel", [
    ((4, 1024), -1, True, True),       # gate open
    ((2, 3, 2048), 2, True, True),     # last axis named positively
    ((4, 128), -1, True, False),       # dim < 1024: library softmax
    ((4, 1000), -1, True, False),      # not a multiple of 128
    ((1024, 4), 0, True, False),       # not the last axis
    ((4, 1024), -1, False, False),     # no opt-in
])
def test_softmax_op_routes_as_the_jax_op(monkeypatch, shape, axis,
                                         use_pallas, kernel):
    monkeypatch.setattr(sm, "should_use_softmax_kernel", _shape_gate)
    calls = []
    plain = sm.softmax_plain
    monkeypatch.setattr(sm, "softmax_plain",
                        lambda x: calls.append(1) or plain(x))
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    op = SoftmaxOp("sm", {"axis": axis, "use_pallas": use_pallas},
                   ft.DataType.DT_FLOAT)
    (got,) = op.forward({}, [torch.tensor(x)], OpContext())
    want = jax.nn.softmax(jnp.asarray(x), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)
    assert bool(calls) == kernel


def test_softmax_op_does_not_raise_on_the_cpu_gate():
    """On CPU tensors the real gate is closed (no CUDA): ``use_pallas``
    computes ``torch.softmax``, as the JAX op computes ``jax.nn.softmax``
    off the TPU."""
    x = torch.randn(4, 2048)
    op = SoftmaxOp("sm", {"axis": -1, "use_pallas": True},
                   ft.DataType.DT_FLOAT)
    assert not sm.should_use_softmax_kernel(x, -1, opt_in=True)
    (got,) = op.forward({}, [x], OpContext())
    torch.testing.assert_close(got, torch.softmax(x, -1), rtol=0, atol=0)


# ------------------------------------------------ one GPT-2 training step
B, S, HID, HEADS, LAYERS, INTER, VOCAB = 2, 32, 64, 4, 2, 128, 1024


def _build(pkg):
    config = pkg.FFConfig()
    config.batch_size, config.seed = B, 3
    ff = pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")
    cfg = (JaxGPT2Config if pkg is fj else GPT2Config)(
        batch_size=B, seq_len=S, hidden=HID, num_heads=HEADS,
        num_layers=LAYERS, intermediate=INTER, vocab_size=VOCAB)
    _ids, logits = (jax_build_gpt2 if pkg is fj else build_gpt2)(ff, cfg)
    ff.softmax(logits, use_pallas=True)
    ff.compile(optimizer=pkg.AdamOptimizer(None, alpha=1e-3),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _jax_gate_open(x, axis, opt_in=False):
    """The JAX gate without its TPU clause (Pallas then runs in
    interpret mode on the CPU)."""
    return bool(opt_in) and axis in (-1, x.ndim - 1) and \
        x.shape[-1] >= 1024 and x.shape[-1] % 128 == 0


@pytest.mark.parametrize("kernel_route", [False, True])
def test_gpt2_step_with_opt_in_softmax_matches_jax(monkeypatch,
                                                   kernel_route):
    calls = []
    if kernel_route:
        monkeypatch.setattr(jsm, "should_use_pallas_softmax", _jax_gate_open)
        monkeypatch.setattr(sm, "should_use_softmax_kernel", _shape_gate)
        bwd = sm.softmax_bwd_plain
        monkeypatch.setattr(sm, "softmax_bwd_plain",
                            lambda p, g: calls.append(1) or bwd(p, g))
    jff, tff = _build(fj), _build(ft)
    tff.set_params_numpy(jax.device_get(jff.params))
    rng = np.random.default_rng(5)
    x = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    y = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    jl, jg = jax_loss_and_grads(jff, x, y)
    tl, tg = port_loss_and_grads(tff, x, y)
    assert abs(tl - jl) <= 1e-5
    assert_trees_close(jg, tg, **GRAD_TOL)
    assert bool(calls) == kernel_route
    # one Adam step through fit in both packages
    jff._telemetry_requested = True
    jff.fit(x, y, epochs=1, shuffle=False)
    tff.fit(x, y, epochs=1, shuffle=False)
    np.testing.assert_allclose(tff.fit_history.loss,
                               jff._telemetry.loss_history, **TOL)
    assert_trees_close(jax.device_get(jff.params), tff.get_params_numpy(),
                       rtol=1e-4, atol=1e-5)
