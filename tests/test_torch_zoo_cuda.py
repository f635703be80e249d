"""The op zoo and the vision and recommendation models on the card. Every
test here needs an NVIDIA GPU and skips without one (the CPU tests
``test_torch_ops_zoo.py`` and ``test_torch_model_zoo*.py`` hold the same
code against the JAX package).

* fp32 convolutions run in IEEE fp32 whatever the process asks of cuDNN:
  with ``torch.backends.cudnn.allow_tf32`` True (PyTorch's default), with
  the per-operation ``conv.fp32_precision`` set to "tf32" where PyTorch
  has it, and with TF32 off, the conv op's output and its input and
  weight grads are within 1e-5 relative norm of a float64 reference (the
  weight grad, a sum over 50176 and more products, within four times the
  rounding fp32 accumulates over its length), at two ResNet-50 shapes and
  a grouped ResNeXt-50 shape; a plain
  ``F.conv2d`` under the same default is not (that is what the guard is
  for), and the process setting is the same after the call;
* a captured ResNet-50 step and a captured DLRM step against the eager
  step body, from the same weights, batches and generator seeds, with
  cuDNN's deterministic algorithms: losses and params equal after four
  steps (cuDNN's default backward algorithms are not bitwise repeatable,
  so the comparison asks for its deterministic ones);
* a captured step through a dropout op draws a fresh mask on every
  replay, equal to the eager step's for the same generator state.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_zoo_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flexflow_tpu_torch as ft
from flexflow_tpu_torch.execution.graphs import _tensors_of
from flexflow_tpu_torch.models import build_dlrm, build_resnet50
from flexflow_tpu_torch.ops.conv import conv2d_hwio

pytestmark = pytest.mark.cuda

# IEEE fp32 against float64, relative norm: 1e-5, or, for a sum of K
# products (the weight grad sums over batch x output pixels, 50176 and
# more here), four times the sqrt(K) * 2**-24 that fp32 rounding alone
# accumulates, whichever is larger. A TF32 convolution rounds every
# operand to 10 bits (2**-11) and reads 2e-4..8e-4 whatever K is
CONV_TOL = 1e-5


def _conv_tol(k: int) -> float:
    return max(CONV_TOL, 4 * k ** 0.5 * 2.0 ** -24)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (cuDNN convolutions and CUDA "
                    "graphs run on the card only)")
    return torch.device("cuda")


def _set_precision(mode):
    """Set cuDNN's process-wide conv precision; returns a restore
    function."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if mode == "per_op_tf32":
        if conv is None:
            pytest.skip("this PyTorch has no per-operation fp32 precision")
        prev = conv.fp32_precision
        conv.fp32_precision = "tf32"
        return lambda: setattr(conv, "fp32_precision", prev)
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = mode == "allow_tf32"
    return lambda: setattr(cudnn, "allow_tf32", prev)


def _conv_errors(fn, x, w, gy, stride, padding, groups):
    """Relative norm errors of fn's output and grads against float64."""
    dev = x.device
    xf = x.float().requires_grad_(True)
    wf = w.float().requires_grad_(True)
    y = fn(xf, wf)
    gx, gw = torch.autograd.grad(y, (xf, wf), gy.float())
    x64, w64 = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y64 = F.conv2d(x64, w64.permute(3, 2, 0, 1), None, stride, padding, 1,
                   groups)
    gx64, gw64 = torch.autograd.grad(y64, (x64, w64), gy)
    assert y.device == dev
    return [float((a.detach().double() - b.detach()).norm()
                  / b.detach().norm())
            for a, b in ((y, y64), (gx, gx64), (gw, gw64))]


# (batch, in channels, size, out channels, kernel, stride, padding, groups)
CONV_SHAPES = {
    "resnet50_s0_3x3": (16, 64, 56, 64, 3, 1, 1, 1),
    "resnet50_stem": (8, 3, 224, 64, 7, 2, 3, 1),
    "resnext50_grouped": (16, 128, 56, 128, 3, 1, 1, 32),
}


@pytest.mark.parametrize("mode", ["allow_tf32", "per_op_tf32", "ieee"])
@pytest.mark.parametrize("shape", sorted(CONV_SHAPES))
def test_fp32_conv_is_ieee_whatever_the_process_default(shape, mode):
    dev = _cuda()
    n, ci, hw, co, k, s, p, g = CONV_SHAPES[shape]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, ci, hw, hw, generator=gen, dtype=torch.float64)
    w = torch.randn(k, k, ci // g, co, generator=gen,
                    dtype=torch.float64) * 0.05
    ho = (hw + 2 * p - k) // s + 1
    gy = torch.randn(n, co, ho, ho, generator=gen, dtype=torch.float64)
    x, w, gy = x.to(dev), w.to(dev), gy.to(dev)
    restore = _set_precision(mode)
    try:
        before = (torch.backends.cudnn.allow_tf32,
                  getattr(getattr(torch.backends.cudnn, "conv", None),
                          "fp32_precision", None))
        errs = _conv_errors(
            lambda a, b: conv2d_hwio(a, b, (s, s), (p, p), g), x, w, gy,
            (s, s), (p, p), g)
        after = (torch.backends.cudnn.allow_tf32,
                 getattr(getattr(torch.backends.cudnn, "conv", None),
                         "fp32_precision", None))
        plain = _conv_errors(
            lambda a, b: F.conv2d(a, b.permute(3, 2, 0, 1), None, (s, s),
                                  (p, p), 1, g), x, w, gy, (s, s), (p, p), g)
    finally:
        restore()
    # reduction lengths of the output, the input grad and the weight grad
    tols = [_conv_tol(ci // g * k * k), _conv_tol(co // g * k * k),
            _conv_tol(n * ho * ho)]
    assert all(e <= t for e, t in zip(errs, tols)), (errs, tols)
    assert after == before
    if mode != "ieee":
        # the guard is needed: the library call alone runs TF32 here
        assert max(p / t for p, t in zip(plain, tols)) > 2, (plain, tols)
    else:
        assert all(e <= t for e, t in zip(plain, tols)), (plain, tols)


def _model(kind, dev, seed=0):
    config = ft.FFConfig()
    config.batch_size, config.seed = 8, seed
    ff = ft.FFModel(config, device=dev)
    if kind == "resnet50":
        build_resnet50(ff, 8, 64)
        loss = ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    else:
        build_dlrm(ff, 8, (20000,) * 8)
        loss = ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
    ff.compile(optimizer=ft.AdamOptimizer(ff, alpha=1e-3), loss_type=loss)
    rng = np.random.default_rng(1)
    n = 8 * 4
    xs = []
    for t in ff._input_tensors:
        shape = (n,) + tuple(t.dims[1:])
        xs.append(rng.integers(0, 20000, shape).astype(np.int64)
                  if t.dtype == ft.DataType.DT_INT64
                  else rng.standard_normal(shape).astype(np.float32))
    if kind == "resnet50":
        y = rng.integers(0, 1000, (n, 1)).astype(np.int32)
    else:
        y = rng.random((n, 1)).astype(np.float32)
    return ff, xs, y


@pytest.mark.parametrize("kind", ["resnet50", "dlrm"])
def test_captured_step_equals_eager(kind):
    """ResNet-50 at its published widths at image 64, batch 8; DLRM with
    eight 20000-row tables, batch 8. Four steps each way from the same
    state and generator seeds, cuDNN deterministic: equal losses and
    params; one capture; finite losses."""
    dev = _cuda()
    ff, xs, y = _model(kind, dev)
    state = [t for ws in ff.params.values() for t in ws.values()]
    state += _tensors_of(ff.opt_state)
    snap = [t.clone() for t in state]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for mode in ("eager", "captured"):
            for t, v in zip(state, snap):
                t.copy_(v)
            ff._rng_counter = 0
            ff._capture_steps = mode == "captured"
            ff.fit(xs, y, epochs=1, shuffle=False)
            torch.cuda.synchronize()
            runs[mode] = (list(ff.fit_history.loss),
                          [t.clone() for ws in ff.params.values()
                           for t in ws.values()])
    finally:
        torch.backends.cudnn.deterministic = was
    (le, pe), (lc, pc) = runs["eager"], runs["captured"]
    assert len(le) == 4 and np.isfinite(le).all()
    assert lc == le
    assert all(torch.equal(a, b) for a, b in zip(pc, pe))
    assert ff.executor.make_train_step().program.captures == 1


def test_dropout_op_draws_a_fresh_mask_every_replay():
    """dense -> dropout 0.5 -> dense, SGD at rate 0 (weights never move):
    a captured step's loss equals the eager step's for the same generator,
    and consecutive replays with the next generators give other losses."""
    dev = _cuda()
    config = ft.FFConfig()
    config.batch_size, config.seed = 16, 0
    ff = ft.FFModel(config, device=dev)
    t = ff.dropout(ff.dense(ff.create_tensor((16, 64)), 256), rate=0.5)
    ff.dense(t, 1)
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.0),
               loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((16, 64)).astype(np.float32),
                     device=dev)
    y = torch.tensor(rng.standard_normal((16, 1)).astype(np.float32),
                     device=dev)
    ex = ff.executor
    step, eager = ex.make_train_step(), ex.make_train_step(capture=False)

    def loss(fn, k):
        _p, _s, v, _m = fn(ff.params, ff.opt_state, [x], y,
                           torch.Generator().manual_seed(k))
        return float(v)

    step_losses = [loss(step, k) for k in range(5)]  # eager, capture, ...
    assert step.program.captures == 1
    assert step_losses[2] == loss(eager, 2)
    assert len(set(step_losses[1:])) == 4, step_losses
