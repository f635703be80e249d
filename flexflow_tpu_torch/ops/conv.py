"""Conv2D, Pool2D, Flat, BatchNorm (port of ``flexflow_tpu.ops.conv``;
reference: src/ops/conv_2d.cc, pool_2d.cc, flat.cc, batch_norm.cc).

The user-visible layout is NCHW, as in the JAX package. Conv kernels stay
HWIO, so ``get/set_params_numpy`` carry them 1:1 (the rule Linear's
(in, out) follows); the forward permutes them to cuDNN's OIHW and the
backward permutes the kernel's grad back.

The JAX package computes these ops with ``lax`` calls outside any Pallas
kernel, so here they are cuDNN's convolution, pooling and batch norm.

fp32 convolutions run in IEEE fp32 whatever the process default is:
cuDNN follows ``torch.backends.cudnn.allow_tf32`` (default True), and a
TF32 convolution moves results by 2e-4..8e-4, beyond the port's fp32
parity. :func:`ieee_fp32_convolutions` holds cuDNN's convolutions at IEEE
fp32 around the forward and, through :func:`conv2d_hwio`'s autograd
function, around the backward, which autograd runs after the forward has
returned. The setting is read when the kernel is chosen, so it also holds
inside a CUDA-graph capture.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ..ffconst import ActiMode, OperatorType, PoolType
from .base import Op, OpContext, register_op
from .linear import apply_activation


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


@contextlib.contextmanager
def ieee_fp32_convolutions():
    """cuDNN convolutions in IEEE fp32 inside the block (PyTorch's
    per-operation ``torch.backends.cudnn.conv.fp32_precision``), the
    process setting restored after it."""
    import torch

    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = prev


def _conv_function():
    import torch
    import torch.nn.functional as F

    class Conv2dHWIO(torch.autograd.Function):
        """``F.conv2d`` on an HWIO kernel, forward and backward in IEEE
        fp32 for fp32 tensors (module doc). The kernel is permuted to a
        contiguous OIHW copy once a call; its grad comes back as HWIO."""

        @staticmethod
        def forward(ctx, x, kernel, stride, padding, groups):
            w = kernel.permute(3, 2, 0, 1).contiguous()
            ctx.save_for_backward(x, w)
            ctx.conf = (stride, padding, groups)
            with ieee_fp32_convolutions():
                return F.conv2d(x, w, None, stride, padding, 1, groups)

        @staticmethod
        def backward(ctx, gy):
            x, w = ctx.saved_tensors
            stride, padding, groups = ctx.conf
            need_x, need_w = ctx.needs_input_grad[:2]
            with ieee_fp32_convolutions():
                gx, gw, _ = torch.ops.aten.convolution_backward(
                    gy, x, w, None, stride, padding, (1, 1), False, (0, 0),
                    groups, (need_x, need_w, False))
            if gw is not None:
                gw = gw.permute(2, 3, 1, 0)
            return gx, gw, None, None, None

    return Conv2dHWIO


_CONV_FN = None


def conv2d_hwio(x, kernel, stride=(1, 1), padding=(0, 0), groups: int = 1):
    """NCHW ``x`` convolved with an HWIO ``kernel`` (no bias),
    differentiable; fp32 in IEEE fp32 on the card."""
    global _CONV_FN
    if _CONV_FN is None:
        _CONV_FN = _conv_function()
    return _CONV_FN.apply(x, kernel, tuple(stride), tuple(padding),
                          int(groups))


@register_op(OperatorType.OP_CONV2D)
class Conv2DOp(Op):
    """attrs: out_channels, kernel_h/w, stride_h/w, padding_h/w, activation,
    groups, use_bias (reference builder: FFModel::conv2d, src/ops/conv_2d.cc).

    On a mesh under the hybrid strategy's channel-out split (mode
    "channel") the kernel and bias hold this rank's output channels and
    the forward, unchanged, computes them: its output is split over the
    model axis on the channel dim (``parallel/spmd.py``)."""

    def infer_output_shapes(self, input_shapes):
        n, c, h, w = input_shapes[0]
        a = self.attrs
        oh = _conv_out(h, a["kernel_h"], a["stride_h"], a["padding_h"])
        ow = _conv_out(w, a["kernel_w"], a["stride_w"], a["padding_w"])
        return [(n, a["out_channels"], oh, ow)]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (DefaultBiasInitializer,
                                              DefaultWeightInitializer)

        a = self.attrs
        in_c = input_shapes[0][1] // a.get("groups", 1)
        specs = {
            "kernel": ((a["kernel_h"], a["kernel_w"], in_c,
                        a["out_channels"]), self.data_type,
                       a.get("kernel_initializer")
                       or DefaultWeightInitializer()),
        }
        if a.get("use_bias", True):
            specs["bias"] = ((a["out_channels"],), self.data_type,
                             a.get("bias_initializer")
                             or DefaultBiasInitializer())
        return specs

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        a = self.attrs
        y = conv2d_hwio(x, params["kernel"], (a["stride_h"], a["stride_w"]),
                        (a["padding_h"], a["padding_w"]), a.get("groups", 1))
        if "bias" in params:
            y = y + params["bias"][None, :, None, None]
        return [apply_activation(y, a.get("activation",
                                          ActiMode.AC_MODE_NONE))]

    def flops(self, input_shapes, output_shapes):
        a = self.attrs
        n, co, oh, ow = output_shapes[0]
        ci = input_shapes[0][1] // a.get("groups", 1)
        return 2 * n * co * oh * ow * ci * a["kernel_h"] * a["kernel_w"]


@register_op(OperatorType.OP_POOL2D)
class Pool2DOp(Op):
    """attrs: kernel_h/w, stride_h/w, padding_h/w, pool_type, activation
    (reference: src/ops/pool_2d.cc). Max pooling pads with -inf, as the
    JAX op's ``reduce_window`` does. Average pooling divides by the
    window's cells inside the input (``count_include_pad=False``): the JAX
    op divides by a window sum of ones over the same padding, where padded
    cells count 0. ``F.*_pool2d`` refuse a padding above half the window,
    which ``reduce_window`` takes: there the input is padded explicitly
    (``-inf`` for max; zeros for the average's sum, divided by the same
    window sum over padded ones, as the JAX op divides) and pooled with
    padding 0."""

    def infer_output_shapes(self, input_shapes):
        n, c, h, w = input_shapes[0]
        a = self.attrs
        oh = _conv_out(h, a["kernel_h"], a["stride_h"], a["padding_h"])
        ow = _conv_out(w, a["kernel_w"], a["stride_w"], a["padding_w"])
        return [(n, c, oh, ow)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch
        import torch.nn.functional as F

        (x,) = inputs
        a = self.attrs
        kernel = (a["kernel_h"], a["kernel_w"])
        stride = (a["stride_h"], a["stride_w"])
        padding = (a["padding_h"], a["padding_w"])
        is_max = a.get("pool_type", PoolType.POOL_MAX) == PoolType.POOL_MAX
        if all(p <= k // 2 for p, k in zip(padding, kernel)):
            if is_max:
                y = F.max_pool2d(x, kernel, stride, padding)
            else:
                y = F.avg_pool2d(x, kernel, stride, padding,
                                 count_include_pad=False)
        else:
            pad = (padding[1], padding[1], padding[0], padding[0])
            if is_max:
                y = F.max_pool2d(F.pad(x, pad, value=float("-inf")),
                                 kernel, stride)
            else:
                s = F.avg_pool2d(F.pad(x, pad), kernel, stride,
                                 divisor_override=1)
                cnt = F.avg_pool2d(F.pad(torch.ones_like(x), pad), kernel,
                                   stride, divisor_override=1)
                y = s / cnt
        return [apply_activation(y, a.get("activation",
                                          ActiMode.AC_MODE_NONE))]


@register_op(OperatorType.OP_FLAT)
class FlatOp(Op):
    """Flatten all non-batch dims (reference: src/ops/flat.cc)."""

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        return [(s[0], int(np.prod(s[1:])))]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [x.reshape(x.shape[0], -1)]


@register_op(OperatorType.OP_BATCHNORM)
class BatchNormOp(Op):
    """attrs: relu (default True), eps (default 1e-5) (reference:
    src/ops/batch_norm.cc).

    Batch statistics always, in training and in eval, with no running
    statistics, as the JAX op does; the variance is the biased one
    (``jnp.var`` divides by N). ``F.batch_norm`` with ``training=True``
    and no running buffers normalises by exactly that, with its
    statistics in fp32 for 16-bit inputs, and writes the result once in
    the input's dtype, as the JAX op's fp32 arithmetic followed by one
    cast."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (ConstantInitializer,
                                              ZeroInitializer)

        c = input_shapes[0][1]
        return {
            "scale": ((c,), self.data_type, ConstantInitializer(1.0)),
            "bias": ((c,), self.data_type, ZeroInitializer()),
        }

    def forward(self, params, inputs, ctx: OpContext):
        import torch.nn.functional as F

        import torch

        (x,) = inputs
        # fp32 scale and shift for 16-bit inputs: with 16-bit ones the CPU
        # kernel folds them with the statistics into 16-bit factors, off
        # by several ulp
        wdt = torch.float32 if x.element_size() < 4 else x.dtype
        y = F.batch_norm(x, None, None, params["scale"].to(wdt),
                         params["bias"].to(wdt), training=True,
                         eps=self.attrs.get("eps", 1e-5))
        if self.attrs.get("relu", True):
            y = F.relu(y)
        return [y]
