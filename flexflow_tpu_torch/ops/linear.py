"""Linear (dense) operator (port of ``flexflow_tpu.ops.linear``; reference:
src/ops/linear.cc).

Weight layout stays (in_dim, out_dim), as in the JAX package, so weights
move between the packages unchanged. The product runs in the compute dtype:
cuBLAS and oneDNN accumulate bf16 products in fp32 and round the result
once, which is what the JAX op's ``preferred_element_type=float32`` followed
by a cast asks for. ``jax.nn.gelu`` defaults to the tanh approximation, so
GELU here is ``F.gelu(approximate="tanh")``.
"""
from __future__ import annotations

import numpy as np

from ..ffconst import ActiMode, OperatorType
from .base import Op, OpContext, register_op


def apply_activation(x, activation: ActiMode):
    import torch
    import torch.nn.functional as F

    if activation == ActiMode.AC_MODE_NONE:
        return x
    if activation == ActiMode.AC_MODE_RELU:
        return F.relu(x)
    if activation == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if activation == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if activation == ActiMode.AC_MODE_GELU:
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {activation}")


def apply_weight_regularizer(spec, kernel, ctx: OpContext) -> None:
    """The ``("l1"|"l2", lam)`` penalty of ``kernel`` (the compute-dtype
    copy the forward multiplies by), in fp32, appended to
    ``ctx.aux_losses`` when training (flexflow_tpu/ops/linear.py:74-89).
    On a mesh the penalty of a split kernel is summed over its shards, and
    where the kernel's grads are summed over the data axis afterwards, the
    penalty's gradient enters each rank's share once divided by that
    axis's size (its value is the whole penalty)."""
    if not spec or not ctx.training or ctx.aux_losses is None:
        return
    kind, lam = spec
    w = kernel.float()
    if kind == "l1":
        pen = lam * w.abs().sum()
    elif kind == "l2":
        pen = lam * (w * w).sum()
    else:
        raise ValueError(f"unknown regularizer kind {kind!r}")
    shard = ctx.shard
    if shard is not None:
        from ..parallel.spmd import reduce_to_replicated

        pen = reduce_to_replicated(pen, shard.mesh,
                                   shard.weight_axes("kernel"))
        n = shard.grad_scale()
        if n > 1:
            pen = pen.detach() + (pen - pen.detach()) / n
    ctx.aux_losses.append(pen)


@register_op(OperatorType.OP_LINEAR)
class LinearOp(Op):
    """attrs: out_dim, activation, use_bias, kernel_initializer,
    bias_initializer, kernel_regularizer.

    On a mesh the kernel and bias are this rank's shards: column-parallel
    (mode "col") computes its block of output columns; row-parallel ("row")
    contracts its block of input features and all-reduces the partial sum
    over the model axis before the bias and the activation. Both keep the
    cross-rank sums in fp32 (``ShardInfo.row_matmul`` /
    ``column_matmuls``)."""

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        return [tuple(ishape[:-1]) + (self.attrs["out_dim"],)]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (DefaultBiasInitializer,
                                              DefaultWeightInitializer)

        in_dim = input_shapes[0][-1]
        out_dim = self.attrs["out_dim"]
        specs = {
            "kernel": ((in_dim, out_dim), self.data_type,
                       self.attrs.get("kernel_initializer")
                       or DefaultWeightInitializer()),
        }
        if self.attrs.get("use_bias", True):
            specs["bias"] = ((out_dim,), self.data_type,
                             self.attrs.get("bias_initializer")
                             or DefaultBiasInitializer())
        return specs

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        kernel = params["kernel"]
        mode = ctx.shard.mode if ctx.shard is not None else "plain"
        if mode == "row":
            y = ctx.shard.row_matmul(x, kernel)
        elif mode == "col":
            (y,) = ctx.shard.column_matmuls(x, [kernel])
        else:
            y = x @ kernel
        if "bias" in params:
            y = y + params["bias"]
        apply_weight_regularizer(self.attrs.get("kernel_regularizer"),
                                 kernel, ctx)
        return [apply_activation(y, self.attrs.get("activation",
                                                   ActiMode.AC_MODE_NONE))]

    def flops(self, input_shapes, output_shapes):
        return 2 * int(np.prod(input_shapes[0])) * self.attrs["out_dim"]
