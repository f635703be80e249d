"""Elementwise binary and unary ops, scalar ops, cast and dropout (port of
``flexflow_tpu.ops.elementwise``; reference: src/ops/element_binary.cc,
element_unary.cc, cast.cc, dropout.cc).

Each is one PyTorch call, as each is one ``jnp`` call in the JAX package.
``jax.nn.gelu`` defaults to the tanh approximation, so GELU is
``F.gelu(approximate="tanh")``; ``jnp.round`` and ``torch.round`` both
round half to even.

Dropout cannot reproduce ``jax.random.bernoulli``'s stream. Its mask is
the flash kernels' counter hash (``kernels/flash_attention.py``
``dropout_keep_scale_plain``) with the element's flat index as the
counter, seeded from the step's random stream as attention dropout is:
``fit`` draws a fresh seed every step, and a captured step reads it from
the program's seed buffer, so every replay masks anew.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ffconst import OperatorType, dtype_to_torch
from .base import Op, OpContext, register_op


def _broadcast_shape(a: Tuple[int, ...],
                     b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(np.broadcast_shapes(a, b))


class _BinaryOp(Op):
    _fn_name = ""

    def infer_output_shapes(self, input_shapes):
        a, b = input_shapes
        return [_broadcast_shape(a, b)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        a, b = inputs
        return [getattr(torch, self._fn_name)(a, b)]


@register_op(OperatorType.OP_EW_ADD)
class AddOp(_BinaryOp):
    _fn_name = "add"


@register_op(OperatorType.OP_EW_SUB)
class SubOp(_BinaryOp):
    _fn_name = "sub"


@register_op(OperatorType.OP_EW_MUL)
class MulOp(_BinaryOp):
    _fn_name = "mul"


@register_op(OperatorType.OP_EW_DIV)
class DivOp(_BinaryOp):
    _fn_name = "div"


@register_op(OperatorType.OP_EW_MAX)
class MaxOp(_BinaryOp):
    _fn_name = "maximum"


@register_op(OperatorType.OP_EW_MIN)
class MinOp(_BinaryOp):
    _fn_name = "minimum"


class _UnaryOp(Op):
    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def _apply(self, x):
        raise NotImplementedError

    def forward(self, params, inputs, ctx: OpContext):
        return [self._apply(inputs[0])]


def _unary_fn(name: str):
    import torch
    import torch.nn.functional as F

    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("relu", "elu"):
        return getattr(F, name)
    return getattr(torch, name)


def _make_unary(op_type: OperatorType, fn_name: str, name: str):
    """A unary op computing ``torch.<fn_name>`` (``F.<fn_name>`` for relu,
    elu and the tanh-approximate gelu)."""

    @register_op(op_type)
    class _U(_UnaryOp):
        def _apply(self, x):
            return _unary_fn(fn_name)(x)

    _U.__name__ = name
    return _U


ReluOp = _make_unary(OperatorType.OP_RELU, "relu", "ReluOp")
SigmoidOp = _make_unary(OperatorType.OP_SIGMOID, "sigmoid", "SigmoidOp")
TanhOp = _make_unary(OperatorType.OP_TANH, "tanh", "TanhOp")
EluOp = _make_unary(OperatorType.OP_ELU, "elu", "EluOp")
GeluOp = _make_unary(OperatorType.OP_GELU, "gelu", "GeluOp")
ExpOp = _make_unary(OperatorType.OP_EXP, "exp", "ExpOp")
LogOp = _make_unary(OperatorType.OP_LOG, "log", "LogOp")
SinOp = _make_unary(OperatorType.OP_SIN, "sin", "SinOp")
CosOp = _make_unary(OperatorType.OP_COS, "cos", "CosOp")
SqrtOp = _make_unary(OperatorType.OP_SQRT, "sqrt", "SqrtOp")
CeilOp = _make_unary(OperatorType.OP_CEIL, "ceil", "CeilOp")
RoundOp = _make_unary(OperatorType.OP_ROUND, "round", "RoundOp")
RsqrtOp = _make_unary(OperatorType.OP_RSQRT, "rsqrt", "RsqrtOp")


@register_op(OperatorType.OP_IDENTITY)
class IdentityOp(_UnaryOp):
    def _apply(self, x):
        return x


@register_op(OperatorType.OP_POW)
class PowOp(_UnaryOp):
    def _apply(self, x):
        import torch

        return torch.pow(x, self.attrs["exponent"])


@register_op(OperatorType.OP_SCALAR_MULTIPLY)
class ScalarMultiplyOp(_UnaryOp):
    def _apply(self, x):
        return x * self.attrs["scalar"]


@register_op(OperatorType.OP_SCALAR_ADD)
class ScalarAddOp(_UnaryOp):
    def _apply(self, x):
        return x + self.attrs["scalar"]


@register_op(OperatorType.OP_SCALAR_SUB)
class ScalarSubOp(_UnaryOp):
    def _apply(self, x):
        return x - self.attrs["scalar"]


@register_op(OperatorType.OP_SCALAR_TRUE_DIV)
class ScalarTrueDivOp(_UnaryOp):
    def _apply(self, x):
        return x / self.attrs["scalar"]


@register_op(OperatorType.OP_CAST)
class CastOp(Op):
    """reference: src/ops/cast.cc."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def output_dtype(self, input_dtypes):
        return self.attrs["target_dtype"]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0].to(dtype_to_torch(self.attrs["target_dtype"]))]


def dropout_mask(seed, shape, rate: float, device, global_shape=None,
                 offsets=None):
    """The keep-scale mask ({0, 1/(1-rate)} in fp32) of a tensor of
    ``shape``: the flash kernels' counter hash at each element's flat
    index. ``seed``: an int or a 0-d integer tensor. For a rank's shard
    of a tensor of ``global_shape`` starting at ``offsets``, the index is
    the element's flat index in the whole tensor."""
    import torch

    from ..kernels.flash_attention import dropout_keep_scale_plain

    if global_shape is None:
        n = int(np.prod(shape))
        idx = torch.arange(n, dtype=torch.int64, device=device).view(shape)
    else:
        idx = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(shape))):
            pos = torch.arange(shape[d], dtype=torch.int64,
                               device=device) + offsets[d]
            idx = idx + (pos * stride).view(
                (-1,) + (1,) * (len(shape) - 1 - d))
            stride *= int(global_shape[d])
    return dropout_keep_scale_plain(seed, 0, idx, 0, rate)


@register_op(OperatorType.OP_DROPOUT)
class DropoutOp(Op):
    """attrs: rate (default 0.5), seed (kept for the builder's signature;
    the mask's seed comes from the step, as in the JAX op). The identity
    outside training and at rate 0; in training the survivors are scaled
    by 1/(1-rate) (module doc for the mask)."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        from ..execution.graphs import next_seed

        (x,) = inputs
        rate = float(self.attrs.get("rate", 0.5))
        if not ctx.training or rate <= 0.0:
            return [x]
        if ctx.rng is None:
            raise ValueError(
                f"{self.name}: dropout in a training forward needs the "
                "step's random stream (OpContext.rng); fit and "
                "make_train_step pass it")
        where = {} if ctx.shard is None else {
            "global_shape": ctx.shard.in_shapes[0],
            "offsets": ctx.shard.in_offsets(0)}
        mask = dropout_mask(next_seed(ctx.rng), tuple(x.shape), rate,
                            x.device, **where)
        return [(x * mask).to(x.dtype)]
