"""Elementwise binary ops (port of ``flexflow_tpu.ops.elementwise``;
reference: src/ops/element_binary.cc). This slice needs ``add``; the other
binary, unary, scalar, cast and dropout ops come with the slices that use
them."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ffconst import OperatorType
from .base import Op, OpContext, register_op


def _broadcast_shape(a: Tuple[int, ...],
                     b: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(np.broadcast_shapes(a, b))


@register_op(OperatorType.OP_EW_ADD)
class AddOp(Op):
    def infer_output_shapes(self, input_shapes):
        a, b = input_shapes
        return [_broadcast_shape(a, b)]

    def forward(self, params, inputs, ctx: OpContext):
        a, b = inputs
        return [a + b]
