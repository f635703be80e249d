"""Input / Weight / Constant source nodes of the PCG (port of
``flexflow_tpu.ops.noop``; reference: src/ops/noop.cc)."""
from __future__ import annotations

import numpy as np

from ..ffconst import OperatorType, dtype_to_torch
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_NOOP)
class NoOp(Op):
    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        return [inputs[0]]


@register_op(OperatorType.OP_INPUT)
class InputOp(Op):
    """Graph source; attrs: shape, dtype."""

    def infer_output_shapes(self, input_shapes):
        return [tuple(self.attrs["shape"])]

    def forward(self, params, inputs, ctx: OpContext):
        raise RuntimeError("InputOp is bound by the executor, never executed")


@register_op(OperatorType.OP_WEIGHT)
class WeightOp(Op):
    """Weight source node; attrs: shape, dtype."""

    def infer_output_shapes(self, input_shapes):
        return [tuple(self.attrs["shape"])]

    def forward(self, params, inputs, ctx: OpContext):
        raise RuntimeError("WeightOp is bound by the executor, never executed")


@register_op(OperatorType.OP_CONSTANT)
class ConstantOp(Op):
    """Frozen host tensor baked into the graph (attrs: value — np.ndarray).
    The tensor is made on the device of the params it runs with, once per
    device, and reused."""

    def infer_output_shapes(self, input_shapes):
        return [tuple(np.asarray(self.attrs["value"]).shape)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        device = ctx.device
        cached = getattr(self, "_on_device", None)
        if cached is None or cached.device != device:
            cached = torch.as_tensor(
                np.asarray(self.attrs["value"]),
                dtype=dtype_to_torch(self.data_type)).to(device)
            self._on_device = cached
        return [cached]
