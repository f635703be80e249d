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
    The tensor is made on the context's device once, and reused (a step's
    first, eager run makes it; a CUDA-graph capture, which can make no
    host-to-device copy, finds it made)."""

    def infer_output_shapes(self, input_shapes):
        return [tuple(np.asarray(self.attrs["value"]).shape)]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        # keyed by the device asked for: torch.device("cuda") is not equal
        # to the "cuda:0" of the tensor made there
        device = torch.device(ctx.device or "cpu")
        made = getattr(self, "_on_device", None)
        if made is None or made[0] != device:
            made = (device, torch.as_tensor(
                np.asarray(self.attrs["value"]),
                dtype=dtype_to_torch(self.data_type)).to(device))
            self._on_device = made
        return [made[1]]
