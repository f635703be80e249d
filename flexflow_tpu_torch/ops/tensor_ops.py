"""Reductions (port of the ``ReduceMeanOp`` / ``MeanOp`` pair of
``flexflow_tpu.ops.tensor_ops``; reference: src/ops/reduce.cc, mean.cc).
BERT's pooler needs them; the rest of the tensor ops come in later
slices."""
from __future__ import annotations

from ..ffconst import OperatorType
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_REDUCE_MEAN)
class ReduceMeanOp(Op):
    """attrs: axes, keepdims."""

    def _axes(self, ndim):
        return tuple(sorted(a % ndim for a in self.attrs["axes"]))

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        axes = self._axes(len(s))
        keep = self.attrs.get("keepdims", False)
        out = [(1 if keep else None) if i in axes else d
               for i, d in enumerate(s)]
        return [tuple(d for d in out if d is not None)]

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        return [x.mean(dim=self._axes(x.dim()),
                       keepdim=self.attrs.get("keepdims", False))]


@register_op(OperatorType.OP_MEAN)
class MeanOp(ReduceMeanOp):
    """reference: src/ops/mean.cc."""
