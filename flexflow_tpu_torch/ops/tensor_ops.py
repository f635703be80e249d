"""Reductions and top-k (port of the ``ReduceMeanOp`` / ``MeanOp`` pair and
``TopKOp`` of ``flexflow_tpu.ops.tensor_ops``; reference: src/ops/reduce.cc,
mean.cc, topk.cc). BERT's pooler needs the means; the rest of the tensor
ops come in later slices."""
from __future__ import annotations

from ..ffconst import DataType, OperatorType
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


@register_op(OperatorType.OP_TOPK)
class TopKOp(Op):
    """attrs: k, sorted, use_pallas. outputs: (values, int32 indices) over
    the last dim (reference: src/ops/topk.cc). ``torch.topk`` by default;
    on opt-in (``use_pallas``) a shape the kernel gate takes
    (``kernels/topk.py``: 1 <= k <= 8, rows a multiple of 128, on CUDA)
    goes through the row top-k kernel, as the JAX op routes to its Pallas
    kernel. Values keep x's dtype; ties go to the lowest index on the
    kernel route (``torch.topk`` does not specify its order among ties)."""

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        out = tuple(s[:-1]) + (self.attrs["k"],)
        return [out, out]

    def output_dtypes(self, input_dtypes, num_outputs):
        return [input_dtypes[0], DataType.DT_INT32]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        from ..kernels.topk import should_use_topk_kernel, topk

        (x,) = inputs
        k = self.attrs["k"]
        if should_use_topk_kernel(x, k,
                                  opt_in=self.attrs.get("use_pallas", False)):
            values, indices = topk(x, k)
        else:
            values, indices = torch.topk(x, k, dim=-1)
        return [values, indices.to(torch.int32)]
