"""Embedding lookup (port of ``flexflow_tpu.ops.embedding``; reference:
src/ops/embedding.cc).

``jnp.take`` never raises on an out-of-range id (it clamps or fills);
torch indexing raises on the CPU and trips a device-side assert on CUDA.
The serving steps therefore keep every position id inside the table
(``execution/executor.py`` clamps pad rows, and admission rejects requests
longer than the position table)."""
from __future__ import annotations

from ..ffconst import AggrMode, OperatorType
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_EMBEDDING)
class EmbeddingOp(Op):
    """attrs: num_entries, out_dim, aggr (AggrMode), kernel_initializer.

    input: int ids of shape (batch,) or (batch, bag); output
    (batch, bag, out_dim) for AGGR_MODE_NONE, (batch, out_dim) for SUM/AVG.
    """

    def infer_output_shapes(self, input_shapes):
        s = input_shapes[0]
        aggr = self.attrs.get("aggr", AggrMode.AGGR_MODE_NONE)
        if aggr == AggrMode.AGGR_MODE_NONE:
            return [tuple(s) + (self.attrs["out_dim"],)]
        return [(s[0], self.attrs["out_dim"])]

    def output_dtype(self, input_dtypes):
        return self.data_type

    def weight_specs(self, input_shapes):
        from ..execution.initializers import NormInitializer

        return {
            "weight": ((self.attrs["num_entries"], self.attrs["out_dim"]),
                       self.data_type,
                       self.attrs.get("kernel_initializer") or NormInitializer(
                           stddev=0.05)),
        }

    def forward(self, params, inputs, ctx: OpContext):
        import torch.nn.functional as F

        (ids,) = inputs
        out = F.embedding(ids.long(), params["weight"])
        aggr = self.attrs.get("aggr", AggrMode.AGGR_MODE_NONE)
        if aggr == AggrMode.AGGR_MODE_SUM:
            out = out.sum(dim=1)
        elif aggr == AggrMode.AGGR_MODE_AVG:
            out = out.mean(dim=1)
        return [out]
