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

    On a mesh the table is this rank's shard: split over the vocabulary
    (mode "vocab", the hybrid strategy's) each rank gathers the ids it
    holds, zeroes the others and the rows are summed over the model axis;
    split over the embedding dim ("dim") each rank returns its columns.
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
        weight = params["weight"]
        vocab = ctx.shard is not None and ctx.shard.mode == "vocab"
        if vocab:
            rows = weight.shape[0]
            local = ids.long() - ctx.shard.axis_offset(rows)
            held = (local >= 0) & (local < rows)
            out = F.embedding(local.clamp(0, rows - 1), weight) * \
                held[..., None].to(weight.dtype)
        else:
            out = F.embedding(ids.long(), weight)
        aggr = self.attrs.get("aggr", AggrMode.AGGR_MODE_NONE)
        if aggr == AggrMode.AGGR_MODE_SUM:
            out = out.sum(dim=1)
        elif aggr == AggrMode.AGGR_MODE_AVG:
            out = out.mean(dim=1)
        if vocab:
            out = ctx.shard.reduce(out)
        return [out]
