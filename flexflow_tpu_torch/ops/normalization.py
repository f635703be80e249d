"""LayerNorm (port of ``flexflow_tpu.ops.normalization``; reference:
src/ops/layer_norm.cc). Statistics are taken in fp32 whatever the compute
dtype, and the result is cast back, as in the JAX op. RMSNorm and the
opt-in Pallas softmax come in later slices."""
from __future__ import annotations

from ..ffconst import OperatorType
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_LAYERNORM)
class LayerNormOp(Op):
    """attrs: axes (list of ints), elementwise_affine, eps (default 1e-5)."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def _norm_shape(self, ishape):
        axes = [a % len(ishape)
                for a in self.attrs.get("axes", [len(ishape) - 1])]
        return tuple(ishape[a] for a in sorted(axes))

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (ConstantInitializer,
                                              ZeroInitializer)

        if not self.attrs.get("elementwise_affine", True):
            return {}
        nshape = self._norm_shape(input_shapes[0])
        return {
            "scale": (nshape, self.data_type, ConstantInitializer(1.0)),
            "bias": (nshape, self.data_type, ZeroInitializer()),
        }

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        (x,) = inputs
        ndim = x.dim()
        axes = tuple(sorted(a % ndim
                            for a in self.attrs.get("axes", [ndim - 1])))
        eps = self.attrs.get("eps", 1e-5)
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
        y = (xf - mean) / torch.sqrt(var + eps)
        if "scale" in params:
            bshape = [x.shape[a] if a in axes else 1 for a in range(ndim)]
            y = y * params["scale"].reshape(bshape) \
                + params["bias"].reshape(bshape)
        return [y.to(x.dtype)]
