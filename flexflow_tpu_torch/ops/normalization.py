"""LayerNorm and Softmax (port of ``flexflow_tpu.ops.normalization``;
reference: src/ops/layer_norm.cc, softmax.cc). LayerNorm statistics are
taken in fp32 whatever the compute dtype, and the result is cast back, as
in the JAX op. ``SoftmaxOp`` takes the row-softmax kernel on opt-in
(``use_pallas``) where the JAX op takes its Pallas kernel. RMSNorm, the JAX
package's extension for LLM blocks, keeps its statistics in fp32 too."""
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
        import torch.nn.functional as F

        (x,) = inputs
        ndim = x.dim()
        axes = tuple(sorted(a % ndim
                            for a in self.attrs.get("axes", [ndim - 1])))
        eps = self.attrs.get("eps", 1e-5)
        w, b = params.get("scale"), params.get("bias")
        if axes == tuple(range(ndim - len(axes), ndim)) and all(
                t is None or t.dtype == x.dtype for t in (w, b)):
            # trailing axes: one fused kernel (and one in the backward),
            # which takes the statistics and applies scale and shift in
            # fp32 for 16-bit inputs too and rounds the result once
            return [F.layer_norm(x, x.shape[ndim - len(axes):], w, b, eps)]
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = xf.var(dim=axes, keepdim=True, unbiased=False)
        y = (xf - mean) / torch.sqrt(var + eps)
        if "scale" in params:
            bshape = [x.shape[a] if a in axes else 1 for a in range(ndim)]
            y = y * params["scale"].reshape(bshape) \
                + params["bias"].reshape(bshape)
        return [y.to(x.dtype)]


@register_op(OperatorType.OP_RMSNORM)
class RMSNormOp(Op):
    """attrs: axes (default the last), eps (default 1e-6);
    ``x / sqrt(mean(x**2) + eps) * scale`` in fp32, cast back
    (flexflow_tpu/ops/normalization.py:54-80)."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def _axes(self, ndim):
        return tuple(sorted(a % ndim
                            for a in self.attrs.get("axes", [ndim - 1])))

    def weight_specs(self, input_shapes):
        from ..execution.initializers import ConstantInitializer

        ishape = input_shapes[0]
        nshape = tuple(ishape[a] for a in self._axes(len(ishape)))
        return {"scale": (nshape, self.data_type, ConstantInitializer(1.0))}

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        (x,) = inputs
        axes = self._axes(x.dim())
        xf = x.float()
        ms = (xf * xf).mean(dim=axes, keepdim=True)
        y = xf / torch.sqrt(ms + self.attrs.get("eps", 1e-6))
        bshape = [x.shape[a] if a in axes else 1 for a in range(x.dim())]
        return [(y * params["scale"].reshape(bshape)).to(x.dtype)]


@register_op(OperatorType.OP_SOFTMAX)
class SoftmaxOp(Op):
    """attrs: axis (default -1), use_pallas. ``torch.softmax`` over the
    axis, in the input's dtype as ``jax.nn.softmax``. ``use_pallas=True``
    opts last-axis rows the kernel gate takes (``kernels/softmax.py``:
    rows of at least 1024, a multiple of 128, on CUDA) into the row-softmax
    kernel and its backward; elsewhere it computes ``torch.softmax``, as
    the JAX op computes ``jax.nn.softmax`` where its gate is closed."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        from ..kernels.softmax import softmax, should_use_softmax_kernel

        (x,) = inputs
        axis = self.attrs.get("axis", -1)
        if should_use_softmax_kernel(
                x, axis, opt_in=bool(self.attrs.get("use_pallas"))):
            return [softmax(x)]
        return [torch.softmax(x, dim=axis)]
