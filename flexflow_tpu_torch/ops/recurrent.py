"""Recurrent ops: LSTM (port of ``flexflow_tpu.ops.recurrent``; reference:
nmt/lstm.cu, the legacy NMT app's cuDNN RNN).

The JAX op computes one input GEMM over all steps and then ``lax.scan``s
the recurrent GEMM and the gate arithmetic (flexflow_tpu/ops/recurrent.py
:75-90). Here the scan is a Python loop of the same terms: per step one
``addmm`` (the step's input projection plus ``h @ wh``) and the gate
arithmetic, unrolled into the captured train step. No Pallas kernel lies
on this path in the JAX package, so the port has none either.

cuDNN's RNN is not used: it follows ``torch.backends.cudnn.allow_tf32``
(True by default), which breaks fp32 parity with the JAX op, and it
carries a second bias (``b_hh``) that would take gradients. The carry
``(h, c)`` stays in the compute dtype, as JAX keeps it.

Layout: input (batch, seq, in_dim) -> outputs (batch, seq, hidden).
Optional second input: the initial state (batch, 2*hidden) = [h, c]
concatenated (how the NMT decoder receives the encoder's final state).
Outputs: [sequence outputs, final state (batch, 2*hidden)].
"""
from __future__ import annotations

from ..ffconst import OperatorType
from .base import Op, OpContext, register_op


@register_op(OperatorType.OP_LSTM)
class LSTMOp(Op):
    """attrs: hidden_size; optional 2nd input = initial [h, c]. Weights
    ``wx (in, 4h)``, ``wh (h, 4h)``, ``bias (4h)``, gates in the order i,
    f, g, o, as the JAX op declares them."""

    def infer_output_shapes(self, input_shapes):
        b, s, _ = input_shapes[0]
        h = self.attrs["hidden_size"]
        return [(b, s, h), (b, 2 * h)]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (GlorotUniformInitializer,
                                              ZeroInitializer)

        in_dim = input_shapes[0][-1]
        h = self.attrs["hidden_size"]
        glorot = GlorotUniformInitializer()
        return {
            "wx": ((in_dim, 4 * h), self.data_type, glorot),
            "wh": ((h, 4 * h), self.data_type, glorot),
            "bias": ((4 * h,), self.data_type, ZeroInitializer()),
        }

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        if ctx.serving is not None:
            raise NotImplementedError(
                f"{self.name}: LSTM serving (the recurrent carry as decode "
                "state) is ported in a later slice")
        x = inputs[0]
        b, s, _ = x.shape
        h = self.attrs["hidden_size"]
        if len(inputs) > 1:
            h_t, c_t = inputs[1][:, :h], inputs[1][:, h:]
        else:
            h_t = torch.zeros((b, h), dtype=x.dtype, device=x.device)
            c_t = torch.zeros((b, h), dtype=x.dtype, device=x.device)
        wh = params["wh"]
        # the input projections of every step in one GEMM, as the JAX op
        # computes them before its scan; step-major, so each step's rows
        # are contiguous. ``unbind``, not ``xproj[t]``: the backward of s
        # selects would zero-fill and add s full-size grads, that of one
        # unbind stacks the s step grads once
        xproj = x.transpose(0, 1) @ params["wx"] + params["bias"]
        ys = []
        for xp_t in xproj.unbind(0):
            gates = torch.addmm(xp_t, h_t, wh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c_t = torch.sigmoid(f) * c_t + torch.sigmoid(i) * torch.tanh(g)
            h_t = torch.sigmoid(o) * torch.tanh(c_t)
            ys.append(h_t)
        return [torch.stack(ys, dim=1), torch.cat([h_t, c_t], dim=-1)]

    def flops(self, input_shapes, output_shapes):
        b, s, d = input_shapes[0]
        h = self.attrs["hidden_size"]
        # per step: x @ wx (the shared precompute) + h @ wh, 4 gates
        return 2 * b * s * (d * 4 * h + h * 4 * h)
