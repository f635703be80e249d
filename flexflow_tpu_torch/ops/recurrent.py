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

Serving (flexflow_tpu/ops/recurrent.py:52-72, 93-108): the carry is the
LSTM's decode state. A prefill puts ``[h, c]`` at each row's true last
token into ``cache_out``; a decode step resumes from ``cache_in`` and puts
the advanced carry into ``cache_out`` (the decode program copies it into
the engine's slot-major buffer in place); a prefill chunk raises.

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

        sv = ctx.serving
        if sv is not None and sv.mode == "chunk":
            # the carry is a summary, not per-token pool rows: there is no
            # block to share or chunk. The engine turns the prefix cache off
            # and refuses --prefill-chunk-tokens for LSTM graphs; this is
            # the backstop, as in the JAX op
            raise NotImplementedError(
                f"{self.name}: chunked/prefix-cached prefill supports "
                "attention-only stateful graphs; LSTM recurrence has no "
                "chunk path (serve without --prefill-chunk-tokens and "
                "with --prefix-cache off)")
        x = inputs[0]
        b, s, _ = x.shape
        h = self.attrs["hidden_size"]
        if sv is not None and sv.mode == "decode" and \
                sv.cache_in is not None and self.name in sv.cache_in:
            # the carry IS the decode state: resume from the slot's [h, c]
            # (which already folds a graph-given initial state through
            # the prefill)
            carry = sv.cache_in[self.name]
            h_t, c_t = carry[:, :h], carry[:, h:]
        elif len(inputs) > 1:
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
        prefill = sv is not None and sv.mode == "prefill" and \
            sv.lengths is not None
        ys, cs = [], []
        for xp_t in xproj.unbind(0):
            gates = torch.addmm(xp_t, h_t, wh)
            i, f, g, o = gates.chunk(4, dim=-1)
            c_t = torch.sigmoid(f) * c_t + torch.sigmoid(i) * torch.tanh(g)
            h_t = torch.sigmoid(o) * torch.tanh(c_t)
            ys.append(h_t)
            if prefill:
                cs.append(c_t)
        outputs = torch.stack(ys, dim=1)
        final_state = torch.cat([h_t, c_t], dim=-1)
        if prefill:
            # right-padded prompts: the carry decode resumes from is the
            # state at each row's last real token (lengths - 1), not at
            # the padded tail the loop marched through; gathered on the
            # device
            rows = torch.arange(b, device=x.device)
            idx = (sv.lengths.long() - 1).clamp(0, s - 1)
            sv.cache_out[self.name] = torch.cat(
                [outputs[rows, idx], torch.stack(cs, dim=1)[rows, idx]],
                dim=-1)
        elif sv is not None:
            sv.cache_out[self.name] = final_state
        return [outputs, final_state]

    def flops(self, input_shapes, output_shapes):
        b, s, d = input_shapes[0]
        h = self.attrs["hidden_size"]
        # per step: x @ wx (the shared precompute) + h @ wh, 4 gates
        return 2 * b * s * (d * 4 * h + h * 4 * h)
