"""Multi-head attention (port of ``flexflow_tpu.ops.attention``; reference:
src/ops/attention.cc).

Weight layouts are the JAX package's — ``wq/wk/wv (d, h, k)``,
``wo (h, v, d)``, ``bo (d,)`` — so parameters carry over unchanged. Scores
and the probability-weighted sum accumulate in fp32 whatever the compute
dtype (the JAX op's ``preferred_element_type=float32``).

Serving (``ctx.serving``): prefill runs the plain causal core and hands the
prompt's k/v rows to the engine; decode writes one token per slot into the
paged pool and reads it through the flash-decode kernel
(``kernels/flash_decode.py``; CUDA on the card, its plain version on the
CPU); chunk prefill writes a chunk's rows into one slot's blocks and
attends over the slot's gathered extent. The training/eval flash kernels
are ported in the next slice; until then a whole-sequence forward outside
serving runs the plain einsum core.
"""
from __future__ import annotations

import numpy as np

from ..ffconst import OperatorType
from .base import Op, OpContext, register_op

NEG_INF = -1e30


def mha_core(q, k, v, *, causal: bool = False, scale: float = None):
    """q,k,v: (batch, heads, seq, head_dim) -> (batch, heads, seq_q, vd) in
    v's dtype; scores, softmax and the PV sum in fp32."""
    import torch

    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(head_dim)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=logits.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


@register_op(OperatorType.OP_MULTIHEAD_ATTENTION)
class MultiHeadAttentionOp(Op):
    """attrs: embed_dim, num_heads, kdim, vdim, dropout, bias, add_bias_kv,
    add_zero_attn, causal (builder: FFModel.multihead_attention).

    inputs: (query, key, value), each (batch, seq, dim).
    output: (batch, seq_q, embed_dim).
    """

    def _dims(self):
        a = self.attrs
        embed = a["embed_dim"]
        heads = a["num_heads"]
        kdim = a.get("kdim") or embed // heads
        vdim = a.get("vdim") or embed // heads
        return embed, heads, kdim, vdim

    def infer_output_shapes(self, input_shapes):
        q = input_shapes[0]
        return [(q[0], q[1], self.attrs["embed_dim"])]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (DefaultBiasInitializer,
                                              DefaultWeightInitializer)

        embed, heads, kdim, vdim = self._dims()
        init = self.attrs.get("kernel_initializer") \
            or DefaultWeightInitializer()
        specs = {
            "wq": ((input_shapes[0][-1], heads, kdim), self.data_type, init),
            "wk": ((input_shapes[1][-1], heads, kdim), self.data_type, init),
            "wv": ((input_shapes[2][-1], heads, vdim), self.data_type, init),
            "wo": ((heads, vdim, embed), self.data_type, init),
        }
        if self.attrs.get("bias", True):
            specs["bo"] = ((embed,), self.data_type, DefaultBiasInitializer())
        return specs

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        q_in, k_in, v_in = inputs
        q = torch.einsum("bsd,dhk->bhsk", q_in, params["wq"])
        k = torch.einsum("bsd,dhk->bhsk", k_in, params["wk"])
        v = torch.einsum("bsd,dhk->bhsk", v_in, params["wv"])
        causal = self.attrs.get("causal", False)
        if ctx.serving is not None:
            out = _serving_attention(self.name, q, k, v, ctx.serving,
                                     causal=causal)
        else:
            if ctx.training and self.attrs.get("dropout", 0.0):
                raise NotImplementedError(
                    f"{self.name}: attention dropout in training is ported "
                    "in a later slice (training)")
            out = mha_core(q, k, v, causal=causal)
        y = torch.einsum("bhsv,hvd->bsd", out.float(),
                         params["wo"].float()).to(q_in.dtype)
        if "bo" in params:
            y = y + params["bo"]
        return [y]


def _serving_attention(name: str, q, k, v, sv, *, causal: bool):
    """Prefill / decode / chunk attention over the paged KV pool
    (``serving/kvcache.py``). q/k/v are (batch, heads, seq, dim)."""
    import torch

    from ..serving.kvcache import gather_paged_kv, write_token_kv_paged

    if not causal:
        raise ValueError(
            f"{name}: serving prefill/decode requires CAUSAL self-attention "
            "(bidirectional attention cannot be decoded incrementally); "
            "build the model with causal=True")
    if sv.mode == "chunk":
        return _chunk_prefill_attention(name, q, k, v, sv)
    if sv.mode == "prefill":
        # the prompt's rows; the engine scatters them into the slot's
        # blocks (serving/kvcache.scatter_prefill_paged)
        sv.cache_out[name] = (k, v)
        return mha_core(q, k, v, causal=True)
    scale = 1.0 / np.sqrt(q.shape[-1])
    tables, bs = sv.block_tables, sv.block_size
    kp, vp = sv.cache_in[name]
    write_token_kv_paged(kp, k, sv.positions, tables, bs)
    write_token_kv_paged(vp, v, sv.positions, tables, bs)
    sv.cache_out[name] = (kp, vp)
    out = _maybe_flash_decode(q, (kp, vp), tables, sv, scale)
    if out is not None:
        return out
    kc = gather_paged_kv(kp, tables)
    vc = gather_paged_kv(vp, tables)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    kpos = torch.arange(kc.shape[2], device=q.device)
    mask = kpos[None, None, None, :] <= sv.positions.long()[:, None, None,
                                                            None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vc.dtype).float(),
                       vc.float())
    return out.to(vc.dtype)


def _chunk_prefill_attention(name: str, q, k, v, sv):
    """One prefill CHUNK of a single slot (batch 1): q/k/v carry
    ``chunk_len`` tokens starting at ``sv.positions[0]``, of which the first
    ``sv.lengths[0]`` are real. The real rows are written into the slot's
    pool blocks (pad rows into the garbage block) and every row attends to
    the slot's gathered extent — the cached prefix and earlier chunks plus
    this chunk — under ``key_pos <= row_pos``."""
    import torch

    from ..serving.kvcache import gather_paged_kv, write_chunk_kv_paged

    tables, bs = sv.block_tables, sv.block_size  # tables: (1, mb)
    row = tables[0]
    chunk_len = q.shape[2]
    pos = sv.positions[0].long() + torch.arange(chunk_len, device=q.device)
    valid = torch.arange(chunk_len, device=q.device) < sv.lengths[0]
    kp, vp = sv.cache_in[name]
    write_chunk_kv_paged(kp, k, pos, valid, row, bs)
    write_chunk_kv_paged(vp, v, pos, valid, row, bs)
    sv.cache_out[name] = (kp, vp)
    kc = gather_paged_kv(kp, tables)
    vc = gather_paged_kv(vp, tables)
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    kpos = torch.arange(kc.shape[2], device=q.device)
    mask = kpos[None, None, None, :] <= pos[None, None, :, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vc.dtype).float(),
                       vc.float())
    return out.to(vc.dtype)


def _maybe_flash_decode(q, entry, tables, sv, sm_scale):
    """Route one paged decode read through the flash-decode kernel — the
    default (non-exact) path, as ``jax`` routes it to the Pallas kernel on
    a TPU. Returns the (S, h, 1, vd) output, or None for the exact gather
    path. The wrapper launches the CUDA kernel for CUDA tensors and runs
    its plain version for CPU tensors."""
    from ..kernels.flash_decode import flash_decode

    if sv.exact:
        return None
    kp, vp = entry
    n_keys = (sv.positions + 1).to(tables.dtype)
    out = flash_decode(q[:, :, 0, :].contiguous(), kp, vp, tables, n_keys,
                       sm_scale=sm_scale)
    return out[:, :, None, :]
