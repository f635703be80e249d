"""Multi-head attention and the SDPA core (port of
``flexflow_tpu.ops.attention``; reference: src/ops/attention.cc).

Weight layouts are the JAX package's — ``wq/wk/wv (d, h, k)``,
``wo (h, v, d)``, ``bo (d,)`` — so parameters carry over unchanged. Scores
and the probability-weighted sum accumulate in fp32 whatever the compute
dtype (the JAX op's ``preferred_element_type=float32``).

Whole-sequence forwards (training, eval, predict) route as the JAX op
routes (flexflow_tpu/ops/attention.py:111-135): serving first; then, where
a strategy names a ``sequence_parallel_axis`` of the mesh, the sequence
split over it (``ctx.shard``'s plan hands the op its block of positions)
and attention by ring rotation (``kernels/ring_attention.py``, the
default) or, under ``sequence_parallel_mode="alltoall"``, by Ulysses'
all-to-alls (``kernels/ulysses_attention.py``), both on the flash kernels;
then the flash-attention kernels (``_should_use_flash``;
``kernels/flash_attention.py``, CUDA forward and backward on the card,
their plain versions on the CPU); else the plain einsum core
``mha_core``. Attention dropout takes its uint32 seed from the step's
random stream (``ctx.rng``: a generator it draws from, or a step
program's seeds, device tensors under CUDA-graph capture) and masks
through the flash path's counter hash on both routes, so one seed gives
one mask whichever route runs.

Serving (``ctx.serving``): prefill runs the plain causal core and hands the
prompt's k/v rows to the engine; decode writes one token per slot into the
paged pool and reads it through the flash-decode kernel
(``kernels/flash_decode.py``), or under ``seq_shards`` > 1 through its
segment mode, one launch a key segment, merged by
``kernels/seqpar_decode.combine_partials``; chunk prefill writes a chunk's
rows into one slot's blocks and attends over the slot's gathered extent.
The ring layout (``block_tables`` None) writes the token at each slot's
cursor and reads the whole ring under the position mask, plain tensor
code as in the JAX package, where the ring runs no Pallas kernel either.
Under ``kv_dtype="int8"`` every write quantizes its rows per (token, head)
and stores the scales beside them; decode reads through the kernel's int8
branch, the exact and chunk paths dequantize the gathered rows to the
compute dtype.
"""
from __future__ import annotations

import numpy as np

from ..execution.graphs import next_seed
from ..ffconst import OperatorType
from .base import Op, OpContext, register_op

NEG_INF = -1e30


def mha_core(q, k, v, *, causal: bool = False, dropout: float = 0.0,
             seed=None, attn_mask=None, scale: float = None, shard=None):
    """q,k,v: (batch, heads, seq, head_dim) -> (batch, heads, seq_q, vd) in
    v's dtype; scores, softmax and the PV sum in fp32. ``attn_mask`` is a
    bool mask (True attends) or an additive one, broadcastable to
    (b, h, seq_q, seq_k). ``dropout`` > 0 needs a ``seed`` (an int or a
    0-d integer tensor) and multiplies the probabilities by the
    counter-hash mask of that seed, at the global coordinates of ``shard``
    (``kernels.flash_attention.global_bh``) when q/k/v are a rank's slice
    of the batch and heads."""
    import torch

    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / np.sqrt(head_dim)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, NEG_INF)
        else:
            logits = logits + attn_mask.float()
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=logits.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout > 0.0:
        probs = probs * _dropout_mask(seed, probs.shape, dropout,
                                      probs.device, shard)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _dropout_mask(seed, shape, rate: float, device, shard=None):
    """The (b, h, sq, sk) keep-scale mask of the flash kernels' counter
    hash at GLOBAL coordinates."""
    import torch

    from ..kernels.flash_attention import (dropout_keep_scale_plain,
                                           global_bh, seq_offsets)

    b, h, sq, sk = shape
    bh = global_bh(b, h, shard, device)
    qo, ko = seq_offsets(shard)
    qp = torch.arange(sq, device=device).view(1, 1, sq, 1) + qo
    kp = torch.arange(sk, device=device).view(1, 1, 1, sk) + ko
    return dropout_keep_scale_plain(seed, bh, qp, kp, rate)


@register_op(OperatorType.OP_MULTIHEAD_ATTENTION)
class MultiHeadAttentionOp(Op):
    """attrs: embed_dim, num_heads, kdim, vdim, dropout, bias, add_bias_kv,
    add_zero_attn, causal, use_flash ("auto", True or False; set on the
    layer's attrs, as in the JAX package) (builder:
    FFModel.multihead_attention).

    inputs: (query, key, value), each (batch, seq, dim).
    output: (batch, seq_q, embed_dim).

    On a mesh (``ctx.shard`` in mode "heads", the hybrid strategy's
    attribute parallelism) ``wq``/``wk``/``wv`` hold this rank's heads and
    ``wo`` their rows: q, k and v are projected for the local heads only,
    the flash kernels run on them, and the output projection's partial sum
    is all-reduced over the model axis before ``bo``, in fp32 as is the
    inputs' grad of the q/k/v projections (``ShardInfo.row_matmul`` /
    ``column_matmuls``). Under a ``sequence_parallel_axis`` the op takes
    and returns its rank's block of positions, the projections are
    per-token and the core is the ring or Ulysses schedule over the
    axis. Dropout hashes the global (batch, head, position) coordinates,
    so every rank draws its slice of the single-device mask.
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

    def flops(self, input_shapes, output_shapes):
        """The projections and the attention core at the full sequence
        (a causal mask is not discounted), as the JAX op counts them."""
        b, sq, _ = input_shapes[0]
        sk = input_shapes[1][1]
        embed, heads, kdim, vdim = self._dims()
        proj = 2 * b * sq * input_shapes[0][-1] * heads * kdim * 3 \
            + 2 * b * sq * heads * vdim * embed
        core = 2 * b * heads * sq * sk * (kdim + vdim)
        return proj + core

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        q_in, k_in, v_in = inputs
        tp = ctx.shard if ctx.shard is not None and \
            ctx.shard.mode == "heads" and ctx.shard.split else None
        if tp is None:
            q = torch.einsum("bsd,dhk->bhsk", q_in, params["wq"])
            k = torch.einsum("bsd,dhk->bhsk", k_in, params["wk"])
            v = torch.einsum("bsd,dhk->bhsk", v_in, params["wv"])
        else:
            q, k, v = _local_head_projections(tp, inputs, params)
        causal = self.attrs.get("causal", False)
        if ctx.serving is not None:
            out = _serving_attention(self.name, q, k, v, ctx.serving,
                                     causal=causal)
        else:
            out = _attention_core(self.attrs, q, k, v, ctx, causal)
        # in the compute dtype: cuBLAS sums bf16 products in fp32 and rounds
        # once, as the JAX op's preferred_element_type=float32 + astype
        wo = params["wo"]
        if tp is None:
            y = torch.einsum("bhsv,hvd->bsd", out.to(wo.dtype), wo)
        else:  # row-parallel wo: the local heads' partial, summed in fp32
            b, h, s, dv = out.shape
            y = tp.row_matmul(
                out.to(wo.dtype).transpose(1, 2).reshape(b, s, h * dv),
                wo.reshape(h * dv, wo.shape[-1]))
        y = y.to(q_in.dtype)
        if "bo" in params:
            y = y + params["bo"]
        return [y]


def _local_head_projections(tp, inputs, params):
    """q, k and v (batch, local heads, seq, dim) of ``inputs`` under a
    model axis: one ``column_matmuls`` for each distinct input tensor (a
    self-attention's q, k and v share one), so the input's grad is one
    fp32 all-reduce."""
    ws = [params[w] for w in ("wq", "wk", "wv")]
    out = [None] * 3
    for i, x in enumerate(inputs):
        if out[i] is not None:
            continue
        idx = [j for j in range(3) if inputs[j] is x]
        ys = tp.column_matmuls(x, [ws[j].reshape(ws[j].shape[0], -1)
                                   for j in idx])
        for j, y in zip(idx, ys):
            out[j] = y.view(*y.shape[:-1], ws[j].shape[1],
                            ws[j].shape[2]).transpose(1, 2)
    return out


def _serving_attention(name: str, q, k, v, sv, *, causal: bool):
    """Prefill / decode / chunk attention over the paged KV pool or the
    ring (``serving/kvcache.py``). q/k/v are (batch, heads, seq, dim)."""
    import torch

    from ..serving.kvcache import (quantize_kv, write_token_kv,
                                   write_token_kv_paged,
                                   write_token_scale_paged)

    if not causal:
        raise ValueError(
            f"{name}: serving prefill/decode requires CAUSAL self-attention "
            "(bidirectional attention cannot be decoded incrementally); "
            "build the model with causal=True")
    if sv.mode == "chunk":
        return _chunk_prefill_attention(name, q, k, v, sv)
    if sv.mode == "prefill":
        # the prompt's rows; the engine scatters them into the slot's
        # blocks (serving/kvcache.scatter_prefill_paged), quantizing them
        # for an int8 pool
        sv.cache_out[name] = (k, v)
        return mha_core(q, k, v, causal=True)
    scale = 1.0 / np.sqrt(q.shape[-1])
    if sv.block_tables is None:
        # the ring (flexflow_tpu/ops/attention.py:259-288): the write at
        # each slot's cursor, then the masked read over the whole ring,
        # the paged exact path's arithmetic on the same extent
        kc, vc = sv.cache_in[name]
        write_token_kv(kc, k, sv.positions)
        write_token_kv(vc, v, sv.positions)
        sv.cache_out[name] = (kc, vc)
        kpos = torch.arange(kc.shape[2], device=q.device)
        mask = kpos[None, None, None, :] <= sv.positions.long()[
            :, None, None, None]
        return _masked_core(q, kc, vc, mask, scale)
    tables, bs = sv.block_tables, sv.block_size
    entry = sv.cache_in[name]
    if sv.kv_dtype == "int8":
        kq, ks, vq, vs = entry
        for pool, scales, new in ((kq, ks, k), (vq, vs, v)):
            rows, row_scales = quantize_kv(new)   # scales (S, h, 1)
            write_token_kv_paged(pool, rows, sv.positions, tables, bs)
            write_token_scale_paged(scales, row_scales, sv.positions,
                                    tables, bs)
    else:
        for pool, new in zip(entry, (k, v)):
            write_token_kv_paged(pool, new, sv.positions, tables, bs)
    sv.cache_out[name] = entry
    if sv.seq_shards > 1:
        return _seqpar_decode(q, entry, tables, sv, scale, k.dtype)
    out = _maybe_flash_decode(q, entry, tables, sv, scale)
    if out is not None:
        return out
    kc, vc = _gathered_kv(entry, tables, sv.kv_dtype, k.dtype)
    kpos = torch.arange(kc.shape[2], device=q.device)
    mask = kpos[None, None, None, :] <= sv.positions.long()[:, None, None,
                                                            None]
    return _masked_core(q, kc, vc, mask, scale)


def _seqpar_decode(q, entry, tables, sv, scale: float, dtype):
    """Sequence-parallel decode (flexflow_tpu/ops/attention.py:291-348):
    each slot's extent is scored as ``sv.seq_shards`` contiguous key
    segments of ``mb / seq_shards`` table columns each, on the rank's own
    heads.

    ``exact`` keeps the bitwise contract against the single-segment exact
    path: each segment is scored by a full-extent product whose keys
    outside the segment are zero, so its columns come from the same
    kernel at the same shape as that path's (the key axis is never
    reduced by the score product; the JAX package pads q to the extent
    for the same reason), and their concatenation in position order
    feeds the one masked softmax and PV sum. The fast path takes each
    segment's online-softmax partial ``(m, l, acc)`` from the flash-decode
    kernel's segment mode (its plain version on the CPU) and merges them
    with ``seqpar_decode.combine_partials``; a segment above a slot's
    cursor weighs exactly 0."""
    import torch

    from ..kernels.flash_decode import flash_decode_segment
    from ..kernels.seqpar_decode import (MASK_NEG, combine_partials,
                                         shard_segment)

    S = int(sv.seq_shards)
    mb = tables.shape[1]
    shard_segment(mb * sv.block_size, S)
    if mb % S:
        raise ValueError(
            f"seq_shards={S} does not split the {mb}-column block table "
            "into whole blocks (FF006: max_blocks_per_slot must be "
            "divisible by seq_shards)")
    cols = mb // S
    if sv.exact:
        kc, vc = _gathered_kv(entry, tables, sv.kv_dtype, dtype)
        seg = shard_segment(kc.shape[2], S)
        cols = []
        for s in range(S):
            lo, hi = s * seg, (s + 1) * seg
            kseg = torch.zeros_like(kc, dtype=torch.float32)
            kseg[:, :, lo:hi] = kc[:, :, lo:hi].float()
            cols.append((torch.einsum("bhqd,bhkd->bhqk", q.float(), kseg)
                         * scale)[..., lo:hi])
        logits = torch.cat(cols, dim=-1)
        kpos = torch.arange(kc.shape[2], device=q.device)
        mask = kpos[None, None, None, :] <= sv.positions.long()[
            :, None, None, None]
        logits = logits.masked_fill(~mask, MASK_NEG)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vc.dtype).float(),
                           vc.float())
        return out.to(vc.dtype)
    n_keys = (sv.positions + 1).to(tables.dtype)
    qr = q[:, :, 0, :].contiguous()
    if sv.kv_dtype == "int8":
        kq, ks, vq, vs = entry
        pools, scales = (kq, vq), dict(kscale=ks, vscale=vs)
    else:
        pools, scales = tuple(entry), {}
    partials = [flash_decode_segment(qr, *pools, tables, n_keys,
                                     s * cols, (s + 1) * cols,
                                     sm_scale=scale, **scales)
                for s in range(S)]
    return combine_partials(partials).to(dtype)


def _gathered_kv(entry, tables, kv_dtype: str, dtype):
    """Every slot's K and V extent in position order, ``(S, h, mb * bs,
    d)``: the stored rows, or for int8 the rows dequantized to ``dtype``
    (the compute dtype), as the JAX op reads them off the kernel path."""
    from ..serving.kvcache import (dequantize_kv, gather_paged_kv,
                                   gather_paged_scales)

    if kv_dtype == "int8":
        kq, ks, vq, vs = entry
        return (dequantize_kv(gather_paged_kv(kq, tables),
                              gather_paged_scales(ks, tables), dtype),
                dequantize_kv(gather_paged_kv(vq, tables),
                              gather_paged_scales(vs, tables), dtype))
    kp, vp = entry
    return gather_paged_kv(kp, tables), gather_paged_kv(vp, tables)


def _masked_core(q, kc, vc, mask, scale: float):
    """Scores in fp32 under a bool ``mask`` (True attends), softmax, and
    the PV sum with the probabilities rounded to the cache dtype first."""
    import torch

    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kc.float()) * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(vc.dtype).float(),
                       vc.float())
    return out.to(vc.dtype)


def _chunk_prefill_attention(name: str, q, k, v, sv):
    """One prefill CHUNK of a single slot (batch 1): q/k/v carry
    ``chunk_len`` tokens starting at ``sv.positions[0]``, of which the first
    ``sv.lengths[0]`` are real. The real rows are written into the slot's
    pool blocks (pad rows into the garbage block; int8 pools take them
    quantized, with their scales) and every row attends to the slot's
    gathered extent — the cached prefix and earlier chunks plus this chunk
    — under ``key_pos <= row_pos``."""
    import torch

    from ..serving.kvcache import (quantize_kv, write_chunk_kv_paged,
                                   write_chunk_scale_paged)

    tables, bs = sv.block_tables, sv.block_size  # tables: (1, mb)
    row = tables[0]
    chunk_len = q.shape[2]
    pos = sv.positions[0].long() + torch.arange(chunk_len, device=q.device)
    valid = torch.arange(chunk_len, device=q.device) < sv.lengths[0]
    entry = sv.cache_in[name]
    if sv.kv_dtype == "int8":
        kq, ks, vq, vs = entry
        for pool, scales, new in ((kq, ks, k), (vq, vs, v)):
            rows, row_scales = quantize_kv(new)   # scales (1, h, C)
            write_chunk_kv_paged(pool, rows, pos, valid, row, bs)
            write_chunk_scale_paged(scales, row_scales, pos, valid, row, bs)
    else:
        for pool, new in zip(entry, (k, v)):
            write_chunk_kv_paged(pool, new, pos, valid, row, bs)
    sv.cache_out[name] = entry
    kc, vc = _gathered_kv(entry, tables, sv.kv_dtype, k.dtype)
    kpos = torch.arange(kc.shape[2], device=q.device)
    mask = kpos[None, None, None, :] <= pos[None, None, :, None]
    return _masked_core(q, kc, vc, mask, 1.0 / np.sqrt(q.shape[-1]))


def _maybe_flash_decode(q, entry, tables, sv, sm_scale):
    """Route one paged decode read through the flash-decode kernel — the
    default (non-exact) path, as ``jax`` routes it to the Pallas kernel on
    a TPU; int8 pools go through its int8 branch with their scales.
    Returns the (S, h, 1, vd) output, or None for the exact gather path.
    The wrapper launches the CUDA kernel for CUDA tensors and runs its
    plain version for CPU tensors."""
    from ..kernels.flash_decode import flash_decode

    if sv.exact:
        return None
    n_keys = (sv.positions + 1).to(tables.dtype)
    qr = q[:, :, 0, :].contiguous()
    if sv.kv_dtype == "int8":
        kq, ks, vq, vs = entry
        out = flash_decode(qr, kq, vq, tables, n_keys, sm_scale=sm_scale,
                           kscale=ks, vscale=vs)
    else:
        kp, vp = entry
        out = flash_decode(qr, kp, vp, tables, n_keys, sm_scale=sm_scale)
    return out[:, :, None, :]


def _attention_core(attrs, q, k, v, ctx: OpContext, causal: bool):
    """Whole-sequence attention of MultiHeadAttentionOp: ring or Ulysses
    attention over a sequence axis of the mesh, else the flash kernels
    where ``_should_use_flash`` and the block table allow, else the einsum
    core (flexflow_tpu/ops/attention.py:111-147)."""
    live = _resolve_live_dropout(attrs.get("dropout", 0.0), ctx)
    seed = next_seed(ctx.rng) if live else None
    shard = _hash_shard(ctx, q, attrs["num_heads"])
    sg = _sequence_group(attrs, ctx)
    if sg is not None:
        if attrs.get("sequence_parallel_mode") == "alltoall":
            from ..kernels.ulysses_attention import ulysses_attention

            return ulysses_attention(
                q, k, v, sg, causal, dropout=live, seed=seed, shard=shard,
                seq_axis=attrs["sequence_parallel_axis"])
        from ..kernels.ring_attention import ring_attention

        return ring_attention(q, k, v, sg, causal, dropout=live, seed=seed,
                              shard=shard)
    blocks = _flash_blocks(q.shape[-2], k.shape[-2])
    if _should_use_flash(attrs.get("use_flash", "auto"), q, k, causal) \
            and blocks is not None:
        from ..kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal, *blocks, dropout=live,
                               seed=seed, shard=shard)
    return mha_core(q, k, v, causal=causal, dropout=live, seed=seed,
                    shard=shard)


def _hash_shard(ctx, q, heads: int):
    """(batch offset, head offset, global heads) of this rank's (b, h)
    block of q on a mesh, for the dropout hash; None off a mesh. The
    sequence offsets are the ring's and Ulysses' own."""
    if ctx.shard is None:
        return None
    b_off = ctx.shard.in_offsets(0)[0]
    h_off = ctx.shard.axis_offset(q.shape[1]) \
        if ctx.shard.mode == "heads" else 0
    return (b_off, h_off, heads)


def _sequence_group(attrs, ctx):
    """The ``SeqGroup`` of the strategy's ``sequence_parallel_axis`` on
    the mesh the op runs on, or None (no such axis, or off a mesh: the
    JAX op's condition, flexflow_tpu/ops/attention.py:120)."""
    axis = attrs.get("sequence_parallel_axis")
    if not axis or ctx.shard is None or \
            axis not in ctx.shard.mesh.axis_names:
        return None
    from ..kernels.ring_attention import SeqGroup

    mesh = ctx.shard.mesh
    i = mesh.axis_names.index(axis)
    return SeqGroup.of(mesh.groups[i], mesh.sizes[i], mesh.coords[i])


def _resolve_live_dropout(dropout, ctx) -> float:
    """Effective dropout rate for this forward. A training context that
    asks for dropout but carries no generator would train without dropout
    on every path: say so loudly, as the JAX op does."""
    if not dropout or not ctx.training:
        return 0.0
    if ctx.rng is None:
        import warnings

        warnings.warn(
            f"attention dropout={dropout} requested with training=True but "
            "the step context has no rng — training WITHOUT dropout. Thread "
            "a torch.Generator through OpContext.rng (fit and "
            "make_train_step do this).", stacklevel=3)
        return 0.0
    return float(dropout)


# The port's flash tile row (the JAX package keys its rows by TPU
# generation; no TPU row applies here). The CUDA kernels tile in 64 rows
# (kernels/csrc/flash_attention.cu), so the caps only steer the plain
# versions' summation blocks and the divisibility gate; ``min_block`` 128
# is the JAX gate's 128-multiple rule, as the flash/einsum crossover on the
# H100 is not measured yet (PERF.md, open questions).
FLASH_TUNING = {"block_q_cap": 128, "block_k_cap": 128, "min_block": 128}


def _flash_blocks(seq_q: int, seq_k: int):
    """(block_q, block_k) for the flash kernels, or None when a sequence
    has no 128-multiple divisor under the cap (the einsum core runs)."""
    def pick(seq, cap):
        for b in (cap, 512, 384, 256, 128):
            if b <= cap and seq % b == 0:
                return b
        return None

    bq = pick(seq_q, FLASH_TUNING["block_q_cap"])
    bk = pick(seq_k, FLASH_TUNING["block_k_cap"])
    if bq is None or bk is None:
        return None
    return bq, bk


def _should_use_flash(use_flash, q, k, causal) -> bool:
    """``True`` forces the flash function (its plain version on CPU
    tensors, as JAX forces interpret mode off-TPU); ``"auto"`` takes it on
    CUDA tensors under the JAX gate (head_dim % 64 == 0, blocks of at least
    ``min_block``) narrowed to the head dims the kernels are built for, and
    never on the CPU (the JAX package's off-TPU default)."""
    from ..kernels.flash_attention import KERNEL_HEAD_DIMS

    if causal and q.shape[-2] > k.shape[-2]:
        return False  # empty attention windows: einsum core only
    if use_flash is True:
        return True
    if use_flash == "auto":
        if q.device.type != "cuda" or q.shape[-1] not in KERNEL_HEAD_DIMS:
            return False
        blocks = _flash_blocks(q.shape[-2], k.shape[-2])
        return blocks is not None and \
            min(blocks) >= FLASH_TUNING["min_block"]
    return False


@register_op(OperatorType.OP_SDPA)
class SDPAOp(Op):
    """Scaled-dot-product attention core without projections (torch
    ``F.scaled_dot_product_attention``'s signature; the port never calls
    it).

    inputs: (q, k, v[, attn_mask]), q/k/v (batch, heads, seq, hd).
    attrs: dropout, causal, scale (None = 1/sqrt(head_dim)), use_flash.
    """

    def infer_output_shapes(self, input_shapes):
        q, _k, v = input_shapes[:3]
        return [tuple(q[:-1]) + (v[-1],)]

    def flops(self, input_shapes, output_shapes):
        """Scores and values at the full sequence, as the JAX op counts
        them (flexflow_tpu/ops/attention.py:653)."""
        b, h, sq, d = input_shapes[0]
        sk = input_shapes[1][2]
        vd = input_shapes[2][3]
        return 2 * b * h * sq * sk * (d + vd)

    def forward(self, params, inputs, ctx: OpContext):
        q, k, v = inputs[:3]
        mask = inputs[3] if len(inputs) > 3 else None
        causal = self.attrs.get("causal", False)
        live = _resolve_live_dropout(self.attrs.get("dropout", 0.0), ctx)
        seed = next_seed(ctx.rng) if live else None
        shard = _hash_shard(ctx, q, q.shape[1])
        blocks = _flash_blocks(q.shape[-2], k.shape[-2])
        # the flash kernels take no mask and no scale
        if mask is None and self.attrs.get("scale") is None \
                and _should_use_flash(self.attrs.get("use_flash", "auto"),
                                      q, k, causal) \
                and blocks is not None:
            from ..kernels.flash_attention import flash_attention

            return [flash_attention(q, k, v, causal, *blocks, dropout=live,
                                    seed=seed, shard=shard)]
        return [mha_core(q, k, v, causal=causal, dropout=live, seed=seed,
                         attn_mask=mask, scale=self.attrs.get("scale"),
                         shard=shard)]
