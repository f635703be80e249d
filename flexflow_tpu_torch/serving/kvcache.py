"""KV-cache state of the serving engine: the paged block pool and the ring.

Port of ``flexflow_tpu.serving.kvcache``. Paged layout (the default,
``--kv-cache paged``): each causal attention node owns one pool of
fixed-size KV blocks
``(n_blocks, heads, block_size, head_dim)`` per K and V, and every decode
slot owns one row of the ``(n_slots, max_blocks_per_slot)`` int32 block
table that maps its positions onto pool blocks. Block 0 is the reserved
GARBAGE block: unused table entries point at it, free slots write their
discarded tokens into it, and attention never reads it unmasked — its
contents only need to stay finite.

Where the JAX package returns new arrays, this port updates the pool and
the cursors IN PLACE (``index_put_``): the decode loop never copies the
pool. Free slots collide in the garbage block, which is harmless for the
same reason as above.

Quantized layout (``kv_dtype="int8"``): pool blocks hold symmetric
per-(token, head) int8 rows, with float32 scales in block-paged scale
arrays ``(n_blocks, heads, block_size)`` — scale = amax / 127 over the
head_dim row, written once with the row and folded back on read. The
quantizer is the JAX package's bit for bit (``torch.round`` rounds half to
even, as ``jnp.round``).

Ring layout (``--kv-cache ring``, the bitwise reference layout): each node
keeps per-slot buffers ``(n_slots, heads, max_len, head_dim)`` per K and V
and no block tables. A prefill's rows are inserted at position 0 of the
slot's ring with the rest zeroed (:func:`update_slot_entry`), each decode
step writes one row at the slot's cursor (:func:`write_token_kv`), and
attention reads the whole ring under the mask ``key_pos <= position``:
masked lanes weigh exact zeros, so with ``max_len`` a multiple of the
block size the ring and the paged gather give bitwise-equal logits.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

#: reserved pool block every unused block-table entry points at — written
#: by free slots, never read unmasked, must stay finite
GARBAGE_BLOCK = 0

#: supported KV-cache storage dtypes
KV_DTYPES = ("native", "int8")

INT8_QMAX = 127.0


class SeqShardsError(ValueError):
    """Sequence-parallel decode (``--seq-shards`` > 1) asked for in a mode
    that cannot honour it: the ring layout has no block tables to
    partition."""


@dataclasses.dataclass
class ServingState:
    """Per-forward serving context threaded as ``OpContext.serving``.

    mode:      "prefill" (whole padded prompt), "decode" (one token per
               slot) or "chunk" (one fixed-width prefill chunk of ONE slot,
               batch 1, written into its pool blocks)
    max_len:   per-slot capacity (``--max-decode-len``)
    positions: (batch,) int32 — the first position this call writes
               (zeros for prefill, the slot cursors for decode, the chunk's
               start for chunk mode)
    lengths:   (batch,) int32 true prompt lengths (prefill) or the chunk's
               real token count (chunk)
    cache_in:  {node_name: (kpool, vpool)} read by decode/chunk
    cache_out: {node_name: entry} every causal attention node fills:
               the prompt's (k, v) rows for prefill, the updated pools for
               decode/chunk
    exact:     True takes the plain gather path for decode attention
               instead of the flash-decode kernel (the JAX package's
               bitwise-verification mode)
    block_tables: (n_slots, max_blocks_per_slot) int32 — None selects the
               ring layout (the two layouts' decode programs are
               distinct)
    block_size: tokens per KV block
    kv_dtype:  "native" (pools in the model dtype, entries ``(kpool,
               vpool)``) or "int8" (entries ``(kq, kscale, vq, vscale)``)
    seq_shards: sequence-parallel decode width: each slot's gathered
               extent is scored as this many contiguous key segments and
               merged by the flash segment combine
               (``kernels/seqpar_decode.py``). 1 is the unsharded path.
               Paged decode only; chunk prefill writes the same rows at
               any width.
    """

    mode: str
    max_len: int
    positions: Any
    lengths: Any = None
    cache_in: Optional[Dict[str, Any]] = None
    cache_out: Dict[str, Any] = dataclasses.field(default_factory=dict)
    exact: bool = False
    block_tables: Any = None
    block_size: int = 0
    kv_dtype: str = "native"
    seq_shards: int = 1


@dataclasses.dataclass
class DecodeState:
    """The decode loop's carried state: {node_name: (kpool, vpool)} (int8:
    ``(kq, kscale, vq, vscale)``; ring: the ``(kbuf, vbuf)`` rings), the
    per-slot length cursor and the block tables (None for the ring).
    Decode steps update all of it in place."""

    caches: Dict[str, Any]
    lengths: Any  # (n_slots,) int32
    block_tables: Any = None  # (n_slots, max_blocks_per_slot) int32 | None

    @property
    def n_slots(self) -> int:
        return int(self.lengths.shape[0])


def cache_leaves(entry) -> Tuple[Any, ...]:
    """The tensors of one cache entry: a K/V entry's tuple as it is, the
    LSTM carry (one ``(batch, 2h)`` tensor) as a 1-tuple."""
    return entry if isinstance(entry, tuple) else (entry,)


def is_kv_entry(entry) -> bool:
    """Attention K/V entries are tuples of 4-D leaves (the prefill's ``(1,
    h, L, hd)`` rows, the pools, the rings): the pageable kind. Anything
    else (the LSTM carry ``(1, 2h)``) is kept slot-major."""
    return isinstance(entry, tuple) and bool(entry) and all(
        getattr(leaf, "ndim", 0) == 4 for leaf in entry)


def parse_context_buckets(spec) -> Tuple[int, ...]:
    """Normalize a ``--context-buckets`` spec ("1024,4096" or an int
    sequence) into a validated ascending tuple (copied from the JAX
    package so ``FFConfig`` fails fast on the same inputs). Empty spec ->
    no bucketing."""
    if not spec:
        return ()
    if isinstance(spec, str):
        vals = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                vals.append(int(part))
            except ValueError:
                raise ValueError(
                    f"--context-buckets: {part!r} is not an integer "
                    "(expected a comma-separated list like "
                    "'1024,4096,16384')")
    else:
        vals = [int(v) for v in spec]
    if any(v < 1 for v in vals):
        raise ValueError(
            f"--context-buckets entries must be >= 1, got {vals}")
    if vals != sorted(set(vals)):
        raise ValueError(
            "--context-buckets must be strictly ascending context "
            f"lengths, got {vals}")
    return tuple(vals)


def is_position_constant(value) -> bool:
    """Detect the position-id constant the autoregressive builders bake in
    (models/gpt2.py: ``broadcast(arange(seq_len), (b, s))``): an integer
    2-D constant whose every row is ``arange(seq)``. Serving regenerates it
    per phase."""
    v = np.asarray(value)
    if v.ndim != 2 or not np.issubdtype(v.dtype, np.integer):
        return False
    if v.shape[1] < 1:
        return False
    return bool(np.all(v == np.arange(v.shape[1], dtype=v.dtype)[None, :]))


def ring_entry(leaf, n_slots: int, max_len: int):
    """Zero ring ``(n_slots, h, max_len, hd)`` for one KV leaf whose
    per-request shape is ``(1, h, L, hd)``, in the leaf's dtype."""
    import torch

    _, h, _L, hd = leaf.shape
    return torch.zeros((n_slots, h, max_len, hd), dtype=leaf.dtype,
                       device=leaf.device)


def update_slot_entry(buf, rows, slot):
    """Insert one prefilled request's k or v rows ``(1, h, L, hd)`` into the
    ring ``buf (n_slots, h, max_len, hd)`` at ``slot`` (a (1,) device int
    tensor), in place: the rows at positions ``0..L-1`` and zeros past them,
    as the JAX ring's fresh zero buffer gives — the zeros are what the
    masked lanes of a decode read weigh."""
    padded = rows.new_zeros((1,) + tuple(buf.shape[1:]))
    padded[:, :, :rows.shape[2]] = rows
    buf.index_copy_(0, slot.long(), padded.to(buf.dtype))
    return buf


def write_token_kv(buf, new, positions):
    """Write one token's k or v ``(n_slots, h, 1, hd)`` into the ring
    ``(n_slots, h, max_len, hd)`` at each slot's position, in place (no
    arithmetic on the stored values)."""
    import torch

    slots = torch.arange(buf.shape[0], device=buf.device)
    buf[slots, :, positions.long()] = new[:, :, 0, :].to(buf.dtype)
    return buf


def blocks_per_slot(max_len: int, block_size: int) -> int:
    """Block-table width: blocks covering ``max_len`` tokens."""
    return -(-int(max_len) // int(block_size))


def kv_token_bytes(heads: int, kdim: int, vdim: int, el: int,
                   kv_dtype: str = "native") -> int:
    """KV bytes ONE token costs across one attention node's heads: int8
    stores 1-byte rows plus the two f32 per-(token, head) scales, native
    the model dtype (``el`` bytes an element)."""
    if kv_dtype == "int8":
        return heads * ((kdim + vdim) * 1 + 8)
    return heads * (kdim + vdim) * el


def quantize_kv(x) -> Tuple[Any, Any]:
    """Symmetric per-row int8 quantization over the trailing head_dim axis:
    ``q = round(x / scale)`` (half to even) with ``scale = amax(|x|) / 127``
    (scale 1 for an all-zero row, so its dequant stays exactly zero).
    Returns ``(q int8, scale f32)``, ``scale`` shaped like ``x`` minus its
    last axis."""
    import torch

    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / INT8_QMAX,
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -INT8_QMAX,
                    INT8_QMAX).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype):
    """``q * scale`` in f32, cast to ``dtype``: the read half of
    :func:`quantize_kv`."""
    return (q.float() * scale[..., None]).to(dtype)


def write_token_kv_paged(pool, new, positions, block_tables, block_size):
    """Write one token's k or v ``(n_slots, h, 1, hd)`` into the pool, in
    place, at each slot's position: block ``tables[slot, pos // bs]``,
    offset ``pos % bs``. Returns the pool."""
    import torch

    pos = positions.long()
    bi = torch.gather(block_tables.long(), 1,
                      (pos // block_size)[:, None])[:, 0]
    pool[bi, :, pos % block_size] = new[:, :, 0, :].to(pool.dtype)
    return pool


def write_token_scale_paged(scales, scale_new, positions, block_tables,
                            block_size):
    """Scale-array twin of :func:`write_token_kv_paged`, in place:
    ``scales (n_blocks, h, block_size)``, ``scale_new (n_slots, h, 1)``."""
    import torch

    pos = positions.long()
    bi = torch.gather(block_tables.long(), 1,
                      (pos // block_size)[:, None])[:, 0]
    scales[bi, :, pos % block_size] = scale_new[:, :, 0]
    return scales


def _chunk_rows(positions, valid, table_row, block_size):
    """(block, offset) of each chunk row: pad rows go to GARBAGE_BLOCK."""
    import torch

    mb = table_row.shape[0]
    pos = positions.long()
    blk = torch.clamp(pos // block_size, 0, mb - 1)
    bi = torch.where(valid, table_row.long()[blk],
                     torch.full_like(blk, GARBAGE_BLOCK))
    return bi, pos % block_size


def write_chunk_kv_paged(pool, new, positions, valid, table_row,
                         block_size):
    """Write one prefill chunk's k or v rows ``(1, h, C, hd)`` into the
    pool, in place, at ``positions`` (C,) of the slot owning ``table_row``
    (mb,). Pad rows (``valid`` False) go to the GARBAGE block."""
    bi, off = _chunk_rows(positions, valid, table_row, block_size)
    rows = new[0].transpose(0, 1)  # (h, C, hd) -> (C, h, hd)
    pool[bi, :, off] = rows.to(pool.dtype)
    return pool


def write_chunk_scale_paged(scales, scale_new, positions, valid, table_row,
                            block_size):
    """Scale-array twin of :func:`write_chunk_kv_paged`, in place:
    ``scales (n_blocks, h, bs)``, ``scale_new (1, h, C)``."""
    bi, off = _chunk_rows(positions, valid, table_row, block_size)
    scales[bi, :, off] = scale_new[0].transpose(0, 1)
    return scales


def gather_paged_kv(pool, block_tables):
    """Each slot's logical KV extent in position order:
    ``(n_blocks, h, bs, hd)`` through ``(n_slots, mb)`` tables ->
    ``(n_slots, h, mb * bs, hd)``. The exact/chunk read path."""
    g = pool[block_tables.long()]          # (S, mb, h, bs, hd)
    g = g.transpose(1, 2)                  # (S, h, mb, bs, hd)
    return g.reshape(g.shape[0], g.shape[1], -1, g.shape[-1])


def gather_paged_scales(scales, block_tables):
    """(n_blocks, h, bs) through (n_slots, mb) -> (n_slots, h, mb * bs)."""
    g = scales[block_tables.long()]        # (S, mb, h, bs)
    g = g.transpose(1, 2)                  # (S, h, mb, bs)
    return g.reshape(g.shape[0], g.shape[1], -1)


def paged_pool_entry(leaf, n_blocks: int, block_size: int,
                     kv_dtype: str = "native"):
    """Zero pool for one KV leaf whose per-request shape is
    ``(1, h, L, hd)``: the pool in the leaf's dtype for "native", ``(pool
    int8, scales f32 (n_blocks, h, block_size))`` for "int8"."""
    import torch

    _, h, _L, hd = leaf.shape
    if kv_dtype == "int8":
        return (torch.zeros((n_blocks, h, block_size, hd), dtype=torch.int8,
                            device=leaf.device),
                torch.zeros((n_blocks, h, block_size), dtype=torch.float32,
                            device=leaf.device))
    return torch.zeros((n_blocks, h, block_size, hd), dtype=leaf.dtype,
                       device=leaf.device)


def scatter_prefill_paged(pool, leaf, table_row, block_size: int,
                          scales=None):
    """Write one prefilled request's k or v rows ``(1, h, L, hd)`` into its
    table row's pool blocks, in place: rows are padded with zeros to whole
    blocks, reshaped block-major and written at ``table_row[:ceil(L/bs)]``.
    Entries past the request's allocation point at GARBAGE_BLOCK and take
    the tail rows — harmless, never read. An int8 pool takes the rows
    quantized, with their scales written into ``scales`` (the pool's scale
    array). Returns the pool, or ``(pool, scales)`` for int8."""
    import torch

    x = leaf[0]                            # (h, L, hd)
    h, L, hd = x.shape
    nb = -(-L // block_size)
    pad = nb * block_size - L
    if pad:
        x = torch.cat([x, x.new_zeros((h, pad, hd))], dim=1)
    rows = table_row[:nb].long()
    if scales is not None:
        q, s = quantize_kv(x)              # (h, P, hd), (h, P)
        pool[rows] = q.reshape(h, nb, block_size, hd).transpose(0, 1)
        scales[rows] = s.reshape(h, nb, block_size).transpose(0, 1)
        return pool, scales
    xb = x.reshape(h, nb, block_size, hd).transpose(0, 1)
    pool[rows] = xb.to(pool.dtype)
    return pool
