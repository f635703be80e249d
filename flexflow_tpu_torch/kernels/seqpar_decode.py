"""Sequence-parallel decode: per-segment flash partials and their combine
(port of ``flexflow_tpu/kernels/seqpar_decode.py``).

``--seq-shards S`` partitions a slot's gathered KV extent (``mb * bs``
positions of its block table) into ``S`` contiguous key segments. Each
segment is scored on its own into the online-softmax partial ``(m, l,
acc)`` of its keys, and one combine merges the partials:

    m*   = max_s m_s
    l*   = sum_s l_s * exp(m_s - m*)
    out  = sum_s acc_s * exp(m_s - m*) / l*

which is the flash-attention segment-merge identity, so the combined
output equals the single-segment online softmax up to reassociation. A
segment above the slot's cursor holds no key: its ``m`` is ``MASK_NEG``
and its weight ``exp(MASK_NEG - m*)`` is exactly 0.

The JAX package runs every segment on the chip that runs the decode (its
module doc: on one device the decomposition is emulated locally), and so
does the port: each rank decomposes its own heads. On CUDA the segment
partials come from the flash-decode kernel's segment mode
(``kernels/flash_decode.flash_decode_segment``), whose plain version is
:func:`decode_shard_partial` here; the combine is fp32 torch arithmetic,
as the JAX one is ``jnp``. The byte counts are the closed forms the
serving search prices the combine's traffic with.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

#: additive mask value; the decode mask's, so a segment with no key weighs
#: exactly 0 in the combine
MASK_NEG = -1e30


def shard_segment(extent: int, seq_shards: int) -> int:
    """Tokens of each of ``seq_shards`` contiguous segments of a gathered
    KV extent. FF006 checks ``max_blocks_per_slot % seq_shards == 0`` when
    the engine is built, so a decode step never raises here."""
    if seq_shards < 1:
        raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
    if extent % seq_shards:
        raise ValueError(
            f"KV extent {extent} does not split into {seq_shards} "
            "contiguous sequence shards (FF006: max_blocks_per_slot "
            "must be divisible by seq_shards)")
    return extent // seq_shards


def decode_shard_partial(q, k_seg, v_seg, mask_seg, sm_scale: float):
    """One segment's online-softmax partial: ``q`` (b, h, 1, d),
    ``k_seg``/``v_seg`` (b, h, seg, d), ``mask_seg`` (b, 1, 1, seg) bool
    (True attends). Returns fp32 ``(m, l, acc)`` of shapes (b, h, 1),
    (b, h, 1) and (b, h, 1, vd). As in the JAX function, a segment with no
    key has ``m = MASK_NEG``, ``l = seg`` and ``acc`` the sum of its
    values; the combine weighs it by 0."""
    import torch

    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k_seg.float()) * sm_scale
    logits = torch.where(mask_seg, logits,
                         torch.full_like(logits, MASK_NEG))
    m = logits.amax(dim=-1)                           # (b, h, 1)
    p = torch.exp(logits - m[..., None])              # (b, h, 1, seg)
    l = p.sum(dim=-1)                                 # noqa: E741
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v_seg.dtype).float(),
                       v_seg.float())
    return m, l, acc


def combine_partials(partials: Sequence[Tuple]):
    """Merge per-segment ``(m, l, acc)`` into the attention output (b, h,
    1, vd) in fp32, in segment order."""
    import torch

    ms: List = [m for m, _l, _a in partials]
    m_star = ms[0]
    for m in ms[1:]:
        m_star = torch.maximum(m_star, m)
    l_star = None
    out = None
    for m, l, acc in partials:
        w = torch.exp(m - m_star)          # exactly 0 for a keyless segment
        lw = l * w
        aw = acc * w[..., None]
        l_star = lw if l_star is None else l_star + lw
        out = aw if out is None else out + aw
    return out / l_star[..., None]


def combine_bytes_per_step(heads: int, vdim: int, slots: int,
                           seq_shards: int, el: int = 4) -> int:
    """Bytes each segment's owner would contribute to one decode step's
    combine for one attention node, were the segments on different chips:
    per slot and head the fp32 ``m`` and ``l`` and the ``acc`` row."""
    if seq_shards <= 1:
        return 0
    return slots * heads * (2 + vdim) * el


def query_bytes_per_step(heads: int, kdim: int, slots: int,
                         el: int) -> int:
    """Bytes of the step's query rows (slots x heads x kdim at the model's
    element size) that every segment's owner needs before it scores its
    keys."""
    return slots * heads * kdim * el
