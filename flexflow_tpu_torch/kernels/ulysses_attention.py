"""All-to-all (DeepSpeed-Ulysses) sequence parallelism (port of
``flexflow_tpu/kernels/ulysses_attention.py:53-108``).

q, k and v arrive split over the sequence axis, ``(b, h, s/P, d)`` on each
of its ``P`` ranks. One ``all_to_all_single`` each re-partitions them to
``(b, h/P, s, d)``: every rank then holds the whole sequence of its head
group and runs whole-sequence ``flash_attention`` on it (the kernels' B1
forward and their backward, fused or two-pass by the JAX package's rule)
with ``shard = (batch offset, head offset of the group, heads, 0, 0)``, so
the dropout mask is the unsharded call's. The output is cast to q's dtype
and one more all-to-all carries it back to ``(b, h, s/P, d)``. The
gradient of each all-to-all is the inverse all-to-all. Four all-to-alls of
the activation volume a call, whatever P; ``heads % P != 0`` raises the
JAX package's message.

The JAX package's ``_full_attn`` materialises the ``(s, s)`` scores of a
head group; the flash kernels do not. The search's memory guard for this
schedule (``search/simulator.sequence_schedule``, scores within HBM/8)
stays the JAX rule, so both searches emit the same plans.
"""
from __future__ import annotations

from typing import Optional

from . import flash_attention as fa
from .ring_attention import SeqGroup


def _seq_to_heads(x, sg: SeqGroup):
    """(b, h, s/P, d) on each rank -> (b, h/P, s, d): head group ``rank``
    of the whole sequence."""
    import torch
    import torch.distributed as dist

    b, h, s, d = x.shape
    p = sg.size
    src = x.reshape(b, p, h // p, s, d).transpose(0, 1).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=sg.group)
    # out[j]: rank j's positions of this rank's head group
    return out.permute(1, 2, 0, 3, 4).reshape(b, h // p, p * s, d)


def _heads_to_seq(x, sg: SeqGroup):
    """The inverse of :func:`_seq_to_heads`."""
    import torch
    import torch.distributed as dist

    b, hp, s, d = x.shape
    p = sg.size
    src = x.reshape(b, hp, p, s // p, d).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=sg.group)
    # out[j]: head group j of this rank's positions
    return out.transpose(0, 1).reshape(b, p * hp, s // p, d)


_FNS = None


def _functions():
    import torch

    class SeqToHeads(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, sg):
            ctx.sg = sg
            return _seq_to_heads(x, sg)

        @staticmethod
        def backward(ctx, g):
            return _heads_to_seq(g.contiguous(), ctx.sg), None

    class HeadsToSeq(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, sg):
            ctx.sg = sg
            return _heads_to_seq(x, sg)

        @staticmethod
        def backward(ctx, g):
            return _seq_to_heads(g.contiguous(), ctx.sg), None

    return SeqToHeads, HeadsToSeq


def ulysses_attention(q, k, v, sg: SeqGroup, causal: bool = False,
                      dropout: float = 0.0, seed=None, shard=None,
                      seq_axis: Optional[str] = "seq"):
    """q, k, v (batch, heads, s/P, head_dim): this rank's block of a
    sequence split over the ``sg`` axis in rank order -> the attention
    output of its positions, differentiable. ``shard`` = (batch offset,
    head offset, global heads) of the call for the dropout hash; ``seed``
    as for ``flash_attention``; ``seq_axis`` names the axis in the error
    for heads that do not divide."""
    global _FNS
    heads = q.shape[1]
    if heads % sg.size:
        raise ValueError(f"ulysses needs heads ({heads}) divisible by "
                         f"|{seq_axis}| ({sg.size})")
    if _FNS is None:
        _FNS = _functions()
    to_heads, to_seq = _FNS
    b_off, h_off, h_all = (fa.shard_tuple(shard) or (0, 0, heads))[:3]
    h_local = heads // sg.size
    qh, kh, vh = (to_heads.apply(t.contiguous(), sg) for t in (q, k, v))
    out = fa.flash_attention(
        qh, kh, vh, causal, dropout=dropout, seed=seed,
        shard=(b_off, h_off + sg.rank * h_local, h_all, 0, 0))
    # the output leaves the kernels in q's dtype: the all-to-all moves it
    # at input width (flexflow_tpu/kernels/ulysses_attention.py:100-104)
    return to_seq.apply(out.to(q.dtype), sg)
