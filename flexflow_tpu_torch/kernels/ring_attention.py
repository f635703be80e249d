"""Ring attention: the sequence split over a mesh axis, k/v rotated round
the ranks (port of ``flexflow_tpu/kernels/ring_attention.py:62-123``).

Rank ``my`` of the axis's ``P`` ranks holds q, k and v of its ``s/P``
positions. The JAX package materialises one ``(s/P, s/P)`` score block a
step in ``jnp``; here every block runs on the flash kernels
(``kernels/flash_attention.py``), which keep the O(s) memory the schedule
exists for:

* **Forward.** Step ``i`` runs B1 on (q, the k/v block of ``src = (my - i)
  % P``) with the dropout hash's position offsets ``my * s/P`` and ``src *
  s/P`` and merges its (O_i, lse_i) into the running (O, lse) in fp32 by
  the log-sum-exp identity: the JAX (m, l, acc) recurrence of :96-112
  written with lse. The next block's ``batch_isend_irecv`` is posted
  before the current block's kernel and waited on after it (the JAX
  ``ppermute`` of :109-110 as point-to-point), so the rotation overlaps
  the kernel.
* **Causal blocks.** Step 0 is the diagonal block (``src == my``, the
  kernels' causal band at equal sizes); a block below it (``src < my``)
  runs without a mask and one above it (``src > my``) is skipped. That is
  exact: in the JAX recurrence such a block's weight ``exp(-1e30 - m)`` is
  0 once the diagonal has set ``m``.
* **Backward.** q, k, v, the merged O (in q's dtype) and the merged lse are
  saved. ``delta = rowsum(dO * O)`` comes from the merged O; then P steps
  rotate k and v again together with their fp32 dK/dV accumulators, each
  step running B3 (dK, dV of the block) and B4 (dQ) with the merged lse and
  delta, and one more rotation brings the accumulators home. The blocks
  the causal mask removes are skipped here too.
* **Dropout** keys on the global (batch, head) index of ``shard`` and the
  global positions, so the mask is the unsharded call's (the JAX code's
  ``global_bh_indices``, :79-84).

CPU tensors run the same loop with the plain flash functions; CUDA tensors
launch the kernels or raise. ``ring_attention(..., plain=True)`` runs the
plain loop on any device (the card's reference). Each block's O and each
block's dQ, dK, dV leave the kernels in q's dtype and are summed in fp32:
in bf16 that is one rounding a block more than one device's call.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import flash_attention as fa


@dataclasses.dataclass(frozen=True)
class SeqGroup:
    """The sequence axis of one rank: its process group, size, this rank's
    place on it and the global ranks of its ring neighbours."""

    group: Any
    size: int
    rank: int
    next_rank: int
    prev_rank: int

    @staticmethod
    def of(group, size: int, rank: int) -> "SeqGroup":
        """The axis of ``size`` ranks whose group is ``group``, this rank
        ``rank`` on it (group ranks; the neighbours' global ranks are
        looked up)."""
        import torch.distributed as dist

        if size == 1:
            return SeqGroup(group, 1, 0, -1, -1)
        return SeqGroup(group, size, rank,
                        dist.get_global_rank(group, (rank + 1) % size),
                        dist.get_global_rank(group, (rank - 1) % size))


def _rotate(sg: SeqGroup, sends):
    """Post the ring's next rotation: each of ``sends`` to the next rank,
    a fresh buffer of each from the previous one. Returns (works, bufs)."""
    import torch
    import torch.distributed as dist

    bufs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, sg.next_rank, sg.group) for t in sends]
    ops += [dist.P2POp(dist.irecv, b, sg.prev_rank, sg.group) for b in bufs]
    return dist.batch_isend_irecv(ops), bufs


def _wait(works) -> None:
    for w in works:
        w.wait()


def _visible(causal: bool, my: int, src: int) -> bool:
    """Does the query block ``my`` see any key of block ``src``?"""
    return not causal or src <= my


def _block_shard(shard, s_local: int, my: int, src: int):
    b_off, h_off, heads = shard[:3]
    return (b_off, h_off, heads, my * s_local, src * s_local)


def _block_fwd(q, qs, k, v, causal, dropout, seed, shard, plain):
    """One block's (O in q's dtype, lse fp32): B1 on CUDA tensors (``qs``
    is q pre-scaled), the plain forward otherwise."""
    import torch

    if plain or q.device.type == "cpu":
        return fa.flash_forward_plain(q, k, v, causal, fa.DEFAULT_BLOCK_Q,
                                      fa.DEFAULT_BLOCK_K, dropout, seed,
                                      shard)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    fa._launch_fwd(qs, k, v, out, lse, causal, dropout, seed, shard)
    return out, lse


def _block_bwd(qs, k, v, out, dor, lse, delta, causal, dropout, seed,
               shard, plain):
    """One block's (dq, dk, dv) in the inputs' dtype (dq scaled by
    1/sqrt(d)): B3 then B4 on CUDA tensors, the plain walks otherwise,
    rounded as the kernels round their outputs."""
    import torch

    if plain or qs.device.type == "cpu":
        args = (qs, k, v, dor, lse, delta, causal, fa.DEFAULT_BLOCK_Q,
                fa.DEFAULT_BLOCK_K, dropout, seed)
        dk, dv, _ = fa.flash_bwd_kv_plain(*args, shard=shard)
        dq = fa.flash_bwd_q_plain(*args, shard=shard)
        return ((dq * fa._sm_scale(qs.shape[3])).to(qs.dtype),
                dk.to(k.dtype), dv.to(v.dtype))
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), \
        torch.empty_like(qs)
    fa._launch_bwd_kv(qs, k, v, out, dor, lse, delta, dk, dv, None, causal,
                      dropout, seed, shard)
    fa._launch_bwd_q(qs, k, v, dor, lse, delta, dq, causal, dropout, seed,
                     shard)
    return dq, dk, dv


def _merge(o, lse, o_i, lse_i):
    """(O, lse) of two softmax partials over disjoint keys, in fp32."""
    import torch

    new = torch.logaddexp(lse, lse_i)
    o = o * torch.exp(lse - new)[..., None] + \
        o_i.float() * torch.exp(lse_i - new)[..., None]
    return o, new


def ring_forward(q, k, v, sg: SeqGroup, causal: bool, dropout: float,
                 seed, shard, plain: bool = False):
    """(O in q's dtype, merged lse in fp32) of this rank's queries over
    every rank's keys (module doc)."""
    s_local = q.shape[2]
    qs = None if plain or q.device.type == "cpu" else fa._prescale(q)
    kv = (k, v)
    o = lse = None
    for i in range(sg.size):
        src = (sg.rank - i) % sg.size
        works = bufs = None
        if i + 1 < sg.size:
            works, bufs = _rotate(sg, kv)
        if _visible(causal, sg.rank, src):
            o_i, lse_i = _block_fwd(
                q, qs, kv[0], kv[1], causal and src == sg.rank, dropout,
                seed, _block_shard(shard, s_local, sg.rank, src), plain)
            if o is None:
                o, lse = o_i.float(), lse_i
            else:
                o, lse = _merge(o, lse, o_i, lse_i)
        if works is not None:
            _wait(works)
            kv = tuple(bufs)
    return o.to(q.dtype), lse


def ring_backward(q, k, v, out, lse, do, sg: SeqGroup, causal: bool,
                  dropout: float, seed, shard, plain: bool = False):
    """(dq, dk, dv) of this rank's blocks (module doc)."""
    import torch

    s_local = q.shape[2]
    qs, dor, delta = fa._bwd_inputs(q, out, do, fused=False)
    dor, delta = dor.contiguous(), delta.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kv = (k, v)
    # the block's fp32 dK/dV accumulators travel with it, one step behind
    # its k and v: each rank adds its share, then sends them on while the
    # next block's kernels run; the last rotation brings each home
    acc = pending = None
    for i in range(sg.size):
        src = (sg.rank - i) % sg.size
        works = bufs = None
        if i + 1 < sg.size:
            works, bufs = _rotate(sg, kv)
        part = None
        if _visible(causal, sg.rank, src):
            dq_i, dk_i, dv_i = _block_bwd(
                qs, kv[0], kv[1], out, dor, lse, delta,
                causal and src == sg.rank, dropout, seed,
                _block_shard(shard, s_local, sg.rank, src), plain)
            dq += dq_i.float()
            part = (dk_i, dv_i)
        if pending is not None:
            _wait(pending[0])
            acc = pending[1]
        else:
            acc = [torch.zeros(k.shape, dtype=torch.float32,
                               device=k.device) for _ in range(2)]
        if part is not None:
            acc = [a + p.float() for a, p in zip(acc, part)]
        pending = _rotate(sg, acc) if sg.size > 1 else None
        if works is not None:
            _wait(works)
            kv = tuple(bufs)
    if pending is not None:
        _wait(pending[0])
        acc = pending[1]
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


_FN = None


def _function():
    import torch

    class RingAttentionFn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, sg, causal, dropout, seed, shard, plain):
            out, lse = ring_forward(q, k, v, sg, causal, dropout, seed,
                                    shard, plain)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.cfg = (sg, causal, dropout, seed, shard, plain)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = ring_backward(q, k, v, out, lse, do.contiguous(),
                                       *ctx.cfg)
            return dq, dk, dv, None, None, None, None, None, None

    return RingAttentionFn


def _coerce(q, dropout, seed, plain):
    dropout = float(dropout)
    if not 0.0 <= dropout < 1.0:
        raise ValueError(f"ring_attention dropout must be in [0, 1), got "
                         f"{dropout}")
    if dropout > 0.0 and seed is None:
        raise ValueError("ring_attention dropout requires a seed")
    if dropout == 0.0:
        return dropout, 0
    if q.device.type == "cuda" and not plain:
        # one device seed for every block's launches, forward and backward
        return dropout, fa.seed_on_device(seed, q.device)
    return dropout, fa._seed_u32(seed)


def ring_attention(q, k, v, sg: SeqGroup, causal: bool = False,
                   dropout: float = 0.0, seed=None, shard=None,
                   plain: bool = False):
    """q, k, v (batch, heads, s/P, head_dim): this rank's block of a
    sequence split over the ``sg`` axis in rank order -> the attention
    output of its queries over the whole sequence, differentiable.
    ``shard`` = (batch offset, head offset, global heads) places the
    batch and heads in the whole call for the dropout hash (the sequence
    offsets are the ring's own); ``seed`` as for ``flash_attention``.
    ``plain`` runs the plain flash functions on any device (the reference
    the kernels' ring is held against)."""
    global _FN
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} must be "
                         "the same (b, h, s/P, d) blocks")
    if q.device.type == "cuda" and not plain:
        fa._check_cuda_inputs("ring_attention", q.contiguous(),
                              k.contiguous(), v.contiguous())
    dropout, seed = _coerce(q, dropout, seed, plain)
    shard = fa.shard_tuple(shard) or (0, 0, q.shape[1], 0, 0)
    if _FN is None:
        _FN = _function()
    return _FN.apply(q.contiguous(), k.contiguous(), v.contiguous(), sg,
                     bool(causal), dropout, seed, shard, bool(plain))
