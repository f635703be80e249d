"""Mixture-of-Experts building blocks: GroupBy, Experts, Aggregate,
AggregateSpec, and the Cache op they pair with (port of ``flexflow_tpu.ops.moe_ops``; reference:
src/ops/group_by.cc, aggregate.cc, aggregate_spec.cc, moe.cc).

The dispatch is the JAX package's fixed-capacity scatter/gather, term for
term: capacity ``ceil(k * batch * alpha / n)``; a token's slot is its rank
among the same expert's tokens in the scan order of ``assign.reshape(-1)``
(the inputs repeated k times, row by row); a token past its expert's
capacity is dropped: its destination is clipped to the expert's last slot
and its contribution multiplied by 0. GroupBy and Aggregate recompute the
same dispatch from ``assign``. No Pallas kernel lies on this path in the
JAX package (``cumsum``, ``.at[].add`` and a gather), so the port has
none either.

Everything here is graph-capturable: no host sync, no data-dependent
shape. The one-hot is a comparison with ``arange(n)``, drops are masks
multiplied in, and the scatter is ``index_add`` into a fixed
``(n * capacity, d)`` buffer. ``index_add`` on CUDA accumulates with
atomics in no fixed order, yet the result is exact and repeatable: every
kept slot receives exactly one non-zero contribution (kept tokens have
distinct slots), and a dropped token adds an exact zero to the slot it is
clipped to. The backward of the gather (an ``index_add`` of the same
indices) is exact for the same reason.

``CacheOp`` keeps an intermediate tensor across steps for the dynamic
recompile (``execution/recompile.py``): the train step reads its cached
value and the ``__use_cache__`` flag from static buffers the host writes
in place, so a captured step replays them without a recapture.
"""
from __future__ import annotations

import numpy as np

from ..ffconst import ActiMode, OperatorType
from .base import Op, OpContext, register_op
from .linear import apply_activation


def moe_capacity(k: int, batch: int, alpha: float, n: int) -> int:
    return int(np.ceil(k * batch * alpha / n))


def _onehot(assign_flat, n: int):
    """(t,) ints in [0, n) -> (t, n) int32 one-hot, without a host sync."""
    import torch

    experts = torch.arange(n, dtype=assign_flat.dtype,
                           device=assign_flat.device)
    return (assign_flat[:, None] == experts).to(torch.int32)


def dispatch_indices(assign_flat, n: int, capacity: int):
    """assign_flat: (t,) int in [0, n) -> (dest (t,) int64, keep (t,)
    bool). ``dest`` is the flat slot ``expert * capacity + position``;
    ``keep`` is False for a token past its expert's capacity. Position is
    the token's rank among same-expert tokens in scan order (JAX's
    ``cumsum`` of the one-hot, flexflow_tpu/ops/moe_ops.py:38-55)."""
    import torch

    assign_flat = assign_flat.long()
    pos_all = torch.cumsum(_onehot(assign_flat, n), dim=0) - 1  # (t, n)
    pos = torch.gather(pos_all, 1, assign_flat[:, None])[:, 0]
    keep = pos < capacity
    dest = assign_flat * capacity + pos.clamp(0, capacity - 1)
    return dest, keep


def dispatch_mask(assign, n: int, capacity: int):
    """assign: (t,) -> (t, n, capacity) one-hot dispatch tensor: the
    dense formulation, kept as the tests' reference for the scatter path
    (as the JAX package keeps it)."""
    import torch

    onehot = _onehot(assign.long(), n)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1  # (t, n)
    keep = (pos >= 0) & (pos < capacity)
    slot = (pos.clamp(0, capacity - 1)[..., None]
            == torch.arange(capacity, device=assign.device)).to(torch.int32)
    return slot * keep[..., None].to(torch.int32)


def _scatter_group(x_flat, assign_flat, n: int, cap: int):
    """(t, d) tokens -> (n, cap, d) expert buffers by scatter-add."""
    import torch

    d = x_flat.shape[-1]
    dest, keep = dispatch_indices(assign_flat, n, cap)
    contrib = x_flat * keep[:, None].to(x_flat.dtype)
    grouped = torch.zeros((n * cap, d), dtype=x_flat.dtype,
                          device=x_flat.device).index_add(0, dest, contrib)
    return grouped.view(n, cap, d)


@register_op(OperatorType.OP_GROUP_BY)
class GroupByOp(Op):
    """attrs: n (experts), alpha (capacity factor), stacked (one (n, cap,
    d) output for the batched Experts op instead of n (cap, d) ones).

    inputs: (input (batch, d), assign (batch, k) int)."""

    def _cap(self, input_shapes):
        (batch, _d), (_, k) = input_shapes
        return moe_capacity(k, batch, self.attrs.get("alpha", 1.0),
                            self.attrs["n"])

    def infer_output_shapes(self, input_shapes):
        d = input_shapes[0][1]
        n = self.attrs["n"]
        cap = self._cap(input_shapes)
        if self.attrs.get("stacked"):
            return [(n, cap, d)]
        return [(cap, d)] * n

    def forward(self, params, inputs, ctx: OpContext):
        x, assign = inputs
        n = self.attrs["n"]
        k = assign.shape[1]
        cap = self._cap([tuple(x.shape), tuple(assign.shape)])
        # token order matches assign.reshape(-1): each row k times
        grouped = _scatter_group(x.repeat_interleave(k, dim=0),
                                 assign.reshape(-1), n, cap)
        if self.attrs.get("stacked"):
            return [grouped]
        return [grouped[e] for e in range(n)]


@register_op(OperatorType.OP_EXPERTS)
class ExpertsOp(Op):
    """Every expert's dense layer as one batched product over a stacked
    (n, cap, d) dispatch: one (n, d_in, out_dim) kernel, an optional (n,
    out_dim) bias and a fused activation (the JAX package's ``einsum``,
    flexflow_tpu/ops/moe_ops.py:162-175; ``torch.bmm`` accumulates 16-bit
    products in fp32 and rounds once, as its ``preferred_element_type``
    and cast do).

    attrs: n, out_dim, activation, use_bias.

    On a mesh whose strategy splits the kernel's expert dim (mode
    "experts") the kernel, the bias and the dispatch hold this rank's
    experts, and the forward, unchanged, computes them."""

    def infer_output_shapes(self, input_shapes):
        n, cap, _d = input_shapes[0]
        return [(n, cap, self.attrs["out_dim"])]

    def weight_specs(self, input_shapes):
        from ..execution.initializers import (DefaultBiasInitializer,
                                              DefaultWeightInitializer)

        n, _cap, d = input_shapes[0]
        out = self.attrs["out_dim"]
        specs = {"kernel": ((n, d, out), self.data_type,
                            self.attrs.get("kernel_initializer")
                            or DefaultWeightInitializer())}
        if self.attrs.get("use_bias", True):
            specs["bias"] = ((n, out), self.data_type,
                             DefaultBiasInitializer())
        return specs

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        (x,) = inputs
        y = torch.bmm(x, params["kernel"])
        if "bias" in params:
            y = y + params["bias"][:, None, :]
        return [apply_activation(y, self.attrs.get("activation")
                                 or ActiMode.AC_MODE_NONE)]

    def flops(self, input_shapes, output_shapes):
        n, cap, d = input_shapes[0]
        return 2 * n * cap * d * self.attrs["out_dim"]


def _combine_tokens(exp_preds, gate_preds, gate_assign, n: int,
                    weighted: bool = True):
    """(n, cap, d) expert outputs -> (batch, k, d) per-assignment rows."""
    batch, k = gate_assign.shape
    _n, cap, d = exp_preds.shape
    dest, keep = dispatch_indices(gate_assign.reshape(-1), n, cap)
    gathered = exp_preds.reshape(n * cap, d)[dest]  # (t, d)
    gathered = gathered * keep[:, None].to(gathered.dtype)
    if weighted:
        gathered = gathered * gate_preds.reshape(-1)[:, None].to(
            gathered.dtype)
    return gathered.reshape(batch, k, d)


def _load_balance_aux(gate_assign, full_gate, n: int, lambda_bal: float,
                      ctx: OpContext):
    """The ``lambda_bal`` surrogate (reference: aggregate.cu's backward):
    the share of all (token, k) assignments routed to each expert times
    its mean gate probability, summed over experts, times ``lambda_bal *
    n``; appended to ``ctx.aux_losses`` in training."""
    import torch

    if not lambda_bal or not ctx.training or ctx.aux_losses is None:
        return
    load = _onehot(gate_assign.reshape(-1).long(), n).float().mean(dim=0)
    importance = full_gate.float().mean(dim=0)
    ctx.aux_losses.append(lambda_bal * n * torch.sum(load * importance))


def _expert_outputs(inputs):
    """The expert predictions of an Aggregate's inputs: one stacked (n,
    cap, d) tensor, or n (cap, d) ones stacked here."""
    import torch

    if len(inputs) == 5 and inputs[4].dim() == 3:
        return inputs[4]
    return torch.stack(list(inputs[4:]), dim=0)


@register_op(OperatorType.OP_AGGREGATE)
class AggregateOp(Op):
    """attrs: n, lambda_bal.

    inputs: (gate_preds (batch, k), gate_assign (batch, k),
    true_gate_assign (batch, k), full_gate_grads (batch, n), then n expert
    outputs (cap, d) or one stacked (n, cap, d)); output (batch, d): each
    token's kept expert rows weighted by their gate values and summed.
    The load-balance term goes to the loss through ``ctx.aux_losses``."""

    def infer_output_shapes(self, input_shapes):
        return [(input_shapes[0][0], input_shapes[4][-1])]

    def forward(self, params, inputs, ctx: OpContext):
        exp_preds = _expert_outputs(inputs)
        n = self.attrs["n"]
        rows = _combine_tokens(exp_preds, inputs[0], inputs[1], n)
        _load_balance_aux(inputs[1], inputs[3], n,
                          self.attrs.get("lambda_bal", 0.0), ctx)
        return [rows.sum(dim=1).to(exp_preds.dtype)]


@register_op(OperatorType.OP_AGG_SPEC)
class AggregateSpecOp(Op):
    """Speculative aggregation: one unweighted output row per (token,
    assignment), so the loss supervises every expert's prediction;
    ``compile`` replicates the labels k times (reference:
    aggregate_spec.cc; model.cc:2875-2877)."""

    def infer_output_shapes(self, input_shapes):
        batch, k = input_shapes[1]
        return [(batch * k, input_shapes[4][-1])]

    def forward(self, params, inputs, ctx: OpContext):
        exp_preds = _expert_outputs(inputs)
        n = self.attrs["n"]
        batch, k = inputs[1].shape
        rows = _combine_tokens(exp_preds, None, inputs[1], n,
                               weighted=False)
        _load_balance_aux(inputs[1], inputs[3], n,
                          self.attrs.get("lambda_bal", 0.0), ctx)
        return [rows.reshape(batch * k, -1).to(exp_preds.dtype)]


@register_op(OperatorType.OP_CACHE)
class CacheOp(Op):
    """Caches an intermediate tensor across iterations, re-using it while a
    user score function deems it fresh (reference: src/ops/cache.cc:291;
    flexflow_tpu/ops/moe_ops.py:282-309). The executor threads the cache
    state: forward publishes the fresh value through ``ctx.cache_out``
    (the train step returns it; ``FFModel.fit`` scores it on the host with
    ``score_fn`` and feeds the recompile trigger) and, where the step reads
    a cache, returns ``where(__use_cache__, cached, fresh)``.

    attrs: num_batches, score_fn (callable(cached, fresh) -> float)."""

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, params, inputs, ctx: OpContext):
        import torch

        fresh = inputs[0]
        if ctx.cache_out is not None:
            ctx.cache_out[self.name] = fresh
        if ctx.cache_in is not None and self.name in ctx.cache_in:
            use_cache = ctx.cache_in.get("__use_cache__")
            if use_cache is not None:
                cached = ctx.cache_in[self.name]
                return [torch.where(use_cache, cached.to(fresh.dtype),
                                    fresh)]
        return [fresh]
