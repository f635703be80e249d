"""SPMD execution of a strategy over a ``torch.distributed`` device mesh.

The JAX package runs one program over global arrays: ``NamedSharding``
carries each array's layout, ``with_sharding_constraint`` pins it, and
XLA's partitioner inserts the collectives. The port is multi-controller:
one process per GPU, each holding its local shard as a plain tensor. This
module is its partitioner, written out:

* **Placements.** A value's layout is one ``torch.distributed.tensor``
  placement per mesh dim: ``Shard(d)``, ``Replicate()`` or ``Partial()``
  (a sum still to be taken). :func:`spec_placements` turns the
  strategies' per-dim spec entries into them.
* **Collectives with their gradients.** :func:`redistribute` moves a local
  tensor from one layout to another (all-gather, local chunk, all-reduce)
  and :func:`copy_to` is Megatron's ``f`` (identity forward, all-reduce
  backward), all as autograd functions over ``torch.distributed``
  collectives, so one code path serves NCCL, gloo and the threaded test
  group. The products of the tensor-parallel dense and attention ops whose
  sums cross ranks (:func:`row_matmul`'s output, :func:`column_matmuls`'
  input grad) keep each rank's partial in fp32, sum it in fp32 and round
  once, as the one-device product does (and the JAX dot's fp32
  ``preferred_element_type``, which XLA all-reduces): a bf16 partial
  rounded before the sum drifts from the one-device run. The convention:
  the gradient of a replicated value is complete and
  the same on every rank; a param's gradient is the exception, left partial
  over the data axis and summed once for all params after the backward
  (:class:`~..execution.executor.Executor`'s flat all-reduce).
* **The plan.** :func:`plan_spmd` walks the PCG once and fixes, for every
  node, the layout each input must arrive in, the layout of each weight as
  stored and as the op computes with it, the layout of each output, the
  mode of the mesh-aware ops (column-/row-parallel dense, attention over
  local heads, vocab- or dim-sharded embedding, channel-out convolution,
  experts over the expert axis) and the mesh axes its param grads are
  partial over. The layouts depend on the graph and the strategy only, so
  the plan is static and a captured step replays its collectives.

A weight whose spec names the data axis (ZeRO-3 / FSDP) is stored split
over it (``NodePlan.fsdp``): :func:`gather_weight` all-gathers it for its
op and reduce-scatters its grad (its data-parallel sum, so it stays out
of the flat all-reduce); the op computes with the weight's model-axis
layout as if the spec named no data axis. A dim split over the data axis
together with another axis raises.

Ops outside the mesh-aware set see replicated values on every axis but
the data axis: elementwise ops keep any layout, per-sample ops run on the
local batch, and ops that mix samples (batch statistics, the MoE dispatch,
reshapes of the batch) see the whole batch. A fused region (``--fusion``
under a strategy, whose members the strategy does not pin) runs on the
local batch iff each of its sub-ops would, its weights' grads partial over
the data axis, and each sub-op reads its own global shapes. The loss reads
the final output replicated everywhere, as the JAX package's loss reads
its global array, so the loss, the metrics and ``predict``'s output are
the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..ffconst import OperatorType

Placements = Tuple[Any, ...]


# ----------------------------------------------------------------- placements
def _types():
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Shard, Replicate, Partial


def replicated(n: int) -> Placements:
    _, Replicate, _ = _types()
    return (Replicate(),) * n


def entry_axes(entry) -> Tuple[str, ...]:
    """Mesh axes named by one per-dim spec entry."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(a for a in entry if a is not None)
    return (entry,)


def spec_placements(spec, axis_names: Sequence[str]) -> Placements:
    """Per-dim spec entries (None, an axis name or a tuple of names, one per
    tensor dim) -> a placement per mesh dim: ``Shard(d)`` on the axes that
    name dim d, ``Replicate()`` elsewhere."""
    Shard, Replicate, _ = _types()
    out = [Replicate()] * len(axis_names)
    for d, e in enumerate(spec or ()):
        for a in entry_axes(e):
            if a in axis_names:
                out[list(axis_names).index(a)] = Shard(d)
    return tuple(out)


def _with(pl: Placements, i: int, p) -> Placements:
    return pl[:i] + (p,) + pl[i + 1:]


def shard_offsets(shape, pl: Placements, mesh) -> Tuple[int, ...]:
    """This rank's offset along each dim of a tensor of global ``shape``
    held in layout ``pl`` (mesh dims in order, the first one outermost,
    as :func:`redistribute` chunks)."""
    size = list(shape)
    off = [0] * len(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            size[p.dim] //= mesh.sizes[i]
            off[p.dim] += mesh.coords[i] * size[p.dim]
    return tuple(off)


def local_slice(t, pl: Placements, mesh):
    """This rank's shard of a full tensor ``t`` (a view)."""
    for i, p in enumerate(pl):
        if p.is_shard():
            n = t.shape[p.dim] // mesh.sizes[i]
            t = t.narrow(p.dim, mesh.coords[i] * n, n)
    return t


# ---------------------------------------------------------------- collectives
_FNS = None


def _gather(x, dim: int, group, n: int):
    import torch
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.movedim(0, dim)
    return out if dim == 0 else out.contiguous()


def _chunk(x, dim: int, n: int, coord: int):
    k = x.shape[dim] // n
    return x.narrow(dim, coord * k, k).contiguous()


def _reduce_scatter(g, dim: int, group, n: int):
    """This rank's chunk along ``dim`` of the sum of ``g`` over the group,
    in fp32."""
    import torch
    import torch.distributed as dist

    src = g.movedim(dim, 0).float().contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x, group):
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _mm_f32(a, b):
    """``a @ b`` (2-D, in the compute dtype) with its fp32 sums: cuBLAS's
    fp32 output on CUDA, an upcast on the CPU (exact for bf16 and fp16)."""
    import torch

    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _functions():
    import torch
    import torch.distributed as dist

    class AllReduce(torch.autograd.Function):
        """Partial -> Replicate: the sum over the group; its gradient is the
        replicated cotangent itself."""

        @staticmethod
        def forward(ctx, x, group):
            return _all_reduce(x, group)

        @staticmethod
        def backward(ctx, g):
            return g, None

    class CopyTo(torch.autograd.Function):
        """Megatron's f: identity forward, the cotangent summed over the
        group backward (a replicated value read by a computation that is
        split over the group)."""

        @staticmethod
        def forward(ctx, x, group):
            ctx.group = group
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return _all_reduce(g, ctx.group), None

    class AllGather(torch.autograd.Function):
        """Shard(dim) -> Replicate; backward keeps this rank's chunk."""

        @staticmethod
        def forward(ctx, x, dim, group, n, coord):
            ctx.cfg = (dim, n, coord)
            return _gather(x, dim, group, n)

        @staticmethod
        def backward(ctx, g):
            dim, n, coord = ctx.cfg
            return _chunk(g, dim, n, coord), None, None, None, None

    class Chunk(torch.autograd.Function):
        """Replicate -> Shard(dim): this rank's chunk; backward gathers the
        chunks' cotangents."""

        @staticmethod
        def forward(ctx, x, dim, group, n, coord):
            ctx.cfg = (dim, group, n)
            return _chunk(x, dim, n, coord)

        @staticmethod
        def backward(ctx, g):
            dim, group, n = ctx.cfg
            return _gather(g, dim, group, n), None, None, None, None

    class RowMatmul(torch.autograd.Function):
        """The row-parallel product: ``x`` split on its last dim and ``w``
        on its first over the group, the output the sum of the ranks'
        partial products, each kept in fp32, summed in fp32 and rounded
        once to ``x``'s dtype. Backward is local (the output's grad is
        replicated)."""

        @staticmethod
        def forward(ctx, x, w, group):
            ctx.save_for_backward(x, w)
            y = _mm_f32(x.reshape(-1, x.shape[-1]), w)
            dist.all_reduce(y, group=group)
            return y.to(x.dtype).view(*x.shape[:-1], w.shape[-1])

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            g2 = g.reshape(-1, g.shape[-1])
            dx = (g2 @ w.t()).view(x.shape) \
                if ctx.needs_input_grad[0] else None
            dw = x.reshape(-1, x.shape[-1]).t() @ g2 \
                if ctx.needs_input_grad[1] else None
            return dx, dw, None

    class ColumnMatmuls(torch.autograd.Function):
        """The column-parallel products ``x @ w`` for each ``w`` (a block of
        columns) of one ``x`` replicated over the group: Megatron's f
        fused into them, so the grad of ``x``, partial over the group, is
        the fp32 sum of every product's share, all-reduced in fp32 and
        rounded once."""

        @staticmethod
        def forward(ctx, x, group, *ws):
            ctx.save_for_backward(x, *ws)
            ctx.group = group
            x2 = x.reshape(-1, x.shape[-1])
            return tuple((x2 @ w).view(*x.shape[:-1], w.shape[-1])
                         for w in ws)

        @staticmethod
        def backward(ctx, *gs):
            x, *ws = ctx.saved_tensors
            x2 = x.reshape(-1, x.shape[-1])
            dx, dws = None, []
            for i, (g, w) in enumerate(zip(gs, ws)):
                g2 = g.reshape(-1, g.shape[-1])
                if ctx.needs_input_grad[0]:
                    p = _mm_f32(g2, w.t())
                    dx = p if dx is None else dx.add_(p)
                dws.append(x2.t() @ g2 if ctx.needs_input_grad[2 + i]
                           else None)
            if dx is not None:
                dist.all_reduce(dx, group=ctx.group)
                dx = dx.to(x.dtype).view(x.shape)
            return (dx, None, *dws)

    class GatherWeight(torch.autograd.Function):
        """A weight split over the data axis (ZeRO-3 / FSDP), all-gathered
        whole for its op; backward reduce-scatters its grad over the data
        axis (the grad is partial there: that scatter is its
        data-parallel sum), or keeps this rank's chunk of a grad that is
        already complete (an op that saw the whole batch). The sum runs
        in fp32; ``sink`` ((dict, key) or None) keeps the fp32 sum, which
        the executor takes for the weight's grad in place of the one
        autograd rounds to the weight's 16-bit dtype."""

        @staticmethod
        def forward(ctx, x, dim, group, n, coord, partial, sink):
            ctx.cfg = (dim, group, n, coord, partial, sink)
            return _gather(x, dim, group, n)

        @staticmethod
        def backward(ctx, g):
            dim, group, n, coord, partial, sink = ctx.cfg
            out = _reduce_scatter(g, dim, group, n) if partial else \
                _chunk(g, dim, n, coord).float()
            if sink is not None:
                sink[0][sink[1]] = out
            return out.to(g.dtype), None, None, None, None, None, None

    return (AllReduce, CopyTo, AllGather, Chunk, RowMatmul, ColumnMatmuls,
            GatherWeight)


def _fns():
    global _FNS
    if _FNS is None:
        _FNS = _functions()
    return _FNS


def redistribute(x, mesh, src: Placements, dst: Placements):
    """``x`` (this rank's local tensor in layout ``src``) in layout
    ``dst``, differentiably. Mesh dims of size 1 move nothing. Gathers run
    innermost mesh dim first and chunks outermost first, so several mesh
    dims sharding one tensor dim keep the mesh-order layout."""
    if src == dst:
        return x
    AllReduce, _, AllGather, Chunk = _fns()[:4]
    _, Replicate, _ = _types()
    cur = list(src)
    for i in reversed(range(len(cur))):
        s, d = cur[i], dst[i]
        if s == d or (not s.is_partial() and d.is_partial()):
            if s != d:
                raise ValueError(f"redistribute: {s} -> {d} is not a "
                                 "layout the executor produces")
            continue
        n = mesh.sizes[i]
        if n > 1:
            if s.is_partial():
                x = AllReduce.apply(x, mesh.groups[i])
            elif s.is_shard():
                x = AllGather.apply(x, s.dim, mesh.groups[i], n,
                                    mesh.coords[i])
        cur[i] = Replicate() if (s.is_partial() or s.is_shard()) else s
    for i in range(len(cur)):
        s, d = cur[i], dst[i]
        if s == d:
            continue
        if mesh.sizes[i] > 1:
            x = Chunk.apply(x, d.dim, mesh.groups[i], mesh.sizes[i],
                            mesh.coords[i])
        cur[i] = d
    return x


def gather_weight(w, mesh, axis: int, dim: int, partial: bool,
                  sink=None):
    """A weight stored split on ``dim`` over the mesh dim ``axis`` (the
    data axis), gathered whole over it for its op (:class:`GatherWeight`:
    its grad reduce-scattered back when ``partial``, the fp32 sum left in
    ``sink``). Issued on an axis of one rank too, as the grad sync's
    all-reduce is, so a mesh of one card runs and captures the
    collectives a mesh of several does."""
    return _fns()[6].apply(w, dim, mesh.groups[axis], mesh.sizes[axis],
                           mesh.coords[axis], partial, sink)


def copy_to(x, mesh, axes: Sequence[int]):
    """Megatron's ``f`` over the mesh dims ``axes`` of size above 1."""
    CopyTo = _fns()[1]
    for i in axes:
        if mesh.sizes[i] > 1:
            x = CopyTo.apply(x, mesh.groups[i])
    return x


def reduce_to_replicated(x, mesh, axes: Sequence[int]):
    """A value partial over ``axes`` summed into a replicated one."""
    AllReduce = _fns()[0]
    for i in axes:
        if mesh.sizes[i] > 1:
            x = AllReduce.apply(x, mesh.groups[i])
    return x


# ----------------------------------------------------------------------- plan
@dataclasses.dataclass
class NodePlan:
    """Where one node's values live (module doc). ``mode`` is the
    mesh-aware op's schedule ("plain", "col", "row", "heads", "vocab",
    "dim", "channel", "experts" or, for ops that see the
    whole batch, "global"), ``axis`` the mesh dim it is split over."""

    srcs: List[Placements]        # each input as its producer holds it
    ins: List[Placements]         # each input as the op reads it
    natural: List[Placements]     # each output as the op computes it
    outs: List[Placements]        # each output after the output spec
    stored: Dict[str, Placements]  # each weight as the executor holds it
    use: Dict[str, Placements]    # each weight as the op computes with it
    mode: str = "plain"
    axis: Optional[int] = None
    copy_axes: Tuple[int, ...] = ()
    grad_axes: Tuple[int, ...] = ()
    # weights split over the data axis as stored (ZeRO-3 / FSDP): the dim
    # it splits; the op gathers them (:func:`gather_weight`)
    fsdp: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ShardInfo:
    """What a node's op reads of the mesh while it runs (``ctx.shard``)."""

    plan: NodePlan
    mesh: Any
    in_shapes: List[Tuple[int, ...]]

    @property
    def mode(self) -> str:
        return self.plan.mode

    def reduce(self, x):
        """Sum ``x``, partial over the op's axis, into a replicated value."""
        return reduce_to_replicated(x, self.mesh, (self.plan.axis,))

    @property
    def split(self) -> bool:
        """Is the op's axis held by several ranks?"""
        return self.plan.axis is not None and \
            self.mesh.sizes[self.plan.axis] > 1

    def row_matmul(self, x, w):
        """``x @ w`` summed over the op's axis (``RowMatmul``); the plain
        product on an axis of one rank."""
        if not self.split:
            return x @ w
        return _fns()[4].apply(x, w, self.mesh.groups[self.plan.axis])

    def column_matmuls(self, x, ws):
        """``[x @ w for w in ws]`` with ``x`` replicated over the op's axis
        (``ColumnMatmuls``); the plain products on an axis of one rank."""
        if not self.split:
            return [x @ w for w in ws]
        return list(_fns()[5].apply(x, self.mesh.groups[self.plan.axis],
                                    *ws))

    def for_sub_op(self, in_shapes) -> "ShardInfo":
        """What a fused region's sub-op reads (``FusedOp.forward``): its own
        global input shapes, each batch-major one held as the region's
        first input is (a region runs on the local batch or on the whole
        one), the others whole."""
        lead = self.in_shapes[0][:1] if self.in_shapes else ()
        pl0 = self.plan.ins[0] if self.plan.ins else replicated(
            len(self.mesh.sizes))
        ins = [pl0 if tuple(s[:1]) == tuple(lead) and
               len(s) == len(self.in_shapes[0]) else
               replicated(len(self.mesh.sizes)) for s in in_shapes]
        return ShardInfo(dataclasses.replace(self.plan, ins=ins), self.mesh,
                         [tuple(s) for s in in_shapes])

    def in_offsets(self, i: int = 0) -> Tuple[int, ...]:
        """This rank's offset along each dim of input ``i``."""
        return shard_offsets(self.in_shapes[i], self.plan.ins[i], self.mesh)

    def axis_offset(self, local: int) -> int:
        """The offset of this rank's ``local``-long slice of the op's
        axis (a head, vocab or column block)."""
        return self.mesh.coords[self.plan.axis] * local

    def weight_axes(self, wname: str) -> Tuple[int, ...]:
        """Mesh dims a weight is split over as the op computes with it."""
        return tuple(i for i, p in enumerate(self.plan.use.get(wname, ()))
                     if p.is_shard())

    def grad_scale(self) -> int:
        """How many ranks' param grads are summed into one (the data axis's
        size when the op runs on a batch shard)."""
        n = 1
        for i in self.plan.grad_axes:
            n *= self.mesh.sizes[i]
        return n


# elementwise ops that keep any layout but a partial sum
_UNARY = {
    OperatorType.OP_RELU, OperatorType.OP_SIGMOID, OperatorType.OP_TANH,
    OperatorType.OP_ELU, OperatorType.OP_GELU, OperatorType.OP_EXP,
    OperatorType.OP_LOG, OperatorType.OP_SIN, OperatorType.OP_COS,
    OperatorType.OP_SQRT, OperatorType.OP_CEIL, OperatorType.OP_ROUND,
    OperatorType.OP_RSQRT, OperatorType.OP_IDENTITY, OperatorType.OP_POW,
    OperatorType.OP_SCALAR_MULTIPLY, OperatorType.OP_SCALAR_ADD,
    OperatorType.OP_SCALAR_SUB, OperatorType.OP_SCALAR_TRUE_DIV,
    OperatorType.OP_CAST, OperatorType.OP_DROPOUT,
}
_BINARY = {
    OperatorType.OP_EW_ADD, OperatorType.OP_EW_SUB, OperatorType.OP_EW_MUL,
    OperatorType.OP_EW_DIV, OperatorType.OP_EW_MAX, OperatorType.OP_EW_MIN,
}
# ops that treat every sample alone (the batch may be a shard)
_PER_SAMPLE = {
    OperatorType.OP_POOL2D, OperatorType.OP_FLAT, OperatorType.OP_TOPK,
    OperatorType.OP_BATCHMATMUL, OperatorType.OP_SDPA, OperatorType.OP_NOOP,
    OperatorType.OP_LINEAR, OperatorType.OP_MULTIHEAD_ATTENTION,
    OperatorType.OP_EMBEDDING, OperatorType.OP_CONV2D,
}
# the search's resharding nodes (parallel/parallel_op.py): nothing inserts
# them before the search (ROADMAP A.6), which brings their target layouts;
# until then they pass any layout through, as the unary ops do
_PARALLEL = {
    OperatorType.OP_REPARTITION, OperatorType.OP_COMBINE,
    OperatorType.OP_REPLICATE, OperatorType.OP_REDUCTION,
    OperatorType.OP_FUSED_PARALLEL, OperatorType.OP_ALLTOALL,
}


def _per_sample(node, in_shapes) -> bool:
    """Does the op keep samples apart along dim 0 (so it may run on the
    local batch)? A fused region does iff each of its sub-ops does (an
    elementwise sub-op among them too)."""
    t, a = node.op.op_type, node.op.attrs
    nd = len(in_shapes[0]) if in_shapes else 0
    if t in _PER_SAMPLE:
        return True
    if t == OperatorType.OP_FUSED:
        return all(_sub_per_sample(sub, ins)
                   for sub, ins, _outs in node.op.sub_op_shapes(in_shapes))
    if t in (OperatorType.OP_LAYERNORM, OperatorType.OP_RMSNORM):
        return all(x % nd != 0 for x in a.get("axes", (-1,)))
    if t == OperatorType.OP_SOFTMAX:
        return a.get("axis", -1) % nd != 0
    if t in (OperatorType.OP_REDUCE_SUM, OperatorType.OP_REDUCE_MEAN,
             OperatorType.OP_MEAN):
        return all(x % nd != 0 for x in a["axes"])
    if t in (OperatorType.OP_CONCAT, OperatorType.OP_SPLIT,
             OperatorType.OP_REVERSE):
        return a["axis"] % nd != 0
    if t == OperatorType.OP_TRANSPOSE:
        return a["perm"][0] == 0
    if t == OperatorType.OP_GATHER:
        return a["dim"] % nd != 0
    return False


def _sub_per_sample(op, in_shapes) -> bool:
    """A fused region's sub-op keeps samples apart: an elementwise op on
    batch-major inputs of one leading size, or a per-sample op."""
    t = op.op_type
    if t in _UNARY:
        return True
    if t in _BINARY:
        return len({tuple(s[:1]) for s in in_shapes}) == 1 and \
            len({len(s) for s in in_shapes}) == 1
    return _per_sample(_AsNode(op), in_shapes)


@dataclasses.dataclass
class _AsNode:
    op: Any


def _without_axis(spec, axis):
    """A spec with ``axis`` taken out of every entry."""
    out = []
    for e in spec or ():
        rest = tuple(a for a in entry_axes(e) if a != axis)
        out.append(None if not rest else rest[0] if len(rest) == 1
                   else rest)
    return tuple(out)


def _data_dims(node, specs, data_axis) -> Dict[str, int]:
    """{weight: the dim its spec splits over the data axis}; a dim that
    the data axis splits together with another axis raises, naming
    itself."""
    out = {}
    for w, spec in specs.items():
        for d, e in enumerate(spec or ()):
            axes = entry_axes(e)
            if data_axis in axes:
                if len(axes) > 1:
                    raise NotImplementedError(
                        f"{node.name}.{w}: dim {d} split over the data "
                        f"axis together with {tuple(a for a in axes if a != data_axis)} "
                        "is not ported (ROADMAP A.5 remainder); split the "
                        "data axis and a model axis on different dims")
                out[w] = d
    return out


def _axis_of(spec, d: int, names, data_axis) -> Tuple[bool, Optional[str]]:
    """(ok, axis) of entry ``d`` of a weight spec: ok is False for an
    entry the mesh-aware ops do not take (several axes, or the data
    axis)."""
    entries = tuple(spec or ())
    e = entries[d] if d < len(entries) else None
    axes = entry_axes(e)
    if not axes:
        return True, None
    if len(axes) > 1 or axes[0] == data_axis or axes[0] not in names:
        return False, None
    return True, axes[0]


def _aware_mode(node, specs, names, data_axis):
    """(mode, axis name, {wname: use spec}) of a mesh-aware op from its
    weight specs, or None when the specs call for no split it computes."""
    t = node.op.op_type

    def ax(w, d):
        return _axis_of(specs.get(w), d, names, data_axis)

    if t == OperatorType.OP_LINEAR:
        (ok0, a0), (ok1, a1) = ax("kernel", 0), ax("kernel", 1)
        if ok0 and ok1 and a0 is None and a1 is not None:
            return "col", a1, {"kernel": (None, a1), "bias": (a1,)}
        if ok0 and ok1 and a0 is not None and a1 is None:
            return "row", a0, {"kernel": (a0, None)}
    elif t == OperatorType.OP_MULTIHEAD_ATTENTION:
        heads = [ax(w, 1) for w in ("wq", "wk", "wv")] + [ax("wo", 0)]
        other = [ax(w, d) for w, d in (("wq", 0), ("wq", 2), ("wk", 0),
                                      ("wk", 2), ("wv", 0), ("wv", 2),
                                      ("wo", 1), ("wo", 2))]
        names_h = {a for ok, a in heads}
        if all(ok for ok, _ in heads + other) and len(names_h) == 1 and \
                None not in names_h and all(a is None for _, a in other):
            a = names_h.pop()
            return "heads", a, {"wq": (None, a), "wk": (None, a),
                                "wv": (None, a), "wo": (a,)}
    elif t == OperatorType.OP_EMBEDDING:
        (ok0, a0), (ok1, a1) = ax("weight", 0), ax("weight", 1)
        if ok0 and ok1 and a0 is not None and a1 is None:
            return "vocab", a0, {"weight": (a0, None)}
        if ok0 and ok1 and a0 is None and a1 is not None:
            return "dim", a1, {"weight": (None, a1)}
    elif t == OperatorType.OP_CONV2D:
        got = [ax("kernel", d) for d in range(4)]
        if all(ok for ok, _ in got) and all(a is None for _, a in got[:3]) \
                and got[3][1] is not None:
            a = got[3][1]
            return "channel", a, {"kernel": (None, None, None, a),
                                  "bias": (a,)}
    elif t == OperatorType.OP_EXPERTS:
        got = [ax("kernel", d) for d in range(3)]
        if all(ok for ok, _ in got) and got[0][1] is not None and \
                all(a is None for _, a in got[1:]):
            a = got[0][1]
            return "experts", a, {"kernel": (a,), "bias": (a,)}
    return None


def plan_spmd(pcg, strategy, mesh, inputs_sharded: bool = True
              ) -> Dict[int, NodePlan]:
    """The static SPMD plan of ``pcg`` under ``strategy`` on ``mesh``
    (module doc). ``inputs_sharded``: the batch arrives split over the data
    axis (each rank holds its slice), else whole on every rank."""
    Shard, Replicate, _ = _types()
    names = tuple(mesh.axis_names)
    n = len(names)
    R = replicated(n)
    data_axis = strategy.data_axis if strategy.data_axis in names else None
    di = names.index(data_axis) if data_axis is not None else None
    plans: Dict[int, NodePlan] = {}
    held: Dict[Tuple[int, int], Placements] = {}

    def data_of(pl):
        return pl[di] if di is not None else None

    def on_data(pl, p):
        return _with(pl, di, p) if di is not None else pl

    for node in pcg.topo_order():
        op, t = node.op, node.op.op_type
        ns = strategy.node_strategies.get(node.guid)
        specs = dict(ns.weight_specs) if ns is not None else {}
        if ns is not None and ns.extra.get("sequence_parallel_axis"):
            from ..ops.attention import refuse_sequence_parallel

            refuse_sequence_parallel(node.name, ns.extra)
        fsdp = _data_dims(node, specs, data_axis) \
            if data_axis is not None else {}
        in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        srcs = [held[r] for r in node.inputs]
        wdecl = {} if t in (OperatorType.OP_INPUT, OperatorType.OP_WEIGHT) \
            else op.weight_specs(in_shapes)
        stored = {w: spec_placements(specs.get(w), names) for w in wdecl}
        fsdp = {w: d for w, d in fsdp.items() if w in wdecl}
        # the mesh-aware ops read the model axes of a spec; the data axis
        # of a weight is gathered before the op runs
        specs = {w: _without_axis(sp, data_axis) if w in fsdp else sp
                 for w, sp in specs.items()}
        use = {w: R for w in wdecl}
        mode, axis, copy_axes = "plain", None, ()
        nout = len(node.out_shapes)
        batch_split = di is not None and any(
            data_of(p) is not None and data_of(p).is_shard()
            and data_of(p).dim == 0 for p in srcs)
        if t == OperatorType.OP_INPUT:
            pl = on_data(R, Shard(0)) if inputs_sharded else R
            ins, natural = [], [pl]
        elif not node.inputs:
            ins, natural = [], [R] * nout
        elif t in _UNARY or t in _PARALLEL:
            # a partial sum is taken first; any other layout passes through
            src = srcs[0]
            pl = tuple(Replicate() if p.is_partial() else p for p in src)
            ins, natural = [pl], [pl] * nout
        elif t in _BINARY and len(srcs) == 2 and \
                tuple(in_shapes[0]) == tuple(in_shapes[1]) and \
                srcs[0] == srcs[1] and \
                not any(p.is_partial() for p in srcs[0]):
            ins, natural = list(srcs), [srcs[0]] * nout
        elif _per_sample(node, in_shapes) or t in _BINARY:
            aware = _aware_mode(node, specs, names, data_axis) \
                if t in (OperatorType.OP_LINEAR,
                         OperatorType.OP_MULTIHEAD_ATTENTION,
                         OperatorType.OP_EMBEDDING,
                         OperatorType.OP_CONV2D) else None
            b0 = in_shapes[0][0] if in_shapes[0] else None
            split = batch_split and _per_sample(node, in_shapes) or (
                batch_split and t in _BINARY and all(
                    len(s) == len(in_shapes[0]) and s[0] == b0
                    for s in in_shapes))
            dpl = Shard(0) if split else Replicate()

            def batch_of(s):
                return dpl if (s and s[0] == b0 and
                               len(s) == len(in_shapes[0])) else Replicate()

            ins = [on_data(R, batch_of(s)) for s in in_shapes]
            natural = [on_data(R, dpl if s and s[0] == b0 else
                               Replicate()) for s in node.out_shapes]
            if aware is not None:
                mode, axis_name, use_specs = aware
                axis = names.index(axis_name)
                for w in wdecl:
                    use[w] = spec_placements(use_specs.get(w), names)
                nd_out = len(node.out_shapes[0])
                if mode == "channel":
                    copy_axes = (axis,)
                if mode == "col":
                    natural = [_with(natural[0], axis, Shard(nd_out - 1))]
                elif mode == "row":
                    ins[0] = _with(ins[0], axis,
                                   Shard(len(in_shapes[0]) - 1))
                elif mode == "dim":
                    natural = [_with(natural[0], axis, Shard(nd_out - 1))]
                elif mode == "channel":
                    natural = [_with(natural[0], axis, Shard(1))]
        elif t == OperatorType.OP_EXPERTS and _aware_mode(
                node, specs, names, data_axis) is not None:
            mode, axis_name, use_specs = _aware_mode(node, specs, names,
                                                     data_axis)
            axis = names.index(axis_name)
            for w in wdecl:
                use[w] = spec_placements(use_specs.get(w), names)
            ins = [_with(R, axis, Shard(0))]
            natural = [_with(R, axis, Shard(0))]
        else:
            mode = "global"
            ins = [R] * len(srcs)
            natural = [R] * nout
        outs = list(natural)
        if ns is not None and ns.output_spec and nout:
            # the pinned layout on the model axes; the data axis follows
            # the batch (a whole batch on every rank stays whole)
            pinned = spec_placements(ns.output_spec, names)
            outs[0] = tuple(natural[0][i] if i == di else pinned[i]
                            for i in range(n))
        grad_axes = (di,) if (batch_split and wdecl and mode != "global"
                              and data_of(ins[0]) is not None
                              and data_of(ins[0]).is_shard()) else ()
        plans[node.guid] = NodePlan(
            srcs=srcs, ins=ins, natural=natural, outs=outs, stored=stored,
            use=use, mode=mode, axis=axis, copy_axes=copy_axes,
            grad_axes=grad_axes, fsdp=fsdp)
        for i, pl in enumerate(outs):
            held[(node.guid, i)] = pl
    return plans
