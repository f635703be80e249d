"""Executor: runs a PCG's ops as plain PyTorch on one device.

Port of ``flexflow_tpu.execution.executor``: parameter init, the
mixed-precision cast, the graph forward with node overrides, the training
step (forward, loss, autograd over the fp32 master leaves, metrics,
optimizer update), the eval step and the inference forward, and the three
serving programs — per-bucket prefill, chunk prefill and the one-token
decode step. JAX jits the train step and the serving steps once per shape
and donates their state; here each is a :class:`~.graphs.StepProgram`:
on CUDA its body is captured once per input shape as a CUDA graph and
replayed over static buffers, while the train step, the optimizer and the
decode step update params, moments and KV pools in place where JAX
donates them. ``make_train_step(capture=False)`` and
``make_decode_step(..., capture=False)`` return the eager bodies (the
tests and ``chip_smoke.py`` compare the two); ``invalidate_jit_cache``
drops every captured program. Prefill is one program per bucket, chunk
prefill one per chunk shape; eval and predict run eagerly (under
``torch.inference_mode()``). ``make_train_step(guard=True)`` is the
divergence sentinel's step (a second program that also returns ``ok``),
and the training forward follows the ``--remat`` plan
(``execution/remat.py``, :meth:`Executor._forward_remat`). A graph with
CacheOps threads their state through the train step (:meth:`init_cache`).
While a ``torch.profiler`` runs, each node runs inside a
``record_function`` range named after it (the JAX package's per-node
``jax.named_scope``).

Under a strategy (``strategy=`` and ``mesh=``, the multi-controller mesh
path) the executor runs this rank's part of the SPMD program
(``parallel/spmd.py``): params and optimizer state are local shards
(:meth:`init_params` draws the full weights from the seed and keeps its
shard, so every strategy starts from the one-device weights), each node
runs on its inputs redistributed to the layout its plan asks for, and
the final output is gathered over the model axes only: where the plan
splits the batch over the data axis, each rank takes the loss and the
metrics on its own rows (a local mean over the data axis's size, and local
counts and sums, all-reduced over the data axis), as XLA takes the JAX
package's loss on sharded logits; ``predict`` gathers the output whole.
After the backward the param grads the data axis split are summed by one
flat all-reduce (or, under ``--collective-overlap on``, one asynchronous
all-reduce a remat block, issued as that block's backward completes, all
awaited before the optimizer). A weight stored split over the data axis
is gathered for its node and its grad reduce-scattered in the gather's
backward, outside that all-reduce; autograd keeps its shard, not the
gathered copy, and the backward gathers it again
(:meth:`_fsdp_saved_hooks`). The guarded step's verdict is reduced over
every rank of a mesh inside the step. The serving programs run the plan
of a batch held whole on every rank (every rank serves every slot) and
gather their logits whole (:meth:`_serving_final`); attention computes
the rank's heads, so the KV cache a rank keeps holds only those.
"""
from __future__ import annotations

import contextlib

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..ffconst import DataType, LossType, OperatorType, dtype_to_torch
from ..ops.base import OpContext, profiler_on, run_op
from ..parallel.pcg import PCG, PCGNode
from .losses import loss_value


class _LiveBytes:
    """The port's count of a CPU step's memory (:meth:`Executor.
    train_step_memory_analysis`): a ``TorchDispatchMode`` that adds the
    bytes of every new storage an op returns and subtracts them when the
    storage is freed (a finalizer on it), starting from the storages of
    ``resident`` (a tree of tensors alive throughout). ``peak`` is the
    largest total seen."""

    def __init__(self, resident):
        from .graphs import _tensors_of

        self._ptrs: Dict[int, Any] = {}
        self.cur = self.peak = 0
        for t in _tensors_of(resident):
            self._track(t, finalize=False)
        self._mode = None

    def _track(self, t, finalize: bool = True) -> None:
        import weakref

        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr == 0 or ptr in self._ptrs:
            return  # a view, an in-place result, or an empty tensor
        n = st.nbytes()
        token = object()
        self._ptrs[ptr] = token
        self.cur += n
        self.peak = max(self.peak, self.cur)
        if finalize:
            weakref.finalize(st, self._free, ptr, token, n)

    def _free(self, ptr: int, token, n: int) -> None:
        if self._ptrs.get(ptr) is token:
            del self._ptrs[ptr]
        self.cur -= n

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        count = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in tree_leaves(out):
                    if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                        count._track(t)
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False


_NAN_TAG = "ff_debug_nans_node"


def _check_nans(node, outs) -> None:
    """``--debug-nans`` for one node (the counterpart of ``jax_debug_nans``,
    which raises where a jitted op produces a NaN): a NaN in a forward
    output raises ``FloatingPointError`` naming the node at once (one host
    sync a node), and every autograd function between the node's inputs
    and its outputs gets a hook that raises naming the node when its input
    grads hold a NaN. A function already tagged belongs to an earlier node,
    so the walk stops at the node's inputs."""
    import torch

    for i, o in enumerate(outs):
        if torch.is_tensor(o) and o.is_floating_point() and \
                bool(torch.isnan(o).any()):
            raise FloatingPointError(
                f"--debug-nans: node '{node.name}' "
                f"({node.op.op_type.name}) produced NaN in its forward "
                f"output {i}")
    stack = [o.grad_fn for o in outs
             if torch.is_tensor(o) and o.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or _NAN_TAG in fn.metadata or \
                type(fn).__name__ == "AccumulateGrad":
            continue
        fn.metadata[_NAN_TAG] = node.name

        def hook(grad_inputs, _grad_outputs, name=node.name,
                 op=node.op.op_type.name):
            for g in grad_inputs:
                if g is not None and g.is_floating_point() and \
                        bool(torch.isnan(g).any()):
                    raise FloatingPointError(
                        f"--debug-nans: the backward of node '{name}' "
                        f"({op}) produced NaN in an input grad")

        fn.register_hook(hook)
        stack.extend(f for f, _ in fn.next_functions)


def _reached_leaves(loss):
    """ids of the leaf tensors the backward of ``loss`` will reach (a walk
    of its autograd graph to the accumulate-grad nodes)."""
    seen, out = set(), set()
    stack = [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None:
            out.add(id(var))
        stack.extend(f for f, _ in fn.next_functions)
    return out


class Executor:
    def __init__(self, pcg: PCG, config, final_guid: int, device,
                 final_out_idx: int = 0, loss_type: Optional[LossType] = None,
                 metrics=None, optimizer=None, repl_labels: bool = False,
                 strategy=None, mesh=None):
        self.pcg = pcg
        # the mesh path (module doc): None for one device
        self.strategy = strategy
        self.mesh = mesh
        # whether the batch the steps get is this rank's slice of the data
        # axis (``local_batch``) or the whole batch on every rank
        self.batch_sharded = True
        self._plans: Dict[bool, Any] = {}
        self._shard_infos: Dict[bool, Dict[int, Any]] = {}
        self._grad_groups_cache: Optional[Tuple[Any, Any]] = None
        # > 0 while a remat block runs: its recompute gathers the data-axis
        # weights again, so nothing of them is saved to begin with
        self._recomputing = 0
        # {id(leaf): fp32 grad} of the data-axis weights during a 16-bit
        # backward (``spmd.GatherWeight``)
        self._fsdp_sink: Optional[Dict[int, Any]] = None
        self._by_name: Optional[Dict[str, PCGNode]] = None
        if strategy is not None:
            # op-attr overrides a strategy carries (executor.py:57-60)
            for guid, ns in strategy.node_strategies.items():
                if ns.extra and guid in pcg.nodes:
                    pcg.nodes[guid].op.attrs.update(ns.extra)
        self.config = config
        self.final_guid = final_guid
        self.final_out_idx = final_out_idx
        self.device = device
        self.loss_type = loss_type
        self.metrics = metrics
        self.optimizer = optimizer
        self.repl_labels = repl_labels
        # serving programs by key — ("prefill", bucket, max_len) etc.
        self._serving_fns: Dict[Tuple, Callable] = {}
        # the captured train steps (make_train_step), plain and guarded
        self._train_step: Optional[Callable] = None
        self._guarded_train_step: Optional[Callable] = None
        # the remat plan of the training forward (None at level none) and
        # the (plan, blocks) it was built into
        self.remat_plan = None
        self._remat_cache: Optional[Tuple[Any, Any]] = None
        # (stamp of the params it was cast from, compute-dtype copy): the
        # inference programs cast once per version of the params
        self._cast_cache: Optional[Tuple[Any, Any]] = None
        # cache-op state (src/ops/cache.cc; flexflow_tpu/execution/
        # executor.py:52-55): cached tensors across steps, host-scored,
        # paired with the dynamic recompile
        self.cache_nodes = [n for n in pcg.compute_nodes()
                            if n.op.op_type == OperatorType.OP_CACHE]
        self._cache_state: Optional[Dict[str, Any]] = None
        # --debug-nans: every node's outputs are checked in the forward and
        # its input grads in the backward, and the steps run eagerly
        self.debug_nans = bool(getattr(config, "debug_nans", False))

    # ------------------------------------------------------------------ params
    def _node_input_shapes(self, node: PCGNode) -> List[Tuple[int, ...]]:
        return [self.pcg.nodes[g].out_shapes[i] for g, i in node.inputs]

    def weight_entries(self):
        """[(node, wname, shape, dtype, init)] in topo order."""
        entries = []
        for node in self.pcg.compute_nodes():
            in_shapes = self._node_input_shapes(node)
            for wname, (shape, dtype, init) in node.op.weight_specs(
                    in_shapes).items():
                entries.append((node, wname, shape, dtype, init))
        return entries

    def init_params(self, seed: int = 0) -> Dict[str, Dict[str, Any]]:
        """{node_name: {wname: tensor}} on the executor's device, drawn on
        the CPU from one ``torch.Generator`` seeded with ``seed`` (the same
        weights on every device). On a mesh every rank draws the full
        weights in the same order and keeps its shard of each."""
        import torch

        gen = torch.Generator().manual_seed(int(seed))
        params: Dict[str, Dict[str, Any]] = {}
        for node, wname, shape, dtype, init in self.weight_entries():
            w = init(gen, shape, dtype_to_torch(dtype))
            params.setdefault(node.name, {})[wname] = \
                self.shard_param(node.name, wname, w)
        return params

    # --------------------------------------------------------------- the mesh
    def _plan(self):
        """The SPMD plan for the current batch layout (computed once)."""
        key = bool(self.batch_sharded)
        if key not in self._plans:
            from ..parallel.spmd import ShardInfo, plan_spmd

            plans = plan_spmd(self.pcg, self.strategy, self.mesh,
                              inputs_sharded=key)
            self._plans[key] = plans
            self._shard_infos[key] = {
                g: ShardInfo(pl, self.mesh, self._node_input_shapes(
                    self.pcg.nodes[g])) for g, pl in plans.items()}
        return self._plans[key]

    def param_shardings(self) -> Dict[str, Dict[str, Any]]:
        """{node_name: {wname: placements}}: how each weight is held, one
        ``torch.distributed.tensor`` placement per mesh dim (the JAX
        package's NamedSharding pytree, executor.py:87-101); {} off a
        mesh."""
        if self.mesh is None:
            return {}
        plans = self._plan()
        return {n.name: dict(plans[n.guid].stored)
                for n in self.pcg.compute_nodes() if plans[n.guid].stored}

    def batch_sharding(self, ndim: int):
        """The placements of a batch of rank ``ndim``: split over the data
        axis on dim 0 (the JAX package's ``P(data, None, ...)``), or None
        off a mesh."""
        if self.mesh is None:
            return None
        from ..parallel.spmd import spec_placements

        return spec_placements((self.strategy.data_axis,) +
                               (None,) * (ndim - 1), self.mesh.axis_names)

    def data_ranks(self) -> Tuple[int, int]:
        """(data-axis size, this rank's coordinate on it); (1, 0) off a
        mesh or without a data axis."""
        if self.mesh is None or \
                self.strategy.data_axis not in self.mesh.axis_names:
            return 1, 0
        return (self.mesh.size(self.strategy.data_axis),
                self.mesh.coord(self.strategy.data_axis))

    def local_batch(self, arrays):
        """This rank's rows of host batch ``arrays``: its slice of the data
        axis when the batch divides by it, else the whole batch (an eval's
        short last batch). Sets :attr:`batch_sharded` for the steps that
        follow. Ranks of one model-parallel group get the same rows."""
        n, c = self.data_ranks()
        rows = arrays[0].shape[0]
        self.batch_sharded = rows % n == 0
        if n == 1 or not self.batch_sharded:
            return list(arrays)
        k = rows // n
        return [a[c * k:(c + 1) * k] for a in arrays]

    def shard_param(self, node_name: str, wname: str, full):
        """This rank's shard of the full weight ``full`` (a CPU tensor), on
        the executor's device."""
        if self.mesh is None:
            return full.to(self.device)
        from ..parallel.spmd import local_slice

        guid = self._node_by_name()[node_name].guid
        pl = self._plan()[guid].stored[wname]
        return local_slice(full, pl, self.mesh).contiguous().to(self.device)

    def stored_placement(self, node_name: str, wname: str):
        """How a weight is held on the mesh: its placement per mesh dim."""
        return self._plan()[self._node_by_name()[node_name].guid].stored[
            wname]

    def gather_param(self, node_name: str, wname: str, local):
        """The full weight from this rank's shard ``local`` (every rank
        takes part and gets the whole)."""
        if self.mesh is None:
            return local
        from ..parallel.spmd import redistribute, replicated

        guid = self._node_by_name()[node_name].guid
        pl = self._plan()[guid].stored[wname]
        return redistribute(local.detach(), self.mesh, pl,
                            replicated(len(pl)))

    def _node_by_name(self):
        if self._by_name is None:
            self._by_name = {n.name: n for n in self.pcg.compute_nodes()}
        return self._by_name

    def _replicate_output(self, guid: int, idx: int, x):
        """A node's output gathered whole on every rank (what the loss, the
        metrics and ``predict`` read)."""
        if self.mesh is None:
            return x
        from ..parallel.spmd import redistribute, replicated

        pl = self._plan()[guid].outs[idx]
        return redistribute(x, self.mesh, pl, replicated(len(pl)))

    def _final_layout(self):
        """(held, wanted, split, seq) of the final output on a mesh: its
        planned placements, those the loss reads (the model axes gathered,
        the data axis kept where the plan splits the batch on dim 0 over it
        alone, the sequence axes kept where the plan leaves the output's
        positions split over them), whether the batch stays split over a
        data axis of several ranks, and those sequence axes. Static for a
        batch layout, as the plan is."""
        from ..parallel.spmd import replicated

        plan = self._plan()[self.final_guid]
        pl = plan.outs[self.final_out_idx]
        n = len(pl)
        di = self._data_axis()
        split = di is not None and self.mesh.sizes[di] > 1 and \
            pl[di].is_shard() and pl[di].dim == 0 and not any(
                p.is_shard() and p.dim == 0 and self.mesh.sizes[i] > 1
                for i, p in enumerate(pl) if i != di)
        # a (batch, seq, ...) output whose positions stay split: each rank
        # takes the loss on its own tokens (GPT-2's s16384 logits are 3.3
        # GB in fp32, and as much again for their grad)
        seq = tuple(i for i in plan.seq_axes if pl[i].is_shard()
                    and pl[i].dim == 1 and self.mesh.sizes[i] > 1)
        r = replicated(n)
        want = tuple(pl[i] if (split and i == di) or i in seq else r[i]
                     for i in range(n))
        return pl, want, split, seq

    def _data_axis(self) -> Optional[int]:
        """The data axis's index among the mesh dims, or None."""
        if self.mesh is None or \
                self.strategy.data_axis not in self.mesh.axis_names:
            return None
        return self.mesh.axis_names.index(self.strategy.data_axis)

    def _final_rows(self, x):
        """The final output as the loss and the metrics read it
        (:meth:`_final_layout`): this rank's rows where the batch stays
        split, else the whole output; and whether it is split."""
        if self.mesh is None:
            return x, False
        from ..parallel.spmd import redistribute

        held, want, split, _seq = self._final_layout()
        return redistribute(x, self.mesh, held, want), split

    def _sum_over(self, t, axes):
        """A copy of ``t`` summed over the mesh dims ``axes``."""
        import torch.distributed as dist

        out = t.detach().clone()
        for i in axes:
            dist.all_reduce(out, group=self.mesh.groups[i])
        return out

    def _sum_over_data(self, t):
        """A copy of ``t`` summed over the data axis's ranks."""
        return self._sum_over(t, (self._data_axis(),))

    def _loss_on_rows(self, logits, labels, split: bool):
        """(the loss to differentiate, the loss's value) of the final
        output ``logits``. Where the batch stays split, each rank's loss is
        the mean over its own rows (its labels are those rows) over the
        data axis's size: its gradient is the full-batch mean's at those
        rows, and its sum over the data axis, all-reduced, is the value.
        Every loss type is a mean over equal shares of the batch, so the
        value is the whole batch's. Where the output's positions stay
        split over sequence axes (:meth:`_final_layout`), each rank's loss
        is likewise that of its own tokens, over the axes' sizes where the
        loss is a mean over positions, and the value is summed over the
        world. Else the loss of the whole batch on every rank."""
        seq = self._final_layout()[3] if self.mesh is not None else ()
        if not split and not seq:
            loss = loss_value(self.loss_type, logits,
                              self._labels_whole(labels), self.repl_labels)
            return loss, loss
        share = self.mesh.sizes[self._data_axis()] if split else 1
        if seq:
            if not split:
                labels = self._labels_whole(labels)
            labels = self._label_positions(labels, seq)
            if self.loss_type != \
                    LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
                for i in seq:
                    share *= self.mesh.sizes[i]
        part = loss_value(self.loss_type, logits, labels,
                          self.repl_labels) / share
        return part, self._sum_over(
            part, ((self._data_axis(),) if split else ()) + seq)

    def _label_positions(self, labels, seq):
        """This rank's positions (dim 1) of ``labels`` over the mesh dims
        ``seq``, as the final output holds them."""
        from ..parallel.spmd import _types, local_slice, replicated

        Shard = _types()[0]
        pl = tuple(Shard(1) if i in seq else p for i, p in
                   enumerate(replicated(len(self.mesh.sizes))))
        return local_slice(labels, pl, self.mesh).contiguous()

    def _labels_whole(self, labels):
        """The labels gathered whole on every rank (they arrive as the
        batch does)."""
        if self.mesh is None:
            return labels
        from ..parallel.spmd import redistribute, replicated

        n = len(self.mesh.axis_names)
        src = self.batch_sharding(labels.dim()) if self.batch_sharded \
            else replicated(n)
        return redistribute(labels, self.mesh, src, replicated(n))

    def _run_node(self, node, params, inputs, ctx, scoped: bool):
        """One node: ``op.forward`` off a mesh; on a mesh its inputs and
        weights redistributed to the layouts its plan asks for, the op run
        with its ``ShardInfo`` in ``ctx.shard``, and its outputs moved to
        their planned layouts. Under ``--debug-nans`` its outputs are
        checked (:func:`_check_nans`)."""
        outs = self._run_node_body(node, params, inputs, ctx, scoped)
        if self.debug_nans:
            _check_nans(node, outs)
        return outs

    def _run_node_body(self, node, params, inputs, ctx, scoped: bool):
        ws = params.get(node.name, {})
        if self.mesh is None:
            return run_op(node.op, node.name, ws, inputs, ctx, scoped)
        from ..parallel.spmd import copy_to, redistribute

        mesh = self.mesh
        plan = self._plan()[node.guid]
        ins = [redistribute(x, mesh, s, d)
               for x, s, d in zip(inputs, plan.srcs, plan.ins)]
        if plan.copy_axes:
            copied: Dict[int, Any] = {}
            for i, x in enumerate(ins):
                if x.is_floating_point():
                    if id(x) not in copied:
                        copied[id(x)] = copy_to(x, mesh, plan.copy_axes)
                    ins[i] = copied[id(x)]
        # the gathered copies live until the op returns (so no tensor the
        # op makes reuses a storage the saved-tensor hooks key on), no longer
        fulls, saved = [], []
        if plan.fsdp:
            ws, fulls, saved = self._gather_fsdp(plan, ws)
        ws = {w: redistribute(t, mesh, plan.stored[w], plan.use[w])
              if w not in plan.fsdp else redistribute(
                  t, mesh, self._fsdp_src(plan, w), plan.use[w])
              for w, t in ws.items()}
        sctx = dataclasses.replace(
            ctx, shard=self._shard_infos[bool(self.batch_sharded)][
                node.guid])
        import torch

        saving = saved and self._recomputing == 0 and \
            torch.is_grad_enabled()
        with (self._fsdp_saved_hooks(saved) if saving
              else contextlib.nullcontext()):
            outs = run_op(node.op, node.name, ws, ins, sctx, scoped)
        del ws, fulls
        return [redistribute(o, mesh, a, b)
                for o, a, b in zip(outs, plan.natural, plan.outs)]

    # ------------------------------------------- weights over the data axis
    def _fsdp_src(self, plan, w):
        """A data-axis weight's placements once gathered over that axis."""
        from ..parallel.spmd import _types, _with

        return _with(plan.stored[w], self._data_axis(), _types()[1]())

    def _gather_fsdp(self, plan, ws):
        """The weights ``plan`` stores split over the data axis, each
        all-gathered whole over it (``spmd.gather_weight``; its grad is
        reduce-scattered back where the op's grads are partial there).
        Returns the weights, the gathered ones, and [(shard, dim, storage
        pointer of the gathered copy)] for :meth:`_fsdp_saved_hooks`."""
        from ..parallel.spmd import gather_weight

        di = self._data_axis()
        partial = di in plan.grad_axes
        ws = dict(ws)
        fulls, saved = [], []
        sink = self._fsdp_sink
        for w, d in plan.fsdp.items():
            if w in ws:
                shard = ws[w]
                ws[w] = gather_weight(
                    shard, self.mesh, di, d, partial,
                    (sink, id(shard)) if sink is not None else None)
                fulls.append(ws[w])
                saved.append((shard, d, ws[w].untyped_storage().data_ptr()))
        return ws, fulls, saved

    def _fsdp_saved_hooks(self, saved):
        """A context in which autograd saves a gathered weight (or a view
        of it) as its shard and gathers it again when the backward reads
        it: the whole weight is held only while its op runs, and again
        while its backward does. ``saved`` is [(shard, dim, storage
        pointer)]: the hooks, which autograd keeps until the backward,
        hold the shards and never the gathered copies."""
        import torch

        from ..parallel.spmd import _gather

        mesh, di = self.mesh, self._data_axis()
        group, n = mesh.groups[di], mesh.sizes[di]
        device = saved[0][0].device
        shards = [(s, d) for s, d, _p in saved]
        ptrs = {p: k for k, (_s, _d, p) in enumerate(saved)}

        def pack(t):
            k = ptrs.get(t.untyped_storage().data_ptr()) \
                if t.device == device else None
            if k is None:
                return t
            return ("fsdp", k, tuple(t.shape), t.stride(),
                    t.storage_offset())

        def unpack(x):
            if not (isinstance(x, tuple) and x and x[0] == "fsdp"):
                return x
            _tag, k, shape, stride, offset = x
            shard, d = shards[k]
            full = _gather(shard.detach(), d, group, n)
            return full.as_strided(shape, stride, offset)

        return torch.autograd.graph.saved_tensors_hooks(pack, unpack)

    # --------------------------------------------------------- mixed precision
    def _compute_dtype(self):
        """torch dtype for forward compute, or None for the params' own.
        Master weights stay fp32; layer norm statistics and attention
        scores stay fp32 inside the ops."""
        cd = getattr(self.config, "compute_dtype", None)
        if cd is None or cd == DataType.DT_NONE:
            return None
        return dtype_to_torch(cd)

    @staticmethod
    def _params_stamp(params):
        """Every param tensor with its in-place version: a replaced or
        updated tensor (an optimizer step, ``set_params_numpy``, a weight
        edit) breaks the match. It holds the tensors themselves, not their
        ids, so a freed tensor's reused id can never fake a match."""
        return [(t, t._version) for ws in params.values()
                for t in ws.values()]

    @staticmethod
    def _stamp_matches(old, new) -> bool:
        return len(old) == len(new) and all(
            a is b and va == vb for (a, va), (b, vb) in zip(old, new))

    def _cast_for_compute(self, params, xs, cache: bool = False):
        """Params and inputs in the compute dtype (fp32 masters stay
        untouched; a tensor already in it is passed through). The training
        step casts the masters itself, every step inside its graph
        (:meth:`loss_and_grads`), so grads reach the fp32 masters as in
        JAX's ``loss_fn``. The inference programs pass ``cache=True``: the
        cast copy is kept and reused while the params' stamp is unchanged,
        and made again after any update."""
        cdtype = self._compute_dtype()
        if cdtype is None:
            return params, xs
        xs = [x.to(cdtype) if x.is_floating_point() else x for x in xs]

        def cast():
            return {n: {w: (t.to(cdtype) if t.is_floating_point() else t)
                        for w, t in ws.items()}
                    for n, ws in params.items()}

        if not cache:
            return cast(), xs
        stamp = self._params_stamp(params)
        if self._cast_cache is None or \
                not self._stamp_matches(self._cast_cache[0], stamp):
            self._cast_cache = (stamp, cast())
        return self._cast_cache[1], xs

    @staticmethod
    def _logits_f32(logits):
        return logits.float() if logits.is_floating_point() else logits

    # ----------------------------------------------------------------- forward
    def forward_outputs(self, params, bound_inputs: Dict[int, Any],
                        ctx: OpContext,
                        overrides: Optional[Dict[int, List[Any]]] = None
                        ) -> Dict[int, List[Any]]:
        """Run the graph; returns {node_guid: [outputs]}. ``overrides``
        substitutes the outputs of specific compute nodes without running
        them — the serving hook that replaces the baked position ids."""
        values: Dict[int, List[Any]] = {}
        scoped = profiler_on()
        for node in self.pcg.topo_order():
            op = node.op
            if op.op_type in (OperatorType.OP_INPUT, OperatorType.OP_WEIGHT):
                values[node.guid] = [bound_inputs[node.guid]]
                continue
            if overrides is not None and node.guid in overrides:
                values[node.guid] = overrides[node.guid]
                continue
            inputs = [values[g][i] for g, i in node.inputs]
            values[node.guid] = self._run_node(node, params, inputs, ctx,
                                               scoped)
        return values

    def profile_ops(self, params, xs, iters: int = 3):
        """ProfiledStep mode (flexflow_tpu/execution/executor.py:639-740):
        run the graph node by node on the live params and batch and time
        each DISTINCT op shape ``(op params, in-shapes)``: on CUDA as
        ``search.simulator.measure_operator_cost`` times an op (``iters``
        calls of the node captured into one CUDA graph, the median of its
        replays timed by CUDA events), on the CPU the best wall of
        ``iters`` calls. On a
        mesh the node runs as the step runs it (``_run_node``: its
        redistributes and collectives included). Returns one raw record
        per key, ``{guid, name, op_type, in_shapes, measured_fwd_s,
        count}``; a producer's outputs are dropped once its last consumer
        has run."""
        import time

        import torch

        from ..search.simulator import Simulator, _time_captured

        with torch.no_grad():
            params_c, xs_c = self._cast_for_compute(params, list(xs))
            ctx = OpContext(training=False, device=self.device)
            bound = self._bind_inputs(list(xs_c))
            order = self.pcg.topo_order()
            uses: Dict[int, int] = {}
            for node in order:
                for g, _i in node.inputs:
                    uses[g] = uses.get(g, 0) + 1
            values: Dict[int, List[Any]] = {}
            timings: Dict[Tuple, Dict[str, Any]] = {}
            for node in order:
                if node.op.op_type in (OperatorType.OP_INPUT,
                                       OperatorType.OP_WEIGHT):
                    values[node.guid] = [bound[node.guid]]
                    continue
                inputs = [values[g][i] for g, i in node.inputs]
                in_shapes = self._node_input_shapes(node)
                key = Simulator._op_key(node, in_shapes)

                def call(node=node, inputs=inputs):
                    return self._run_node(node, params_c, inputs, ctx,
                                          False)

                values[node.guid] = call()
                if key in timings:
                    timings[key]["count"] += 1
                elif self.device.type == "cuda":
                    timings[key] = dict(
                        guid=node.guid, name=node.name,
                        op_type=node.op.op_type.name, in_shapes=in_shapes,
                        measured_fwd_s=_time_captured(
                            call, max(iters, 1), self.device), count=1)
                else:
                    best = float("inf")
                    for _ in range(max(iters, 1)):
                        t0 = time.perf_counter()
                        call()
                        best = min(best, time.perf_counter() - t0)
                    timings[key] = dict(
                        guid=node.guid, name=node.name,
                        op_type=node.op.op_type.name, in_shapes=in_shapes,
                        measured_fwd_s=best, count=1)
                for g, _i in node.inputs:
                    uses[g] -= 1
                    if uses[g] == 0:
                        values.pop(g, None)
        return list(timings.values())

    def _bind_inputs(self, xs: List[Any]) -> Dict[int, Any]:
        input_nodes = self.pcg.input_nodes()
        if len(xs) != len(input_nodes):
            raise ValueError(
                f"model has {len(input_nodes)} inputs, got {len(xs)}")
        return {n.guid: x for n, x in zip(input_nodes, xs)}

    def forward(self, params, xs):
        """Whole-sequence inference forward (no KV cache): the final
        output in fp32. The plain reference the serving steps are held
        against. Baked position ids are regenerated as ``arange(seq)`` for
        the width of ``xs[0]`` (the builder baked them for its declared
        batch and sequence; for that shape the two are equal)."""
        import torch

        with torch.inference_mode():
            params, xs = self._cast_for_compute(params, list(xs),
                                                    cache=True)
            ctx = OpContext(training=False, device=self.device)
            b, seq = xs[0].shape[:2]
            pos = torch.arange(seq, dtype=torch.int32,
                               device=self.device).expand(b, seq)
            values = self.forward_outputs(
                params, self._bind_inputs(xs), ctx,
                overrides={g: [pos] for g in self._position_const_guids()})
            return self._logits_f32(
                values[self.final_guid][self.final_out_idx])

    # ---------------------------------------------------------------- training
    def _loss_and_logits(self, params, xs, labels, rng, training: bool,
                         cache=None, cache_out=None):
        """(the loss to differentiate, its value, the final output as the
        loss read it: this rank's rows where the batch stays split)."""
        params_c, xs = self._cast_for_compute(params, list(xs))
        ctx = OpContext(training=training, rng=rng, device=self.device,
                        aux_losses=[] if training else None,
                        cache_in=cache, cache_out=cache_out, mesh=self.mesh)
        blocks = self._remat_blocks() if training else None
        final = (self.final_guid, self.final_out_idx)
        if blocks is not None:
            raw = self._forward_remat(params_c, self._bind_inputs(xs), ctx,
                                      blocks, [final])[0]
        else:
            values = self.forward_outputs(params_c, self._bind_inputs(xs),
                                          ctx)
            raw = values[self.final_guid][self.final_out_idx]
        raw, split = self._final_rows(raw)
        logits = self._logits_f32(raw)
        loss, value = self._loss_on_rows(logits, labels, split)
        # the training loss carries the ops' aux terms (the regularizers),
        # as flexflow_tpu/execution/executor.py:554-555 adds them; they are
        # whole on every rank, so they join the value once
        for aux in ctx.aux_losses or ():
            loss = loss + aux
            value = value + aux.detach()
        return loss, value, logits

    # ------------------------------------------------------------------ remat
    def _remat_blocks(self):
        """The training forward's remat blocks for the ``--remat`` plan, or
        None at level ``none``: ``[(guids, recompute, ext_refs,
        out_refs)]`` in topological order. ``full`` makes each of
        ``remat_segments``' segments one block to recompute; ``selective``
        splits each segment at the ``REMAT_SAVEABLE_OPS`` nodes, which run
        outside any block (autograd keeps what they save), and recomputes
        the runs between them. ``ext_refs`` are the (guid, out_idx) values
        a block reads from before it, ``out_refs`` those it hands on (read
        by a later block, or the loss anchor): under ``full`` the only
        activations kept between forward and backward."""
        from .remat import level_pieces, remat_segments, resolve_remat_plan

        # the --remat flag, then the strategy's searched level (as the JAX
        # executor resolves it, flexflow_tpu/execution/executor.py)
        plan = resolve_remat_plan(self.config, self.strategy)
        if plan.level == "none":
            self.remat_plan = None
            return None
        self.remat_plan = plan
        if self._remat_cache is not None and self._remat_cache[0] == plan:
            return self._remat_cache[1]
        pieces = [p for seg in remat_segments(self.pcg, plan.segment_size)
                  for p in level_pieces(self.pcg, seg, plan.level)]
        blocks = self._blocks_of(pieces, [(self.final_guid,
                                           self.final_out_idx)])
        self._remat_cache = (plan, blocks)
        return blocks

    def _blocks_of(self, pieces, anchors):
        """Remat blocks ``[(guids, recompute, ext_refs, out_refs)]`` of
        ``pieces`` (``[(guids, recompute)]`` in topological order): a
        block hands on what a later block reads and the ``anchors``
        ((guid, out_idx) values read after the forward)."""
        piece_of = {g: k for k, (guids, _) in enumerate(pieces)
                    for g in guids}
        needed = set(anchors)
        for node in self.pcg.compute_nodes():
            needed.update((pg, i) for pg, i in node.inputs
                          if piece_of.get(pg, -1) != piece_of[node.guid])
        blocks = []
        for guids, recompute in pieces:
            inside = set(guids)
            ext_refs: List[Tuple[int, int]] = []
            for g in guids:
                for ref in self.pcg.nodes[g].inputs:
                    if ref[0] not in inside and ref not in ext_refs:
                        ext_refs.append(ref)
            out_refs = [(g, i) for g in guids
                        for i in range(len(self.pcg.nodes[g].out_shapes))
                        if (g, i) in needed]
            blocks.append((guids, recompute, ext_refs, out_refs))
        return blocks

    def _run_nodes(self, guids, params, values, ctx) -> None:
        scoped = profiler_on()
        for g in guids:
            node = self.pcg.nodes[g]
            outs = self._run_node(node, params,
                                  [values[r] for r in node.inputs], ctx,
                                  scoped)
            values.update(((g, i), v) for i, v in enumerate(outs))

    def _forward_remat(self, params, bound_inputs: Dict[int, Any],
                       ctx: OpContext, blocks, anchors):
        """The training forward through the remat blocks: each block to
        recompute runs under ``torch.utils.checkpoint.checkpoint``
        (non-reentrant, so ``autograd.grad`` and closures over the param
        leaves work; ``preserve_rng_state=False``, which would sync the
        device and break a capture — the ops draw no torch RNG). A block's
        dropout seeds are drawn once, on its first run, and replayed on
        its recompute (:class:`~.graphs.SegmentSeeds`); its aux losses
        and its CacheOps' fresh values leave it as outputs, so a recompute
        does not add them twice (flexflow_tpu/execution/executor.py:
        287-332). Returns the values of ``anchors`` ((guid, out_idx)
        pairs, each in a block's ``out_refs`` or a node outside any)."""
        from torch.utils.checkpoint import checkpoint

        from .graphs import SegmentSeeds

        values: Dict[Tuple[int, int], Any] = {
            (g, 0): v for g, v in bound_inputs.items()}
        for guids, recompute, ext_refs, out_refs in blocks:
            if not recompute:
                self._run_nodes(guids, params, values, ctx)
                continue
            seeds = SegmentSeeds(ctx.rng) if ctx.rng is not None else None
            cache_names = [self.pcg.nodes[g].name for g in guids
                           if self.pcg.nodes[g].op.op_type ==
                           OperatorType.OP_CACHE] \
                if ctx.cache_out is not None else []

            def block(*ext, guids=guids, ext_refs=ext_refs,
                      out_refs=out_refs, seeds=seeds,
                      cache_names=cache_names):
                local = dict(zip(ext_refs, ext))
                aux = [] if ctx.aux_losses is not None else None
                fresh = {} if ctx.cache_out is not None else None
                bctx = dataclasses.replace(
                    ctx, rng=seeds.replay() if seeds is not None else None,
                    aux_losses=aux, cache_out=fresh)
                self._recomputing += 1
                try:
                    self._run_nodes(guids, params, local, bctx)
                finally:
                    self._recomputing -= 1
                return (tuple(local[r] for r in out_refs)
                        + tuple(fresh[n] for n in cache_names)
                        + tuple(aux or ()))

            outs = checkpoint(block, *[values[r] for r in ext_refs],
                              use_reentrant=False, preserve_rng_state=False)
            values.update(zip(out_refs, outs))
            n_out = len(out_refs) + len(cache_names)
            if cache_names:
                ctx.cache_out.update(zip(cache_names,
                                         outs[len(out_refs):n_out]))
            if ctx.aux_losses is not None:
                ctx.aux_losses.extend(outs[n_out:])
        return [values[r] for r in anchors]

    # ----------------------------------------------------------- cache state
    def init_cache(self) -> Dict[str, Any]:
        """Zeroed cache state for the graph's CacheOps, on the device:
        ``{"__use_cache__": a 0-d bool tensor (False), op_name: zeros of
        its input's shape and dtype}`` (flexflow_tpu/execution/
        executor.py:458-469). The train step reads these tensors in place,
        so a captured step keeps reading them: the host changes them with
        ``copy_``, never by binding new ones. So the executor makes them
        once and a later call zeroes the same tensors (a fit, a rollback):
        new tensors would make the step capture anew."""
        import torch

        if self._cache_state is not None:
            for t in self._cache_state.values():
                t.zero_()
            return self._cache_state
        cache = {"__use_cache__": torch.zeros((), dtype=torch.bool,
                                              device=self.device)}
        for node in self.cache_nodes:
            g, i = node.inputs[0]
            src = self.pcg.nodes[g]
            cache[node.name] = torch.zeros(
                src.out_shapes[i], dtype=dtype_to_torch(src.out_dtypes[i]),
                device=self.device)
        self._cache_state = cache
        return cache

    # ---------------------------------------------------------------- steps
    def invalidate_jit_cache(self) -> None:
        """Drop every captured program and the inference cast copy, and
        with them their CUDA graphs and memory pools
        (flexflow_tpu/execution/executor.py:472-482). Required after
        anything a graph bakes in changes: an optimizer's ``lr`` /
        ``alpha`` (``Optimizer.set_learning_rate``), an op attribute,
        replaced params (``FFModel.set_params_numpy`` calls it). A pending
        learning-rate change is taken up with the programs that baked the
        old rate."""
        if self.optimizer is not None:
            self.optimizer._lr_changed = False
        for fn in [self._train_step, self._guarded_train_step,
                   *self._serving_fns.values()]:
            program = getattr(fn, "program", None)
            if program is not None:
                program.reset()
        self._train_step = None
        self._guarded_train_step = None
        self._serving_fns = {}
        self._cast_cache = None
        self._remat_cache = None

    def make_train_step(self, capture: bool = True, guard: bool = False):
        """``(params, opt_state, xs, labels, rng) -> (params, opt_state,
        loss, metrics)``: forward (through the ``--remat`` blocks when the
        plan asks), loss, ``torch.autograd.grad`` over the fp32 master
        leaves, metrics, then the optimizer's in-place update
        (flexflow_tpu/execution/executor.py:484-596 without overlap).
        ``rng`` is the step's ``torch.Generator`` (dropout seeds).
        ``params`` and ``opt_state`` come back as the same objects,
        updated in place; ``loss`` and the metrics stay on the device (no
        host sync in the step).

        With CacheOps in the graph the step takes the cache state
        (:meth:`init_cache`) as a sixth argument and returns the CacheOps'
        fresh values ``{op_name: tensor}`` after the metrics (before
        ``ok``), as the JAX step does.

        With ``guard=True`` (the divergence sentinel,
        ``resilience.GuardedTrainStep``) the step computes ``ok =
        isfinite(loss) & isfinite(Σ|g|²)`` on the device (the grads'
        squared norms, one multi-tensor launch, summed in fp32; any NaN or
        Inf in any grad reaches the sum), applies the update masked by it
        (``optimizers`` module doc: a bad step leaves every param and
        state tensor bitwise unchanged) and returns ``ok``, a 0-d bool
        device tensor, as a fifth value.

        Each step is a :class:`~.graphs.StepProgram`, cached on the
        executor as the JAX package caches its jitted steps (the plain and
        the guarded one apart): on CUDA the first call of a batch shape
        runs eagerly, the second captures the step as a CUDA graph, later
        ones replay it. ``capture=False`` returns the eager body itself
        (for comparisons)."""
        # a captured graph cannot raise mid-program: --debug-nans steps
        # run eagerly
        capture = capture and not self.debug_nans
        cached = self._guarded_train_step if guard else self._train_step
        if capture and cached is not None:
            return cached
        import torch

        opt = self.optimizer
        cache_names = [n.name for n in self.cache_nodes]
        verdict_world = guard and self.mesh is not None and \
            self.mesh.numel > 1

        def step(params, opt_state, xs, labels, rng, cache=None):
            fresh = {} if cache is not None else None
            loss, logits, grads = self.loss_and_grads(
                params, xs, labels, rng, cache=cache, cache_out=fresh)
            m = self._compute_metrics(logits, labels)
            extra = (fresh,) if cache is not None else ()
            if not guard:
                params, opt_state = opt.update(params, grads, opt_state)
                return (params, opt_state, loss, m) + extra
            gs = [g for ws in grads.values() for g in ws.values()]
            ok = torch.isfinite(loss)
            if gs:
                gsq = torch.stack(torch._foreach_norm(gs)).square().sum()
                ok = ok & torch.isfinite(gsq)
            if verdict_world:
                # one rank's NaN (a grad shard under tp, its own batch)
                # skips the step on every rank: one all-reduce of the bad
                # count over the world, inside the step
                import torch.distributed as dist

                bad = (~ok).to(torch.int32).reshape(1)
                dist.all_reduce(bad)
                ok = (bad == 0).reshape(())
            params, opt_state = opt.update(params, grads, opt_state, ok=ok)
            return (params, opt_state, loss, m) + extra + (ok,)

        if not capture:
            return step
        from .graphs import StepProgram

        # metric names in output order, and the host-side (int) metrics
        layout: Dict[str, Any] = {}
        extra = 1 if guard else 0  # ok follows the loss

        def body(inputs, seeds, params, opt_state, *cache):
            _p, _s, loss, m, *rest = step(params, opt_state, inputs[:-1],
                                          inputs[-1], seeds, *cache)
            fresh = rest[0] if cache else {}
            layout["names"] = [k for k, v in m.items() if torch.is_tensor(v)]
            layout["host"] = {k: v for k, v in m.items()
                              if not torch.is_tensor(v)}
            return [loss, *rest[len(rest) - extra:]] + \
                [fresh[n] for n in cache_names if cache] + \
                [m[k] for k in layout["names"]]

        program = StepProgram(body, self.device,
                              "train_guarded" if guard else "train")

        def train_step(params, opt_state, xs, labels, rng, cache=None):
            """The cache tensors are arguments the program reads in
            place (their addresses are captured), not static inputs."""
            args = (params, opt_state) + ((cache,) if cache is not None
                                          else ())
            outs = program(list(xs) + [labels], *args, rng=rng)
            n_fresh = len(cache_names) if cache is not None else 0
            m = dict(layout["host"])
            m.update(zip(layout["names"], outs[1 + extra + n_fresh:]))
            fresh = (dict(zip(cache_names, outs[1 + extra:1 + extra +
                                                n_fresh])),) \
                if cache is not None else ()
            return (params, opt_state, outs[0], m) + fresh + \
                tuple(outs[1:1 + extra])

        train_step.program = program
        if guard:
            self._guarded_train_step = train_step
        else:
            self._train_step = train_step
        return train_step

    def loss_and_grads(self, params, xs, labels, rng=None, cache=None,
                       cache_out=None):
        """The differentiated half of the train step: ``(loss, logits,
        grads)`` with grads ``{node: {wname: tensor}}`` on the fp32 master
        leaves (zeros for a param the loss does not reach, as
        ``jax.value_and_grad`` gives), all detached. ``cache`` is the
        CacheOps' state the forward reads, ``cache_out`` a dict it fills
        with their fresh values (detached).

        With a compute dtype the masters are cast afresh every step, all at
        once (one flat copy, whose per-tensor views are the graph's
        leaves), and the grads of those compute-dtype leaves are upcast to
        fp32 at once: the same values autograd through a per-tensor cast
        gives (its backward upcasts the same accumulated grads), in four
        launches instead of two per tensor."""
        import torch

        names = [(n, w) for n, ws in params.items()
                 for w, t in ws.items() if t.is_floating_point()]
        masters = [params[n][w].detach() for n, w in names]
        cdtype = self._compute_dtype()
        if cdtype is None:
            # leaves share storage with the masters: an in-place update of
            # the masters is what the next step's leaves read
            leaf_list = masters
        else:
            sizes = [m.numel() for m in masters]
            flat = torch.cat([m.reshape(-1) for m in masters]).to(cdtype)
            leaf_list = [v.view(m.shape)
                         for v, m in zip(flat.split(sizes), masters)]
        leaf_list = [t.detach().requires_grad_(True) for t in leaf_list]
        leaves = {n: dict(ws) for n, ws in params.items()}
        for (n, w), t in zip(names, leaf_list):
            leaves[n][w] = t
        overlap = None
        sink = self._fsdp_sink = {} if cdtype is not None and \
            self.mesh is not None else None
        with torch.enable_grad():
            loss, value, logits = self._loss_and_logits(
                leaves, xs, labels, rng, training=True, cache=cache,
                cache_out=cache_out)
            if self.mesh is not None and (getattr(
                    self.config, "collective_overlap", "off")
                    or "off") == "on":
                overlap = self._overlap_hooks(names, leaf_list, cdtype,
                                              loss)
            try:
                flat_grads = self._grad(loss, leaf_list)
            finally:
                self._fsdp_sink = None
                if overlap is not None:
                    for h in overlap[0]:
                        h.remove()
        if cache_out:
            cache_out.update({k: v.detach() for k, v in cache_out.items()})
        if overlap is not None:
            flat_grads = self._overlap_finish(overlap, masters, leaf_list,
                                              flat_grads, cdtype)
        else:
            flat_grads = [g if g is not None else torch.zeros_like(t)
                          for g, t in zip(flat_grads, leaf_list)]
            up = None
            if cdtype is not None:
                up = torch.cat([g.reshape(-1) for g in flat_grads]).float()
                flat_grads = [v.view(m.shape)
                              for v, m in zip(up.split(sizes), masters)]
            if self.mesh is not None:
                flat_grads = self._all_reduce_grads(names, flat_grads, up)
        if sink:
            # a data-axis weight's grad as its reduce-scatter summed it in
            # fp32, not rounded to the 16-bit leaf's dtype on the way
            for i, t in enumerate(leaf_list):
                if id(t) in sink:
                    flat_grads[i].copy_(sink[id(t)])
        grads: Dict[str, Dict[str, Any]] = {n: {} for n in params}
        for (n, w), g in zip(names, flat_grads):
            grads[n][w] = g
        return value.detach(), logits.detach(), grads

    def make_probe_step(self):
        """``(params, xs, labels, rng[, cache]) -> (loss, grad_l2_norm)``:
        forward, loss and grads with NO optimizer update and nothing
        written in place (flexflow_tpu/execution/executor.py:598-637), the
        parallel-correctness audit's probe (``resilience/audit.py``). The
        train step's own loss recipe (:meth:`loss_and_grads`: the
        compute-dtype cast, the aux losses, the dropout seeds drawn from
        ``rng``), so masks replay alike across strategies over the same
        graph. On a mesh the loss is the global one and the norm is taken
        over every grad gathered whole (each rank returns the same two
        0-d fp32 device tensors); it is a collective, so every rank calls
        it. Eager, as the audit runs it once."""
        import torch

        def probe(params, xs, labels, rng=None, cache=None):
            fresh = {} if cache is not None else None
            loss, _logits, grads = self.loss_and_grads(
                params, xs, labels, rng, cache=cache, cache_out=fresh)
            gsq = torch.zeros((), dtype=torch.float32, device=self.device)
            for n, ws in grads.items():
                for w, g in ws.items():
                    full = self.gather_param(n, w, g).float()
                    gsq = gsq + full.square().sum()
            return loss.float(), gsq.sqrt()

        return probe

    def train_step_memory_analysis(self, params, opt_state, xs, labels,
                                   guard: bool = False,
                                   capture: bool = True) -> Dict[str, int]:
        """The peak memory of the training step, measured (the
        counterpart of XLA's compiled ``memory_analysis``,
        flexflow_tpu/execution/executor.py:751-765, which the port cannot
        have before anything runs). The exact step the loop will run
        (:meth:`make_train_step` with ``guard`` and ``capture``) runs on
        clones of ``params`` and ``opt_state``, which stay untouched, with
        ``xs`` / ``labels`` this rank's device batch.

        On CUDA: the allocator's peak is reset, the step's first call
        (eager) and, when captured, its second (the capture into the
        program's private pool, then its replay) run, and the peak is
        ``torch.cuda.max_memory_allocated`` less the clones' bytes (the
        loop holds the params once). The program's entries, which hold the
        clones, are dropped after. On the CPU: the port's own count of one
        eager step (:class:`_LiveBytes`): the bytes of the clones and the
        batch, plus every storage the step's ops allocate, each counted
        until it is freed; the peak is the largest total.

        Returns ``{"peak_memory_in_bytes", "argument_size_in_bytes",
        "source"}`` (``source`` ``cuda_allocator`` or ``cpu_count``)."""
        import torch

        from .checkpoint import _tree_map, tree_bytes

        step = self.make_train_step(capture=capture, guard=guard)
        p = _tree_map(lambda t: t.clone(), params)
        s = _tree_map(lambda t: t.clone(), opt_state)
        cache = (_tree_map(lambda t: t.clone(), self.init_cache()),) \
            if self.cache_nodes else ()
        xs = list(xs)
        clone_bytes = tree_bytes([p, s, *cache])
        args_bytes = tree_bytes([params, opt_state, xs, labels])
        program = getattr(step, "program", None)
        try:
            if self.device.type == "cuda":
                dev = self.device
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                for _ in range(2 if program is not None else 1):
                    step(p, s, xs, labels, torch.Generator().manual_seed(0),
                         *cache)
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) - clone_bytes
                source = "cuda_allocator"
            else:
                with _LiveBytes([p, s, *cache, xs, labels]) as count:
                    step(p, s, xs, labels, torch.Generator().manual_seed(0),
                         *cache)
                peak = count.peak
                source = "cpu_count"
        finally:
            if program is not None:
                program.reset()  # its entry holds the clones
        return {"peak_memory_in_bytes": int(peak),
                "argument_size_in_bytes": int(args_bytes),
                "source": source}

    def _grad(self, loss, leaf_list):
        """``torch.autograd.grad`` of the step; under ``--debug-nans``
        inside ``detect_anomaly(check_nan=True)``, whose error (a NaN no
        node's hook named, in the loss's own backward) becomes a
        ``FloatingPointError``."""
        import torch

        if not self.debug_nans:
            return torch.autograd.grad(loss, leaf_list, allow_unused=True)
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # anomaly mode's own notice
            try:
                with torch.autograd.detect_anomaly(check_nan=True):
                    return torch.autograd.grad(loss, leaf_list,
                                               allow_unused=True)
            except RuntimeError as e:
                if "nan values" not in str(e):
                    raise
                raise FloatingPointError(f"--debug-nans: {e}") from e

    # ------------------------------------------------------------ grad sync
    def _grad_groups(self, names):
        """[(mesh dims, indices into ``names``)]: the params whose grads
        are partial over the same mesh dims (the data axis, for ops that
        ran on a batch slice), each group summed by one flat all-reduce.
        Params whose grads are complete on every rank are in no group.
        Kept for each batch layout, as the plan is: a whole batch leaves
        every grad complete."""
        key = (bool(self.batch_sharded), tuple(names))
        if self._grad_groups_cache is not None and \
                self._grad_groups_cache[0] == key:
            return self._grad_groups_cache[1]
        plans = self._plan()
        by_name = self._node_by_name()
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for i, (n, w) in enumerate(names):
            plan = plans[by_name[n].guid]
            # a data-axis weight's grad was reduce-scattered in its
            # gather's backward: summed already
            axes = tuple(a for a in plan.grad_axes
                         if not (w in plan.fsdp and a == self._data_axis()))
            if axes:
                groups.setdefault(axes, []).append(i)
        out = list(groups.items())
        self._grad_groups_cache = (key, out)
        return out

    def _all_reduce_groups(self, buf, axes) -> None:
        """Sum ``buf`` in place over the mesh dims ``axes``, even on a
        one-rank group (which NCCL answers without a kernel): a mesh of one
        card still issues, captures and replays the data axis's collective
        that a mesh of several runs."""
        import torch.distributed as dist

        for i in axes:
            dist.all_reduce(buf, group=self.mesh.groups[i])

    def _all_reduce_grads(self, names, flat_grads, flat=None):
        """The data-parallel grad sync: each group of :meth:`_grad_groups`
        summed by one all-reduce of its grads laid end to end (``flat``,
        the fp32 upcast every grad is a view of, when one group holds them
        all: XLA's combined all-reduce)."""
        import torch

        groups = self._grad_groups(names)
        if flat is not None and len(groups) == 1 and \
                len(groups[0][1]) == len(names):
            self._all_reduce_groups(flat, groups[0][0])
            return flat_grads
        flat_grads = list(flat_grads)
        for axes, idx in groups:
            buf = torch.cat([flat_grads[i].reshape(-1) for i in idx])
            self._all_reduce_groups(buf, axes)
            for i, v in zip(idx, buf.split([flat_grads[i].numel()
                                            for i in idx])):
                flat_grads[i] = v.view(flat_grads[i].shape)
        return flat_grads

    def _overlap_hooks(self, names, leaf_list, cdtype, loss):
        """``--collective-overlap on`` (the counterpart of
        ``_blockwise_value_and_grad``, flexflow_tpu/execution/executor.py:
        357-456): the param grads of each group of :meth:`_grad_groups`
        split into buckets by remat block, and a hook on each leaf; once
        the backward has produced every grad of a bucket that the loss
        reaches, the bucket's grads are laid end to end (upcast to fp32
        with a compute dtype, as the synchronous path's flat upcast) and
        their all-reduce starts asynchronously. :meth:`_overlap_finish`
        waits for every bucket before the optimizer. The same sums of the
        same values as the synchronous path, so the grads are bitwise
        equal."""
        import torch

        from .remat import remat_segments, resolve_remat_plan

        plan = resolve_remat_plan(self.config, self.strategy)
        block_of = {g: k for k, seg in enumerate(
            remat_segments(self.pcg, plan.segment_size)) for g in seg}
        by_name = self._node_by_name()
        buckets: Dict[Tuple[int, Tuple[int, ...]], List[int]] = {}
        for axes, idx in self._grad_groups(names):
            for i in idx:
                blk = block_of[by_name[names[i][0]].guid]
                buckets.setdefault((blk, axes), []).append(i)
        reached = _reached_leaves(loss)
        pending: Dict[Tuple, Any] = {}
        handles = []
        for key, idx in buckets.items():
            want = [i for i in idx if id(leaf_list[i]) in reached]
            if not want:
                continue
            got: Dict[int, Any] = {}

            def hook(g, i, key=key, idx=idx, want=want, got=got):
                got[i] = g
                if len(got) < len(want):
                    return
                flat = torch.cat([
                    (got[j] if j in got else torch.zeros_like(
                        leaf_list[j])).reshape(-1) for j in idx])
                if cdtype is not None:
                    flat = flat.float()
                for a in key[1][:-1]:
                    self._all_reduce_groups(flat, (a,))
                pending[key] = (flat, [self._async_all_reduce(
                    flat, key[1][-1])])

            for i in want:
                handles.append(leaf_list[i].register_hook(
                    lambda g, i=i, hook=hook: hook(g, i)))
        return handles, buckets, pending

    def _async_all_reduce(self, buf, axis: int):
        import torch.distributed as dist

        return dist.all_reduce(buf, group=self.mesh.groups[axis],
                               async_op=True)

    def _overlap_finish(self, overlap, masters, leaf_list, returned, cdtype):
        """The grads after :meth:`_overlap_hooks`' all-reduces: every
        bucket awaited and cut back into per-param views; params in no
        bucket (complete grads) and unreached ones as the synchronous
        path gives them."""
        import torch

        _handles, buckets, pending = overlap
        out: List[Any] = [None] * len(masters)
        for key, idx in buckets.items():
            if key not in pending:
                continue  # no grad reached this bucket: zeros below
            flat, works = pending[key]
            for w in works:
                w.wait()
            for i, v in zip(idx, flat.split([masters[i].numel()
                                             for i in idx])):
                out[i] = v.view(masters[i].shape)
        for i, g in enumerate(out):
            if g is None:
                g = returned[i] if returned[i] is not None else \
                    torch.zeros_like(leaf_list[i])
                out[i] = g.float() if cdtype is not None else g
        return out

    def _compute_metrics(self, logits, labels):
        """The metrics of the final output as the loss read it
        (:meth:`_final_rows`): where the batch stays split, counts and
        sums over this rank's rows, all-reduced over the data axis; where
        its positions stay split, over this rank's positions, summed over
        the sequence axes (the output is never gathered for them)."""
        import torch

        if self.metrics is None:
            return {}
        split, seq = self._final_layout()[2:] \
            if self.mesh is not None else (False, ())
        if not split:
            labels = self._labels_whole(labels)
        if self.repl_labels:
            k = logits.shape[0] // labels.shape[0]
            labels = torch.repeat_interleave(labels, k, dim=0)
        positions = None
        if seq:
            labels = self._label_positions(labels, seq)
            n = 1
            for i in seq:
                n *= self.mesh.sizes[i]
            positions = (n, lambda t: self._sum_over(t, seq))
        m = self.metrics.compute(logits, labels, positions)
        if split:
            n = self.mesh.sizes[self._data_axis()]
            m = {k: (self._sum_over_data(v) if torch.is_tensor(v)
                     else v * n) for k, v in m.items()}
        return m

    def make_eval_step(self):
        """``(params, xs, labels) -> (loss, metrics)``, no dropout, no
        grads (flexflow_tpu/execution/executor.py:777-797); on a mesh the
        loss and the metrics of the train step's rule (:meth:`_loss_on_rows`,
        :meth:`_compute_metrics`)."""
        import torch

        def estep(params, xs, labels):
            with torch.inference_mode():
                params_c, xs_c = self._cast_for_compute(params, list(xs),
                                                        cache=True)
                ctx = OpContext(training=False, device=self.device)
                ctx.mesh = self.mesh
                values = self.forward_outputs(params_c,
                                              self._bind_inputs(xs_c), ctx)
                raw, split = self._final_rows(
                    values[self.final_guid][self.final_out_idx])
                logits = self._logits_f32(raw)
                _part, loss = self._loss_on_rows(logits, labels, split)
                return loss, self._compute_metrics(logits, labels)

        return estep

    def make_forward(self):
        """``(params, xs) -> final output`` in the compute dtype: the
        inference forward of ``predict`` (executor.py:799-817). Unlike
        :meth:`forward` it runs the graph as built, baked constants
        included."""
        import torch

        def fwd(params, xs):
            with torch.inference_mode():
                params_c, xs_c = self._cast_for_compute(params, list(xs),
                                                        cache=True)
                ctx = OpContext(training=False, device=self.device,
                                mesh=self.mesh)
                values = self.forward_outputs(params_c,
                                              self._bind_inputs(xs_c), ctx)
                return self._replicate_output(
                    self.final_guid, self.final_out_idx,
                    values[self.final_guid][self.final_out_idx])

        return fwd

    # ----------------------------------------------------------------- serving
    @contextlib.contextmanager
    def _batch_whole(self):
        """Run the plan of a batch held whole on every rank (the serving
        programs' layout, module doc) within the block."""
        saved = self.batch_sharded
        self.batch_sharded = False
        try:
            yield
        finally:
            self.batch_sharded = saved

    def _serving_final(self, params, xs, ctx, overrides):
        """The final output of a serving forward, whole on every rank. On a
        mesh the batch (the slots, or one prompt) is whole on every rank,
        as the JAX engine's programs hold it on a mesh, and the plan's
        node layouts apply: attention runs on the rank's heads, so the
        cache entries it hands back hold those heads only."""
        with self._batch_whole():
            values = self.forward_outputs(params, self._bind_inputs(xs),
                                          ctx, overrides=overrides)
            return self._replicate_output(
                self.final_guid, self.final_out_idx,
                values[self.final_guid][self.final_out_idx])

    def serving_local_heads(self, node) -> int:
        """The heads of attention node ``node`` that this rank's serving
        programs compute and its KV pool holds: all of them off a mesh,
        the rank's share where the serving plan splits them."""
        heads = int(node.op.attrs.get("num_heads", 1))
        if self.mesh is None:
            return heads
        with self._batch_whole():
            plan = self._plan()[node.guid]
        if plan.mode == "heads" and plan.axis is not None:
            return heads // self.mesh.sizes[plan.axis]
        return heads

    def _position_const_guids(self) -> List[int]:
        """Compute nodes holding the baked position-id constant."""
        from ..serving.kvcache import is_position_constant

        return [node.guid for node in self.pcg.compute_nodes()
                if node.op.op_type == OperatorType.OP_CONSTANT
                and is_position_constant(node.op.attrs.get("value"))]

    def make_prefill_step(self, bucket_len: int, max_decode_len: int,
                          capture: bool = True):
        """``(params, xs, lengths) -> (logits, last_logits, cache)``: run the
        whole right-padded prompt (``bucket_len`` wide) and return each
        causal attention node's prompt k/v rows in ``cache``. ``lengths``
        are the true prompt lengths, a device int32 tensor;
        ``last_logits`` (batch, vocab) are taken at ``lengths - 1`` on the
        device.

        The step is a :class:`~.graphs.StepProgram` per bucket, as the JAX
        package jits one per bucket: its static inputs are the ids and the
        lengths, its outputs the fp32 logits (the whole ``(batch, bucket,
        vocab)``, as JAX returns them), the last rows and every k/v leaf.
        Its only other argument is the params (the compute-dtype cast copy
        under a compute dtype), so one program serves every engine of the
        model. ``capture=False`` runs the body eagerly.

        Pad rows' position ids are clamped to the row's last real position:
        a bucket may be wider than the position table, where ``jnp.take``
        would fill and torch indexing raises. Real rows are unchanged (a
        causal row never sees the pad rows after it)."""
        key = ("prefill", int(bucket_len), int(max_decode_len), bool(capture))
        fn = self._serving_fns.get(key)
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState, cache_leaves
        from .graphs import step_program

        # the cache's (node name, leaf count) in output order; 0 marks an
        # entry that is one tensor (the LSTM carry), not a tuple
        layout: List[Tuple[str, int]] = []

        def body(inputs, _seeds, params):
            import torch

            *xs, lengths = inputs
            sv = ServingState(mode="prefill", max_len=max_decode_len,
                              positions=torch.zeros_like(lengths),
                              lengths=lengths)
            ctx = OpContext(training=False, device=self.device, serving=sv)
            b = xs[0].shape[0]
            pos = torch.arange(bucket_len, dtype=torch.int32,
                               device=self.device).expand(b, bucket_len)
            pos = torch.minimum(pos, (lengths - 1).clamp(min=0)[:, None])
            logits = self._logits_f32(self._serving_final(
                params, xs, ctx, {g: [pos] for g in pos_guids}))
            idx = (lengths.long() - 1).clamp(0, logits.shape[1] - 1)
            last = logits[torch.arange(b, device=logits.device), idx]
            layout[:] = [(n, len(e) if isinstance(e, tuple) else 0)
                         for n, e in sv.cache_out.items()]
            # the leaves come out of a head transpose; contiguous, the
            # slot write's copy into its static inputs is one memcpy each,
            # not a copy kernel launched outside any graph
            return [logits, last, *(t.contiguous()
                                    for e in sv.cache_out.values()
                                    for t in cache_leaves(e))]

        program = step_program(body, self.device, f"prefill_{bucket_len}",
                               capture and not self.debug_nans)

        def prefill(params, xs, lengths):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs),
                                                    cache=True)
                logits, last, *leaves = program(
                    list(xs) + [lengths.to(torch.int32)], params)
            cache, i = {}, 0
            for n, k in layout:
                cache[n] = leaves[i] if k == 0 else tuple(leaves[i:i + k])
                i += max(k, 1)
            return logits, last, cache

        prefill.program = program
        self._serving_fns[key] = prefill
        return prefill

    def make_chunk_prefill_step(self, chunk_len: int, max_decode_len: int,
                                block_size: int, kv_dtype: str = "native",
                                capture: bool = True,
                                fns: Optional[Dict] = None):
        """``(params, xs, state, table_row, start, n_new) ->
        (last_logits, state)``: one prefill chunk of ``chunk_len`` token
        slots of a SINGLE request against the paged pool. ``xs`` carries
        the chunk's ids ``(1, chunk_len)`` (rows beyond ``n_new`` are pad),
        ``table_row`` the slot's (mb,) block-table row, ``start`` (1,) the
        chunk's first position and ``n_new`` (1,) its real tokens, all
        int32 tensors on the device. The chunk's k/v rows are written into
        the pool in place; lengths and the block tables are untouched (the
        engine arms the slot only when its whole prompt is in).
        ``kv_dtype`` is the pool's layout ("native" or "int8").

        The step is a :class:`~.graphs.StepProgram` per chunk shape, as the
        JAX package jits one per shape with the state donated: the ids,
        table row, start and count are its static inputs (no host int
        reaches the body), the last real row is gathered on the device,
        and the pools are arguments written in place — so a program
        captures anew for other pools. ``fns`` is the dict the program is
        kept in (default the executor's): a serving engine passes its own,
        so that engines of one model used in turns each replay their own
        graph. ``capture=False`` runs the body eagerly."""
        key = ("chunk", int(chunk_len), int(max_decode_len), int(block_size),
               str(kv_dtype), bool(capture))
        cache = self._serving_fns if fns is None else fns
        fn = cache.get(key)
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState
        from .graphs import step_program

        def body(inputs, _seeds, params, state):
            import torch

            *xs, table_row, start_t, n_t = inputs
            sv = ServingState(mode="chunk", max_len=max_decode_len,
                              positions=start_t, lengths=n_t,
                              cache_in=state.caches,
                              block_tables=table_row[None, :],
                              block_size=int(block_size),
                              kv_dtype=str(kv_dtype))
            ctx = OpContext(training=False, device=self.device, serving=sv)
            # pad rows past the last real token would index past the
            # position table when start + chunk_len overhangs the context:
            # clamp them to the last real position
            pos = start_t + torch.arange(chunk_len, dtype=torch.int32,
                                         device=self.device)
            pos = torch.minimum(pos, start_t + n_t - 1)[None, :]
            logits = self._logits_f32(self._serving_final(
                params, xs, ctx, {g: [pos] for g in pos_guids}))
            idx = (n_t.long() - 1).clamp(0, logits.shape[1] - 1)
            return [logits[0].index_select(0, idx)]

        program = step_program(body, self.device, f"chunk_{chunk_len}",
                               capture and not self.debug_nans)

        def chunk(params, xs, state, table_row, start, n_new):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs),
                                                    cache=True)
                (last,) = program(list(xs) + [table_row, start, n_new],
                                  params, state)
            return last, state

        chunk.program = program
        cache[key] = chunk
        return chunk

    def make_decode_step(self, max_decode_len: int, exact: bool = False,
                         guard: bool = False, block_size: int = 0,
                         kv_dtype: str = "native", capture: bool = True,
                         seq_shards: int = 1, fns: Optional[Dict] = None):
        """``(params, xs, state) -> (logits, state)``: ONE token per slot
        through the graph, writing each slot's k/v at its ``lengths``
        cursor into the paged pool (``block_size`` > 0) or the ring
        (``block_size`` 0, a state without block tables) and advancing the
        cursors — all in place. ``exact=True`` reads paged attention
        through the plain gather path instead of the flash-decode kernel.
        ``kv_dtype`` is the pool's layout ("native" or "int8");
        ``seq_shards`` > 1 reads each slot's extent as that many key
        segments (``ops/attention._seqpar_decode``), a program of its own.

        ``guard=True`` is the guarded decode program, a second program
        (flexflow_tpu/execution/executor.py:975-1060): it returns
        ``(logits, state, ok)``, ``ok`` the (n_slots,) int32 verdict
        ``isfinite(logits).all(-1)`` computed inside the same graph. The
        logits are untouched, so a healthy slot's values equal the
        unguarded step's bitwise; the quarantine decision is the host's.

        The step is a :class:`~.graphs.StepProgram` over the static token
        input ``xs[0]`` (n_slots, 1); lengths, block tables and pools are
        persistent and written in place. The params it reads (the
        compute-dtype cast copy under a compute dtype, made afresh after
        any update of the masters) and the pools are the tensors it was
        captured against: a call with others (updated params, another
        engine's pools) drops the graph and captures anew, so a replay
        never reads stale weights. ``fns`` is the dict the program is kept
        in (default the executor's); a serving engine passes its own, as
        for the chunk program. ``capture=False`` returns the eager body
        (for comparisons)."""
        key = ("decode", int(max_decode_len), bool(exact), bool(guard),
               int(block_size), str(kv_dtype), int(seq_shards))
        cache = self._serving_fns if fns is None else fns
        fn = cache.get(key if capture else key + ("eager",))
        if fn is not None:
            return fn
        pos_guids = self._position_const_guids()
        from ..serving.kvcache import ServingState, cache_leaves

        def run(params, xs, state):
            """The step on compute-dtype params and inputs: the logits, and
            under ``guard`` the verdict."""
            import torch

            with torch.inference_mode():
                sv = ServingState(mode="decode", max_len=max_decode_len,
                                  positions=state.lengths,
                                  cache_in=state.caches, exact=exact,
                                  block_tables=state.block_tables,
                                  block_size=int(block_size),
                                  kv_dtype=str(kv_dtype),
                                  seq_shards=int(seq_shards))
                ctx = OpContext(training=False, device=self.device,
                                serving=sv)
                logits = self._logits_f32(self._serving_final(
                    params, xs, ctx,
                    {g: [state.lengths[:, None]] for g in pos_guids}))[:, 0]
                # the state is written in place: attention entries already
                # are (their pools took the token's rows); any other entry
                # (the LSTM carry) is copied into the state's buffer, so
                # the program's next replay reads the advanced state
                for name, out in sv.cache_out.items():
                    for c, o in zip(cache_leaves(state.caches[name]),
                                    cache_leaves(out)):
                        if o is not c:
                            c.copy_(o)
                state.lengths += 1
                if guard:
                    ok = torch.isfinite(logits).all(dim=-1)
                    return [logits, ok.to(torch.int32)]
                return [logits]

        program = None
        if capture and not self.debug_nans:
            from .graphs import StepProgram

            program = StepProgram(
                lambda inputs, _seeds, params, state: run(params, inputs,
                                                          state),
                self.device, "decode_guarded" if guard else "decode")

        def decode(params, xs, state):
            import torch

            with torch.inference_mode():
                params, xs = self._cast_for_compute(params, list(xs),
                                                    cache=True)
                outs = run(params, xs, state) if program is None \
                    else program(xs, params, state)
                return (outs[0], state, *outs[1:])

        decode.program = program
        cache[key if capture else key + ("eager",)] = decode
        return decode
