"""Hand-written parallelization strategies.

A copy of ``flexflow_tpu.parallel.strategies`` (:20-179): the counterparts
of the reference's manually-constructed substitution outputs
(create_replicate_linear_combine substitution.cc:3226,
create_partition_attention_combine :3169, DLRM's pre-searched strategy
protobufs examples/cpp/DLRM/strategies/*.pb): known-good hybrid shardings
that are what ``--import-strategy`` files look like. The builders write the
same specs node by node as the JAX package's, so the exported JSON is the
same text. ``long_context_strategy`` is a builder only here: the attention
op refuses its ``sequence_parallel_axis`` until the long-context schedules
are ported.
"""
from __future__ import annotations

from typing import Optional

from ..ffconst import OperatorType
from ..machine_view import MachineView
from .pcg import PCG
from .strategy import NodeStrategy, Strategy


def hybrid_data_tensor_strategy(pcg: PCG, dp: int, tp: int,
                                data_axis: str = "data",
                                model_axis: str = "model") -> Strategy:
    """Megatron-style DP x TP over a (data, model) mesh.

    Per block: attention q/k/v projections sharded over heads (the reference's
    attribute parallelism), output projection row-sharded (all-reduced);
    MLP fc1 column-parallel, fc2 row-parallel; embedding tables row
    (vocab)-sharded. Batch dim sharded over ``data`` everywhere.
    """
    s = Strategy(mesh_shape=(dp, tp), axis_names=(data_axis, model_axis),
                 data_axis=data_axis)
    view = MachineView(dim=(dp, tp), stride=(tp, 1))
    axis_sizes = {data_axis: dp, model_axis: tp}

    col_parallel_prev: set = set()  # guids of col-parallel linears
    for node in pcg.topo_order():
        ns = s.for_node(node.guid)
        ns.view = view
        op = node.op
        if op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
            ns.weight_specs = {
                "wq": (None, model_axis, None),
                "wk": (None, model_axis, None),
                "wv": (None, model_axis, None),
                "wo": (model_axis, None, None),
                "bo": (None,),
            }
            # output fully reduced, batch-sharded (Reduction semantics)
            ndim = len(node.out_shapes[0])
            ns.output_spec = (data_axis,) + (None,) * (ndim - 1)
        elif op.op_type == OperatorType.OP_LINEAR:
            producer = _transitive_producer(pcg, node)
            if producer in col_parallel_prev:
                # row-parallel: contract the sharded dim, then all-reduce
                ns.weight_specs = {"kernel": (model_axis, None),
                                   "bias": (None,)}
                ndim = len(node.out_shapes[0])
                ns.output_spec = (data_axis,) + (None,) * (ndim - 1)
            else:
                # column-parallel
                ns.weight_specs = {"kernel": (None, model_axis),
                                   "bias": (model_axis,)}
                col_parallel_prev.add(node.guid)
        elif op.op_type == OperatorType.OP_EMBEDDING:
            # table-sharded over vocab (DLRM-style parameter parallelism);
            # the masked gather, then an all-reduce
            ns.weight_specs = {"weight": (model_axis, None)}
            ndim = len(node.out_shapes[0])
            ns.output_spec = (data_axis,) + (None,) * (ndim - 1)
        elif op.op_type == OperatorType.OP_CONV2D:
            # channel-out (parameter) parallel
            ns.weight_specs = {"kernel": (None, None, None, model_axis),
                               "bias": (model_axis,)}
        _validate_node_specs(pcg, node, ns, axis_sizes)
    return s


def _validate_node_specs(pcg: PCG, node, ns: NodeStrategy, axis_sizes) -> None:
    """Drop shardings whose dim isn't divisible by the axis size (the
    reference's get_valid_machine_views plays this role, graph.h:230)."""
    in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
    wspecs = node.op.weight_specs(in_shapes)
    for wname in list(ns.weight_specs):
        if wname not in wspecs:
            del ns.weight_specs[wname]
            continue
        shape = wspecs[wname][0]
        entries = list(ns.weight_specs[wname])
        for d, ax in enumerate(entries):
            if ax is None or d >= len(shape):
                continue
            size = axis_sizes.get(ax, 1)
            if shape[d] % size != 0:
                entries[d] = None
        ns.weight_specs[wname] = tuple(entries)
    if ns.output_spec is not None:
        oshape = node.out_shapes[0]
        entries = list(ns.output_spec)
        for d, ax in enumerate(entries):
            if ax is not None and oshape[d] % axis_sizes.get(ax, 1) != 0:
                entries[d] = None
        ns.output_spec = tuple(entries)


def _transitive_producer(pcg: PCG, node) -> Optional[int]:
    """Walk back through unary/elementwise ops to the producing heavy op."""
    passthrough = {
        OperatorType.OP_RELU, OperatorType.OP_GELU, OperatorType.OP_TANH,
        OperatorType.OP_SIGMOID, OperatorType.OP_ELU, OperatorType.OP_DROPOUT,
        OperatorType.OP_IDENTITY, OperatorType.OP_SCALAR_MULTIPLY,
        OperatorType.OP_SCALAR_ADD, OperatorType.OP_CAST,
    }
    g, i = node.inputs[0] if node.inputs else (None, 0)
    while g is not None:
        prod = pcg.nodes[g]
        if prod.op.op_type in passthrough and prod.inputs:
            g, i = prod.inputs[0]
            continue
        return prod.guid
    return None


def long_context_strategy(pcg: PCG, dp: int, sp: int,
                          data_axis: str = "data",
                          seq_axis: str = "seq",
                          mode: str = "ring") -> Strategy:
    """Sequence/context parallelism: activations sharded over the seq dim,
    attention computed over the ``seq`` mesh axis with one of two schedules
    — ``mode="ring"`` (k/v rotation, kernels/ring_attention.py, O((s/P)^2)
    score memory) or ``mode="alltoall"`` (Ulysses head re-partition,
    kernels/ulysses_attention.py, 4 all-to-alls; needs heads % sp == 0).
    No reference analog (SURVEY §5) — the long-context extension the
    reference lacks."""
    assert mode in ("ring", "alltoall"), \
        f"mode must be 'ring' or 'alltoall', got {mode!r}"
    s = Strategy(mesh_shape=(dp, sp), axis_names=(data_axis, seq_axis),
                 data_axis=data_axis)
    view = MachineView(dim=(dp, sp), stride=(sp, 1))
    for node in pcg.topo_order():
        ns = s.for_node(node.guid)
        ns.view = view
        ot = node.op.op_type
        if ot == OperatorType.OP_MULTIHEAD_ATTENTION:
            ns.extra["sequence_parallel_axis"] = seq_axis
            if mode != "ring":
                ns.extra["sequence_parallel_mode"] = mode
            # output stays seq-sharded: (batch, seq, hidden)
            ns.output_spec = (data_axis, seq_axis, None)
        elif len(node.out_shapes[0]) >= 3 and \
                node.out_shapes[0][1] % max(sp, 1) == 0:
            # keep 3D activations sharded over seq between blocks
            ndim = len(node.out_shapes[0])
            ns.output_spec = (data_axis, seq_axis) + (None,) * (ndim - 2)
    return s


def expert_parallel_strategy(pcg: PCG, dp: int, ep: int,
                             data_axis: str = "data",
                             expert_axis: str = "expert") -> Strategy:
    """Shard MoE expert Linears over an expert axis: expert i's weights live on
    mesh column i % ep (reference: per-expert MachineViews on group_by outputs).
    Realized by replicating the expert dense weights only over ``data`` and
    round-robin-sharding via distinct submesh specs is not expressible in pure
    SPMD — instead we shard each expert's weight over ``expert`` jointly, which
    places the experts' columns evenly."""
    s = Strategy(mesh_shape=(dp, ep), axis_names=(data_axis, expert_axis),
                 data_axis=data_axis)
    view = MachineView(dim=(dp, ep), stride=(ep, 1))
    for node in pcg.topo_order():
        ns = s.for_node(node.guid)
        ns.view = view
        if node.op.op_type == OperatorType.OP_LINEAR and \
                "moe_expert" in node.name:
            # shard each expert's FFN over the expert axis (out-dim); the
            # grouped batch stays replicated over ep — tokens meet weights
            # where they live
            ns.weight_specs = {"kernel": (None, expert_axis),
                               "bias": (expert_axis,)}
    return s
