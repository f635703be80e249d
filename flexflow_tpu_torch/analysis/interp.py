"""Abstract interpretation of a parallelized PCG over the placement lattice.

One forward walk of the graph in topological order, tracking a
:class:`~.lattice.Placement` per tensor (``(guid, out_idx)``), seeded from
the Strategy's declared shardings and advanced by per-op transfer
functions:

* a Linear whose kernel is sharded on its **contraction** dim (the
  row-parallel plan of ``parallel/strategies.py``), an attention output
  projection sharded over heads, a vocab-sharded embedding gather, and an
  in-channel-sharded Conv2D all produce ``partial_sum(axis)`` — the psum
  semantics documented on ``parallel/parallel_op.py``'s ReductionOp;
* a declared ``output_spec`` on the producing node discharges the partial
  (lowered to ``with_sharding_constraint``, XLA materializes the psum /
  reduce-scatter that satisfies it);
* an explicit ``OP_REDUCTION`` parallel-op node discharges the partial
  over its ``axes`` — and reducing a value that is NOT partial over those
  axes is the dual defect (a double-counted allreduce);
* every other consumer **requires** a non-partial value.

Violations surface as **FF001** diagnostics during the walk (see
``rules.py`` for the registry); the resulting placement map feeds the
FF006 shape/divisibility checks and the CLI's per-tensor dump. The
interpreter is pure Python over graph metadata — no device, no compile,
no probe step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..ffconst import OperatorType
from .lattice import Placement, entry_axes
from .report import Diagnostic

# ops that preserve their (single) input's shape and placement elementwise;
# kept in sync with the Unity DP's state-preserving set (search/unity.py) —
# the ops the search itself pins to pass sharded states through unchanged
_STATE_PRESERVING = {
    OperatorType.OP_RELU, OperatorType.OP_GELU, OperatorType.OP_TANH,
    OperatorType.OP_SIGMOID, OperatorType.OP_ELU, OperatorType.OP_IDENTITY,
    OperatorType.OP_DROPOUT, OperatorType.OP_SCALAR_MULTIPLY,
    OperatorType.OP_SCALAR_ADD, OperatorType.OP_SCALAR_SUB,
    OperatorType.OP_SCALAR_TRUE_DIV, OperatorType.OP_CAST,
    OperatorType.OP_EXP, OperatorType.OP_POW, OperatorType.OP_LAYERNORM,
    OperatorType.OP_SOFTMAX, OperatorType.OP_BATCHNORM,
}
_ELEMENTWISE_BINARY = {
    OperatorType.OP_EW_ADD, OperatorType.OP_EW_SUB, OperatorType.OP_EW_MUL,
    OperatorType.OP_EW_DIV, OperatorType.OP_EW_MAX, OperatorType.OP_EW_MIN,
}

# (op_type, weight name, contraction dim of that weight): a strategy that
# shards this weight dim makes the op contract over a sharded dim — the
# output is a partial sum over the sharding axes until reduced
_CONTRACTION_WEIGHT_DIMS = {
    OperatorType.OP_LINEAR: ("kernel", 0),
    OperatorType.OP_MULTIHEAD_ATTENTION: ("wo", 0),
    OperatorType.OP_EMBEDDING: ("weight", 0),
    OperatorType.OP_CONV2D: ("kernel", 2),
}


@dataclasses.dataclass
class InterpResult:
    # (guid, out_idx) -> Placement for every tensor the walk reached
    values: Dict[Tuple[int, int], Placement]
    # FF001 findings discovered during propagation
    diagnostics: List[Diagnostic]


def _default_placement(shape, data_axis: Optional[str]) -> Placement:
    """The placement we assume when nothing is declared: activations ride
    the data-parallel batch split on dim 0, everything else replicated —
    the executor's ``batch_sharding`` convention."""
    ndim = len(shape)
    if ndim == 0 or data_axis is None:
        return Placement.replicated(ndim)
    return Placement(dims=(data_axis,) + (None,) * (ndim - 1))


def _partial_axes_produced(node, ns) -> Tuple[str, ...]:
    """Mesh axes the node's output is an unreduced partial sum over, from
    the strategy's weight shardings alone."""
    if ns is None or not ns.weight_specs:
        return ()
    probe = _CONTRACTION_WEIGHT_DIMS.get(node.op.op_type)
    if probe is None:
        return ()
    wname, cdim = probe
    spec = ns.weight_specs.get(wname)
    if not spec or cdim >= len(spec):
        return ()
    return entry_axes(spec[cdim])


def interpret(pcg, strategy, data_axis: Optional[str] = None
              ) -> InterpResult:
    """Run the abstract interpreter; returns placements + FF001 findings.

    ``strategy`` may be None (a bare graph — everything defaults to the
    batch-split placement and no partials can arise)."""
    from .rules import RULES

    ff001 = RULES["FF001"]
    node_strats = (strategy.node_strategies if strategy is not None else {})
    if data_axis is None and strategy is not None:
        data_axis = (strategy.data_axis
                     if strategy.data_axis in tuple(strategy.axis_names)
                     else None)
    values: Dict[Tuple[int, int], Placement] = {}
    diags: List[Diagnostic] = []
    # one FF001 per offending producer tensor, not per consumer edge —
    # after reporting, the value is treated as reduced so a fan-out of
    # consumers doesn't bury the root cause in repeats
    flagged_partials: set = set()

    for node in pcg.topo_order():
        ot = node.op.op_type
        ns = node_strats.get(node.guid)
        out_shapes = node.out_shapes or [()]
        if ot == OperatorType.OP_INPUT:
            values[(node.guid, 0)] = _default_placement(out_shapes[0],
                                                        data_axis)
            continue
        if ot == OperatorType.OP_WEIGHT:
            values[(node.guid, 0)] = Placement.replicated(len(out_shapes[0]))
            continue

        in_places = [values.get((g, i),
                                Placement.replicated(
                                    len(pcg.nodes[g].out_shapes[i])))
                     for g, i in node.inputs]

        if getattr(node.op, "is_parallel_op", False):
            out = _transfer_parallel_op(pcg, node, ns, in_places, values,
                                        diags, flagged_partials, ff001,
                                        data_axis)
            for idx in range(len(out_shapes)):
                values[(node.guid, idx)] = out
            continue

        # ---- compute op: consuming a partial value is the FF001 defect
        for slot, ((g, i), place) in enumerate(zip(node.inputs, in_places)):
            if place.is_partial and (g, i) not in flagged_partials:
                flagged_partials.add((g, i))
                prod = pcg.nodes[g].name
                axes = ", ".join(sorted(place.partial))
                diags.append(Diagnostic(
                    rule_id="FF001", node=node.name,
                    message=(f"consumes input {slot} from '{prod}' that is "
                             f"an unreduced partial_sum over mesh axis "
                             f"({axes}); only a Reduction parallel op (or "
                             "an output sharding constraint on the "
                             "producer) may consume a partial sum"),
                    fix_hint=ff001.fix_hint))

        partial_axes = _partial_axes_produced(node, ns)
        out_spec = ns.output_spec if ns is not None else None
        if out_spec is not None:
            # a declared constraint both pins the sharding and discharges
            # any partial the op produced (XLA materializes the reduce)
            out = Placement.from_spec(out_spec, len(out_shapes[0]))
        else:
            out = _propagate(node, in_places, out_shapes[0], ns, data_axis)
            if partial_axes:
                out = out.with_partial(partial_axes)
        for idx, shp in enumerate(out_shapes):
            if idx == 0 or len(shp) == len(out_shapes[0]):
                values[(node.guid, idx)] = dataclasses.replace(out)
            else:
                values[(node.guid, idx)] = _default_placement(shp, data_axis)
    return InterpResult(values=values, diagnostics=diags)


def _transfer_parallel_op(pcg, node, ns, in_places, values, diags,
                          flagged_partials, ff001, data_axis) -> Placement:
    """Transfer function for the parallel-op IR nodes
    (parallel/parallel_op.py): Reduction discharges partial sums; every
    other resharding node requires an already-reduced input."""
    ot = node.op.op_type
    g, i = node.inputs[0] if node.inputs else (None, 0)
    inp = in_places[0] if in_places else Placement.replicated(0)
    ndim = len(node.out_shapes[0]) if node.out_shapes else 0
    out_spec = ns.output_spec if ns is not None else None

    if ot == OperatorType.OP_REDUCTION:
        axes = tuple(a for a in (node.op.attrs.get("axes") or ()) if a)
        if not axes:
            axes = tuple(sorted(inp.partial))
        reduced_any = bool(inp.partial & set(axes))
        if not reduced_any and (g, i) not in flagged_partials:
            prod = pcg.nodes[g].name if g in pcg.nodes else "?"
            diags.append(Diagnostic(
                rule_id="FF001", node=node.name,
                message=(f"reduces over mesh axis {axes} but its input "
                         f"from '{prod}' is not a partial_sum over "
                         f"{axes} (placement: {inp.describe()}) — a "
                         "doubled reduction double-counts the allreduce "
                         "and scales the value by the axis degree"),
                fix_hint=ff001.fix_hint))
        out = inp.reduce_over(axes)
        if out_spec is not None:
            return Placement.from_spec(out_spec, ndim)
        return out

    # Combine / Repartition / Replicate / AllToAll / FusedParallel: pure
    # resharding of a *complete* value — moving partial terms between
    # devices without reducing them is the same wrong-gradient defect
    if inp.is_partial and (g, i) not in flagged_partials:
        flagged_partials.add((g, i))
        prod = pcg.nodes[g].name if g in pcg.nodes else "?"
        axes = ", ".join(sorted(inp.partial))
        diags.append(Diagnostic(
            rule_id="FF001", node=node.name,
            message=(f"reshards ({ot.name}) a value from '{prod}' that is "
                     f"still an unreduced partial_sum over ({axes}); "
                     "insert the Reduction before the reshard"),
            fix_hint=ff001.fix_hint))
    if out_spec is not None:
        return Placement.from_spec(out_spec, ndim)
    return dataclasses.replace(inp, partial=frozenset())


def _propagate(node, in_places, out_shape, ns, data_axis) -> Placement:
    """Placement of an undeclared compute output: state-preserving and
    elementwise ops keep their (shape-identical) input placement; a
    column-parallel Linear shards its last dim like its kernel's out-dim;
    anything rank-changing falls back to the batch-split default."""
    ot = node.op.op_type
    ndim = len(out_shape)
    if ot == OperatorType.OP_LINEAR and ns is not None and ns.weight_specs:
        kspec = ns.weight_specs.get("kernel")
        if kspec and len(kspec) >= 2:
            col_axes = entry_axes(kspec[1])
            if col_axes:
                base = _default_placement(out_shape, data_axis)
                dims = list(base.dims)
                dims[-1] = col_axes[0] if len(col_axes) == 1 \
                    else tuple(col_axes)
                return Placement(dims=tuple(dims))
    if (ot in _STATE_PRESERVING or ot in _ELEMENTWISE_BINARY) \
            and in_places:
        src = in_places[0]
        if len(src.dims) == ndim:
            return dataclasses.replace(src, partial=frozenset())
    return _default_placement(out_shape, data_axis)
