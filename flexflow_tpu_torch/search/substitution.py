"""Graph substitution engine (GraphXfer) + TASO-style JSON rule loader.

Rebuild of the reference's pattern engine (include/flexflow/substitution.h:
64-247 ``OpX/TensorX/GraphXfer``; src/runtime/substitution.cc:3802) and the
JSON rule collection loader (substitution_loader.h:131-179, rules file
substitutions/graph_subst_3_v2.json).

Role in the TPU build: the Unity DP search (unity.py) already covers the
parallelization xfers (partition/replicate linear+attention combine) natively
via sharding choices. The GraphXfer engine here covers the *algebraic* graph
rewrites those rules express (fusing linear+linear, reordering ops), applied
as a pre-pass over the PCG, and gives ``--substitution-json`` parity: rules
loaded from a JSON file are matched against the PCG and applied when the
simulator says they help.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from ..ffconst import OperatorType
from ..parallel.pcg import PCG, PCGNode

# name map (reference: substitution_loader.h operator-name table)
_NAME_TO_OP = {
    "OP_LINEAR": OperatorType.OP_LINEAR,
    "OP_CONV2D": OperatorType.OP_CONV2D,
    "OP_RELU": OperatorType.OP_RELU,
    "OP_SIGMOID": OperatorType.OP_SIGMOID,
    "OP_TANH": OperatorType.OP_TANH,
    "OP_EW_ADD": OperatorType.OP_EW_ADD,
    "OP_EW_MUL": OperatorType.OP_EW_MUL,
    "OP_MATMUL": OperatorType.OP_BATCHMATMUL,
    "OP_BATCHMATMUL": OperatorType.OP_BATCHMATMUL,
    "OP_CONCAT": OperatorType.OP_CONCAT,
    "OP_SPLIT": OperatorType.OP_SPLIT,
    "OP_RESHAPE": OperatorType.OP_RESHAPE,
    "OP_TRANSPOSE": OperatorType.OP_TRANSPOSE,
    "OP_SOFTMAX": OperatorType.OP_SOFTMAX,
    "OP_REPARTITION": OperatorType.OP_REPARTITION,
    # the TASO collection's names for the parallel ops
    # (substitution_loader.h's table): OP_PARTITION == Repartition,
    # OP_REDUCE == Reduction
    "OP_PARTITION": OperatorType.OP_REPARTITION,
    "OP_COMBINE": OperatorType.OP_COMBINE,
    "OP_REPLICATE": OperatorType.OP_REPLICATE,
    "OP_REDUCTION": OperatorType.OP_REDUCTION,
    "OP_REDUCE": OperatorType.OP_REDUCTION,
    "OP_MULTIHEAD_ATTENTION": OperatorType.OP_MULTIHEAD_ATTENTION,
}


@dataclasses.dataclass
class OpX:
    """Pattern node (reference: substitution.h:64-110): an op type plus
    input slots referencing other pattern nodes (by index) or open inputs
    (negative).

    src side: ``attr_constraints`` filters matches — a value, a tuple of
    admissible values, or a callable predicate.
    dst side: ``attrs_from`` names the src OpX index whose matched node's
    attrs seed the new op (default: first src OpX of the same type), then
    ``attr_overrides`` are applied on top."""

    op_type: OperatorType
    inputs: List[int]  # >=0: OpX index in pattern; <0: open input slot
    attr_constraints: Dict[str, Any] = dataclasses.field(default_factory=dict)
    attrs_from: Optional[int] = None
    attr_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def constraint_ok(self, attrs: Dict[str, Any]) -> bool:
        for k, v in self.attr_constraints.items():
            got = attrs.get(k)
            if callable(v):
                if not v(got):
                    return False
            elif isinstance(v, tuple):
                if got not in v:
                    return False
            elif got != v:
                return False
        return True


@dataclasses.dataclass
class GraphXfer:
    """A source pattern -> destination pattern rewrite."""

    name: str
    src: List[OpX]
    dst: List[OpX]
    # map dst open-input slots to src open-input slots (identity by default)

    def find_matches(self, pcg: PCG) -> List[Dict[int, int]]:
        """Return list of {pattern_idx -> node_guid} matches. Pattern edges
        must map to PCG edges; matched interior nodes must have no external
        consumers (reference: GraphXfer::can_match)."""
        matches = []
        nodes = pcg.compute_nodes()
        by_type: Dict[OperatorType, List[PCGNode]] = {}
        for n in nodes:
            by_type.setdefault(n.op.op_type, []).append(n)

        def backtrack(i: int, mapping: Dict[int, int],
                      open_bind: Dict[int, tuple]):
            if i == len(self.src):
                matches.append(dict(mapping))
                return
            px = self.src[i]
            for cand in by_type.get(px.op_type, []):
                if cand.guid in mapping.values():
                    continue
                ok = True
                bound_here = []
                for slot, pin in enumerate(px.inputs):
                    if pin >= 0:
                        if slot >= len(cand.inputs) or \
                                cand.inputs[slot][0] != mapping.get(pin):
                            ok = False
                            break
                    elif slot < len(cand.inputs):
                        # open slots with the same id are the SAME external
                        # tensor (TASO rules share weights/inputs this way)
                        # — every occurrence must bind to one producer
                        prod = cand.inputs[slot]
                        if pin in open_bind:
                            if open_bind[pin] != prod:
                                ok = False
                                break
                        else:
                            open_bind[pin] = prod
                            bound_here.append(pin)
                if ok and not px.constraint_ok(cand.op.attrs):
                    ok = False
                if ok:
                    mapping[i] = cand.guid
                    backtrack(i + 1, mapping, open_bind)
                    del mapping[i]
                for pin in bound_here:
                    del open_bind[pin]
                bound_here.clear()

        backtrack(0, {}, {})
        # interior nodes (consumed inside the pattern) must have no external
        # consumers
        out = []
        for m in matches:
            interior = set()
            for px in self.src:
                for pin in px.inputs:
                    if pin >= 0:
                        interior.add(m[pin])
            valid = all(
                all(c in m.values() for c in pcg.consumers(g))
                for g in interior)
            if valid:
                out.append(m)
        return out

    def apply(self, pcg: PCG, match: Dict[int, int],
              return_touched: bool = False):
        """Apply the rewrite on a copy of ``pcg`` (reference:
        GraphXfer::run, substitution.cc — create_new_operator + rewire).

        Convention: the LAST src OpX is the pattern's output node; its
        external consumers are rewired to the LAST dst node's output 0. Open
        input slots bind to the matched nodes' actual producers. The new op's
        attrs come from ``attrs_from`` (see OpX) so shape-bearing parameters
        (out_dim, num_heads, ...) carry over. Shapes must be preserved by the
        rule — verified, ValueError otherwise.

        With ``return_touched`` the result is ``(graph, touched_guids)``
        where ``touched_guids`` are the newly created nodes — the seed of
        the delta-cost engine's dirty set (best_first_optimize re-costs
        only them plus their descendants; the matched nodes are deleted, and
        every rewired consumer is a descendant of a touched node)."""
        from ..ops.base import op_class_for

        g = pcg.copy()
        # open-input bindings: pattern slot id -> (producer_guid, out_idx)
        bindings: Dict[int, tuple] = {}
        for i, px in enumerate(self.src):
            node = g.nodes[match[i]]
            for slot, pin in enumerate(px.inputs):
                if pin < 0 and slot < len(node.inputs):
                    bindings[pin] = node.inputs[slot]

        out_src_guid = match[len(self.src) - 1]
        old_out = g.nodes[out_src_guid]

        new_nodes = []
        for j, dx in enumerate(self.dst):
            src_idx = dx.attrs_from
            if src_idx is None:
                for i, px in enumerate(self.src):
                    if px.op_type == dx.op_type:
                        src_idx = i
                        break
            attrs = dict(g.nodes[match[src_idx]].op.attrs) \
                if src_idx is not None else {}
            attrs.update(dx.attr_overrides)
            template = g.nodes[match[src_idx]] if src_idx is not None \
                else old_out
            inputs = []
            for pin in dx.inputs:
                if pin >= 0:
                    inputs.append((new_nodes[pin].guid, 0))
                else:
                    if pin not in bindings:
                        raise ValueError(
                            f"{self.name}: unbound open input {pin}")
                    inputs.append(bindings[pin])
            # the output node inherits its attrs-template's name: it carries
            # that node's weights (e.g. the fused Linear keeps the original
            # Linear's name), so name-keyed weight mapping — frontends'
            # copy_torch_weights, checkpoints — survives the rewrite
            if j == len(self.dst) - 1 and src_idx is not None:
                name = template.op.name
            else:
                name = f"{self.name}_{j}_g{old_out.guid}"
            op = op_class_for(dx.op_type)(
                name, attrs, template.op.data_type, num_inputs=len(inputs))
            node = g.add_node(op, inputs)
            new_nodes.append(node)

        new_out = new_nodes[-1]
        if new_out.out_shapes[0] != old_out.out_shapes[0]:
            raise ValueError(
                f"{self.name}: rewrite changes output shape "
                f"{old_out.out_shapes[0]} -> {new_out.out_shapes[0]}")
        # rewire external consumers of the pattern output
        for n in g.nodes.values():
            if n.guid == new_out.guid:
                continue
            n.inputs = [(new_out.guid, i) if pg == out_src_guid
                        else (pg, i) for pg, i in n.inputs]
        # drop all matched nodes
        for guid in match.values():
            del g.nodes[guid]
            g._order.remove(guid)
        g.retopo()
        if return_touched:
            return g, tuple(n.guid for n in new_nodes)
        return g


def load_substitution_json(path: str) -> List[GraphXfer]:
    """Parse a TASO-style rule collection (reference:
    substitution_loader.cc `from_json`; format: {"rule": [{"name", "srcOp":
    [{"type", "input": [{"opId","tsId"}], "para": [...]}], "dstOp": [...]}]}).
    Unknown op types or parameter values skip the rule (the reference does
    the same for ops it can't map)."""
    with open(path) as f:
        data = json.load(f)
    rules = data.get("rule", data.get("rules", []))
    xfers: List[GraphXfer] = []
    for rule in rules:
        try:
            src_json = rule.get("srcOp", [])
            src = _parse_ops(src_json)
            # first same-type src op's raw PM params — the template a dst op
            # inherits its attrs from (OpX.attrs_from default). Dropping a
            # dst-side PM_* key is only sound when it RESTATES the
            # template's value; _parse_ops rejects the rule otherwise.
            src_pm: Dict[OperatorType, Dict[str, Any]] = {}
            for op in src_json:
                t = _NAME_TO_OP.get(op.get("type"))
                if t is not None and t not in src_pm:
                    src_pm[t] = {str(p["key"]): p["value"]
                                 for p in op.get("para", [])
                                 if "key" in p and "value" in p}
            dst = _parse_ops(rule.get("dstOp", []), dst=True, src_pm=src_pm)
        except KeyError:
            continue
        if src:
            xfers.append(GraphXfer(rule.get("name", f"rule{len(xfers)}"),
                                   src, dst))
    return xfers


# TASO's ActiMode encoding in the rule collection (values observed in
# graph_subst_3_v2.json: 0 and 2) -> our ActiMode. An unmapped value makes
# the RULE unparseable — silently dropping the constraint would let an
# activation-fusing rule delete a relu without fusing it (review).
_TASO_ACTI = {0: None, 1: "AC_MODE_SIGMOID", 2: "AC_MODE_RELU",
              3: "AC_MODE_TANH"}


# PM_* keys that are fully enforced by the pattern structure and apply()'s
# hard output-shape check: op type comes from the record's "type", arity
# from the pattern edges, dim counts from shape inference — dropping them
# loses nothing on either side
_PM_SHAPE_ENFORCED = {"PM_OP_TYPE", "PM_NUMDIM", "PM_NUM_INPUTS",
                      "PM_NUM_OUTPUTS"}


def _parse_ops(ops_json, dst: bool = False,
               src_pm: Optional[Dict[OperatorType, Dict[str, Any]]] = None
               ) -> List[OpX]:
    """``dst=False``: parameters become match CONSTRAINTS on the src
    pattern. ``dst=True``: they become attr OVERRIDES on the new ops —
    apply() reads only attr_overrides, so dst-side attributes fed into
    constraints would be silently ignored (review). ``src_pm`` (dst side
    only) maps each src op type to its first src op's raw PM params: a dst
    op inherits its attrs from that matched node's template, so a dst-side
    PM_* key may be dropped only when it restates the template's value."""
    from ..ffconst import ActiMode

    out = []
    for op in ops_json:
        tname = op.get("type")
        if tname not in _NAME_TO_OP:
            raise KeyError(tname)
        inputs = []
        for inp in op.get("input", []):
            # negative opIds are the rule's GLOBAL open-input slots: the
            # same id appearing in several ops means the same external
            # tensor (e.g. a shared weight), so keep them verbatim —
            # renumbering per op (pre-round-5 bug) collided distinct
            # tensors AND broke src<->dst slot correspondence
            inputs.append(inp.get("opId", -1))
        attrs = {}
        for p in op.get("para", []):
            if "key" not in p or "value" not in p:
                continue
            key, val = str(p["key"]), p["value"]
            if key == "PM_ACTI":
                if val not in _TASO_ACTI:
                    raise KeyError(f"PM_ACTI={val}")
                name = _TASO_ACTI[val]
                mode = ActiMode.AC_MODE_NONE if name is None \
                    else getattr(ActiMode, name)
                # src constraint accepts both spellings of "no activation";
                # dst override must be one concrete value
                attrs["activation"] = mode if dst else (
                    (None, ActiMode.AC_MODE_NONE)
                    if name is None else mode)
            elif key.startswith("PM_"):
                if dst and key not in _PM_SHAPE_ENFORCED:
                    # semantics-bearing override (PM_AXIS, PM_PERM,
                    # PM_PARALLEL_*, ... — untranslated here: the reference
                    # stores them with reversed-dims indexing). Dropping it
                    # is sound ONLY when a same-type src template exists
                    # AND restates the same value — then the new op
                    # inherits the matched node's real attr. With no
                    # template the op would be built with DEFAULT attrs;
                    # with a DIFFERING value the rule deliberately changes
                    # the attr (e.g. a new transpose perm) and inheritance
                    # would apply the old one — either way a
                    # shape-preserving mismatch (square dims, equal-size
                    # axes) could slip a semantically wrong rewrite past
                    # the cost gate. Reject the rule like an unknown
                    # PM_ACTI instead of silently dropping.
                    tpl = None if src_pm is None else \
                        src_pm.get(_NAME_TO_OP[tname])
                    if tpl is None or key not in tpl or tpl[key] != val:
                        raise KeyError(f"{key}={val}")
                # src-side constraints and template-restated dst keys:
                # shape-enforced keys (PM_NUMDIM, PM_NUM_INPUTS, ...) are
                # re-checked structurally; the dims-indexed ones use the
                # reference's reversed-dims indexing, so dropping them only
                # widens matching — soundness is kept by apply()'s hard
                # output-shape check plus the cost gate
                continue
            else:
                attrs[key] = val
        if dst:
            out.append(OpX(_NAME_TO_OP[tname], inputs,
                           attr_overrides=attrs))
        else:
            out.append(OpX(_NAME_TO_OP[tname], inputs, attrs))
    return out


# ------------------------------------------------------- built-in fusion rules
def fuse_consecutive_reshapes(pcg: PCG) -> int:
    """reshape(reshape(x)) -> reshape(x) (simplification pass analog of the
    reference's Graph::simplify). Returns number of rewrites."""
    count = 0
    for node in list(pcg.compute_nodes()):
        if node.op.op_type != OperatorType.OP_RESHAPE:
            continue
        (g, i) = node.inputs[0]
        prod = pcg.nodes.get(g)
        if prod is None or prod.op.op_type != OperatorType.OP_RESHAPE:
            continue
        if len(pcg.consumers(g)) != 1:
            continue
        node.inputs[0] = prod.inputs[0]
        del pcg.nodes[g]
        pcg._order.remove(g)
        count += 1
    return count


def builtin_xfers() -> List[GraphXfer]:
    """Hand-registered rewrite rules mirroring the reference's manual xfers
    (substitution.cc:3041-3226). The parallelization variants
    (partition/replicate + combine) are realized natively by the DP search's
    sharding states (unity.node_options); the algebraic rules here fuse a
    Linear with a following activation into the Linear's fused-activation
    form (the reference's cuBLAS GEMM + fused activation epilogue,
    src/ops/kernels/linear_kernels.cu) — applied by best_first_optimize when
    the simulator approves."""
    from ..ffconst import ActiMode

    none_act = (None, ActiMode.AC_MODE_NONE)
    xfers = []
    for act_op, mode, name in [
            (OperatorType.OP_RELU, ActiMode.AC_MODE_RELU, "relu"),
            (OperatorType.OP_SIGMOID, ActiMode.AC_MODE_SIGMOID, "sigmoid"),
            (OperatorType.OP_TANH, ActiMode.AC_MODE_TANH, "tanh"),
            (OperatorType.OP_GELU, ActiMode.AC_MODE_GELU, "gelu")]:
        xfers.append(GraphXfer(
            f"linear_{name}_fuse",
            src=[OpX(OperatorType.OP_LINEAR, [-1],
                     {"activation": none_act}),
                 OpX(act_op, [0])],
            dst=[OpX(OperatorType.OP_LINEAR, [-1], attrs_from=0,
                     attr_overrides={"activation": mode})]))
    return xfers


def apply_simplifications(pcg: PCG) -> int:
    """Run the always-beneficial simplification passes (reference:
    Graph::simplify called during optimization)."""
    return fuse_consecutive_reshapes(pcg)
