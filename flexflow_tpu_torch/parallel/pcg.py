"""Parallel Computation Graph (PCG).

Port of ``flexflow_tpu.parallel.pcg`` (reference: ``PCG::Graph``,
include/flexflow/graph.h:293): a graph of (Op, guid) nodes over edges that
carry tensor indices. The same structure serves lowering, strategies, the
remat segmentation and the Unity search, which mutates copies of it many
times (edge insertion, splitting at bottlenecks, retopo) and keys its
tables on a cheap structural hash (reference ``Graph::hash``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from ..ffconst import DataType, OperatorType
from ..machine_view import MachineView
from ..ops.base import Op

_node_guid = itertools.count(1)


@dataclasses.dataclass
class PCGNode:
    guid: int
    op: Op
    # each input is (producer_guid, producer_output_idx)
    inputs: List[Tuple[int, int]]
    out_shapes: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    out_dtypes: List[DataType] = dataclasses.field(default_factory=list)
    machine_view: Optional[MachineView] = None

    @property
    def name(self) -> str:
        return self.op.name


class PCG:
    """Node/edge container with topo order and structural hash."""

    def __init__(self):
        self.nodes: Dict[int, PCGNode] = {}
        self._order: List[int] = []  # insertion == topological order

    # -- construction -----------------------------------------------------------
    def add_node(self, op: Op, inputs: Sequence[Tuple[int, int]]) -> PCGNode:
        guid = next(_node_guid)
        in_shapes = [self.nodes[g].out_shapes[i] for g, i in inputs]
        in_dtypes = [self.nodes[g].out_dtypes[i] for g, i in inputs]
        node = PCGNode(guid=guid, op=op, inputs=list(inputs))
        if op.op_type in (OperatorType.OP_INPUT, OperatorType.OP_WEIGHT):
            node.out_shapes = [tuple(op.attrs["shape"])]
            node.out_dtypes = [op.attrs.get("dtype", DataType.DT_FLOAT)]
        else:
            node.out_shapes = [tuple(s)
                               for s in op.infer_output_shapes(in_shapes)]
            node.out_dtypes = op.output_dtypes(in_dtypes,
                                               len(node.out_shapes))
        self.nodes[guid] = node
        self._order.append(guid)
        return node

    # -- queries ----------------------------------------------------------------
    def topo_order(self) -> List[PCGNode]:
        return [self.nodes[g] for g in self._order]

    def in_edges(self, guid: int) -> List[Tuple[int, int]]:
        return self.nodes[guid].inputs

    def consumers(self, guid: int) -> List[int]:
        return [n.guid for n in self.nodes.values()
                if any(g == guid for g, _ in n.inputs)]

    def sources(self) -> List[PCGNode]:
        return [n for n in self.topo_order() if not n.inputs]

    def sinks(self) -> List[PCGNode]:
        consumed = {g for n in self.nodes.values() for g, _ in n.inputs}
        return [n for n in self.topo_order() if n.guid not in consumed]

    def input_nodes(self) -> List[PCGNode]:
        return [n for n in self.topo_order()
                if n.op.op_type == OperatorType.OP_INPUT]

    def weight_nodes(self) -> List[PCGNode]:
        return [n for n in self.topo_order()
                if n.op.op_type == OperatorType.OP_WEIGHT]

    def compute_nodes(self) -> List[PCGNode]:
        return [n for n in self.topo_order()
                if n.op.op_type not in (OperatorType.OP_INPUT,
                                        OperatorType.OP_WEIGHT)]

    def insert_node_on_edge(self, consumer_guid: int, input_idx: int,
                            op: Op) -> PCGNode:
        """Insert ``op`` on the edge feeding ``consumer_guid``'s input slot
        ``input_idx`` (reference: the search inserting parallel ops into the
        PCG, substitution.cc GraphXfer::run). The new node is placed in the
        order right before the consumer, preserving topological validity."""
        consumer = self.nodes[consumer_guid]
        g, i = consumer.inputs[input_idx]
        src = self.nodes[g]
        node = PCGNode(guid=next(_node_guid), op=op, inputs=[(g, i)],
                       out_shapes=[src.out_shapes[i]],
                       out_dtypes=[src.out_dtypes[i]])
        self.nodes[node.guid] = node
        self._order.insert(self._order.index(consumer_guid), node.guid)
        consumer.inputs[input_idx] = (node.guid, 0)
        return node

    def retopo(self) -> None:
        """Restore ``_order`` to a topological order (Kahn) after a rewrite
        appended nodes out of place."""
        indeg: Dict[int, int] = {g: 0 for g in self.nodes}
        outs: Dict[int, List[int]] = {g: [] for g in self.nodes}
        for n in self.nodes.values():
            for g, _ in n.inputs:
                indeg[n.guid] += 1
                outs[g].append(n.guid)
        ready = [g for g in self._order if indeg[g] == 0]
        order: List[int] = []
        while ready:
            g = ready.pop(0)
            order.append(g)
            for c in outs[g]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        assert len(order) == len(self.nodes), "cycle after rewrite"
        self._order = order

    # -- structural hash (reference: Graph::hash) -------------------------------
    def hash(self) -> int:
        h = 17
        remap = {g: i for i, g in enumerate(self._order)}
        for g in self._order:
            n = self.nodes[g]
            key = (n.op.params_key(),
                   tuple((remap[pg], pi) for pg, pi in n.inputs),
                   n.machine_view.hash() if n.machine_view else 0)
            h = hash((h, key))
        return h

    def copy(self) -> "PCG":
        import copy as _copy

        g = PCG()
        g.nodes = {k: dataclasses.replace(
            v, inputs=list(v.inputs), out_shapes=list(v.out_shapes),
            out_dtypes=list(v.out_dtypes)) for k, v in self.nodes.items()}
        g._order = list(self._order)
        return g

    # -- search-time splitting (reference: Graph::split_at_node,
    # src/runtime/graph.cc:958) -------------------------------------------------
    def split_at_node(self, guid: int) -> Tuple["PCG", "PCG"]:
        """Split into (pre, post) subgraphs at a bottleneck node: ``pre``
        contains the node and everything it depends on; ``post`` contains
        the rest, with the bottleneck's producers re-rooted as inputs."""
        assert guid in self.nodes, guid
        anc: set = set()
        stack = [guid]
        while stack:
            g = stack.pop()
            if g in anc:
                continue
            anc.add(g)
            stack.extend(pg for pg, _ in self.nodes[g].inputs)
        pre, post = PCG(), PCG()
        for g in self._order:
            n = self.nodes[g]
            target = pre if g in anc else post
            target.nodes[g] = dataclasses.replace(
                n, inputs=list(n.inputs), out_shapes=list(n.out_shapes),
                out_dtypes=list(n.out_dtypes))
            target._order.append(g)
        # post-side consumers of pre-side nodes keep the guid reference;
        # materialize those producers as input placeholders in `post`
        from ..ops.noop import InputOp

        needed = {pg for g in post._order for pg, _ in post.nodes[g].inputs
                  if pg in anc}
        for pg in sorted(needed):
            src = self.nodes[pg]
            op = InputOp(name=f"split_in_{pg}",
                         attrs={"shape": src.out_shapes[0],
                                "dtype": src.out_dtypes[0]},
                         dtype=src.out_dtypes[0], num_inputs=0)
            node = PCGNode(guid=pg, op=op, inputs=[],
                           out_shapes=list(src.out_shapes),
                           out_dtypes=list(src.out_dtypes))
            post.nodes[pg] = node
            post._order.insert(0, pg)
        return pre, post

    def bottlenecks(self) -> List[int]:
        """Compute-node guids every source-to-sink path passes through
        (reference: find_bottleneck_node via imm_post_dominators,
        graph.cc:610-623)."""
        from ..utils.graph_utils import find_bottlenecks, pcg_basic_graph

        g = pcg_basic_graph(self)
        sinks = set(x.guid for x in self.sinks())
        return [b for b in find_bottlenecks(g) if b not in sinks]

    # -- observability (reference: export_strategy_computation_graph) -----------
    def to_dot(self, include_costs: bool = False, costs=None) -> str:
        lines = ["digraph PCG {"]
        for n in self.topo_order():
            label = f"{n.name}\\n{n.op.op_type.name}"
            if n.machine_view:
                label += f"\\nview={n.machine_view.dim}"
            if include_costs and costs and n.guid in costs:
                label += f"\\ncost={costs[n.guid]:.1f}us"
            lines.append(f'  n{n.guid} [label="{label}"];')
            for pg, pi in n.inputs:
                lines.append(f"  n{pg} -> n{n.guid} [label=\"{pi}\"];")
        lines.append("}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self.nodes)
