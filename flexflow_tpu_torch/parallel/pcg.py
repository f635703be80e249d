"""Parallel Computation Graph (PCG).

Port of ``flexflow_tpu.parallel.pcg`` (reference: ``PCG::Graph``,
include/flexflow/graph.h:293): a graph of (Op, guid) nodes over edges that
carry tensor indices. It keeps what lowering, strategies and the remat
segmentation need — construction, topological order, sources/sinks,
bottlenecks — and leaves the search-time mutations (edge insertion,
splitting, structural hashing) to the search slice.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence, Tuple

from ..ffconst import DataType, OperatorType
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

    @property
    def name(self) -> str:
        return self.op.name


class PCG:
    """Node/edge container in insertion (== topological) order."""

    def __init__(self):
        self.nodes: Dict[int, PCGNode] = {}
        self._order: List[int] = []

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

    def topo_order(self) -> List[PCGNode]:
        return [self.nodes[g] for g in self._order]

    def sinks(self) -> List[PCGNode]:
        consumed = {g for n in self.nodes.values() for g, _ in n.inputs}
        return [n for n in self.topo_order() if n.guid not in consumed]

    def input_nodes(self) -> List[PCGNode]:
        return [n for n in self.topo_order()
                if n.op.op_type == OperatorType.OP_INPUT]

    def compute_nodes(self) -> List[PCGNode]:
        return [n for n in self.topo_order()
                if n.op.op_type not in (OperatorType.OP_INPUT,
                                        OperatorType.OP_WEIGHT)]

    def bottlenecks(self) -> List[int]:
        """Compute-node guids every source-to-sink path passes through
        (reference: find_bottleneck_node via imm_post_dominators,
        graph.cc:610-623), sinks excluded."""
        from ..utils.graph_utils import find_bottlenecks, pcg_basic_graph

        sinks = set(x.guid for x in self.sinks())
        return [b for b in find_bottlenecks(pcg_basic_graph(self))
                if b not in sinks]

    def __len__(self) -> int:
        return len(self.nodes)
