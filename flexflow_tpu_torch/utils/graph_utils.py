"""Graph algorithms on a minimal adjacency protocol (a copy of
``flexflow_tpu.utils.graph_utils``; reference: include/flexflow/
dominators.h:205-261, basic_graph.h, graph_structures.h,
utils/disjoint_set.h).

A *bottleneck* node is one that every source-to-sink path passes through
(reference: Graph::find_bottleneck_node, src/runtime/graph.cc:610-623):
its output is the only live tensor at a cut there, so remat blocks end
at bottlenecks (``execution/remat.py``) and pipeline stage cuts snap to
them (``parallel/pipeline.split_stages``). Immediate (post-)dominators
come from the dominator sets (the JAX package's native fast path for
large graphs belongs with the search); ``transitive_reduction`` and
``DisjointSet`` are the reference's graph helpers.
"""
from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, List, Optional, Set, \
    Tuple, TypeVar

N = TypeVar("N", bound=Hashable)


class BasicGraph(Generic[N]):
    """Minimal directed-graph container (reference: basic_graph.h)."""

    def __init__(self, nodes: Iterable[N] = (),
                 edges: Iterable[Tuple[N, N]] = ()):
        self.nodes: Set[N] = set(nodes)
        self._out: Dict[N, Set[N]] = {}
        self._in: Dict[N, Set[N]] = {}
        for u, v in edges:
            self.add_edge(u, v)

    def add_node(self, n: N) -> None:
        self.nodes.add(n)

    def add_edge(self, u: N, v: N) -> None:
        self.nodes.add(u)
        self.nodes.add(v)
        self._out.setdefault(u, set()).add(v)
        self._in.setdefault(v, set()).add(u)

    def out_edges(self, n: N) -> Set[N]:
        return self._out.get(n, set())

    def in_edges(self, n: N) -> Set[N]:
        return self._in.get(n, set())

    def sources(self) -> List[N]:
        return [n for n in self.nodes if not self._in.get(n)]

    def sinks(self) -> List[N]:
        return [n for n in self.nodes if not self._out.get(n)]

    def reversed(self) -> "BasicGraph[N]":
        g: BasicGraph[N] = BasicGraph(self.nodes)
        for u, vs in self._out.items():
            for v in vs:
                g.add_edge(v, u)
        return g

    def topo_order(self) -> List[N]:
        indeg = {n: len(self._in.get(n, ())) for n in self.nodes}
        # deterministic order, as the JAX package's
        ready = sorted((n for n, d in indeg.items() if d == 0), key=repr)
        out: List[N] = []
        while ready:
            n = ready.pop(0)
            out.append(n)
            for v in sorted(self._out.get(n, ()), key=repr):
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(out) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return out


def dominators(g: BasicGraph[N]) -> Dict[N, Set[N]]:
    """node -> set of its dominators, incl. itself (dominators.h:205):
    d dominates n iff every path from any source to n passes through d.
    Iterative dataflow over the topological order; several sources get an
    implicit virtual root."""
    dom: Dict[N, Set[N]] = {}
    for n in g.topo_order():
        preds = g.in_edges(n)
        if not preds:
            dom[n] = {n}
            continue
        common: Optional[Set[N]] = None
        for p in preds:
            common = set(dom[p]) if common is None else (common & dom[p])
        dom[n] = (common or set()) | {n}
    return dom


def post_dominators(g: BasicGraph[N]) -> Dict[N, Set[N]]:
    """node -> set of its post-dominators (dominators on the reverse
    graph; dominators.h:230)."""
    return dominators(g.reversed())


def _imm_from_sets(g: BasicGraph[N], doms: Dict[N, Set[N]],
                   order: List[N]) -> Dict[N, N]:
    """Immediate dominator = the strict dominator that appears latest in
    the topological order (reference: imm_dominators picks via topo
    position)."""
    pos = {n: i for i, n in enumerate(order)}
    imm: Dict[N, N] = {}
    for n in g.nodes:
        strict = [d for d in doms[n] if d != n]
        imm[n] = max(strict, key=lambda d: pos[d]) if strict else n
    return imm


def imm_dominators(g: BasicGraph[N]) -> Dict[N, N]:
    """node -> its immediate dominator (itself for sources;
    dominators.h:246)."""
    return _imm_from_sets(g, dominators(g), g.topo_order())


def imm_post_dominators(g: BasicGraph[N]) -> Dict[N, N]:
    """node -> its immediate post-dominator (itself for sinks;
    dominators.h:253)."""
    rev = g.reversed()
    return _imm_from_sets(rev, dominators(rev), rev.topo_order())


def transitive_reduction(g: BasicGraph[N]) -> BasicGraph[N]:
    """Remove edges implied by longer paths (reference: Graph::reduced,
    include/flexflow/graph.h:352). DAG only."""
    order = g.topo_order()
    pos = {n: i for i, n in enumerate(order)}
    # reach[n] = nodes reachable from n (excl. n)
    reach: Dict[N, Set[N]] = {n: set() for n in g.nodes}
    for n in reversed(order):
        for v in g.out_edges(n):
            reach[n].add(v)
            reach[n] |= reach[v]
    out: BasicGraph[N] = BasicGraph(g.nodes)
    for u in g.nodes:
        succs = sorted(g.out_edges(u), key=lambda v: pos[v])
        for v in succs:
            # edge u->v is redundant if v reachable from another successor
            if any(v in reach[w] for w in succs if w != v):
                continue
            out.add_edge(u, v)
    return out


def find_bottlenecks(g: BasicGraph[N]) -> List[N]:
    """Nodes through which EVERY source-to-sink path passes, in topo order:
    a node that dominates every sink and post-dominates every source."""
    if not g.nodes:
        return []
    dom = dominators(g)
    pdom = post_dominators(g)
    sinks, srcs = g.sinks(), g.sources()
    return [n for n in g.topo_order()
            if all(n in dom[s] for s in sinks)
            and all(n in pdom[s] for s in srcs)]


class DisjointSet(Generic[N]):
    """Union-find with path compression + union by rank
    (reference: include/flexflow/utils/disjoint_set.h)."""

    def __init__(self):
        self._parent: Dict[N, N] = {}
        self._rank: Dict[N, int] = {}

    def find(self, x: N) -> N:
        if x not in self._parent:
            self._parent[x] = x
            self._rank[x] = 0
            return x
        root = x
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[x] != root:  # path compression
            self._parent[x], x = root, self._parent[x]
        return root

    def union(self, a: N, b: N) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self._rank[ra] < self._rank[rb]:
            ra, rb = rb, ra
        self._parent[rb] = ra
        if self._rank[ra] == self._rank[rb]:
            self._rank[ra] += 1

    def same(self, a: N, b: N) -> bool:
        return self.find(a) == self.find(b)

    def groups(self) -> List[Set[N]]:
        by_root: Dict[N, Set[N]] = {}
        for x in self._parent:
            by_root.setdefault(self.find(x), set()).add(x)
        return list(by_root.values())


def pcg_basic_graph(pcg, compute_only: bool = True) -> BasicGraph[int]:
    """A PCG as a BasicGraph of guids (reference: the GraphStructure
    adapter, graph_structures.h)."""
    g: BasicGraph[int] = BasicGraph()
    nodes = pcg.compute_nodes() if compute_only else pcg.topo_order()
    keep = {n.guid for n in nodes}
    for n in nodes:
        g.add_node(n.guid)
        for pg, _ in n.inputs:
            if pg in keep:
                g.add_edge(pg, n.guid)
    return g
