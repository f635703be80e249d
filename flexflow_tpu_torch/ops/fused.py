"""Operator fusion: FusedOp regions and the ``apply_fusion`` compile pass
(port of ``flexflow_tpu.ops.fused``; reference: ``FFModel::apply_fusion``,
src/runtime/model.cc:2495, and the FusedOp interpreter,
src/ops/fused.cc:117).

``--fusion`` merges single-consumer chains of ops into one ``FusedOp``
node each, with the JAX pass's rule, names and weight namespaces, so a
fused model's parameters move 1:1 between the two packages
(``set_params_numpy`` / ``get_params_numpy``, checkpoints). The sub-ops
run one after another inside the step, as the JAX region's do inside its
jitted step, so a fused step launches the same kernels as an unfused one;
the captured step program is what cuts the host's per-op launch cost
here. Dropout seeds are drawn from the step's seed source in sub-op order
(the JAX region folds ``ctx.rng`` with the sub-op's position instead; the
port's streams differ from ``jax.random``'s everywhere). ``flops`` sums
the sub-ops', so MFU does not change under ``--fusion``. The JAX op's
``memory_bytes`` and ``params_key`` serve the search's cost model and
come with it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

from ..ffconst import DataType, OperatorType
from .base import (Op, OpContext, op_flops, profiler_on, register_op,
                   run_op)

# wiring entry: ("ext", input_idx, 0) region input | ("sub", pos, out_idx)
WireT = Tuple[str, int, int]


@register_op(OperatorType.OP_FUSED)
class FusedOp(Op):
    """A region of sub-ops executed as one node.

    attrs:
      sub_ops:  List[Op] in execution order
      wiring:   List[List[WireT]] — per sub-op, where each input comes from
    """

    def __init__(self, name: str, attrs: Dict[str, Any], dtype: DataType,
                 num_inputs: int = 1):
        super().__init__(name, attrs, dtype, num_inputs)
        self.sub_ops: List[Op] = list(attrs["sub_ops"])
        self.wiring: List[List[WireT]] = [list(w) for w in attrs["wiring"]]

    # one weight namespace per sub-op position (fused.cc:117)
    @staticmethod
    def _prefix(i: int, sub: Op) -> str:
        return f"sub{i}:{sub.name}:"

    # -- shape plumbing through the region ----------------------------------
    def _sub_in_shapes(self, input_shapes, sub_out_shapes, i):
        return [input_shapes[j] if kind == "ext" else sub_out_shapes[j][k]
                for kind, j, k in self.wiring[i]]

    def _trace_shapes(self, input_shapes):
        sub_out_shapes: List[List[Tuple[int, ...]]] = []
        for i, sub in enumerate(self.sub_ops):
            ins = self._sub_in_shapes(input_shapes, sub_out_shapes, i)
            sub_out_shapes.append(
                [tuple(s) for s in sub.infer_output_shapes(ins)])
        return sub_out_shapes

    def sub_op_shapes(self, input_shapes):
        """``[(sub_op, its input shapes, its output shapes)]`` in region
        order (``op_flops`` walks them)."""
        sub_out_shapes = self._trace_shapes(input_shapes)
        return [(sub, self._sub_in_shapes(input_shapes, sub_out_shapes, i),
                 sub_out_shapes[i]) for i, sub in enumerate(self.sub_ops)]

    def infer_output_shapes(self, input_shapes):
        return self._trace_shapes(input_shapes)[-1]

    def output_dtype(self, input_dtypes):
        return self.sub_ops[-1].data_type

    def weight_specs(self, input_shapes):
        specs = {}
        for i, (sub, ins, _outs) in enumerate(
                self.sub_op_shapes(input_shapes)):
            for wname, spec in sub.weight_specs(ins).items():
                specs[self._prefix(i, sub) + wname] = spec
        return specs

    def forward(self, params, inputs, ctx: OpContext):
        # sub-op ranges under a profiler, as the JAX region opens a named
        # scope per sub-op: a trace attributes the region's work to them
        scoped = profiler_on()
        sub_outs: List[List[Any]] = []
        for i, sub in enumerate(self.sub_ops):
            ins = [inputs[j] if kind == "ext" else sub_outs[j][k]
                   for kind, j, k in self.wiring[i]]
            pfx = self._prefix(i, sub)
            sub_params = {k[len(pfx):]: v for k, v in params.items()
                          if k.startswith(pfx)}
            sub_outs.append(run_op(sub, sub.name, sub_params, ins, ctx,
                                   scoped))
        return sub_outs[-1]

    def flops(self, input_shapes, output_shapes):
        return op_flops(self, input_shapes, output_shapes)


# ------------------------------------------------------------------ the pass
_FUSE_EXCLUDED = {
    OperatorType.OP_INPUT, OperatorType.OP_WEIGHT, OperatorType.OP_FUSED,
    OperatorType.OP_CACHE,  # stateful across iterations
    OperatorType.OP_REPARTITION, OperatorType.OP_COMBINE,
    OperatorType.OP_REPLICATE, OperatorType.OP_REDUCTION,
    OperatorType.OP_FUSED_PARALLEL, OperatorType.OP_PIPELINE,
    OperatorType.OP_ALLTOALL,
}


def _eligible(node) -> bool:
    """The JAX pass's rule on one device, where no strategy pins a node:
    an op outside ``_FUSE_EXCLUDED`` with one output."""
    return node.op.op_type not in _FUSE_EXCLUDED and \
        len(node.out_shapes) == 1


def apply_fusion(pcg, max_region: int = 16, barrier_guids=()):
    """Merge single-consumer chains of ops into FusedOp nodes
    (flexflow_tpu/ops/fused.py:157-267; model.cc:2965-3040).

    Returns (new_pcg, n_fused_regions, remap) where remap maps old guid ->
    (new guid, out idx) — out idx -1 meaning "original indices preserved".
    ``barrier_guids``: nodes whose outputs must stay addressable (the
    compile final anchor) — a chain never extends past them, so they end
    up either unfused or as a region tail (whose output is the
    FusedOp's)."""
    from ..parallel.pcg import PCG, PCGNode, _node_guid

    barriers = set(barrier_guids)
    consumers: Dict[int, List[int]] = {}
    for n in pcg.topo_order():
        for g, _ in n.inputs:
            consumers.setdefault(g, []).append(n.guid)

    # build chains greedily along sole-consumer edges
    in_chain: Dict[int, int] = {}  # guid -> chain id
    chains: List[List[int]] = []
    for node in pcg.topo_order():
        if node.guid in in_chain or not _eligible(node):
            continue
        chain = [node.guid]
        cur = node
        while len(chain) < max_region and cur.guid not in barriers:
            cons = consumers.get(cur.guid, [])
            if len(cons) != 1:
                break
            nxt = pcg.nodes[cons[0]]
            # `nxt` must consume cur exactly once and be eligible
            if not _eligible(nxt) or nxt.guid in in_chain:
                break
            if sum(1 for g, _ in nxt.inputs if g == cur.guid) != 1:
                break
            chain.append(nxt.guid)
            cur = nxt
        if len(chain) >= 2:
            cid = len(chains)
            chains.append(chain)
            for g in chain:
                in_chain[g] = cid

    if not chains:
        return pcg, 0, {g: (g, -1) for g in pcg.nodes}

    # rebuild the graph, replacing each chain with one FusedOp node
    new = PCG()
    remap: Dict[int, Tuple[int, int]] = {}  # old guid -> (new guid, out idx)
    for node in pcg.topo_order():
        cid = in_chain.get(node.guid)
        if cid is None:
            # non-fused producers keep their output indices (-1 marker);
            # fused producers collapse to output 0
            nn = PCGNode(guid=node.guid, op=node.op,
                         inputs=[(remap[g][0],
                                  i if remap[g][1] < 0 else remap[g][1])
                                 for g, i in node.inputs],
                         out_shapes=list(node.out_shapes),
                         out_dtypes=list(node.out_dtypes))
            new.nodes[nn.guid] = nn
            new._order.append(nn.guid)
            remap[node.guid] = (node.guid, -1)  # -1: keep original out idx
            continue
        chain = chains[cid]
        if node.guid != chain[-1]:
            # emit the region at its LAST member: every external producer of
            # every member is topologically earlier, so remap is complete
            continue
        members = [pcg.nodes[g] for g in chain]
        member_pos = {g: i for i, g in enumerate(chain)}
        ext_inputs: List[Tuple[int, int]] = []  # (old guid, out idx)
        ext_index: Dict[Tuple[int, int], int] = {}
        wiring: List[List[WireT]] = []
        for m in members:
            ws: List[WireT] = []
            for g, i in m.inputs:
                if g in member_pos:
                    ws.append(("sub", member_pos[g], i))
                else:
                    key = (g, i)
                    if key not in ext_index:
                        ext_index[key] = len(ext_inputs)
                        ext_inputs.append(key)
                    ws.append(("ext", ext_index[key], 0))
            wiring.append(ws)
        tail = members[-1]
        fused = FusedOp(
            name="fused_" + "+".join(m.name for m in members),
            attrs={"sub_ops": [m.op for m in members], "wiring": wiring},
            dtype=tail.op.data_type, num_inputs=len(ext_inputs))
        guid = next(_node_guid)
        nn = PCGNode(
            guid=guid, op=fused,
            inputs=[(remap[g][0], i if remap[g][1] < 0 else remap[g][1])
                    for g, i in ext_inputs],
            out_shapes=list(tail.out_shapes),
            out_dtypes=list(tail.out_dtypes))
        new.nodes[guid] = nn
        new._order.append(guid)
        for g in chain:
            remap[g] = (guid, 0)
    return new, len(chains), remap
