"""Unity-style auto-parallelization search (a copy of
``flexflow_tpu.search.unity`` on the port's PCG, ops and ``Strategy``).

Rebuild of the reference's search stack (SURVEY §2.1 L4a): GraphSearchHelper's
outer substitution loop (substitution.cc:1898, base_optimize :2229),
SearchHelper's DP over per-node MachineViews (graph.h:170-283), memory-aware λ
search (graph.cc:2060-2133), and the legacy MCMC fallback (model.cc:3285).

TPU-native reformulation (SURVEY §7): the reference searches over graph
substitutions that insert partition/combine/replicate/reduction nodes and
assigns 1-D divisor-degree MachineViews (register_all_machine_views,
graph.cc:2329). Under XLA SPMD that space is: (a) a mesh factorization
(dp, tp) of the chip count, and (b) a per-op choice of how the tp axis is
applied, with resharding transitions between choices. The per-op state is the
activation's sharding class:

  'R'  batch-sharded over dp only (replicated over the model axis)
  'S'  additionally sharded over the hidden (last) dim      — Megatron TP
  'Q'  additionally sharded over the sequence dim           — sequence/SP

and the per-op kinds: none | col | row | heads | table | expert | ring.
Transitions pay the collective the matching parallel op would run
(Repartition = free slice, Combine = all-gather, AllToAll for S<->Q —
src/parallel_ops/), and ``insert_parallel_ops`` materializes those transitions
as first-class parallel-op PCG nodes, matching the reference's search output.

  outer best-first loop over GraphXfer rewrites  == base_optimize
  outer loop over (dp, tp) factorizations        == enumerating MachineViews
  per-graph DP over {R,S,Q} sharding states      == graph_cost<T>
  transition costs from the Simulator            == estimate_xfer_cost
  alpha pruning + budget                         == base_optimize's prune
  memory λ binary search                         == graph_optimize_task λ loop
  remat level (none|selective|full) per strategy == beyond ref (docs/remat.md)
  MCMC fallback                                  == FFModel::mcmc_optimize

The output is a Strategy (per-op shardings) — the artifact the reference
serializes as optimal_views.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import random
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..ffconst import OperatorType
from ..machine_view import MachineView
from ..parallel.pcg import PCG, PCGNode
from ..parallel.strategy import Strategy
from ..utils.recursive_logger import RecursiveLogger
from .machine_model import GPUMachineModel
from .simulator import OpSharding, Simulator, selfcheck_enabled

_log = RecursiveLogger("unity")

# state-preserving ops (elementwise etc.): pass R through; pass S/Q through
# when the sharded dim divides
_STATE_PRESERVING = {
    OperatorType.OP_RELU, OperatorType.OP_GELU, OperatorType.OP_TANH,
    OperatorType.OP_SIGMOID, OperatorType.OP_ELU, OperatorType.OP_IDENTITY,
    OperatorType.OP_DROPOUT, OperatorType.OP_SCALAR_MULTIPLY,
    OperatorType.OP_SCALAR_ADD, OperatorType.OP_SCALAR_SUB,
    OperatorType.OP_SCALAR_TRUE_DIV, OperatorType.OP_CAST,
    OperatorType.OP_EXP, OperatorType.OP_POW,
}
_ELEMENTWISE_BINARY = {
    OperatorType.OP_EW_ADD, OperatorType.OP_EW_SUB, OperatorType.OP_EW_MUL,
    OperatorType.OP_EW_DIV, OperatorType.OP_EW_MAX, OperatorType.OP_EW_MIN,
}


@dataclasses.dataclass
class SearchSpace:
    """Which parallelism families the search may use. The reference's
    enable_{parameter,attribute}_parallel flags gate only the legacy MCMC
    space (linear.cc:727,777 get_random_parallel_config /
    is_valid_parallel_config); the Unity graph search always explores the full
    space — mirrored here by ``full()`` vs ``from_config()``."""

    parameter: bool = True   # col/row linear, table-sharded embedding
    attribute: bool = True   # head-parallel attention
    sequence: bool = True    # ring attention + Q states (TPU-native extension)
    expert: bool = True      # expert-parallel MoE

    @staticmethod
    def full() -> "SearchSpace":
        return SearchSpace()

    @staticmethod
    def from_config(config) -> "SearchSpace":
        return SearchSpace(
            parameter=config.enable_parameter_parallel,
            attribute=config.enable_attribute_parallel,
            sequence=getattr(config, "enable_sequence_parallel", True),
            expert=config.enable_parameter_parallel)


@dataclasses.dataclass
class RankedCandidate:
    """One entry of ``SearchResult.ranked`` — the strategy-safety layer's
    fallback chain. ``strategy_json`` is the candidate's Strategy
    serialized against its OWN (possibly rewritten) graph, so a fallback
    compile can re-map it by node name onto a freshly built PCG
    (``Strategy.from_json``); the winner (rank 0) and pipeline candidates
    carry None — the winner is already compiled, and the GPipe trainer is
    outside the cascade's SPMD re-entry path."""

    mesh_shape: Tuple[int, int]
    dcn: Tuple[int, int] = (1, 1)
    remat: str = "none"
    sim_time: float = 0.0
    sim_memory: int = 0
    feasible: bool = True
    pipeline: Optional[Tuple[int, int, int]] = None
    # pipeline schedule of the candidate: gpipe | 1f1b |
    # interleaved ("" for SPMD candidates), with the interleaved virtual
    # chunk count — distinct schedules of one grid are distinct candidates
    schedule: str = ""
    virtual_stages: int = 1
    # pod-level assignment of the hierarchical multi-pod search: (pod count,
    # "dp"|"pipeline", grad-accum factor),
    # None for flat-searched / single-pod candidates
    pods: Optional[Tuple[int, str, int]] = None
    strategy_json: Optional[str] = None

    def describe(self) -> str:
        # same vocabulary as Strategy.describe(), so a plan reads the same
        # in fallback events whether described from the chain or the model
        bits = [f"mesh={tuple(self.mesh_shape)}"]
        if self.pipeline:
            bits.append(f"pipeline={tuple(self.pipeline)}")
            from ..parallel.pipeline import describe_schedule

            sched = describe_schedule(self.schedule, self.virtual_stages)
            if sched:
                bits.append(f"schedule={sched}")
        if self.remat and self.remat != "none":
            bits.append(f"remat={self.remat}")
        if tuple(self.dcn) != (1, 1):
            bits.append(f"dcn={tuple(self.dcn)}")
        if self.pods:
            from ..parallel.strategy import describe_pods

            bits.append(describe_pods(self.pods))
        return " ".join(bits)


@dataclasses.dataclass
class SearchResult:
    strategy: Strategy
    assignment: Dict[int, OpSharding]
    sim_time: float
    sim_memory: int
    mesh_shape: Tuple[int, int]
    pcg: Optional[PCG] = None          # rewritten graph (xfers applied)
    states: Optional[Dict[int, str]] = None
    # (dp_dcn, tp_dcn): the DCN-spanning subfactor of each mesh axis on a
    # multi-host machine ((1, 1) = single slice)
    dcn: Tuple[int, int] = (1, 1)
    # activation-remat level the winning plan trains under:
    # none | selective | full — also stamped on strategy.remat so the
    # Executor/PipelineTrainer apply the matching jax.checkpoint policy
    remat: str = "none"
    # delta-cost engine telemetry, filled by unity_search: total search wall
    # seconds, number of costed candidates, and the Simulator's cache
    # hit/miss counters (bench.py's search_wall_s / search_candidates_per_s)
    search_wall_s: Optional[float] = None
    candidates: int = 0
    cache_stats: Optional[Dict] = None
    # ranked top-K candidate chain: rank 0 is the winner; the
    # rest are the best distinct runners-up, each restorable by name via
    # strategy_json — what the executor's fallback cascade degrades
    # through when the winner fails to compile / OOMs / fails the audit
    ranked: List[RankedCandidate] = dataclasses.field(default_factory=list)
    # candidates ShardLint rejected before simulation: free
    # rejections — none of these paid an op_cost/simulate call
    pruned_static: int = 0
    # pod-level assignment from the hierarchical multi-pod search
    # the pod plan: (pod count, "dp"|"pipeline", grad-accum factor); the
    # same triple is stamped on strategy.pods
    pod_plan: Optional[Tuple[int, str, int]] = None
    # hierarchical-search telemetry (docs/multipod.md): ICI sub-solution
    # memo hits/misses, DCN candidates composed, op_cost misses during
    # the DCN enumeration (the memo law's ground truth — must be 0),
    # exactly-repriced candidate count
    multipod_stats: Optional[Dict] = None
    # the WARM simulator that priced this search: the drift
    # sentinel's closed loop repairs THIS ruler in place (selective
    # delta-cost invalidation) and re-ranks `ranked` with its hot tables;
    # an elastic restart hands it back in for cache reuse
    sim: Optional[Simulator] = dataclasses.field(default=None, repr=False)


def dcn_placements(dp: int, tp: int, num_hosts: int
                   ) -> List[Tuple[int, int]]:
    """How the host factor can map onto a (dp, tp) mesh: every split
    h_dp * h_tp == num_hosts with h_dp | dp and h_tp | tp. The DCN factor of
    an axis must not split an ICI ring, so it is an outer factor (reference:
    inter-node placement in EnhancedMachineModel; jax:
    mesh_utils.create_hybrid_device_mesh's same constraint)."""
    if num_hosts <= 1:
        return [(1, 1)]
    out = []
    for h_dp in range(1, num_hosts + 1):
        if num_hosts % h_dp:
            continue
        h_tp = num_hosts // h_dp
        if dp % h_dp == 0 and tp % h_tp == 0:
            out.append((h_dp, h_tp))
    return out


def factorizations(n: int) -> List[Tuple[int, int]]:
    """(dp, tp) pairs with dp*tp == n (reference: divisor-degree views)."""
    out = []
    for tp in range(1, n + 1):
        if n % tp == 0:
            out.append((n // tp, tp))
    return out


def node_options(node: PCGNode, tp: int,
                 in_shapes: List[Tuple[int, ...]],
                 space: Optional[SearchSpace] = None
                 ) -> List[Tuple[str, str, str]]:
    """Per-op (kind, in_state, out_state) choices — the valid-MachineView
    enumeration of the reference (get_valid_machine_views, graph.h:230) over
    the TPU state space. Divisibility checks inline."""
    space = space or SearchSpace.full()
    ot = node.op.op_type
    a = node.op.attrs
    out = node.out_shapes[0] if node.out_shapes else ()

    def q_ok(shape):  # sequence dim shardable
        return len(shape) >= 3 and shape[1] % tp == 0

    def s_ok(shape):  # hidden (last) dim shardable
        return len(shape) >= 2 and shape[-1] % tp == 0

    def h_ok(shape):  # spatial height (NCHW dim 2) shardable
        return len(shape) == 4 and shape[2] % tp == 0

    opts: List[Tuple[str, str, str]] = [("none", "R", "R")]
    if tp <= 1:
        return opts
    if ot == OperatorType.OP_LINEAR:
        if space.parameter and a["out_dim"] % tp == 0:
            opts.append(("col", "R", "S"))
        if space.parameter and in_shapes and in_shapes[0][-1] % tp == 0:
            opts.append(("row", "S", "R"))
        if space.sequence and in_shapes and q_ok(in_shapes[0]) and q_ok(out):
            opts.append(("none", "Q", "Q"))  # dense is per-token
    elif ot == OperatorType.OP_MULTIHEAD_ATTENTION:
        if space.attribute and a["num_heads"] % tp == 0:
            opts.append(("heads", "R", "R"))
        if space.sequence and in_shapes and q_ok(in_shapes[0]) \
                and len(node.inputs) == 3 \
                and len({g for g, _ in node.inputs}) == 1:
            # self-attention only; dropout is fine — ring/Ulysses share the
            # flash kernel's counter-based in-kernel dropout stream
            # (kernels/ring_attention.py:49-56, ops/attention.py:113-129),
            # so the search must not refuse SP to dropout models
            opts.append(("ring", "Q", "Q"))
    elif ot == OperatorType.OP_EMBEDDING:
        if space.parameter and a["num_entries"] % tp == 0:
            opts.append(("table", "R", "R"))
    elif ot == OperatorType.OP_CONV2D:
        if space.parameter and a["out_channels"] % tp == 0:
            opts.append(("col", "R", "S"))
        if space.attribute and h_ok(out) and in_shapes \
                and h_ok(in_shapes[0]):
            # spatial (height) attribute parallelism — the reference's main
            # Unity lever for CNNs (create_mapping_xfers<Conv2D>,
            # substitution.cc:1797); XLA SPMD inserts the halo exchange
            opts.append(("spatial", "H", "H"))
    elif ot == OperatorType.OP_POOL2D:
        if space.attribute and h_ok(out) and in_shapes \
                and h_ok(in_shapes[0]):
            # create_mapping_xfers<Pool2D> (substitution.cc:1798)
            opts.append(("spatial", "H", "H"))
    elif ot == OperatorType.OP_BATCHNORM:
        if space.attribute and h_ok(out):
            # per-channel stats reduce over (b, h, w): XLA psums the
            # spatial partials — pass-through in H
            opts.append(("none", "H", "H"))
    elif ot == OperatorType.OP_EXPERTS:
        if space.expert and a["n"] % tp == 0:
            opts.append(("expert", "R", "R"))
    elif ot == OperatorType.OP_LAYERNORM:
        axes = [x % len(out) for x in a.get("axes", [len(out) - 1])] \
            if out else []
        if space.sequence and q_ok(out) and 1 not in axes:
            opts.append(("none", "Q", "Q"))
    elif ot == OperatorType.OP_SOFTMAX:
        axis = a.get("axis", -1) % len(out) if out else -1
        if space.sequence and q_ok(out) and axis != 1:
            opts.append(("none", "Q", "Q"))
    elif ot in _ELEMENTWISE_BINARY:
        if s_ok(out):
            opts.append(("none", "S", "S"))
        if space.sequence and q_ok(out):
            opts.append(("none", "Q", "Q"))
        if space.attribute and h_ok(out):
            opts.append(("none", "H", "H"))
    elif ot in _STATE_PRESERVING and len(node.inputs) == 1:
        if s_ok(out):
            opts.append(("none", "S", "S"))
        if space.sequence and q_ok(out):
            opts.append(("none", "Q", "Q"))
        if space.attribute and h_ok(out):
            opts.append(("none", "H", "H"))
    return opts


def _space_key(space: Optional[SearchSpace]) -> Tuple[bool, bool, bool, bool]:
    space = space or SearchSpace.full()
    return (space.parameter, space.attribute, space.sequence, space.expert)


def _node_cost_entries(sim: Simulator, node: PCGNode,
                       in_shapes: List[Tuple[int, ...]], dp: int, tp: int,
                       space: Optional[SearchSpace], remat: str = "none"):
    """Materialize the per-node cost table the DP mixes over: one entry
    ``(kind, in_state, out_state, time_s, resident_mem_bytes)`` per valid
    sharding option, plus the unsharded fallback row. Held in the
    Simulator's bounded LRU keyed by (op params key, in-shapes, dp, tp,
    dcn, search-space, remat level) — guid-independent, so the 24
    identical BERT layers share one entry and the table survives
    factorization sweeps, λ iterations and rewrite candidates (the
    delta-cost engine's unit of reuse; reference analog: simulator.cc's
    cached task costs). The remat level shapes both sides of the entry:
    recompute time inside ``op_cost`` (OpSharding.remat is part of ITS
    key) and the keep-fraction-scaled resident memory."""
    key = ("dp_table", node.op.params_key(), tuple(map(tuple, in_shapes)),
           dp, tp, sim.dp_dcn, sim.tp_dcn, _space_key(space), remat)
    hit = sim.table_get(key)
    if hit is not None:
        return hit
    entries = []
    for kind, in_state, out_state in node_options(node, tp, in_shapes, space):
        eff_tp = tp if kind != "none" else 1
        act_tp = tp if (kind == "none"
                        and out_state in ("S", "Q", "H")) else 1
        sh = OpSharding(dp=dp, tp=eff_tp, kind=kind, act_tp=act_tp,
                        remat=remat)
        cm = sim.op_cost(node, in_shapes, sh)
        # liveness-aware per-node resident memory — the same per-node
        # formula Simulator.simulate's peak sums; the DP objective is a
        # LOWER bound on the full peak (the global transient max-term
        # cannot decompose per node) and the λ loop's accept/reject uses
        # the full simulate() model, which includes it
        entries.append((kind, in_state, out_state, cm.total_time(),
                        sim.node_resident_bytes(node, cm, remat)))
    sh = OpSharding(dp=dp, tp=1, kind="none", remat=remat)
    cm = sim.op_cost(node, in_shapes, sh)
    value = (tuple(entries),
             ("none", "R", "R", cm.total_time(),
              sim.node_resident_bytes(node, cm, remat)))
    sim.table_put(key, value)
    return value


def dp_assign(pcg: PCG, sim: Simulator, dp: int, tp: int,
              batch_size: int, space: Optional[SearchSpace] = None,
              lam: float = 1.0, remat: str = "none"
              ) -> Tuple[Dict[int, OpSharding], Dict[int, str], float]:
    """Viterbi DP over the topo order: per node, a table keyed by output
    sharding state; transitions pay resharding collectives (reference:
    find_optimal_sequence_graph_time + estimate_xfer_cost).

    ``lam`` mixes runtime and per-chip memory into the DP objective
    (reference: the MemoryOptimConfig run_time_cost_factor,
    memory_optimization.h:24-100): obj = lam * time_ms + (1-lam) * mem_GiB.
    lam=1.0 is the pure-runtime search. The per-node (time, mem) inputs to
    the mix come from ``_node_cost_entries``' memoized tables, so re-running
    at a different λ is a pure remix: zero new ``op_cost`` calls.

    Fan-in nodes sum their producers' table costs (shared ancestors are
    counted once per branch — an over-estimate the final ``simulate`` pass
    corrects); fan-out states are chosen by the first consumer walked back,
    other consumers pay conversions. Sink nodes are pinned to state R (the
    loss consumes replicated logits, reference: final-op label matching
    model.cc:3090-3124).

    ``remat`` is the rematerialization level every emitted
    OpSharding carries: the DP's per-node (time, mem) entries are priced at
    that level, so the memory-λ mix can trade recompute flops for dropped
    activation bytes exactly like it trades collective time for sharding."""
    assignment, states, _table = _dp_core(pcg, sim, dp, tp, space, lam,
                                          remat=remat)
    sim_time = simulate_best(sim, pcg, assignment, states)
    return assignment, states, sim_time


def _dp_core(pcg: PCG, sim: Simulator, dp: int, tp: int,
             space: Optional[SearchSpace] = None, lam: float = 1.0,
             prior: Optional[Dict[int, Dict]] = None,
             dirty: Optional[Set[int]] = None, remat: str = "none"
             ) -> Tuple[Dict[int, OpSharding], Dict[int, str],
                        Dict[int, Dict]]:
    """The DP mix + backtrack behind ``dp_assign``. Returns
    (assignment, states, dp_table) so callers can reuse the table for
    incremental re-costing: with ``prior`` (the parent graph's dp_table at
    the same dp/tp/dcn/space/λ) and ``dirty`` (guids whose rows must be
    recomputed — the rewritten segment plus its resharding frontier), rows
    of clean nodes are copied verbatim. Exact, not approximate: a clean
    node's ancestor cone is untouched by construction (dirty is closed
    under descendants), so its recomputed row would be bit-identical."""
    from ..ffconst import size_of_datatype

    nodes = pcg.compute_nodes()
    sink_guids = {n.guid for n in pcg.sinks()}

    def mix(time_s: float, mem_bytes: float) -> float:
        return lam * time_s * 1e3 + (1.0 - lam) * mem_bytes / 2 ** 30

    INF = float("inf")
    # table[guid][state] = (obj, time, mem, (kind, in_state), srcs)
    table: Dict[int, Dict[str, Tuple[float, float, float, Tuple[str, str],
                                     Dict[int, str]]]] = {}
    reuse_rows = prior is not None and dirty is not None
    for node in nodes:
        if reuse_rows and node.guid not in dirty and node.guid in prior:
            table[node.guid] = prior[node.guid]
            continue
        in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        opts, fallback = _node_cost_entries(sim, node, in_shapes, dp, tp,
                                            space, remat)
        if node.guid in sink_guids:
            opts = tuple(o for o in opts if o[2] == "R") or opts

        def prev_cost(state: str
                      ) -> Tuple[float, float, float, Dict[int, str]]:
            """Sum of producers' best (obj, time, mem) to deliver ``state``,
            plus the per-producer OUTPUT state that achieved it — the
            cheapest delivery may come from a producer in a different state
            via a reshard (e.g. an R consumer fed by a Q region through one
            allgather), and backtracking must reconstruct that same choice
            or the emitted strategy silently diverges from the DP's
            objective (round-5 bug: every Q region upstream of the R-pinned
            sink collapsed to all-R at backtrack)."""
            tot_o = tot_t = tot_m = 0.0
            srcs: Dict[int, str] = {}
            for g, i in node.inputs:
                p = pcg.nodes[g]
                if p.op.op_type in (OperatorType.OP_INPUT,
                                    OperatorType.OP_WEIGHT):
                    continue
                ptab = table.get(g)
                if ptab is None:
                    continue
                nbytes = int(np.prod(p.out_shapes[i])) * \
                    size_of_datatype(p.op.data_type)
                best = None
                for src_state, (po, pt, pm, _bp, _srcs) in ptab.items():
                    if po >= INF:
                        continue
                    if g in srcs and src_state != srcs[g]:
                        # a producer reached through several edges (e.g. a
                        # multi-output split) gets ONE state: later edges
                        # must price the state the first edge committed to,
                        # or pricing and backtrack diverge again
                        continue
                    # x2: the backward pass runs the transposed resharding
                    xfer = 2 * sim.resharding_cost(nbytes, src_state, state,
                                                   dp, tp)
                    cand = (po + mix(xfer, 0.0), pt + xfer, pm, src_state)
                    if best is None or cand[0] < best[0]:
                        best = cand
                if best is None:
                    return (INF, INF, INF, srcs)
                tot_o += best[0]
                tot_t += best[1]
                tot_m += best[2]
                if g in srcs:
                    # producer obj already counted by the first edge; keep
                    # only this edge's xfer increment
                    tot_o -= ptab[srcs[g]][0]
                    tot_t -= ptab[srcs[g]][1]
                    tot_m -= ptab[srcs[g]][2]
                srcs[g] = best[3]
            return (tot_o, tot_t, tot_m, srcs)

        tab: Dict[str, Tuple[float, float, float, Tuple[str, str],
                             Dict[int, str]]] = {}
        for kind, in_state, out_state, op_time, node_mem in opts:
            base_o, base_t, base_m, srcs = prev_cost(in_state)
            if base_o >= INF:
                continue
            t = base_t + op_time
            mem = base_m + node_mem
            obj = base_o + mix(op_time, node_mem)
            if out_state not in tab or obj < tab[out_state][0]:
                tab[out_state] = (obj, t, mem, (kind, in_state), srcs)
        if not tab:  # fallback: unsharded
            _kind, _in, _out, op_time, node_mem = fallback
            base_o, base_t, base_m, srcs = prev_cost("R")
            tab["R"] = (base_o + mix(op_time, node_mem),
                        base_t + op_time, base_m + node_mem,
                        ("none", "R"), srcs)
        table[node.guid] = tab

    # backtrack: choose best final state, then walk back per node
    assignment: Dict[int, OpSharding] = {}
    states: Dict[int, str] = {}
    chosen: Dict[int, str] = {}
    for node in reversed(nodes):
        tab = table[node.guid]
        if node.guid not in chosen:
            chosen[node.guid] = min(tab, key=lambda s: tab[s][0])
        st = chosen[node.guid]
        kind, _in_state = tab[st][3]
        srcs = tab[st][4]
        eff_tp = tp if kind != "none" else 1
        act_tp = tp if (kind == "none" and st in ("S", "Q", "H")) else 1
        assignment[node.guid] = OpSharding(dp=dp, tp=eff_tp, kind=kind,
                                           act_tp=act_tp, remat=remat)
        states[node.guid] = st
        for g, _ in node.inputs:
            p = pcg.nodes[g]
            if p.op.op_type not in (OperatorType.OP_INPUT,
                                    OperatorType.OP_WEIGHT) \
                    and g not in chosen:
                ptab = table[g]
                # the producer state prev_cost actually priced (may differ
                # from the op's declared in_state when a reshard was cheaper)
                chosen[g] = srcs[g] if srcs.get(g) in ptab else \
                    min(ptab, key=lambda s: ptab[s][0])
    # the caller recomputes total time via the simulator (simulate_best) so
    # resharding edges and shared subgraphs are counted exactly once
    return assignment, states, table


_warned_once: Set[str] = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _warned_once:
        _warned_once.add(key)
        _log.warning(msg, *args)


def simulate_best(sim: Simulator, pcg: PCG,
                  assignment: Dict[int, OpSharding],
                  states: Dict[int, str]) -> float:
    """Event-driven makespan via the native core (reference:
    simulate_runtime's per-device timelines); falls back to the additive
    model only when the C++ extension is unavailable — a native-core
    runtime bug propagates rather than silently re-ranking candidates."""
    try:
        return sim.simulate_event_driven(pcg, assignment, states)
    except (ImportError, OSError) as e:
        _warn_once("native-sim", "native task-graph core unavailable (%s); "
                   "falling back to the additive cost model", e)
        return sim.simulate(pcg, assignment, states)[0]


def pipeline_microbatch_safe(pcg: PCG, batch: int) -> bool:
    """Whether GPipe microbatching preserves the graph's semantics: ops
    that bake the global batch size into their attributes or capacity math
    (reshape targets, MoE dispatch buffers, cache state) would compute
    wrong shapes on a microbatch — those graphs keep SPMD strategies."""
    unsafe_types = {OperatorType.OP_GROUP_BY, OperatorType.OP_AGGREGATE,
                    OperatorType.OP_AGG_SPEC, OperatorType.OP_EXPERTS,
                    OperatorType.OP_CACHE}
    for n in pcg.compute_nodes():
        ot = n.op.op_type
        if ot in unsafe_types:
            return False
        if ot == OperatorType.OP_RESHAPE and batch > 1:
            tgt = tuple(n.op.attrs.get("shape", ()))
            in_shape = (pcg.nodes[n.inputs[0][0]].out_shapes[n.inputs[0][1]]
                        if n.inputs else ())
            if tgt and in_shape and in_shape[0] == batch:
                # the input carries the batch: an all-explicit target bakes
                # the global batch volume (ReshapeOp asserts on a
                # microbatch), and a -1 wildcard anywhere but the leading
                # batch position silently absorbs the microbatch factor
                # into the wrong dim
                wild = [i for i, d in enumerate(tgt) if d == -1]
                if not wild:
                    return False
                per_sample = max(int(np.prod(in_shape)) // batch, 1)
                rest = int(np.prod([d for d in tgt if d != -1])) \
                    if len(tgt) > 1 else 1
                if in_shape[0] != batch or wild[0] != 0 or \
                        (rest > 0 and per_sample % rest):
                    return False
            elif tgt and isinstance(tgt[0], (int, np.integer)) and \
                    tgt[0] > 0 and tgt[0] % batch == 0:
                # input batch dim already merged away (e.g. (b*s, h)): an
                # explicit leading batch-derived target — the unflatten
                # back to (b, s, h) — still bakes the global batch
                return False
        if ot == OperatorType.OP_SLICE:
            items = n.op.attrs.get("items", ())
            if items and not (items[0][0] == "slice" and
                              items[0][1] == "none" and
                              items[0][2] == "none" and
                              items[0][3] in ("none", 1)):
                return False  # indexing/striding into the batch dim
    return True


def simulate_pipeline(sim: Simulator, pcg: PCG, pp: int, dp: int,
                      n_micro: int, remat: str = "full",
                      schedule: str = "gpipe", v: int = 1
                      ) -> Tuple[float, int]:
    """(step time, per-chip memory) for a pipelined (pp, dp) grid with
    ``n_micro`` microbatches, at stage-remat level ``remat`` (default
    ``full`` — the classic GPipe recompute-the-stage recipe) under
    ``schedule`` in {gpipe, 1f1b, interleaved} (``v`` virtual chunks per
    device for interleaved — docs/pipeline.md).

    The schedule is built as a TASK GRAPH and run through the SAME
    event-driven native engine that costs SPMD candidates (reference prices
    every strategy through simulate_runtime, simulator.cc:815 — one cost
    engine, unbiased decision boundary): per-(microbatch, chunk) forward
    and remat+backward tasks on per-device compute streams, boundary
    activation/gradient hops on per-link devices, weight-grad allreduce +
    optimizer update after each chunk's flush. 1f1b/interleaved graphs
    additionally chain each device's tasks in the order
    ``parallel.pipeline.pipeline_schedule`` emits — the SAME generator the
    trainer's host loop dispatches from, so the simulator prices exactly
    the execution order the trainer runs; the bubble (and interleaved's
    ~v-fold fill shrink) emerges from the schedule, no closed forms.
    Falls back to the additive closed form only when the native core is
    unavailable.

    Multi-host layout: device rows are laid out contiguously over the
    machine's chips, so row d's dp group occupies chips [d*dp, (d+1)*dp) —
    each row's host span (DCN factor of its gradient sync) and each
    boundary's medium (ICI within a host, DCN across) come from those
    cumulative chip positions, covering pp < hosts and hosts∤pp alike.

    Memory = the heaviest device row's weights + grads (replicated over
    its dp group) + the SCHEDULE's in-flight boundary activations
    (``pipeline_in_flight`` — n_micro for gpipe's flush, ~pp for 1f1b;
    the trainer retains exactly this set, releasing a microbatch's stage
    inputs/outputs as its backward completes) + the full-batch model
    inputs staged on their feeding rows (the trainer device_puts them
    once, microbatch-stacked) + one microbatch's backward-jit peak: the
    remat level's kept residuals (keep-fraction from
    ``Simulator.remat_keep_fraction`` — the SAME helper the SPMD memory
    model uses) plus the recompute working set. Kept residuals never span
    microbatches here — the trainer's fwd and bwd are separate jits."""
    from ..ffconst import size_of_datatype
    from ..parallel.pipeline import (build_stage_specs, pipeline_in_flight,
                                     split_stages)

    if schedule != "interleaved":
        v = 1
    n_chunks = pp * v
    stages = split_stages(pcg, n_chunks)
    machine = sim.machine
    hosts = machine.num_hosts
    cph = machine.chips_per_host

    def dev_of(c: int) -> int:
        return c % pp

    def first_host(d: int) -> int:
        return (d * dp) // cph

    def row_host_span(d: int) -> int:
        return ((d + 1) * dp - 1) // cph - first_host(d) + 1

    # per-chunk op costs, each priced at its device row's own host span;
    # the remat level rides the OpSharding so op_cost's backward includes
    # the level's recompute (full: one extra forward per op — exactly what
    # `stage_bwd += fwd + bwd` hand-rolled before remat was leveled)
    saved_topo = (sim.dp_dcn, sim.tp_dcn)
    stage_fwd = [0.0] * n_chunks
    stage_bwd = [0.0] * n_chunks  # includes the level's forward recompute
    stage_sync = [0.0] * n_chunks
    stage_upd = [0.0] * n_chunks
    stage_w = [0] * n_chunks
    stage_act = [0] * n_chunks
    stage_keep = [0] * n_chunks  # activations the remat level keeps resident
    try:
        for s in range(n_chunks):
            span = row_host_span(dev_of(s)) if hosts > 1 else 1
            sim.set_axis_topology(
                dp_dcn=span if (span > 1 and dp % span == 0) else 1)
            for g in stages[s]:
                node = pcg.nodes[g]
                in_shapes = [pcg.nodes[gg].out_shapes[i]
                             for gg, i in node.inputs]
                # a stage runs in its params' dtype, whatever the
                # compute dtype (parallel/pipeline.py)
                c = sim.op_cost(node, in_shapes,
                                OpSharding(dp=dp, remat=remat,
                                           in_params_dtype=True))
                stage_fwd[s] += c.forward_time
                # the trainer's bwd jit re-traces the stage forward at every
                # level (fwd and bwd are separate jits, residuals cannot
                # cross); under `full` op_cost already priced that recompute
                # inside backward_time — adding it again would double-count
                stage_bwd[s] += c.backward_time + (
                    c.forward_time if remat != "full" else 0.0)
                stage_sync[s] += c.sync_time
                stage_upd[s] += c.update_time
                stage_w[s] += c.weights_memory
                act = c.inputs_memory + c.outputs_memory
                stage_act[s] += act
                stage_keep[s] += int(
                    act * sim.remat_keep_fraction(node, remat))
    finally:
        sim.set_axis_topology(*saved_topo)

    # per-microbatch boundary hop time (the SAME boundary set the trainer
    # transfers — build_stage_specs exposes every cross-chunk tensor,
    # residual skips included). Interleaved pays a hop at EVERY chunk cut
    # (adjacent chunks live on different device rows) — the schedule's
    # known communication tax, priced here.
    specs = build_stage_specs(pcg, stages)
    bnd_micro = [0.0] * max(n_chunks - 1, 0)
    bnd_bytes_micro = [0] * max(n_chunks - 1, 0)  # per-microbatch bytes
    for s in range(n_chunks - 1):
        same_dev = dev_of(s) == dev_of(s + 1)
        medium = "dcn" if (hosts > 1 and
                           first_host(dev_of(s)) !=
                           first_host(dev_of(s + 1))) else "ici"
        for g, i in specs[s].outputs:
            node = pcg.nodes[g]
            # at least 1 byte: integer flooring to 0 would price the hop at
            # pure latency and make tiny cross-stage tensors free
            nbytes = max(int(np.prod(node.out_shapes[i])) *
                         size_of_datatype(node.op.data_type)
                         // (max(dp, 1) * max(n_micro, 1)), 1)
            bnd_bytes_micro[s] += nbytes
            if not same_dev:
                bnd_micro[s] += machine.p2p_time(nbytes, medium)

    m_f = [t / max(n_micro, 1) for t in stage_fwd]
    m_b = [t / max(n_micro, 1) for t in stage_bwd]

    # ---- memory: per device row, weights + grads, the schedule's
    # in-flight boundary activations, the staged full-batch inputs, and
    # one microbatch's backward-jit peak (kept residuals + recompute
    # working set — nothing kept by the policy survives across
    # microbatches: the trainer's fwd and bwd are separate jits)
    in_flight = pipeline_in_flight(schedule, pp, n_micro, v)
    row_w = [0] * pp
    row_peak = [0] * pp   # one-microbatch backward peak (keep + act)
    row_bnd = [0] * pp    # per-microbatch boundary residency (in + out)
    row_inputs = [0] * pp  # full-batch model inputs staged on the row
    input_bytes = {n.guid: max(int(np.prod(n.out_shapes[0])) *
                               size_of_datatype(n.op.data_type)
                               // max(dp, 1), 1)
                   for n in pcg.input_nodes()}
    for s in range(n_chunks):
        d = dev_of(s)
        row_w[d] += stage_w[s]
        # a row's chunks run their backwards ONE at a time (same devices),
        # so only the widest chunk's backward-jit peak is live — max, not
        # sum (summing would overcharge interleaved rows by ~v x)
        row_peak[d] = max(row_peak[d],
                          (stage_keep[s] + stage_act[s]) //
                          max(n_micro, 1))
        # boundary tensors this chunk holds per in-flight microbatch: its
        # incoming cut (stage inputs) + its outgoing cut (stage outputs,
        # kept for the backward's cotangent accumulation)
        if s > 0:
            row_bnd[d] += bnd_bytes_micro[s - 1]
        if s < n_chunks - 1:
            row_bnd[d] += bnd_bytes_micro[s]
        for feed in specs[s].feeds:
            if feed[0] == "model":
                row_inputs[d] += input_bytes.get(feed[1], 0)
    mem = max(2 * w + in_flight * bnd + peak + inp
              for w, bnd, peak, inp in
              zip(row_w, row_bnd, row_peak, row_inputs))

    try:
        # ONE builder for every schedule: per-device order chains from the
        # shared generator, so gpipe/1f1b/interleaved makespans are
        # apples-to-apples models of the trainer's real dispatch order
        # (an unchained gpipe graph lets the engine reorder a device's
        # tasks work-conservingly — slightly optimistic, and unfair to
        # the chained schedules under uneven stage costs)
        t = _pipeline_taskgraph_makespan_sched(
            pp, v, n_micro, m_f, m_b, bnd_micro, stage_sync,
            stage_upd, schedule)
    except (ImportError, OSError) as e:
        _warn_once("native-pipe-sim", "native core unavailable for the "
                   "pipeline candidate (%s); using the additive bound", e)
        micro = [f + b for f, b in zip(m_f, m_b)]
        # diagonal fill through every chunk + steady state on the busiest
        # device row (row d owns chunks d, d+pp, ... under interleaving)
        t = (sum(micro) + (n_micro - 1) * max(
            sum(micro[d::pp]) for d in range(pp))
            + 2 * n_micro * sum(bnd_micro)
            + max(s + u for s, u in zip(stage_sync, stage_upd)))
    return t, mem


def _pipeline_taskgraph_makespan(pp: int, n_micro: int,
                                 m_f: List[float], m_b: List[float],
                                 bnd_micro: List[float],
                                 stage_sync: List[float],
                                 stage_upd: List[float]) -> float:
    """Event-driven makespan of the GPipe schedule. Devices: [0, pp) stage
    compute streams, [pp, 2pp-1) boundary links, [2pp-1, 3pp-1) per-stage
    collective streams (disjoint chip groups sync concurrently)."""
    from ..native import simulate_taskgraph

    costs: List[float] = []
    devs: List[int] = []
    esrc: List[int] = []
    edst: List[int] = []

    def add(cost: float, dev: int) -> int:
        costs.append(cost)
        devs.append(dev)
        return len(costs) - 1

    def edge(a: int, b: int) -> None:
        esrc.append(a)
        edst.append(b)

    link = lambda s: pp + s           # noqa: E731
    coll = lambda s: 2 * pp - 1 + s   # noqa: E731

    fwd_id: Dict[Tuple[int, int], int] = {}
    for m in range(n_micro):
        prev = None
        for s in range(pp):
            f = add(m_f[s], s)
            if prev is not None:
                edge(prev, f)
            fwd_id[(m, s)] = f
            if s < pp - 1:
                c = add(bnd_micro[s], link(s))
                edge(f, c)
                prev = c
            else:
                prev = f
    bwd_ids: List[List[int]] = [[] for _ in range(pp)]
    for m in reversed(range(n_micro)):  # flush: last microbatch first
        prev = None
        for s in reversed(range(pp)):
            b = add(m_b[s], s)
            edge(fwd_id[(m, s)], b)  # remat consumes the stored stage input
            if prev is not None:
                edge(prev, b)
            bwd_ids[s].append(b)
            if s > 0:
                c = add(bnd_micro[s - 1], link(s - 1))
                edge(b, c)
                prev = c
            else:
                prev = b
    for s in range(pp):
        if not bwd_ids[s]:
            continue
        tail = bwd_ids[s][-1]
        if stage_sync[s] > 0:
            # grad allreduce waits for the stage's ENTIRE backward flush —
            # every microbatch contributes to the weight grads
            sy = add(stage_sync[s], coll(s))
            for b in bwd_ids[s]:
                edge(b, sy)
            tail = sy
        if stage_upd[s] > 0:
            up = add(stage_upd[s], s)
            if tail == bwd_ids[s][-1]:  # no sync: update waits on all bwds
                for b in bwd_ids[s]:
                    edge(b, up)
            else:
                edge(tail, up)
    return simulate_taskgraph(
        np.asarray(costs), np.asarray(devs), 3 * pp - 1,
        np.asarray(esrc, dtype=np.int32),
        np.asarray(edst, dtype=np.int32))


def _pipeline_taskgraph_makespan_sched(pp: int, v: int, n_micro: int,
                                       m_f: List[float], m_b: List[float],
                                       bnd_micro: List[float],
                                       stage_sync: List[float],
                                       stage_upd: List[float],
                                       schedule: str) -> float:
    """Event-driven makespan of a pipeline schedule (gpipe, 1f1b or
    interleaved). Devices: [0, pp) device-row compute streams,
    [pp, pp + n_chunks - 1) boundary links, then pp per-row collective
    streams. The per-row execution order comes from
    ``parallel.pipeline.pipeline_schedule`` — the SAME generator the
    trainer dispatches from — encoded as chain edges between a row's
    consecutive tasks, so the makespan is the makespan of exactly the
    order the trainer runs (not an idealized work-conserving bound), and
    the three schedules are compared apples-to-apples."""
    from ..native import simulate_taskgraph
    from ..parallel.pipeline import pipeline_schedule

    n_chunks = pp * (v if schedule == "interleaved" else 1)
    last = n_chunks - 1
    costs: List[float] = []
    devs: List[int] = []
    esrc: List[int] = []
    edst: List[int] = []

    def add(cost: float, dev: int) -> int:
        costs.append(cost)
        devs.append(dev)
        return len(costs) - 1

    def edge(a: int, b: int) -> None:
        esrc.append(a)
        edst.append(b)

    # boundary links are FULL-DUPLEX (ICI): the activation hop forward and
    # the gradient hop back ride separate directional streams — sharing
    # one stream would falsely serialize 1f1b's steady state, where the
    # two directions of a cut are busy simultaneously (gpipe's fill and
    # drain phases never overlap, so it would never pay that artifact)
    n_links = max(n_chunks - 1, 0)
    link_f = lambda c: pp + c                 # noqa: E731
    link_b = lambda c: pp + n_links + c       # noqa: E731
    coll = lambda d: pp + 2 * n_links + d     # noqa: E731

    fid: Dict[Tuple[int, int], int] = {}
    bid: Dict[Tuple[int, int], int] = {}
    prev_on_row: Dict[int, int] = {}
    for phase, m, c in pipeline_schedule(schedule, pp, n_micro, v):
        d = c % pp
        tid = add(m_f[c] if phase == "F" else m_b[c], d)
        (fid if phase == "F" else bid)[(m, c)] = tid
        if d in prev_on_row:  # the row executes in schedule order
            edge(prev_on_row[d], tid)
        prev_on_row[d] = tid
    bwd_ids: List[List[int]] = [[] for _ in range(n_chunks)]
    for m in range(n_micro):
        for c in range(n_chunks):
            f = fid[(m, c)]
            b = bid[(m, c)]
            edge(f, b)  # remat consumes the stored chunk input
            if c < last:
                # activation hop to the next chunk's forward
                fc = add(bnd_micro[c], link_f(c))
                edge(f, fc)
                edge(fc, fid[(m, c + 1)])
                # gradient hop back from the next chunk's backward
                bc = add(bnd_micro[c], link_b(c))
                edge(bid[(m, c + 1)], bc)
                edge(bc, b)
            bwd_ids[c].append(b)
    for c in range(n_chunks):
        tail = bwd_ids[c][-1]
        if stage_sync[c] > 0:
            # grad allreduce waits for the chunk's ENTIRE backward flush —
            # every microbatch contributes to the weight grads
            sy = add(stage_sync[c], coll(c % pp))
            for b in bwd_ids[c]:
                edge(b, sy)
            tail = sy
        if stage_upd[c] > 0:
            up = add(stage_upd[c], c % pp)
            if tail == bwd_ids[c][-1]:  # no sync: update waits on all bwds
                for b in bwd_ids[c]:
                    edge(b, up)
            else:
                edge(tail, up)
    return simulate_taskgraph(
        np.asarray(costs), np.asarray(devs),
        2 * pp + 2 * n_links,
        np.asarray(esrc, dtype=np.int32),
        np.asarray(edst, dtype=np.int32))


# ------------------------------------------------------------------ strategies
def assignment_to_strategy(pcg: PCG, assignment: Dict[int, OpSharding],
                           states: Dict[int, str], dp: int, tp: int,
                           data_axis: str = "data",
                           model_axis: str = "model",
                           machine: Optional[GPUMachineModel] = None,
                           dcn: Tuple[int, int] = (1, 1)) -> Strategy:
    """Materialize the search result as weight/output shardings (the
    reference's convert_graph_to_operators + optimal_views). ``machine``
    enables sequence-schedule selection (ring vs alltoall) consistent with
    the simulator's costs; without it the ring schedule is kept. ``dcn``
    records each axis's DCN subfactor on a multi-host machine — the executor
    builds the mesh via build_hybrid_mesh so the DCN factor never splits an
    ICI ring."""
    if tp == 1:
        s = Strategy(mesh_shape=(dp,), axis_names=(data_axis,),
                     data_axis=data_axis)
        if dcn[0] > 1:
            s.hybrid = ((dp // dcn[0],), (dcn[0],))
    else:
        s = Strategy(mesh_shape=(dp, tp), axis_names=(data_axis, model_axis),
                     data_axis=data_axis)
        if dcn != (1, 1):
            s.hybrid = ((dp // dcn[0], tp // dcn[1]), tuple(dcn))
    view = MachineView(dim=(dp, tp) if tp > 1 else (dp,),
                       stride=(tp, 1) if tp > 1 else (1,))

    def state_spec(state: str, ndim: int):
        if state == "S" and ndim >= 2:
            return (data_axis,) + (None,) * (ndim - 2) + (model_axis,)
        if state == "Q" and ndim >= 3:
            return (data_axis, model_axis) + (None,) * (ndim - 2)
        if state == "H" and ndim >= 4:  # NCHW spatial height
            return (data_axis, None, model_axis) + (None,) * (ndim - 3)
        return (data_axis,) + (None,) * (ndim - 1)

    for node in pcg.topo_order():
        ns = s.for_node(node.guid)
        ns.view = view
        sh = assignment.get(node.guid)
        if sh is None:
            continue
        ndim = len(node.out_shapes[0]) if node.out_shapes else 0
        state = states.get(node.guid, "R")
        # state-preserving ops keep their sharded state pinned so XLA does
        # not round-trip through replicated layouts
        if sh.kind == "none" and state in ("S", "Q", "H") and ndim >= 2 \
                and tp > 1:
            ns.output_spec = state_spec(state, ndim)
            continue
        if sh.kind == "none" or sh.tp == 1:
            continue
        ot = node.op.op_type
        if ot == OperatorType.OP_LINEAR:
            if sh.kind == "col":
                ns.weight_specs = {"kernel": (None, model_axis),
                                   "bias": (model_axis,)}
                ns.output_spec = state_spec("S", ndim)
            elif sh.kind == "row":
                ns.weight_specs = {"kernel": (model_axis, None),
                                   "bias": (None,)}
                ns.output_spec = state_spec("R", ndim)
        elif ot == OperatorType.OP_MULTIHEAD_ATTENTION:
            if sh.kind == "heads":
                ns.weight_specs = {"wq": (None, model_axis, None),
                                   "wk": (None, model_axis, None),
                                   "wv": (None, model_axis, None),
                                   "wo": (model_axis, None, None),
                                   "bo": (None,)}
                ns.output_spec = state_spec("R", ndim)
            elif sh.kind == "ring":
                ns.extra["sequence_parallel_axis"] = model_axis
                if machine is not None:
                    # the SAME rule the simulator costed with
                    # (simulator.sequence_schedule): alltoall only when
                    # cheaper on comm AND its (s, s) score block fits HBM
                    from .simulator import sequence_schedule

                    in_shapes = [pcg.nodes[g].out_shapes[i]
                                 for g, i in node.inputs]
                    # same divisibility clamp as Simulator.op_cost, so the
                    # emitted schedule is chosen at the costed topology
                    tp_dcn = dcn[1] if dcn[1] > 0 and \
                        sh.tp % dcn[1] == 0 else 1
                    sched, _ = sequence_schedule(node, in_shapes, sh,
                                                 machine, tp_dcn=tp_dcn)
                    if sched != "ring":
                        ns.extra["sequence_parallel_mode"] = sched
                ns.output_spec = state_spec("Q", ndim)
        elif ot == OperatorType.OP_EMBEDDING:
            ns.weight_specs = {"weight": (model_axis, None)}
            ns.output_spec = state_spec("R", ndim)
        elif ot == OperatorType.OP_CONV2D:
            if sh.kind == "spatial":
                # weights replicated; activations height-sharded — XLA SPMD
                # inserts the halo exchange the cost model priced
                ns.output_spec = state_spec("H", ndim)
            else:  # out-channel "col" sharding
                ns.weight_specs = {"kernel": (None, None, None, model_axis),
                                   "bias": (model_axis,)}
        elif ot == OperatorType.OP_POOL2D and sh.kind == "spatial":
            ns.output_spec = state_spec("H", ndim)
        elif ot == OperatorType.OP_EXPERTS:
            # expert parallel: dim 0 is the expert dim, not batch — weights
            # and activations ride the model axis; XLA inserts the token
            # all-to-all at the dispatch/combine boundaries
            ns.weight_specs = {"kernel": (model_axis, None, None),
                               "bias": (model_axis, None)}
            ns.output_spec = (model_axis,) + (None,) * (ndim - 1)
    return s


# ----------------------------------------------------------- parallel-op nodes
_PARALLEL_OP_FOR_TRANSITION = {
    # (src_state, dst_state) -> (OperatorType, which tensor dim moves)
    ("S", "R"): (OperatorType.OP_COMBINE, -1),
    ("Q", "R"): (OperatorType.OP_COMBINE, 1),
    ("H", "R"): (OperatorType.OP_COMBINE, 2),
    ("R", "S"): (OperatorType.OP_REPARTITION, -1),
    ("R", "Q"): (OperatorType.OP_REPARTITION, 1),
    ("R", "H"): (OperatorType.OP_REPARTITION, 2),
    ("S", "Q"): (OperatorType.OP_ALLTOALL, 1),
    ("Q", "S"): (OperatorType.OP_ALLTOALL, -1),
    ("H", "S"): (OperatorType.OP_ALLTOALL, -1),
    ("S", "H"): (OperatorType.OP_ALLTOALL, 2),
    ("H", "Q"): (OperatorType.OP_ALLTOALL, 1),
    ("Q", "H"): (OperatorType.OP_ALLTOALL, 2),
}


def insert_parallel_ops(pcg: PCG, assignment: Dict[int, OpSharding],
                        states: Dict[int, str], strategy: Strategy,
                        sim: Simulator, dp: int, tp: int) -> int:
    """Materialize sharding-state transitions as first-class parallel-op
    nodes (reference: the search output's Repartition/Combine/Replicate/
    Reduction nodes, src/parallel_ops/). Each inserted node carries the
    transition's collective cost (visible in the DOT export), an
    output_spec in the strategy (the JAX package's
    ``with_sharding_constraint``) and, on a state transition, the same
    layout as its op's ``target_pts``, which the SPMD plan makes the
    node's output layout (``parallel/spmd.plan_spmd``): the data movement,
    explicit in the IR. Returns #inserted."""
    from ..ffconst import size_of_datatype
    from ..ops.base import op_class_for

    if tp <= 1:
        return 0
    model_axis = strategy.axis_names[-1]
    data_axis = strategy.data_axis
    inserted = 0

    # 1) Reduction nodes after partial-sum producers (reference: the
    # Reduction parallel op following a row-parallel Linear,
    # src/parallel_ops/reduction.cc; for head-parallel attention the wo
    # projection's contraction over sharded heads is the same pattern)
    for node in list(pcg.compute_nodes()):
        sh = assignment.get(node.guid)
        if sh is None or sh.kind not in ("row", "heads", "table") \
                or sh.tp <= 1:
            continue
        shape = node.out_shapes[0]
        nbytes = int(np.prod(shape)) * size_of_datatype(node.op.data_type)
        tp_dcn = sim.tp_dcn if tp % sim.tp_dcn == 0 else 1
        cost = sim.machine.hier_allreduce_time(
            nbytes // max(dp, 1), tp // tp_dcn, tp_dcn,
            nic_sharers=sim._nic_sharers(tp // tp_dcn))
        op = op_class_for(OperatorType.OP_REDUCTION)(
            f"reduction_{node.guid}",
            {"dim": 0, "degree": tp, "axes": (model_axis,),
             "comm_cost_us": round(cost * 1e6, 2)},
            node.op.data_type, num_inputs=1)
        consumers = [c for c in pcg.consumers(node.guid)]
        if not consumers:
            continue
        new = pcg.insert_node_on_edge(
            consumers[0],
            [slot for slot, (g, _i) in
             enumerate(pcg.nodes[consumers[0]].inputs)
             if g == node.guid][0], op)
        for c in consumers[1:]:
            cn = pcg.nodes[c]
            cn.inputs = [(new.guid, 0) if g == node.guid else (g, i)
                         for g, i in cn.inputs]
        ns = strategy.for_node(new.guid)
        prod_ns = strategy.node_strategies.get(node.guid)
        if prod_ns is not None:
            ns.view = prod_ns.view
            # the reduced-output constraint belongs to the Reduction node
            ns.output_spec = prod_ns.output_spec
            prod_ns.output_spec = None
        states[new.guid] = states.get(node.guid, "R")
        assignment[new.guid] = OpSharding(dp=dp, tp=1, kind="none")
        inserted += 1
    # group edges by (producer, out_idx, dst_state): one node serves all
    # consumers needing the same conversion
    reuse: Dict[Tuple[int, int, str], int] = {}
    for node in list(pcg.compute_nodes()):
        if getattr(node.op, "is_parallel_op", False):
            continue
        my_state = _in_state_of(node, assignment, states)
        for slot, (g, i) in enumerate(list(node.inputs)):
            p = pcg.nodes[g]
            if p.op.op_type in (OperatorType.OP_INPUT,
                                OperatorType.OP_WEIGHT):
                continue
            src_state = states.get(g, "R")
            if src_state == my_state:
                continue
            key = (g, i, my_state)
            if key in reuse:
                node.inputs[slot] = (reuse[key], 0)
                continue
            trans = _PARALLEL_OP_FOR_TRANSITION.get((src_state, my_state))
            if trans is None:
                continue
            op_type, dim = trans
            shape = p.out_shapes[i]
            nbytes = int(np.prod(shape)) * size_of_datatype(p.op.data_type)
            cost = sim.resharding_cost(nbytes, src_state, my_state, dp, tp)
            op = op_class_for(op_type)(
                f"{op_type.name.lower()}_{g}_{node.guid}",
                {"dim": dim % len(shape) if shape else 0, "degree": tp,
                 "axes": (model_axis,),
                 "comm_cost_us": round(cost * 1e6, 2)},
                p.op.data_type, num_inputs=1)
            new = pcg.insert_node_on_edge(node.guid, slot, op)
            ns = strategy.for_node(new.guid)
            ns.view = strategy.node_strategies[node.guid].view \
                if node.guid in strategy.node_strategies else ns.view
            ndim = len(shape)
            if my_state == "S" and ndim >= 2:
                ns.output_spec = (data_axis,) + (None,) * (ndim - 2) + (
                    model_axis,)
            elif my_state == "Q" and ndim >= 3:
                ns.output_spec = (data_axis, model_axis) + (None,) * (ndim - 2)
            else:
                ns.output_spec = (data_axis,) + (None,) * (ndim - 1)
            new.op.target_pts = _target_pts(shape, ns.output_spec,
                                            p.op.data_type,
                                            {data_axis: dp, model_axis: tp})
            states[new.guid] = my_state
            assignment[new.guid] = OpSharding(dp=dp, tp=1, kind="none")
            reuse[key] = new.guid
            inserted += 1
    return inserted


def _target_pts(shape, spec, dtype, sizes):
    """The ``ParallelTensorShape`` a resharding node pins its output to:
    ``shape`` split per ``spec`` (one entry a dim: None, an axis name or a
    tuple of names) over mesh axes of ``sizes``. The SPMD plan takes its
    ``partition_spec()`` as the node's output layout
    (``parallel/spmd.plan_spmd``); the JAX package pins the same layout
    through the node's ``output_spec``."""
    from ..parallel_tensor import ParallelDim, ParallelTensorShape

    dims = []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        degree = 1
        for a in axes:
            degree *= int(sizes.get(a, 1))
        dims.append(ParallelDim(size=int(size), degree=degree,
                                mesh_axes=axes))
    return ParallelTensorShape(tuple(dims), dtype)


def _in_state_of(node: PCGNode, assignment: Dict[int, OpSharding],
                 states: Dict[int, str]) -> str:
    """The input state the node's chosen option consumes."""
    from .simulator import op_in_state

    return op_in_state(assignment.get(node.guid), states.get(node.guid, "R"))


# ------------------------------------------------------------ best-first xfers
def apply_all_matches(pcg: PCG, xfers,
                      protected_guids: Sequence[int] = ()) -> Tuple[PCG, int]:
    """Greedily apply every match of always-beneficial rewrites (activation
    fusion strictly removes an op under the roofline model — the reference
    applies such monotonic rules as simplification passes, Graph::simplify,
    rather than spending base_optimize budget). Returns (graph, #applied)."""
    g = pcg
    applied = 0
    changed = True
    while changed and applied < len(pcg.nodes):
        changed = False
        for xfer in xfers:
            matches = xfer.find_matches(g)
            for match in matches:
                if any(guid in protected_guids for guid in match.values()):
                    continue
                try:
                    g = xfer.apply(g, match)
                except (ValueError, KeyError) as e:
                    # structurally inapplicable match (shape/attr mismatch
                    # only visible at apply time) — skip, but say so once
                    _warn_once(f"xfer-apply:{xfer.name}",
                               "xfer %s: match not applicable (%s)",
                               xfer.name, e)
                    continue
                applied += 1
                changed = True
                break  # re-match on the rewritten graph
            if changed:
                break
    return g, applied


def _segment_map(pcg: PCG, threshold: int) -> Dict[int, int]:
    """guid -> rewrite-segment index: the graph is split at bottleneck nodes
    into segments of at most ``threshold`` compute nodes where bottleneck
    spacing allows (reference: GraphSearchHelper::find_split_node,
    substitution.cc:2095 — graphs above base_optimize_threshold are split at
    a post-dominator and optimized piecewise)."""
    bns = set(pcg.bottlenecks())
    seg: Dict[int, int] = {}
    idx = 0
    count = 0
    for n in pcg.topo_order():
        seg[n.guid] = idx
        if n.op.op_type not in (OperatorType.OP_INPUT,
                                OperatorType.OP_WEIGHT):
            count += 1  # compute nodes only, matching compute_nodes()
        if count >= threshold and n.guid in bns:
            idx += 1
            count = 0
    return seg


def _dirty_after_rewrite(g2: PCG, touched: Sequence[int],
                         parent_sinks: Set[int]) -> Set[int]:
    """Guids whose DP rows must be recomputed after a rewrite: the touched
    (newly created) nodes plus every descendant — the rewritten segment and
    its resharding frontier. Clean nodes keep their ancestor cone untouched
    (dirty is closed under consumers), so their parent-graph DP rows are
    exact, not approximate. Sink-status flips seed the set too: a rule that
    drops an input can orphan a clean producer into a sink, changing its
    R pinning."""
    seeds = {t for t in touched if t in g2.nodes}
    new_sinks = {n.guid for n in g2.sinks()}
    for guid in new_sinks.symmetric_difference(parent_sinks):
        if guid in g2.nodes:
            seeds.add(guid)
    consumers: Dict[int, List[int]] = {}
    for n in g2.nodes.values():
        for pg, _ in n.inputs:
            consumers.setdefault(pg, []).append(n.guid)
    dirty: Set[int] = set()
    stack = list(seeds)
    while stack:
        x = stack.pop()
        if x in dirty:
            continue
        dirty.add(x)
        stack.extend(consumers.get(x, ()))
    return dirty


def best_first_optimize(pcg: PCG, sim: Simulator, dp: int, tp: int,
                        batch: int, xfers, budget: int, alpha: float,
                        space: Optional[SearchSpace] = None,
                        lam: float = 1.0,
                        protected_guids: Sequence[int] = (),
                        split_threshold: int = 0,
                        search_log=None, remat: str = "none"
                        ) -> Tuple[PCG, Dict[int, OpSharding],
                                   Dict[int, str], float]:
    """The reference's base_optimize (substitution.cc:2229-2306): best-first
    search over GraphXfer applications, each candidate costed by the DP, with
    alpha pruning and a budget on explored graphs. Above ``split_threshold``
    compute nodes, rewrites are confined to bottleneck-delimited segments —
    the reference's recursive split at find_split_node; matches spanning a
    split point are not explored (the reference optimizes the pieces
    separately). ``search_log`` (obs.SearchLog) records every explored
    rewrite candidate.

    Delta re-costing: every candidate carries its DP table, and a
    rewrite re-runs the DP only over ``GraphXfer.apply``'s touched guids
    plus their descendants (the resharding frontier) — clean rows are
    copied from the parent. Falls back to a full re-cost when no parent
    table is available. Under ``FLEXFLOW_TPU_SEARCH_SELFCHECK`` the delta
    result is shadowed by a full DP and asserted identical."""
    assignment, states, table = _dp_core(pcg, sim, dp, tp, space, lam,
                                         remat=remat)
    t = simulate_best(sim, pcg, assignment, states)
    best = (pcg, assignment, states, t)
    if not xfers:
        return best
    counter = itertools.count()
    heap = [(t, next(counter), pcg, table)]
    seen: Set[int] = {pcg.hash()}
    explored = 0
    while heap and explored < budget:
        cost, _, g, gtable = heapq.heappop(heap)
        if cost > best[3] * alpha:
            continue  # prune (reference: substitution.cc:2288)
        seg = (_segment_map(g, split_threshold) if split_threshold
               and len(g.compute_nodes()) > split_threshold else None)
        parent_sinks = {n.guid for n in g.sinks()}
        for xfer in xfers:
            for match in xfer.find_matches(g):
                if any(guid in protected_guids for guid in match.values()):
                    continue
                if seg is not None and len(
                        {seg.get(guid, -1) for guid in match.values()}) > 1:
                    continue  # spans a split point
                try:
                    g2, touched = xfer.apply(g, match, return_touched=True)
                except (ValueError, KeyError) as e:
                    _warn_once(f"xfer-apply:{xfer.name}",
                               "xfer %s: match not applicable (%s)",
                               xfer.name, e)
                    continue
                h = g2.hash()
                if h in seen:
                    continue
                seen.add(h)
                explored += 1
                dirty = _dirty_after_rewrite(g2, touched, parent_sinks)
                a2, s2, table2 = _dp_core(g2, sim, dp, tp, space, lam,
                                          prior=gtable, dirty=dirty,
                                          remat=remat)
                t2 = simulate_best(sim, g2, a2, s2)
                if selfcheck_enabled():
                    fa, fs, _ft = _dp_core(g2, sim, dp, tp, space, lam,
                                           remat=remat)
                    if (fa, fs) != (a2, s2):
                        raise AssertionError(
                            f"delta-cost selfcheck: incremental DP after "
                            f"xfer {xfer.name} diverged from the full "
                            f"re-cost (dirty={len(dirty)}/"
                            f"{len(g2.compute_nodes())} nodes)")
                _log.info("xfer %s: %.3f ms -> %.3f ms", xfer.name,
                          best[3] * 1e3, t2 * 1e3)
                if search_log is not None:
                    search_log.log(event="xfer", xfer=xfer.name, dp=dp,
                                   tp=tp, cost_ms=round(t2 * 1e3, 4),
                                   accepted=bool(t2 < best[3]),
                                   best_ms=round(min(t2, best[3]) * 1e3, 4),
                                   recost_nodes=len(dirty),
                                   total_nodes=len(g2.compute_nodes()))
                if t2 < best[3]:
                    best = (g2, a2, s2, t2)
                if t2 < best[3] * alpha:
                    heapq.heappush(heap, (t2, next(counter), g2, table2))
                if explored >= budget:
                    break
            if explored >= budget:
                break
    return best


# ----------------------------------------------------------- ranked top-K
# fallback-chain length the search persists (winner + K-1 runners-up); the
# cascade rarely needs more than a couple before the dp+full-remat last
# resort, and each extra entry costs one strategy JSON serialization
RANKED_TOP_K = 5


def _build_ranked(best: SearchResult,
                  spmd_pool: Dict[Tuple, Tuple[bool, SearchResult]],
                  pipe_cands: List[RankedCandidate],
                  mem_budget: Optional[int], k: int = RANKED_TOP_K
                  ) -> List[RankedCandidate]:
    """Collapse the deduped candidate pool into the ranked fallback chain:
    one best entry per (mesh, dcn, remat | pipeline grid), runners-up
    ordered feasible-first by simulated time (ties broken on the plan key,
    so the ranking is deterministic). ``spmd_pool`` is maintained
    incrementally by the search (one retained SearchResult per plan key),
    so a long memory search never accumulates per-λ graph copies."""
    entries: Dict[Tuple, Tuple[bool, float, int, Optional[SearchResult],
                               Optional[RankedCandidate]]] = {}

    def consider(key, feas, t, mem, res, pre):
        cur = entries.get(key)
        if cur is None or (feas and not cur[0]) or \
                (feas == cur[0] and t < cur[1]):
            entries[key] = (feas, t, mem, res, pre)

    for (mesh, dcn, remat, pods), (feas, r) in spmd_pool.items():
        consider((mesh, dcn, remat, pods, None), feas, r.sim_time,
                 r.sim_memory, r, None)
    for c in pipe_cands:
        # distinct schedules of one (grid, remat) are distinct fallback
        # candidates: a 1f1b plan that fails can degrade to its gpipe twin
        consider((tuple(c.mesh_shape), tuple(c.dcn), c.remat, c.pods,
                  tuple(c.pipeline), c.schedule, c.virtual_stages),
                 c.feasible, c.sim_time, c.sim_memory, None, c)

    win_pods = getattr(best, "pod_plan", None)
    win_pipe = (tuple(best.strategy.pipeline)
                if getattr(best.strategy, "pipeline", None) else None)
    win_sched = (getattr(best.strategy, "schedule", "") or "gpipe") \
        if win_pipe else ""
    win_v = int(getattr(best.strategy, "virtual_stages", 1) or 1) \
        if win_pipe else 1
    if win_pipe:
        win_key: Tuple = (tuple(best.mesh_shape), tuple(best.dcn),
                          best.remat, win_pods, win_pipe, win_sched,
                          win_v)
    else:
        win_key = (tuple(best.mesh_shape), tuple(best.dcn), best.remat,
                   win_pods, None)
    ranked = [RankedCandidate(
        mesh_shape=tuple(best.mesh_shape), dcn=tuple(best.dcn),
        remat=best.remat, sim_time=best.sim_time, sim_memory=best.sim_memory,
        feasible=bool(mem_budget is None or best.sim_memory <= mem_budget),
        pipeline=win_pipe, schedule=win_sched, virtual_stages=win_v,
        pods=win_pods)]
    others = sorted(((key, v) for key, v in entries.items()
                     if key != win_key),
                    key=lambda kv: (not kv[1][0], kv[1][1], repr(kv[0])))
    for key, (feas, t, mem, res, pre) in others[:max(k - 1, 0)]:
        if pre is not None:
            ranked.append(pre)
            continue
        sjson = None
        if res is not None and res.pcg is not None:
            sjson = res.strategy.to_json(res.pcg)
        ranked.append(RankedCandidate(
            mesh_shape=key[0], dcn=key[1], remat=key[2], pods=key[3],
            sim_time=t, sim_memory=mem, feasible=feas,
            strategy_json=sjson))
    return ranked


# ------------------------------------------------------------------ top level
def unity_search(pcg: PCG, config, n_dev: int,
                 machine: Optional[GPUMachineModel] = None,
                 return_result: bool = False, calibrate: bool = False,
                 protected_guids: Sequence[int] = (),
                 insert_ir_nodes: bool = True,
                 sim: Optional[Simulator] = None, device=None):
    """Top-level search (reference: graph_optimize_task, graph.cc:2047).

    Enumerates mesh factorizations x graph rewrites, runs the {R,S,Q} DP for
    each, applies alpha pruning, then the memory-λ binary search
    (graph.cc:2060-2133) when ``--memory-search`` is on. The λ search is a
    *remix* under the delta-cost engine: the λ=1.0 sweep populates the
    Simulator's memoized per-node (time, mem) tables, and each subsequent λ
    iteration re-runs only the DP mix ``lam*time + (1-lam)*mem`` over
    cached entries — zero new ``op_cost`` calls (λ is not part of any cache
    key, so every lookup hits). When ``calibrate``
    the per-op cost model is first grounded by on-device measurement
    (reference: simulator.cc:489). The best strategy's sharding transitions
    are materialized as parallel-op IR nodes in ``pcg`` (mutated in place).
    Returns a Strategy (or the full SearchResult). ``device`` is the
    device the machine is detected from and ``calibrate`` measures on (the
    card by default; ``"cpu"`` gives the fixed H100 SXM machine)."""
    if machine is None:
        if config.machine_model_version == 1 and config.machine_model_file:
            machine = GPUMachineModel.from_file(config.machine_model_file,
                                               n_dev)
        else:
            machine = GPUMachineModel.detect(n_dev, device=device)
        # --pods / --dcn-gbps multi-pod overrides (docs/multipod.md);
        # an explicitly passed machine is already the caller's topology
        machine.apply_pod_overrides(
            int(getattr(config, "num_pods", 0) or 0),
            float(getattr(config, "dcn_gbps", 0.0) or 0.0))
    if sim is None:
        from .calibration import dtype_label

        # --collective-overlap on prices the per-block hidden sync
        # fraction (simulator.simulate's block model); the legacy
        # --overlap knob keeps its own coarse hiding model untouched
        sim = Simulator(machine,
                        bool(config.search_overlap_backward_update),
                        calibration_dir=getattr(config, "calibration_dir",
                                                "") or None,
                        dtype_label=dtype_label(config))
        sim.block_overlap = (getattr(config, "collective_overlap", "off")
                             or "off") == "on"
    # the simulator must price full-remat blocks at the SAME size the
    # Executor will cut them (execution/remat.py's one-segmentation rule)
    sim.remat_segment_size = int(
        getattr(config, "remat_segment_size", 8) or 8)
    if calibrate:
        n_measured = sim.calibrate_from_pcg(pcg, device=device)
        _log.info("calibrated %d op shapes on device", n_measured)
    # --calibrate-from-trace: replay a
    # --profile-ops JSONL into the per-key calibration BEFORE ranking, so
    # the search prices candidates with the measured ruler
    trace_path = getattr(config, "calibrate_from_trace", "") or ""
    if trace_path:
        from .calibration import calibrate_sim_from_trace

        rep = calibrate_sim_from_trace(sim, pcg, trace_path)
        _log.info("calibrated from trace %s: %d keys matched, %d updated",
                  trace_path, rep["matched"], rep["updated"])

    xfers = _load_xfers(config)
    # monotonic rewrites (activation fusion) apply greedily up front — one
    # pass instead of budgeted re-search per factorization; the best-first
    # loop keeps the cost-gated rules (--substitution-json)
    from .substitution import builtin_xfers

    fusion_names = {x.name for x in builtin_xfers()}
    greedy = [x for x in xfers if x.name in fusion_names]
    xfers = [x for x in xfers if x.name not in fusion_names]
    base_pcg, n_fused = apply_all_matches(pcg, greedy, protected_guids)
    # the Unity graph search explores the full parameter/attribute space like
    # the reference's (the enable_* flags gate only MCMC, linear.cc:727);
    # sequence parallelism is a TPU-native extension with its own opt-out
    space = SearchSpace.full()
    space.sequence = getattr(config, "enable_sequence_parallel", True)
    batch = config.batch_size
    alpha = config.search_alpha
    budget = config.search_budget if config.search_budget > 0 else 64

    # rematerialization axis: `--remat` forces one level;
    # otherwise the memory search explores every level — priced from the
    # FIRST (λ=1.0) sweep so the λ binary search below stays a pure remix
    # (the remat-extended tables are fully populated before any λ
    # iteration; the zero-new-misses counter contract holds).
    # Without memory pressure remat only adds recompute time, so the
    # runtime-only search keeps the single `none` level.
    from ..execution.remat import REMAT_LEVELS

    forced_remat = (getattr(config, "remat", "") or "").strip()
    if forced_remat and forced_remat not in REMAT_LEVELS:
        raise ValueError(
            f"--remat {forced_remat!r} not in {REMAT_LEVELS}")
    if forced_remat:
        remat_levels: Tuple[str, ...] = (forced_remat,)
    elif config.perform_memory_search:
        remat_levels = REMAT_LEVELS
    else:
        remat_levels = ("none",)

    hbm_budget = machine.hbm_capacity
    if getattr(config, "device_memory_mb", 0):
        hbm_budget = config.device_memory_mb * 2 ** 20  # -ll:fsize analog

    # per-iteration search telemetry: JSONL when --search-log is set, tracer
    # events when tracing is on (reference analog: the exported-strategy
    # workflow, but for the search's decision sequence itself)
    from ..obs import SearchLog, get_tracer

    tracer = get_tracer()
    slog = SearchLog(getattr(config, "search_log_file", "") or None,
                     kind="unity")

    # deduped candidate pool for the ranked fallback chain: one
    # retained SearchResult per (mesh, dcn, remat) — folding each sweep in
    # incrementally keeps retention O(distinct plans), not O(λ iterations)
    ranked_pool: Dict[Tuple, Tuple[bool, SearchResult]] = {}
    rank_budget = hbm_budget if config.perform_memory_search else None
    pipe_cands: List[RankedCandidate] = []

    # ShardLint candidate pruning: statically ill-formed
    # candidates (FF001 partial-sum defects, FF006 indivisible shardings)
    # are rejected after the DP optimizer assigns shardings but BEFORE
    # the final simulate/memory pricing and the ranked pool — a broken
    # rewrite/substitution rule can never win the search or ride a
    # ranked fallback chain. Every lambda's assignment is analyzed (the
    # trade-off changes the per-node shardings), but a pruned PLAN is
    # counted/logged once — pruned_static reports distinct plans, like
    # the ranked pool's dedup.
    static_on = (getattr(config, "static_analysis", "on") or "on") != "off"
    if static_on:
        from ..analysis import analyze_candidate
    pruned_static = [0]
    pruned_keys: set = set()

    # hierarchical multi-pod decomposition:
    # when the machine spans pods and the scale warrants it (or
    # --hierarchical-search on), the SPMD sweep runs the two-level
    # DCN x ICI search instead of the flat enumeration; the pod-local
    # sub-solution memo and its counters live on the solver
    from . import multipod

    use_hier = multipod.hierarchical_enabled(config, machine, n_dev)
    hier_solver = multipod.ICISubSolver(sim) if use_hier else None
    hier_stats: Dict = {}

    def pool_consider(r: SearchResult) -> None:
        feas = rank_budget is None or r.sim_memory <= rank_budget
        key = (tuple(r.mesh_shape), tuple(r.dcn), r.remat,
               getattr(r, "pod_plan", None))
        cur = ranked_pool.get(key)
        if cur is None or (feas and not cur[0]) or \
                (feas == cur[0] and r.sim_time < cur[1].sim_time):
            ranked_pool[key] = (feas, r)

    def search_all(lam: float, mem_budget: Optional[int] = None,
                   hierarchical: Optional[bool] = None
                   ) -> Optional[SearchResult]:
        """One sweep over factorizations at a fixed λ. With a memory budget,
        the best FEASIBLE candidate by time wins (falling back to minimum
        memory — reference: is_valid_strategy, graph.cc:1984-2032). On a
        multi-pod machine the sweep dispatches to the two-level
        hierarchical decomposition (multipod.hierarchical_sweep)."""
        if hierarchical is None:
            hierarchical = use_hier
        if hierarchical:
            return multipod.hierarchical_sweep(
                base_pcg, sim, machine, n_dev, batch, lam, mem_budget,
                space, remat_levels, xfers, budget, alpha,
                protected_guids,
                getattr(config, "base_optimize_threshold", 0), slog,
                hier_solver, static_on, pool_consider, hier_stats)
        results: List[SearchResult] = []
        # per-sweep log state: `accepted` must mirror THIS sweep's actual
        # selection rule (feasibility included) — a global best across λ
        # sweeps would mislabel a sweep's real winner as rejected
        sweep_best = [float("inf")]
        # restore under try/finally: an exception mid-sweep (a raising
        # cost model, a broken rewrite) must not leak a candidate's DCN
        # topology into a warm shared simulator
        saved_topo = (sim.dp_dcn, sim.tp_dcn)
        try:
            for dp, tp in factorizations(n_dev):
                if batch % dp != 0:
                    continue
                for dp_dcn, tp_dcn in dcn_placements(dp, tp,
                                                     machine.num_hosts):
                    sim.set_axis_topology(dp_dcn, tp_dcn)
                    for remat in remat_levels:
                        g, a, s, t = best_first_optimize(
                            base_pcg, sim, dp, tp, batch, xfers,
                            budget=max(budget // 4, 4), alpha=alpha,
                            space=space,
                            lam=lam, protected_guids=protected_guids,
                            split_threshold=getattr(
                                config, "base_optimize_threshold", 0),
                            search_log=slog, remat=remat)
                        strat = assignment_to_strategy(
                            g, a, s, dp, tp, machine=machine,
                            dcn=(dp_dcn, tp_dcn))
                        strat.remat = remat
                        if static_on:
                            rep = analyze_candidate(g, strat)
                            if rep.errors:
                                key = (dp, tp, dp_dcn, tp_dcn, remat)
                                if key not in pruned_keys:
                                    pruned_keys.add(key)
                                    pruned_static[0] += 1
                                    slog.log(
                                        event="pruned_static", dp=dp,
                                        tp=tp,
                                        dcn=[dp_dcn, tp_dcn],
                                        lam=round(lam, 4), remat=remat,
                                        rules=rep.rules_fired(),
                                        first=rep.errors[0]
                                        .format_line()[:300])
                                continue
                        _, mem = sim.simulate(g, a, s)
                        _log.info(
                            "mesh dp=%d tp=%d dcn=(%d,%d) lam=%.2f "
                            "remat=%s -> %.3f ms, %.1f MiB/chip", dp, tp,
                            dp_dcn, tp_dcn,
                            lam, remat, t * 1e3, mem / 2 ** 20)
                        feasible = mem_budget is None or mem <= mem_budget
                        accepted = feasible and t < sweep_best[0]
                        if accepted:
                            sweep_best[0] = t
                        slog.log(event="candidate", dp=dp, tp=tp,
                                 dcn=[dp_dcn, tp_dcn], lam=round(lam, 4),
                                 remat=remat,
                                 cost_ms=round(t * 1e3, 4),
                                 mem_mib=round(mem / 2 ** 20, 1),
                                 feasible=bool(feasible),
                                 accepted=bool(accepted),
                                 best_ms=round(
                                     (sweep_best[0]
                                      if sweep_best[0] != float("inf")
                                      else t) * 1e3, 4))
                        results.append(SearchResult(
                            strategy=strat,
                            assignment=a, sim_time=t, sim_memory=mem,
                            mesh_shape=(dp, tp), pcg=g, states=s,
                            dcn=(dp_dcn, tp_dcn), remat=remat))
        finally:
            sim.set_axis_topology(*saved_topo)
        for r in results:
            pool_consider(r)
        if not results:
            return None
        if mem_budget is not None:
            ok = [r for r in results if r.sim_memory <= mem_budget]
            chosen = (min(ok, key=lambda r: r.sim_time) if ok
                      else min(results, key=lambda r: r.sim_memory))
        else:
            chosen = min(results, key=lambda r: r.sim_time)
        slog.log(event="sweep_result", lam=round(lam, 4),
                 mesh=list(chosen.mesh_shape), remat=chosen.remat,
                 cost_ms=round(chosen.sim_time * 1e3, 4),
                 mem_mib=round(chosen.sim_memory / 2 ** 20, 1),
                 feasible=bool(mem_budget is None
                               or chosen.sim_memory <= mem_budget),
                 # delta-cost engine counters: a λ remix sweep shows hits
                 # growing while misses stay flat (zero new op_cost work)
                 cost_cache_hits=sim.cost_cache_hits,
                 cost_cache_misses=sim.cost_cache_misses)
        return chosen

    t_search0 = time.perf_counter()
    # snapshot the cache counters: the reported stats must be THIS search's
    # deltas, not the Simulator's lifetime totals (a shared sim arrives
    # pre-warmed by calibration or baseline costing — bench.py does both)
    cache0 = (sim.cost_cache_hits, sim.cost_cache_misses,
              sim.table_hits, sim.table_misses)
    with _log.scope("unity_search n_dev=%d" % n_dev), \
            tracer.span("search", n_dev=n_dev):
        best = search_all(lam=1.0)
        if use_hier and selfcheck_enabled() and \
                n_dev <= multipod.SELFCHECK_MAX_DEV:
            # two-level vs flat equivalence gate (docs/multipod.md): on a
            # mesh small enough to enumerate both ways, the hierarchical
            # winner must be the flat search_all winner. The shadow flat
            # sweep must VERIFY, not perturb: snapshot/restore the ranked
            # pool, prune dedup and event counters so selfcheck-on runs
            # rank and report identically to selfcheck-off runs
            pool_snap = dict(ranked_pool)
            counts_snap = dict(slog.counts)
            pruned_snap = (pruned_static[0], set(pruned_keys))
            try:
                flat_best = search_all(lam=1.0, hierarchical=False)
            finally:
                ranked_pool.clear()
                ranked_pool.update(pool_snap)
                slog.counts.clear()
                slog.counts.update(counts_snap)
                pruned_static[0] = pruned_snap[0]
                pruned_keys.clear()
                pruned_keys.update(pruned_snap[1])
            multipod.assert_selfcheck_matches_flat(best, flat_best)
        # memory-aware λ binary search (reference: graph.cc:2060-2133):
        # find the largest λ (most runtime-weighted) whose best strategy
        # still fits per-chip HBM
        if best is not None and config.perform_memory_search and \
                best.sim_memory > hbm_budget:
            lo, hi = 0.0, 1.0
            feasible = None
            for _ in range(6):
                mid = (lo + hi) / 2
                cand = search_all(lam=mid, mem_budget=hbm_budget)
                if cand is not None and cand.sim_memory <= hbm_budget:
                    feasible, lo = cand, mid
                else:
                    hi = mid
            if feasible is None:
                cand = search_all(lam=0.0, mem_budget=hbm_budget)
                if cand is not None and cand.sim_memory <= hbm_budget:
                    feasible = cand
            if feasible is not None:
                best = feasible

        # GPipe pipeline candidate (beyond the reference, which only
        # reserves OP_PIPELINE): the same op-cost model prices (pp, dp)
        # GPipe grids — per-stage weight placement removes the full-model
        # gradient allreduce, so pipeline wins for weight-heavy graphs
        if best is not None and n_dev >= 2 and \
                getattr(config, "enable_pipeline_parallel", True) and \
                batch % n_dev == 0 and \
                pipeline_microbatch_safe(base_pcg, batch):
            # batch % n_dev: the companion eval/predict strategy is DP
            # over all n_dev devices — same guard search_all applies
            n_nodes = len(base_pcg.compute_nodes())
            # stage remat is leveled too (PipelineTrainer runs the same
            # policy machinery): a forced level wins; the memory search
            # explores all levels; otherwise keep the classic GPipe full
            # remat the trainer always ran pre-leveling
            pipe_levels = ((forced_remat,) if forced_remat
                           else remat_levels
                           if config.perform_memory_search else ("full",))
            # the pipeline SCHEDULE is a searched axis too:
            # gpipe/1f1b sweep always; interleaved (v=2 virtual chunks per
            # device) when the graph has enough nodes to cut pp*v chunks.
            # --schedule forces one schedule, like --remat forces a level.
            forced_sched = (getattr(config, "schedule", "") or "").strip()
            forced_v = int(getattr(config, "pipeline_virtual_stages", 0)
                           or 0)
            # pod-aligned grids on a hierarchical multi-pod machine (pods
            # as pipeline stages — the DCN-level pipeline axis, with the
            # schedule per cut searched below); the classic (2, 4, 8)
            # sweep otherwise
            pipe_pods = ((machine.pods, "pipeline", 1)
                         if use_hier else None)
            for pp in multipod.pipeline_grids(n_dev, machine, use_hier):
                if n_dev % pp != 0 or pp > min(n_nodes, n_dev) or pp < 2:
                    continue
                pdp = n_dev // pp
                micro = next((m for m in (2 * pp, pp, 2)
                              if batch % m == 0 and
                              (batch // m) % max(pdp, 1) == 0), None)
                if micro is None:
                    continue
                if forced_sched:
                    # v only applies to interleaved: a stray
                    # --virtual-stages with a forced 1f1b/gpipe must not
                    # leak into the winner (preflight would reject it)
                    v = (forced_v or 2) \
                        if forced_sched == "interleaved" else 1
                    pipe_scheds = [(forced_sched, v)] if (
                        pp * v <= n_nodes and
                        (forced_sched != "interleaved"
                         or micro % pp == 0)) else []
                else:
                    pipe_scheds = [("gpipe", 1), ("1f1b", 1)]
                    # interleaved needs pp*v chunks to cut and microbatch
                    # rounds of pp (preflight names the same constraints)
                    if 2 * pp <= n_nodes and micro % pp == 0:
                        pipe_scheds.append(("interleaved", 2))
                for lv in pipe_levels:
                    for sched, sv in pipe_scheds:
                        t_pipe, m_pipe = simulate_pipeline(
                            sim, base_pcg, pp, pdp, micro, remat=lv,
                            schedule=sched, v=sv)
                        _log.info(
                            "pipeline pp=%d dp=%d m=%d remat=%s "
                            "schedule=%s v=%d -> %.3f ms, %.1f MiB",
                            pp, pdp, micro, lv, sched, sv,
                            t_pipe * 1e3, m_pipe / 2 ** 20)
                        # accepted must mirror the ACTUAL decision below,
                        # memory budget included, or replaying the log
                        # reconstructs a different search than the one
                        # that ran. Ties on time (1f1b's makespan equals
                        # gpipe's under uniform stages — the bubble
                        # fraction is the same (S-1)/(M+S-1); memory is
                        # its win) break toward LOWER memory; an exact
                        # tie on both (the swept n_micro == pp regime,
                        # where in-flight counts coincide) still prefers
                        # the non-gpipe schedule — 1f1b DOMINATES gpipe
                        # (never worse, strictly less in-flight memory
                        # once the fit loop re-derives n_micro = 2*pp
                        # for a real batch), so the tie is not a toss-up.
                        feas = (not config.perform_memory_search
                                or m_pipe <= hbm_budget)
                        is_pipe_best = bool(
                            getattr(best.strategy, "pipeline", None))
                        best_sched = (getattr(best.strategy, "schedule",
                                              "") or "gpipe")
                        pipe_ok = feas and (
                            t_pipe < best.sim_time * (1 - 1e-9)
                            or (is_pipe_best
                                and t_pipe <= best.sim_time * (1 + 1e-9)
                                and (m_pipe < best.sim_memory
                                     or (m_pipe <= best.sim_memory
                                         and best_sched == "gpipe"
                                         and sched != "gpipe"))))
                        # mesh recorded as the winner convention
                        # (n_dev, 1) so an accepted grid's entry dedupes
                        # against its own SearchResult in the ranking
                        pipe_cands.append(RankedCandidate(
                            mesh_shape=(n_dev, 1), remat=lv,
                            sim_time=t_pipe, sim_memory=m_pipe,
                            feasible=bool(feas),
                            pipeline=(pp, pdp, micro),
                            schedule=sched, virtual_stages=sv,
                            pods=pipe_pods))
                        slog.log(event="pipeline_candidate", pp=pp,
                                 dp=pdp, n_micro=micro, remat=lv,
                                 schedule=sched, virtual_stages=sv,
                                 cost_ms=round(t_pipe * 1e3, 4),
                                 mem_mib=round(m_pipe / 2 ** 20, 1),
                                 accepted=bool(pipe_ok),
                                 best_ms=round((t_pipe if pipe_ok
                                                else best.sim_time)
                                               * 1e3, 4))
                        if pipe_ok:
                            from ..parallel.strategy import \
                                data_parallel_strategy

                            strat = data_parallel_strategy(pcg, n_dev)
                            strat.pipeline = (pp, pdp, micro)
                            strat.schedule = sched
                            strat.virtual_stages = sv
                            strat.remat = lv
                            strat.pods = pipe_pods
                            best = SearchResult(
                                strategy=strat, assignment={},
                                sim_time=t_pipe, sim_memory=m_pipe,
                                mesh_shape=(n_dev, 1), pcg=None,
                                states=None, remat=lv,
                                pod_plan=pipe_pods)

    # delta-cost engine telemetry: wall time, throughput and cache counters
    # land on the SearchResult (bench.py's search_wall_s metric) and in the
    # final SearchLog record
    search_wall_s = time.perf_counter() - t_search0
    candidates = sum(slog.counts.get(k, 0) for k in
                     ("candidate", "xfer", "pipeline_candidate",
                      "dcn_candidate"))
    d_hits = sim.cost_cache_hits - cache0[0]
    d_misses = sim.cost_cache_misses - cache0[1]
    cache_stats = {
        "cost_cache_hits": d_hits,
        "cost_cache_misses": d_misses,
        "cost_cache_hit_rate": round(d_hits / (d_hits + d_misses), 4)
        if d_hits + d_misses else 0.0,
        "table_hits": sim.table_hits - cache0[2],
        "table_misses": sim.table_misses - cache0[3],
    }
    if best is not None:
        best.search_wall_s = search_wall_s
        best.candidates = candidates
        best.cache_stats = cache_stats
        best.pruned_static = pruned_static[0]
        if use_hier:
            if hier_solver is not None:
                pruned_static[0] += hier_solver.pruned_static
                best.pruned_static = pruned_static[0]
            best.multipod_stats = dict(hier_stats)
        # ranked fallback chain: persisted on the result AND in
        # the search log, so the compile-time cascade (and a post-mortem of
        # one) can replay which plans were next in line
        best.ranked = _build_ranked(best, ranked_pool, pipe_cands,
                                    rank_budget)
        slog.log(event="ranked", candidates=[
            {"rank": i, "mesh": list(c.mesh_shape), "dcn": list(c.dcn),
             "remat": c.remat,
             "pipeline": list(c.pipeline) if c.pipeline else None,
             "schedule": c.schedule or None,
             "virtual_stages": c.virtual_stages,
             "pods": list(c.pods) if c.pods else None,
             "cost_ms": round(c.sim_time * 1e3, 4),
             "mem_mib": round(c.sim_memory / 2 ** 20, 1),
             "feasible": bool(c.feasible)}
            for i, c in enumerate(best.ranked)])
        slog.log(event="result", cost_ms=round(best.sim_time * 1e3, 4),
                 mem_mib=round(best.sim_memory / 2 ** 20, 1),
                 mesh=list(best.mesh_shape), remat=best.remat,
                 pipeline=(list(best.strategy.pipeline)
                           if getattr(best.strategy, "pipeline", None)
                           else None),
                 schedule=(getattr(best.strategy, "schedule", "") or None),
                 virtual_stages=int(
                     getattr(best.strategy, "virtual_stages", 1) or 1),
                 pods=(list(best.pod_plan) if best.pod_plan else None),
                 search_wall_s=round(search_wall_s, 4),
                 candidates=candidates,
                 candidates_per_s=round(candidates / search_wall_s, 2)
                 if search_wall_s > 0 else None,
                 pruned_static=pruned_static[0],
                 **(dict(best.multipod_stats)
                    if best.multipod_stats else {}),
                 **cache_stats)
    slog.close()
    if best is None:
        from ..parallel.strategy import data_parallel_strategy

        return data_parallel_strategy(pcg, n_dev)

    # adopt the rewritten graph + materialize transitions as parallel-op nodes
    if best.pcg is not None and best.pcg is not pcg:
        pcg.nodes = best.pcg.nodes
        pcg._order = best.pcg._order
    if insert_ir_nodes and best.states is not None:
        dp, tp = best.mesh_shape
        try:
            # annotate at the winner's topology; restore even when an
            # insertion fails so a warm shared simulator stays clean
            sim.set_axis_topology(*best.dcn)
            insert_parallel_ops(pcg, best.assignment, best.states,
                                best.strategy, sim, dp, tp)
        finally:
            sim.set_axis_topology(1, 1)
    best.sim = sim
    return (best if return_result else best.strategy)


def _load_xfers(config):
    from .substitution import builtin_xfers, load_substitution_json

    xfers = list(builtin_xfers())
    if config.substitution_json_path:
        xfers.extend(load_substitution_json(config.substitution_json_path))
    return xfers


def search_all(pcg: PCG, config, n_dev: int, objective: str = "training",
               **kwargs):
    """Objective-dispatching search façade: the training
    objective runs the classic Unity step-time search (``unity_search``);
    ``objective="serving"`` optimizes latency-bounded throughput for the
    DECODE graph instead — tokens/sec subject to simulated p99 <=
    ``--slo-p99-ms`` — via ``serving.search.serving_search`` (which
    returns a ServingPlan rather than a Strategy; the plan's
    ``to_strategy`` materializes executor shardings). Both objectives
    share the Simulator's delta-cost caches when a warm ``sim=`` is
    passed."""
    if objective == "serving":
        from ..serving.search import serving_search

        return serving_search(pcg, config, n_dev, **kwargs)
    if objective != "training":
        raise ValueError(
            f"unknown search objective {objective!r}: "
            "expected 'training' or 'serving'")
    return unity_search(pcg, config, n_dev, **kwargs)


# ---------------------------------------------------------------- legacy MCMC
def mcmc_optimize(pcg: PCG, config, n_dev: int,
                  machine: Optional[GPUMachineModel] = None,
                  iterations: int = 500, temperature: float = 1e-4,
                  seed: int = 0, device=None) -> Strategy:
    """Legacy simulated-annealing search over per-op shardings
    (reference: FFModel::mcmc_optimize, model.cc:3285 — random per-op
    ParallelConfig rewrites accepted by Metropolis criterion). Honors
    enable_parameter_parallel / enable_attribute_parallel exactly like the
    reference's get_random_parallel_config (linear.cc:727)."""
    from .calibration import dtype_label

    machine = machine or GPUMachineModel.detect(n_dev, device=device)
    sim = Simulator(machine, dtype_label=dtype_label(config))
    rng = random.Random(seed)
    batch = config.batch_size
    space = SearchSpace.from_config(config)

    facts = [f for f in factorizations(n_dev) if batch % f[0] == 0]
    dp, tp = facts[0]
    nodes = pcg.compute_nodes()

    def random_choice(node):
        in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        valid = node_options(node, tp, in_shapes, space)
        return rng.choice(valid or [("none", "R", "R")])

    current = {n.guid: OpSharding(dp=dp, tp=tp if k != "none" else 1, kind=k)
               for n in nodes for k, _, _ in [random_choice(n)]}
    # candidates are costed by the SAME engine as unity_search
    # (simulate_best -> native event-driven makespan when available), so
    # the two search modes rank any candidate identically
    cur_t = simulate_best(sim, pcg, current, {})
    # best carries ITS OWN factorization: the restart below re-rolls
    # (dp, tp), and the final strategy must be built around the mesh the
    # best assignment was actually found under
    best, best_t, best_fact = dict(current), cur_t, (dp, tp)
    from ..obs import SearchLog

    slog = SearchLog(getattr(config, "search_log_file", "") or None,
                     kind="mcmc")
    for it in range(iterations):
        # occasionally rewrite the mesh factorization (reference: restart)
        if it % 100 == 99 and len(facts) > 1:
            dp, tp = rng.choice(facts)
            current = {n.guid: OpSharding(
                dp=dp, tp=tp if k != "none" else 1, kind=k)
                for n in nodes for k, _, _ in [random_choice(n)]}
            cur_t = simulate_best(sim, pcg, current, {})
            if cur_t < best_t:
                best, best_t, best_fact = dict(current), cur_t, (dp, tp)
        node = rng.choice(nodes)
        kind, _, _ = random_choice(node)
        cand = dict(current)
        cand[node.guid] = OpSharding(dp=dp, tp=tp if kind != "none" else 1,
                                     kind=kind)
        t = simulate_best(sim, pcg, cand, {})
        accepted = (t < cur_t
                    or rng.random() < math.exp(-(t - cur_t) / temperature))
        slog.log(event="mcmc", cost_ms=round(t * 1e3, 4),
                 accepted=bool(accepted), temperature=temperature,
                 dp=dp, tp=tp, best_ms=round(min(t, best_t) * 1e3, 4))
        if accepted:
            current, cur_t = cand, t
            if t < best_t:
                best, best_t, best_fact = dict(cand), t, (dp, tp)
    slog.log(event="result", cost_ms=round(best_t * 1e3, 4),
             mesh=list(best_fact))
    slog.close()
    states = {n.guid: "R" for n in nodes}
    return assignment_to_strategy(pcg, best, states, *best_fact,
                                  machine=machine)
