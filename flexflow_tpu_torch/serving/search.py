"""The serving objective of the search: latency-bounded throughput (port
of ``flexflow_tpu.serving.search``).

``serving_search`` sits next to the training step-time objective
(``search.unity.unity_search``; both are reached through
``search.unity.search_all``). It sweeps mesh factorizations (dp replicas
x tp within a replica), the decode-state layout (KV sharded over heads or
replicated) and the KV storage dtype for the DECODE graph, and picks the
plan with the most simulated tokens/s subject to ``simulated p99 <=
--slo-p99-ms`` and the per-card memory. It prices with the port's
``Simulator`` and ``GPUMachineModel``, with the JAX package's formulas:

* the decode graph is the model's graph re-inferred at ``(slots per
  replica, 1)``; every op is priced by the same memoized
  ``Simulator.op_cost`` as training, with the Megatron-style kind
  assignment (linears alternate col/row, attention shards heads,
  embeddings the table). Serving is forward-only: comm is half of
  op_cost's forward+backward figure, and sync and update are dropped;
* the KV state is priced explicitly: each attention node streams ``2 *
  slots * heads * max_len * head_dim * el`` bytes a decode step (over tp
  under the sharded layout; ``kv_fill`` scales the read to a measured
  occupancy), and the same bytes count against the card's memory;
* p50 = one decode step; p99 = a decode step plus one max-bucket prefill
  (scaled by the unreused share of prefill tokens);
* tokens/s = slots / decode step.

Context buckets ride on the winner: for each bucket the ``seq_shards``
with the least KV stream plus combine time (``_bucket_seq_shards``) is
recorded, and ``ServingPlan.seq_shards_for`` is admission's lookup.

Under ``FLEXFLOW_TPU_SEARCH_SELFCHECK`` every candidate is priced again on
a fresh Simulator and the winner must be the same.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ffconst import OperatorType, size_of_datatype
from ..parallel.pcg import PCG, PCGNode
from .kvcache import is_position_constant


class ServingSearchError(RuntimeError):
    """The graph could not be re-inferred at decode shapes (baked
    shape-carrying ops like reshape); serve such models via explicit
    prefill/decode steps instead of the searched plan."""


@dataclasses.dataclass
class ServingCandidate:
    """One priced (mesh, layout, kv_dtype) point of the serving sweep."""

    mesh_shape: Tuple[int, int]
    layout: str  # "sharded" | "replicated" (KV-cache over the model axis?)
    slots_per_replica: int
    # KV storage dtype: "native" or "int8" — int8 streams
    # ~1/el of the KV bytes (+ f32 scales) per decode step, the
    # precision-for-bandwidth trade the latency-bounded objective prices
    kv_dtype: str = "native"
    sim_decode_ms: float = 0.0
    sim_prefill_ms: float = 0.0
    sim_p50_ms: float = 0.0
    sim_p99_ms: float = 0.0
    sim_tokens_per_s: float = 0.0
    sim_memory: int = 0
    feasible: bool = True

    def describe(self) -> str:
        return (f"mesh={tuple(self.mesh_shape)} kv={self.layout} "
                f"kv_dtype={self.kv_dtype} "
                f"slots/replica={self.slots_per_replica}")


@dataclasses.dataclass
class ServingPlan:
    """The serving search's winner plus the ranked runner-up chain (the
    strategy-safety shape: an elastic replan degrades through the
    same list)."""

    mesh_shape: Tuple[int, int]
    layout: str
    slots: int
    max_decode_len: int
    slo_p99_ms: float
    sim_decode_ms: float
    sim_prefill_ms: float
    sim_p50_ms: float
    sim_p99_ms: float
    sim_tokens_per_s: float
    sim_memory: int
    feasible: bool
    kv_dtype: str = "native"
    # expected prefill-token reuse fraction the p99 was priced at
    # (measured prefix-cache hit rate, or an assumption)
    prefill_reuse: float = 0.0
    # sequence-parallel decode: the searched context-length buckets and
    # the seq_shards the interconnect closed forms picked for each —
    # admission routes a request to its bucket (``seq_shards_for``)
    context_buckets: Tuple[int, ...] = ()
    seq_shards_by_bucket: Dict[int, int] = dataclasses.field(
        default_factory=dict)
    assignment: Dict[int, object] = dataclasses.field(default_factory=dict)
    ranked: List[ServingCandidate] = dataclasses.field(default_factory=list)
    sim: object = None  # the warm Simulator (elastic re-search reuse)

    def seq_shards_for(self, context_len: int) -> int:
        """Admission routing: the searched seq_shards of the smallest
        bucket covering ``context_len`` (requests beyond every bucket
        take the largest — they must shard hardest); 1 when the search
        ran without buckets."""
        if not self.context_buckets:
            return 1
        for b in self.context_buckets:
            if context_len <= b:
                return self.seq_shards_by_bucket.get(b, 1)
        return self.seq_shards_by_bucket.get(self.context_buckets[-1], 1)

    def describe(self) -> str:
        return (f"mesh={tuple(self.mesh_shape)} kv={self.layout} "
                f"kv_dtype={self.kv_dtype} "
                f"tokens/s={self.sim_tokens_per_s:.1f} "
                f"p99={self.sim_p99_ms:.2f}ms")

    def to_strategy(self, pcg: PCG):
        """Materialize as an executor Strategy (weight shardings by node)
        through the training search's ``assignment_to_strategy``; a plan
        it cannot realize falls back to data parallelism over every
        device, as in the JAX package."""
        from ..parallel.strategy import data_parallel_strategy
        from ..search.unity import assignment_to_strategy

        dp, tp = self.mesh_shape
        if tp <= 1 or not self.assignment:
            return data_parallel_strategy(pcg, dp)
        try:
            return assignment_to_strategy(pcg, self.assignment, {}, dp, tp)
        except Exception:
            return data_parallel_strategy(pcg, dp * tp)


# ------------------------------------------------------------ decode graph
def _rescaled_shape(shape: Tuple[int, ...], batch: int, seq: int
                    ) -> Tuple[int, ...]:
    if len(shape) >= 2:
        return (batch, seq) + tuple(shape[2:])
    return shape


def reshape_graph(pcg: PCG, batch: int, seq: int) -> PCG:
    """The model's graph re-inferred at serving shapes ``(batch, seq)``
    without touching the original (ops are shared between PCG copies, so
    shape-bearing ops — inputs, position constants — are shallow-copied
    with fresh attrs). Raises ServingSearchError when an op's baked shape
    cannot follow (e.g. a hard reshape)."""
    g = PCG()
    g._order = list(pcg._order)
    for guid in pcg._order:
        n = pcg.nodes[guid]
        op = n.op
        try:
            if op.op_type in (OperatorType.OP_INPUT, OperatorType.OP_WEIGHT):
                if op.op_type == OperatorType.OP_INPUT:
                    op = copy.copy(op)
                    op.attrs = dict(op.attrs)
                    op.attrs["shape"] = _rescaled_shape(
                        tuple(n.out_shapes[0]), batch, seq)
                    out_shapes = [op.attrs["shape"]]
                else:
                    out_shapes = list(n.out_shapes)
            elif op.op_type == OperatorType.OP_CONSTANT and \
                    is_position_constant(op.attrs.get("value")):
                v = np.asarray(op.attrs["value"])
                op = copy.copy(op)
                op.attrs = dict(op.attrs)
                op.attrs["value"] = np.broadcast_to(
                    np.arange(seq, dtype=v.dtype), (batch, seq)).copy()
                out_shapes = [(batch, seq)]
            else:
                in_shapes = [g.nodes[pg].out_shapes[pi]
                             for pg, pi in n.inputs]
                out_shapes = op.infer_output_shapes(in_shapes)
        except Exception as e:
            raise ServingSearchError(
                f"{n.name} ({op.op_type.name}) cannot re-infer at serving "
                f"shapes (batch={batch}, seq={seq}): {e}") from e
        g.nodes[guid] = PCGNode(
            guid=guid, op=op, inputs=list(n.inputs),
            out_shapes=[tuple(s) for s in out_shapes],
            out_dtypes=list(n.out_dtypes))
    return g


# ------------------------------------------------------------ cost pricing
_W_SHARD = {
    OperatorType.OP_MULTIHEAD_ATTENTION: "heads",
    OperatorType.OP_EMBEDDING: "table",
    OperatorType.OP_EXPERTS: "expert",
}


def _pick_kind(node: PCGNode, tp: int,
               in_shapes: List[Tuple[int, ...]], flip: List[bool]) -> str:
    """Megatron-style kind assignment for inference: linears alternate
    col -> row (the col half pays no collective, the row half's allreduce
    closes the pair), attention shards heads, embeddings the table. Both
    halves respect divisibility — an unshardable dim keeps the op
    replicated, so every priced kind is realizable by
    ``assignment_to_strategy``."""
    if tp <= 1:
        return "none"
    a = node.op.attrs
    ot = node.op.op_type
    if ot == OperatorType.OP_LINEAR:
        col_ok = a.get("out_dim", 0) % tp == 0
        in_ok = bool(in_shapes) and in_shapes[0][-1] % tp == 0
        if flip[0]:
            if col_ok:
                flip[0] = False
                return "col"
            return "none"
        flip[0] = True  # the pair closes here (or resets on fallback)
        if in_ok:
            return "row"  # row eats the col half's sharded activation
        return "col" if col_ok else "none"
    kind = _W_SHARD.get(ot)
    if kind == "heads" and a.get("num_heads", 0) % tp == 0:
        return "heads"
    if kind == "table" and a.get("num_entries", 0) % tp == 0:
        return "table"
    if kind == "expert" and a.get("n", 0) % tp == 0:
        return "expert"
    return "none"


def _attention_state_bytes(node: PCGNode, slots: int, max_len: int,
                           kv_dtype: str = "native") -> int:
    from .kvcache import kv_token_bytes

    a = node.op.attrs
    heads = int(a.get("num_heads", 1))
    kdim = int(a.get("kdim") or a["embed_dim"] // heads)
    vdim = int(a.get("vdim") or a["embed_dim"] // heads)
    return slots * max_len * kv_token_bytes(
        heads, kdim, vdim, size_of_datatype(node.op.data_type), kv_dtype)


def _graph_cost(sim, g: PCG, tp: int, kv_div: int, slots: int,
                max_len: int, decode: bool, kv_dtype: str = "native",
                kv_fill: float = 1.0):
    """(step_time_s, per_chip_mem_bytes, assignment) for one re-inferred
    serving graph under degree-``tp`` model parallelism. Forward-only:
    comm is half the op_cost fwd+bwd figure, sync/update dropped, no
    optimizer state in the memory model.

    ``kv_dtype`` selects the KV-stream element size (int8
    streams ~1/el the bytes plus f32 scales); ``kv_fill`` scales the
    per-step KV READ traffic (1.0 = the ring layout's O(max_len) bill;
    the paged flash-decode path reads only occupied blocks, so a
    measured mean-occupancy fill prices its true traffic). Pool
    CAPACITY is always charged at full extent — feasibility must hold
    at worst case."""
    from ..search.simulator import OpSharding

    t = comm = 0.0
    mem_w = kv_bytes = 0
    transient = 0
    flip = [True]
    assignment: Dict[int, OpSharding] = {}
    m = sim.machine
    for node in g.compute_nodes():
        in_shapes = [g.nodes[pg].out_shapes[pi] for pg, pi in node.inputs]
        kind = _pick_kind(node, tp, in_shapes, flip)
        sh = OpSharding(dp=1, tp=(tp if kind != "none" else 1), kind=kind)
        assignment[node.guid] = sh
        cm = sim.op_cost(node, in_shapes, sh)
        t += cm.forward_time
        comm += cm.comm_time / 2.0
        mem_w += cm.weights_memory
        transient = max(transient, cm.inputs_memory + cm.outputs_memory)
        if decode:
            if node.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
                kv_bytes += _attention_state_bytes(
                    node, slots, max_len, kv_dtype) // max(kv_div, 1)
            elif node.op.op_type == OperatorType.OP_LSTM:
                h = int(node.op.attrs["hidden_size"])
                kv_bytes += slots * 2 * h * size_of_datatype(
                    node.op.data_type)
    kv_time = kv_bytes * max(min(kv_fill, 1.0), 0.0) / (
        m.hbm_bandwidth * m.hbm_efficiency)
    return t + comm + kv_time, mem_w + kv_bytes + transient, assignment


def _bucket_seq_shards(pcg: PCG, machine, n_dev: int, slots: int,
                       bucket: int, kv_dtype: str,
                       kv_fill: float) -> Tuple[int, float, float, bool]:
    """Searched seq_shards for ONE context bucket: sweep the
    power-of-two shard widths dividing the mesh and pick the one
    minimizing the per-decode-step KV stream + ring-combine time from
    the interconnect closed forms — the same pricing vocabulary as kv_fill/
    prefill_reuse, next to which this axis sits in the objective.

    Per shard width ``s``:

    * the bucket's KV read splits s ways and streams in parallel —
      ``t_kv = kv_read(bucket) / s / (hbm_bw * hbm_eff)``;
    * the combine pays two allgathers per attention node per step: the
      step's query rows out to every shard, the f32 ``(m, l, acc)``
      partial triples back (kernels/seqpar_decode.py byte helpers);
      widths spanning pods compose via ``hier_allgather_time`` (the
      node x NVLink law);
    * feasibility: one shard chip's share of the bucket's FULL-extent
      KV must fit its HBM (capacity is judged at worst case, like the
      sweep's memory term).

    Returns ``(seq_shards, t_kv_s, t_combine_s, fits)``; when no width
    fits, the widest is returned with ``fits=False`` — the least-bad
    plan, flagged rather than hidden."""
    from ..kernels.seqpar_decode import (combine_bytes_per_step,
                                         query_bytes_per_step)
    from .kvcache import kv_token_bytes

    nodes = [n for n in pcg.compute_nodes()
             if n.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION]
    if not nodes:
        return 1, 0.0, 0.0, True
    fill = max(min(float(kv_fill), 1.0), 0.0)
    kv_cap = 0
    dims = []
    for node in nodes:
        a = node.op.attrs
        heads = int(a.get("num_heads", 1))
        kdim = int(a.get("kdim") or a["embed_dim"] // heads)
        vdim = int(a.get("vdim") or a["embed_dim"] // heads)
        el = size_of_datatype(node.op.data_type)
        kv_cap += slots * bucket * kv_token_bytes(
            heads, kdim, vdim, el, kv_dtype)
        dims.append((heads, kdim, vdim, el))
    hbm_stream = machine.hbm_bandwidth * machine.hbm_efficiency
    widths = []
    s = 1
    while s <= n_dev:
        if n_dev % s == 0:
            widths.append(s)
        s *= 2
    best = None
    widest = None
    for s in widths:
        t_kv = kv_cap * fill / s / hbm_stream
        t_comb = 0.0
        if s > 1:
            cpp = machine.chips_per_pod
            for heads, kdim, vdim, el in dims:
                qb = query_bytes_per_step(heads, kdim, slots, el)
                pb = combine_bytes_per_step(heads, vdim, slots, s)
                if s > cpp and s % cpp == 0:
                    t_comb += machine.hier_allgather_time(qb, cpp, s // cpp)
                    t_comb += machine.hier_allgather_time(pb, cpp, s // cpp)
                else:
                    t_comb += machine.allgather_time(qb, s)
                    t_comb += machine.allgather_time(pb, s)
        fits = kv_cap // s <= machine.hbm_capacity
        cand = (s, t_kv, t_comb, fits)
        widest = cand
        if fits and (best is None or
                     t_kv + t_comb < best[1] + best[2] - 1e-12):
            best = cand
    return best if best is not None else widest


# --------------------------------------------------------------- top level
def serving_search(pcg: PCG, config, n_dev: int, machine=None,
                   sim=None, max_inflight: Optional[int] = None,
                   max_decode_len: Optional[int] = None,
                   slo_p99_ms: Optional[float] = None,
                   kv_fill: float = 1.0,
                   prefill_reuse: float = 0.0,
                   context_buckets=None, device=None) -> ServingPlan:
    """Latency-bounded throughput search over (dp, tp, KV layout,
    kv_dtype) for the decode graph (kv_dtype ∈ {native, int8} is the
    precision-for-bandwidth axis; ``--kv-dtype`` pins it
    instead of searching). Returns the winning ServingPlan with the
    ranked runner-up chain; the warm Simulator rides along for elastic
    re-searches (``ServingEngine.elastic_replan``). ``kv_fill`` prices
    the decode KV read at a mean occupancy fraction (paged layout —
    the simulated paged-vs-ring ratio). ``prefill_reuse`` prices the
    prefix cache the same way: the expected
    fraction of prefill tokens served from the radix trie — measured
    (``ServingStats.prefix_reuse_rate``, what ``elastic_replan``
    feeds) or assumed — scales the p99 prefill stall term, so a
    high-hit-rate fleet stops over-providing for a cold-cache worst
    case the SLO never sees.

    ``context_buckets`` makes context-length bucketing a
    searched axis: for each bucket (defaulted from
    ``config.context_buckets``) the objective picks seq_shards from the
    interconnect closed forms (``_bucket_seq_shards``) and records it on the
    plan — ``plan.seq_shards_for(context_len)`` is the admission
    router's lookup. ``device`` is handed to ``GPUMachineModel.detect``
    when no ``machine`` is given (``"cpu"`` for the fixed H100 entry;
    None reads the card)."""
    import time as _time

    from ..obs import SearchLog, get_tracer
    from ..search.machine_model import GPUMachineModel
    from ..search.simulator import Simulator, selfcheck_enabled

    if machine is None:
        machine = GPUMachineModel.detect(n_dev, device=device)
    if sim is None:
        sim = Simulator(machine)
    slots = int(max_inflight or getattr(config, "max_inflight", 8))
    max_len = int(max_decode_len or getattr(config, "max_decode_len", 128))
    slo = slo_p99_ms if slo_p99_ms is not None else \
        float(getattr(config, "slo_p99_ms", 0.0) or 0.0)
    # --kv-dtype pins the axis; the default ("native" config value with
    # a paged cache) searches both storage dtypes
    pinned_dtype = str(getattr(config, "kv_dtype", "native") or "native")
    paged = str(getattr(config, "kv_cache", "paged") or "paged") == "paged"
    kv_dtypes: Tuple[str, ...]
    if not paged:
        kv_dtypes = ("native",)   # int8 is a paged-layout feature
    elif pinned_dtype != "native":
        kv_dtypes = (pinned_dtype,)
    else:
        kv_dtypes = ("native", "int8")

    tracer = get_tracer()
    slog = SearchLog(getattr(config, "search_log_file", "") or None,
                     kind="serving")
    hbm = machine.hbm_capacity
    # expected prefill savings from prefix reuse: a newly-admitted
    # request stalls the batch for only the UNCACHED fraction of its
    # prompt (zero-compute trie mapping covers the rest)
    reuse = max(min(float(prefill_reuse), 1.0), 0.0)
    t0 = _time.perf_counter()

    def sweep(active_sim) -> List[Tuple[ServingCandidate, Dict]]:
        from ..search.unity import factorizations

        out = []
        # the prefill graph is factorization-independent (batch 1, max
        # bucket) and its cost depends only on tp — build once, price per
        # distinct tp
        prefill_g = reshape_graph(pcg, 1, max_len)
        t_pre_by_tp: Dict[int, float] = {}
        for dp, tp in factorizations(n_dev):
            if slots % dp != 0:
                continue
            s_r = slots // dp
            decode_g = reshape_graph(pcg, s_r, 1)
            if tp not in t_pre_by_tp:
                t_pre_by_tp[tp], _pm, _a = _graph_cost(
                    active_sim, prefill_g, tp, 1, 1, max_len, decode=False)
            t_pre = t_pre_by_tp[tp] * (1.0 - reuse)
            layouts = ("sharded", "replicated") if tp > 1 else \
                ("replicated",)
            for layout in layouts:
                kv_div = tp if layout == "sharded" else 1
                for kv_dtype in kv_dtypes:
                    t_dec, mem, assignment = _graph_cost(
                        active_sim, decode_g, tp, kv_div, s_r, max_len,
                        decode=True, kv_dtype=kv_dtype, kv_fill=kv_fill)
                    p50 = t_dec * 1e3
                    p99 = (t_dec + t_pre) * 1e3
                    feas = mem <= hbm and (slo <= 0 or p99 <= slo)
                    out.append((ServingCandidate(
                        mesh_shape=(dp, tp), layout=layout,
                        slots_per_replica=s_r, kv_dtype=kv_dtype,
                        sim_decode_ms=round(t_dec * 1e3, 4),
                        sim_prefill_ms=round(t_pre * 1e3, 4),
                        sim_p50_ms=round(p50, 4), sim_p99_ms=round(p99, 4),
                        sim_tokens_per_s=slots / t_dec,
                        sim_memory=int(mem), feasible=bool(feas)),
                        assignment))
        return out

    with tracer.span("serving_search", n_dev=n_dev):
        cands = sweep(sim)
        if not cands:
            raise ServingSearchError(
                f"no serving candidate for n_dev={n_dev}: max_inflight="
                f"{slots} must be divisible by some dp factor")
        for c, _a in cands:
            slog.log(event="candidate", mesh=list(c.mesh_shape),
                     layout=c.layout, kv_dtype=c.kv_dtype,
                     slots_per_replica=c.slots_per_replica,
                     decode_ms=c.sim_decode_ms, prefill_ms=c.sim_prefill_ms,
                     p99_ms=c.sim_p99_ms,
                     tokens_per_s=round(c.sim_tokens_per_s, 2),
                     mem_mib=round(c.sim_memory / 2 ** 20, 1),
                     feasible=c.feasible, cost_ms=c.sim_decode_ms,
                     accepted=c.feasible)

        def rank_key(pair):
            c = pair[0]
            return (not c.feasible, -c.sim_tokens_per_s, c.sim_p99_ms,
                    repr((c.mesh_shape, c.layout, c.kv_dtype)))

        ordered = sorted(cands, key=rank_key)
        winner, win_assignment = ordered[0]

        if selfcheck_enabled():
            # delta-cost equivalence gate: the memoized sweep must price
            # identically to a cold simulator (same contract as the
            # training search's FLEXFLOW_TPU_SEARCH_SELFCHECK)
            fresh = sweep(Simulator(machine))
            fresh_ordered = sorted(fresh, key=rank_key)
            fw = fresh_ordered[0][0]
            assert (fw.mesh_shape, fw.layout, fw.kv_dtype) == \
                (winner.mesh_shape, winner.layout, winner.kv_dtype), \
                f"serving selfcheck: cached winner {winner.describe()} != " \
                f"fresh winner {fw.describe()}"
            for (a, _), (b, _) in zip(ordered, fresh_ordered):
                assert abs(a.sim_decode_ms - b.sim_decode_ms) <= \
                    1e-9 + 1e-6 * abs(b.sim_decode_ms), \
                    f"serving selfcheck: {a.describe()} cost drifted"

    # context-length bucketing: per searched bucket, pick
    # seq_shards from the interconnect closed forms under the WINNER's kv_dtype
    # and slot count — the bucket axis rides on top of the chosen mesh
    from .kvcache import parse_context_buckets

    buckets = parse_context_buckets(
        context_buckets if context_buckets is not None
        else getattr(config, "context_buckets", "") or "")
    shards_by_bucket: Dict[int, int] = {}
    for bucket in buckets:
        bs, t_kv, t_comb, fits = _bucket_seq_shards(
            pcg, machine, n_dev, slots, bucket, winner.kv_dtype, kv_fill)
        shards_by_bucket[bucket] = bs
        slog.log(event="bucket", context_bucket=bucket, seq_shards=bs,
                 kv_stream_ms=round(t_kv * 1e3, 4),
                 combine_ms=round(t_comb * 1e3, 4),
                 kv_fits_one_chip=bool(fits),
                 cost_ms=round((t_kv + t_comb) * 1e3, 4), accepted=True)

    wall = _time.perf_counter() - t0
    plan = ServingPlan(
        mesh_shape=winner.mesh_shape, layout=winner.layout, slots=slots,
        max_decode_len=max_len, slo_p99_ms=slo,
        kv_dtype=winner.kv_dtype, prefill_reuse=reuse,
        context_buckets=buckets, seq_shards_by_bucket=shards_by_bucket,
        sim_decode_ms=winner.sim_decode_ms,
        sim_prefill_ms=winner.sim_prefill_ms,
        sim_p50_ms=winner.sim_p50_ms, sim_p99_ms=winner.sim_p99_ms,
        sim_tokens_per_s=winner.sim_tokens_per_s,
        sim_memory=winner.sim_memory, feasible=winner.feasible,
        assignment=win_assignment,
        ranked=[c for c, _a in ordered], sim=sim)
    slog.log(event="result", mesh=list(winner.mesh_shape),
             layout=winner.layout, kv_dtype=winner.kv_dtype,
             prefill_reuse=round(reuse, 4),
             cost_ms=winner.sim_decode_ms, p99_ms=winner.sim_p99_ms,
             tokens_per_s=round(winner.sim_tokens_per_s, 2),
             mem_mib=round(winner.sim_memory / 2 ** 20, 1),
             feasible=winner.feasible, search_wall_s=round(wall, 4),
             **sim.cache_stats())
    slog.close()
    return plan
