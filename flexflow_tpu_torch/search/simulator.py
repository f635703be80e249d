"""Cost model + task-graph simulator for candidate parallelization strategies.

A copy of ``flexflow_tpu.search.simulator`` on the port's PCG and ops
(reference: the Simulator, src/runtime/simulator.cc:1880 —
``measure_operator_cost`` caching per-(op, view) timings and
``simulate_runtime`` event-driven execution of the task graph with comm
tasks). The analytic part is the JAX module's, formula for formula, so
the same machine fields and graph give the same prices:

* Per-op cost is a **roofline** over the ``GPUMachineModel``
  (max(FLOPs / peak, bytes / HBM rate), the rates scaled by the
  efficiencies measured on the card), calibrated against measurements
  (``calibrate``, ``calibrate_from_pcg``, ``calibrate_from_profile``).
* Communication is priced with the alpha-beta collective formulas over
  NVLink and the network between nodes.
* ``measure_operator_cost`` times one op standalone on the card through
  the port's own op (``ops.base.run_op``: the attention op reaches the
  flash kernels B1, and B2 for ``"grad"``), CUDA events around each of
  ``_TIMED_REPLAYS`` replays of a captured graph of ``_MEASURE_ITERS``
  calls, the median kept; no dispatch round trip is subtracted.
* Delta-cost engine: ``op_cost`` and the DP search's per-node option
  tables are memoized in bounded LRUs keyed by (op params, in-shapes,
  sharding, dcn); calibration and knob changes flush them; the
  ``FLEXFLOW_TPU_SEARCH_SELFCHECK`` environment variable re-derives every
  hit and asserts equality (a test gate).
* Remat axis: ``OpSharding.remat`` prices activation rematerialization,
  and ``simulate``'s full-remat peaks are priced on the same blocks the
  executor cuts (``execution.remat.remat_segments``).
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ..execution.remat import REMAT_SAVEABLE_OPS, remat_segments
from ..ffconst import OperatorType, size_of_datatype
from ..ops.base import op_flops
from ..parallel.pcg import PCG, PCGNode
from .machine_model import GPUMachineModel

# ops whose cost is tensor-core-bound — the same contraction family whose
# outputs
# the `selective` remat policy saves; ONE set (execution/remat.py) so the
# roofline classification and the analytic keep-fraction can never drift
# from the dots_saveable policy's actual save set
_MATMUL_OPS = REMAT_SAVEABLE_OPS


@dataclasses.dataclass
class CostMetrics:
    """Per-op costs (reference: simulator.h:54-88)."""

    forward_time: float = 0.0  # seconds
    backward_time: float = 0.0
    sync_time: float = 0.0  # gradient allreduce
    comm_time: float = 0.0  # activation resharding
    update_time: float = 0.0  # optimizer step (HBM-bound elementwise)
    inputs_memory: int = 0
    outputs_memory: int = 0
    weights_memory: int = 0

    def total_time(self) -> float:
        return (self.forward_time + self.backward_time + self.sync_time
                + self.comm_time + self.update_time)


@dataclasses.dataclass(frozen=True)
class OpSharding:
    """The search's per-op decision: data-parallel degree, model(tensor)
    degree, and how the model degree is applied. TPU-native MachineView
    (SURVEY §7: the searched space of the reference's
    register_all_machine_views is 1-D divisor-degree views — (dp, tp)
    factorizations cover it).

    ``act_tp`` covers pass-through sharded states (kind == "none" but the
    activation rides the model axis in state S or Q): the op's compute and
    activation memory shard over dp*act_tp while its weights stay
    replicated — e.g. a per-token dense inside a sequence-parallel region.

    ``remat`` is the activation-rematerialization level this op trains
    under (execution.remat.REMAT_LEVELS): it is part of the op-cost cache
    key by construction (this dataclass is the key component), so costs
    priced at one level are never served at another.

    ``in_params_dtype`` (the port's alone) marks an op that runs in its
    params' dtype whatever the compute dtype, as a pipeline stage does: an
    fp32 op then takes the machine's fp32 matmul rate."""

    dp: int = 1
    tp: int = 1
    kind: str = "none"  # none|col|row|heads|table|expert|ring
    act_tp: int = 1
    remat: str = "none"  # none|selective|full (jax.checkpoint level)
    in_params_dtype: bool = False

    @property
    def degree(self) -> int:
        return self.dp * (self.tp if self.kind != "none" else self.act_tp)


def op_in_state(sh: Optional["OpSharding"], out_state: str) -> str:
    """The sharding state an op's chosen kind CONSUMES (col eats R and emits
    S; row eats S and emits R; ring eats/emits Q; state-preserving kinds eat
    what they emit). Used to price resharding on the true input edge, not
    the producer-out vs consumer-out mismatch."""
    if sh is None:
        return "R"
    if sh.kind == "col":
        return "R"
    if sh.kind == "row":
        return "S"
    if sh.kind == "ring":
        return "Q"
    if sh.kind == "spatial":
        return "H"
    if sh.kind in ("heads", "table", "expert"):
        return "R"
    return out_state


def sequence_schedule(node: PCGNode, in_shapes, sh: "OpSharding",
                      machine, tp_dcn: int = 1) -> Tuple[str, float]:
    """Pick the sequence-parallel schedule for a ring-kind attention op and
    return (schedule, comm_time): "ring" (k/v rotation,
    kernels/ring_attention.py) or "alltoall" (Ulysses head re-partition,
    kernels/ulysses_attention.py). All-to-all moves ~P/2x less data but
    materializes the full (s, s) score block per local head group, so it is
    eligible only when the head count divides the axis AND that block fits
    comfortably in HBM (<= 1/8 capacity) — long-context configs keep ring's
    O((s/P)^2) memory. Both ``Simulator.op_cost`` and the strategy emission
    (unity.assignment_to_strategy) use THIS function, so the search's costs
    always match the executed schedule."""
    el = size_of_datatype(node.op.data_type)
    in_bytes = sum(int(np.prod(s)) for s in in_shapes) * el
    deg = max(sh.degree, 1)
    tp_ici = max(sh.tp // max(tp_dcn, 1), 1)
    # concurrent ring groups per host share the NIC (same formula as
    # Simulator._nic_sharers, so sim and emission price identically)
    sharers = max(machine.chips_per_host // tp_ici, 1)
    # k+v are 2 of the 3 equally-sized self-attention inputs
    kv_per_chip = int(2 * in_bytes / 3) // deg
    ring_t = machine.hier_allgather_time(kv_per_chip, tp_ici, tp_dcn,
                                         nic_sharers=sharers)
    heads = node.op.attrs.get("num_heads", 0)
    if not heads or heads % sh.tp != 0:
        return "ring", ring_t
    b, s = in_shapes[0][0], in_shapes[0][1]
    score_bytes = (b / max(sh.dp, 1)) * (heads / sh.tp) * s * s * 4  # f32
    if score_bytes > machine.hbm_capacity / 8:
        return "ring", ring_t
    # 4 all-to-alls (q, k, v in; out back) of the local activation volume
    aa_t = 4 * machine.hier_alltoall_time(int(in_bytes / 3) // deg,
                                          tp_ici, tp_dcn,
                                          nic_sharers=sharers)
    if aa_t < ring_t:
        return "alltoall", aa_t
    return "ring", ring_t


# test-only equivalence gate for the delta-cost engine: when set, every
# cache hit is re-derived from scratch and compared, and the incremental DP
# in unity.best_first_optimize is shadowed by a full re-cost — identical
# chosen strategies and costs (within float tolerance) are asserted.
SELFCHECK_ENV = "FLEXFLOW_TPU_SEARCH_SELFCHECK"


def selfcheck_enabled() -> bool:
    return bool(os.environ.get(SELFCHECK_ENV))


def _assert_cost_close(fresh: "CostMetrics", cached: "CostMetrics",
                       key: Tuple) -> None:
    for f in dataclasses.fields(CostMetrics):
        a = getattr(fresh, f.name)
        b = getattr(cached, f.name)
        if not math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-12):
            raise AssertionError(
                f"delta-cost selfcheck: cached {f.name}={b!r} != "
                f"fresh {a!r} for key {key!r} — a cost knob changed "
                f"without invalidate_cost_tables()")


_KNOB_UNSET = object()


def _cost_knob(name: str, doc: str = ""):
    """A Simulator attribute that parameterizes memoized costs: setting it
    to a NEW value flushes the delta-cost tables, so stale entries priced
    under the old calibration/memory model can never be served."""
    attr = "_knob_" + name

    def fget(self):
        return getattr(self, attr)

    def fset(self, value):
        old = getattr(self, attr, _KNOB_UNSET)
        setattr(self, attr, value)
        if old is not _KNOB_UNSET and old != value:
            self.invalidate_cost_tables()

    return property(fget, fset, doc=doc)


class Simulator:
    # cost knobs: every memoized (time, mem, comm) entry is a function of
    # these, so assignment auto-flushes the caches (delta-cost engine)
    calibration = _cost_knob(
        "calibration", "global measured/analytical scale factor")
    update_bytes_factor = _cost_knob("update_bytes_factor")
    op_overhead = _cost_knob("op_overhead")
    opt_state_words = _cost_knob("opt_state_words")
    activation_el = _cost_knob(
        "activation_el", "bytes per saved-activation element (compute dtype)")
    remat_segment_size = _cost_knob(
        "remat_segment_size",
        "compute nodes per full-remat block — MUST match the Executor's "
        "config.remat_segment_size or the analytic boundary/transient "
        "pricing diverges from the blocks actually checkpointed "
        "(unity_search threads it through)")

    def __init__(self, machine: GPUMachineModel,
                 overlap_backward_update: bool = False,
                 cost_cache_size: int = 1 << 17,
                 calibration_dir: Optional[str] = None,
                 dtype_label: Optional[str] = None):
        self.machine = machine
        self.overlap = overlap_backward_update
        # per-remat-block psum overlap pricing (--collective-overlap on):
        # set by unity_search; distinct from the legacy coarse `overlap`
        # knob — see simulate()'s two hiding models
        self.block_overlap = False
        self._measure_cache: Dict[Tuple, float] = {}
        # ---- delta-cost engine (reference: simulator.cc's cached task
        # costs making delta re-simulation tractable). Bounded LRUs keyed by
        # (op params key, in-shapes, sharding, dcn): entries persist across
        # factorization sweeps, λ iterations and rewrite candidates; the
        # dcn topology is part of the key (set_axis_topology never serves a
        # stale entry), while calibration/knob changes flush everything via
        # invalidate_cost_tables(). cost_cache_size <= 0 disables caching
        # (full re-costing — the equivalence baseline in tests).
        self.cost_cache_size = cost_cache_size
        self._cost_cache: "OrderedDict[Tuple, CostMetrics]" = OrderedDict()
        self._table_cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._reshard_cache: "OrderedDict[Tuple, float]" = OrderedDict()
        self.cost_cache_hits = 0
        self.cost_cache_misses = 0
        self.table_hits = 0
        self.table_misses = 0
        self.calibration = 1.0  # global measured/analytical scale factor
        # per-op-key measured/analytical ratios (reference: the per-(op,view)
        # cost cache of simulator.cc:489; here per op-shape, scaled
        # analytically across shardings)
        self._key_calibration: Dict[Tuple, float] = {}
        # persistent calibration tables:
        # repr(op key) -> {"calibration": r, "bwd_ratio": b} loaded from the
        # per-(chip generation, dtype) JSON store under --calibration-dir
        # and adopted lazily the first time a key is priced (repr() of the
        # key stays off the memoized hot path; op_cost's LRU bounds how
        # often the uncached path runs)
        self.calibration_dir = calibration_dir
        self.dtype_label = dtype_label or "f32"
        # the step's matmuls run in fp32 (the machine's matmul_flops_f32
        # prices them where it sets one)
        self.compute_f32 = self.dtype_label in ("f32", "f")
        self._persisted_calibration: Dict[str, Dict] = {}
        self._persist_checked: Set[Tuple] = set()
        if calibration_dir:
            from .calibration import load_persistent_calibration

            load_persistent_calibration(self)
        # per-op-key MEASURED backward/forward ratios (reference times
        # backward explicitly: inner_measure_operator_cost runs both
        # directions, simulator.cc:537 / model.cu:38). Keys absent here
        # fall back to the analytical 2x/1x heuristic.
        self._key_bwd_ratio: Dict[Tuple, float] = {}
        # optimizer-update HBM traffic per weight byte: Adam-style reads
        # w+g+m+v and writes w+m+v -> ~7 bytes moved per weight byte
        # (reference: optimizer_kernel.cu adam_update_task). Set 0 to price
        # bare SGD (in-place w -= lr*g streams ~3x).
        self.update_bytes_factor = 7.0
        # fixed per-op scheduling overhead (s): the reference's measured
        # task costs inherently include the Legion task-launch overhead
        # (Unity's simulator times whole task bodies, simulator.cc:489);
        # XLA's analog is sub-microsecond per-HLO scheduling. This term is
        # what makes op-count-reducing rewrites (activation fusions, the
        # TASO collection's shrinking rules) properly valued — without it
        # merging two elementwise ops is cost-neutral in a pure roofline.
        self.op_overhead = 5e-7
        # optimizer state words per weight word resident all step (Adam m+v
        # = 2; bare SGD = 0); weights count x(1 + opt_state_words) in the
        # peak-memory model
        self.opt_state_words = 2
        # bytes per saved-activation element under mixed precision (set by
        # calibrate_from_pcg from its compute_dtype; None = the op dtype) —
        # XLA saves residuals in the COMPUTE dtype, so bf16 halves the
        # activation term of the peak-memory model
        self.activation_el: Optional[int] = None
        # full-remat block size for simulate()'s boundary/transient pricing
        # (RematPlan.segment_size default; unity_search overrides from
        # config so sim and executor cut identical blocks)
        self.remat_segment_size = 8
        # per-graph segmentation memo (bottleneck analysis is O(V+E) and
        # simulate() sits in the search's hottest loop); weak keys — a
        # dead candidate graph drops its entry, and object identity avoids
        # the guid-mismatch a structural-hash key would allow between
        # isomorphic graphs with different guids
        import weakref

        self._segment_memo: "weakref.WeakKeyDictionary[PCG, Dict]" = \
            weakref.WeakKeyDictionary()
        # which mesh axis carries the machine's DCN factor for the candidate
        # being costed (reference: intra- vs inter-node pricing in
        # EnhancedMachineModel, simulator.h:212-606). dp_dcn * tp_dcn ==
        # machine.num_hosts when a hybrid placement is being evaluated.
        self.dp_dcn = 1
        self.tp_dcn = 1

    def set_axis_topology(self, dp_dcn: int = 1, tp_dcn: int = 1) -> None:
        """Declare how the candidate mesh maps onto hosts: ``dp_dcn`` /
        ``tp_dcn`` are the DCN-spanning subfactors of the data and model
        axes. Collective costs for an axis with a DCN factor pay DCN
        latency/bandwidth for the cross-host phase."""
        self.dp_dcn = max(dp_dcn, 1)
        self.tp_dcn = max(tp_dcn, 1)

    def scaled_bytes(self, nbytes: int, node: PCGNode) -> int:
        """Re-price ``nbytes`` (computed at the op's declared dtype) into
        the COMPUTE dtype: under mixed precision both the saved residuals
        and the weight grads live in ``activation_el``-byte elements."""
        if self.activation_el is None:
            return nbytes
        el = size_of_datatype(node.op.data_type)
        return int(nbytes * self.activation_el // max(el, 1))

    def act_bytes(self, node: PCGNode, cm: "CostMetrics") -> int:
        """This node's saved-activation bytes in the compute dtype."""
        return self.scaled_bytes(cm.outputs_memory, node)

    @staticmethod
    def remat_keep_fraction(node: PCGNode, level: str) -> float:
        """Fraction of this node's saved-for-backward activation that stays
        resident under a remat level — THE shared accounting all three
        memory consumers price with (simulate's peak, unity's DP tables,
        simulate_pipeline's stage estimate; see execution/remat.py):
        ``none`` keeps everything; ``selective`` keeps only contraction
        outputs (the dots_saveable policy's save set) and recomputes the
        cheap tail; ``full`` keeps nothing per node — block boundaries and
        the recompute transient are priced separately in ``simulate``."""
        if level == "none" or level not in ("selective", "full"):
            return 1.0
        if level == "selective":
            return 1.0 if node.op.op_type in REMAT_SAVEABLE_OPS else 0.0
        return 0.0

    def node_resident_bytes(self, node: PCGNode, cm: "CostMetrics",
                            remat: str = "none") -> int:
        """Per-node resident memory under the liveness-aware model — the
        SAME formula ``simulate``'s peak sums (saved activation in the
        compute dtype scaled by the remat keep-fraction + f32 master
        weights with optimizer moments + the weight grad in the compute
        dtype), shared so the memory-λ DP and the feasibility check price
        one model. Under ``full`` remat the per-node activation term is 0
        (a LOWER bound — simulate() adds back block boundaries and the
        recompute transient, which do not decompose per node)."""
        keep = self.remat_keep_fraction(node, remat)
        return (int(self.act_bytes(node, cm) * keep)
                + cm.weights_memory * (1 + self.opt_state_words)
                + self.scaled_bytes(cm.weights_memory, node))

    def _remat_segments_for(self, pcg: PCG):
        """Memoized ``remat_segments`` at the simulator's block size —
        identical cuts to the Executor's; keyed by graph identity so the
        memo can never serve another graph's guids."""
        per = self._segment_memo.get(pcg)
        if per is None:
            per = {}
            self._segment_memo[pcg] = per
        size = self.remat_segment_size
        segs = per.get(size)
        if segs is None:
            per[size] = segs = remat_segments(pcg, size)
        return segs

    def _nic_sharers(self, group_ici: int) -> int:
        """Concurrent distinct collective groups per host sharing the NIC:
        every chip of the host participates in some group; groups with
        ``group_ici`` local members leave chips_per_host/group_ici distinct
        groups contending for the host's DCN bandwidth."""
        return max(self.machine.chips_per_host // max(group_ici, 1), 1)

    # ------------------------------------------------- delta-cost cache API
    def invalidate_cost_tables(self) -> None:
        """Flush every memoized cost: the op-cost LRU, the per-node DP
        option tables (unity._node_cost_entries), and the resharding memo.
        Called automatically when a cost knob changes and by the
        calibration paths — cached entries priced under stale calibration
        would silently re-rank candidates otherwise."""
        self._cost_cache.clear()
        self._table_cache.clear()
        self._reshard_cache.clear()

    def _adopt_persisted(self, key: Tuple) -> float:
        """Lazy adoption of a persisted calibration entry for ``key``: the JSON
        store is repr-keyed, so the string lookup
        happens at most once per distinct key on the UNCACHED path; a hit
        installs the ratio (and measured bwd/fwd ratio, when stored) into
        the in-memory per-key maps."""
        if not self._persisted_calibration or key in self._persist_checked:
            return self.calibration
        self._persist_checked.add(key)
        ent = self._persisted_calibration.get(repr(key))
        if ent is None:
            return self.calibration
        cal = float(ent.get("calibration", self.calibration))
        self._key_calibration[key] = cal
        b = ent.get("bwd_ratio")
        if b is not None:
            self._key_bwd_ratio.setdefault(key, float(b))
        return cal

    def invalidate_op_keys(self, op_keys) -> Dict[str, int]:
        """Selective delta-cost invalidation: drop exactly the
        memoized entries whose ``(op params, in-shapes)`` key is in
        ``op_keys`` — every cached CostMetrics for that key at ANY
        sharding/dcn, and every per-node DP option table built over it —
        leaving the rest of the caches warm (the whole point of per-key
        recalibration vs the knob setters' full flush). The resharding
        memo is untouched: it is a pure machine-model quantity with no
        per-key calibration term. Under ``FLEXFLOW_TPU_SEARCH_SELFCHECK``
        any entry this SHOULD have dropped but didn't is caught by the
        hit-re-derivation gate in ``op_cost``. Returns removal counts."""
        op_keys = set(op_keys)
        stale_cost = [k for k in self._cost_cache
                      if (k[0], k[1]) in op_keys]
        for k in stale_cost:
            del self._cost_cache[k]
        # pod-level ICI sub-solutions (search/multipod.py) aggregate MANY
        # ops' costs under one graph-hash key, so any recalibrated op may
        # have moved any of them — drop them all (cheap: re-solving is a
        # handful of DP passes, serving a stale pod plan is silent)
        stale_table = [k for k in self._table_cache
                       if (len(k) >= 3 and (k[1], k[2]) in op_keys)
                       or (k and k[0] == "ici_pod_solution")]
        for k in stale_table:
            del self._table_cache[k]
        return {"cost_entries": len(stale_cost),
                "table_entries": len(stale_table)}

    def table_get(self, key: Tuple):
        """Look up an opaque per-node cost table (the DP search's per-node
        option entries) in the bounded LRU; None on miss."""
        v = self._table_cache.get(key)
        if v is None:
            self.table_misses += 1
            return None
        self._table_cache.move_to_end(key)
        self.table_hits += 1
        return v

    def table_put(self, key: Tuple, value) -> None:
        if self.cost_cache_size <= 0:
            return
        self._table_cache[key] = value
        if len(self._table_cache) > self.cost_cache_size:
            self._table_cache.popitem(last=False)

    def cache_stats(self) -> Dict[str, Any]:
        """Hit/miss counters for the SearchLog/tracer and bench.py."""
        total = self.cost_cache_hits + self.cost_cache_misses
        return {
            "cost_cache_hits": self.cost_cache_hits,
            "cost_cache_misses": self.cost_cache_misses,
            "cost_cache_hit_rate": round(self.cost_cache_hits / total, 4)
            if total else 0.0,
            "table_hits": self.table_hits,
            "table_misses": self.table_misses,
        }

    # ------------------------------------------------------------ per-op cost
    def op_cost(self, node: PCGNode, in_shapes: List[Tuple[int, ...]],
                sh: OpSharding) -> CostMetrics:
        """Memoized per-op cost: (op params key, in-shapes, sharding, dcn)
        → CostMetrics, held in a bounded LRU that persists across
        factorizations, λ iterations and rewrite candidates (the delta-cost
        engine's ground layer; reference: measure_operator_cost's per-
        (op, MachineView) cache, simulator.cc:489). The returned
        CostMetrics is shared — callers must not mutate it."""
        key = (node.op.params_key(), tuple(map(tuple, in_shapes)), sh,
               self.dp_dcn, self.tp_dcn)
        cached = self._cost_cache.get(key)
        if cached is not None:
            self._cost_cache.move_to_end(key)
            self.cost_cache_hits += 1
            if selfcheck_enabled():
                _assert_cost_close(
                    self._op_cost_uncached(node, in_shapes, sh), cached, key)
            return cached
        self.cost_cache_misses += 1
        cm = self._op_cost_uncached(node, in_shapes, sh)
        if self.cost_cache_size > 0:
            self._cost_cache[key] = cm
            if len(self._cost_cache) > self.cost_cache_size:
                self._cost_cache.popitem(last=False)
        return cm

    def _op_cost_uncached(self, node: PCGNode,
                          in_shapes: List[Tuple[int, ...]],
                          sh: OpSharding) -> CostMetrics:
        m = self.machine
        op = node.op
        out_shapes = node.out_shapes
        el = size_of_datatype(op.data_type)

        flops = op_flops(op, in_shapes, out_shapes)
        in_bytes = sum(int(np.prod(s)) for s in in_shapes) * el
        out_bytes = sum(int(np.prod(s)) for s in out_shapes) * el
        w_bytes = sum(int(np.prod(spec[0]))
                      for spec in op.weight_specs(in_shapes).values()) * el

        deg = max(sh.degree, 1)
        w_shard_kinds = ("col", "row", "heads", "table", "expert")
        w_div = max(sh.tp if sh.kind in w_shard_kinds else 1, 1)
        shard_flops = flops / deg
        shard_bytes = (in_bytes + out_bytes) / deg + w_bytes / w_div

        if op.op_type in _MATMUL_OPS:
            peak = m.peak_flops
            if m.matmul_flops_f32 and el == 4 and (
                    sh.in_params_dtype or self.compute_f32):
                peak = m.matmul_flops_f32
            compute = shard_flops / (peak * m.matmul_efficiency)
        else:
            compute = shard_flops / (m.peak_flops_f32 * m.matmul_efficiency)
        mem_time = shard_bytes / (m.hbm_bandwidth * m.hbm_efficiency)
        key = self._op_key(node, in_shapes)
        cal = self._key_calibration.get(key)
        if cal is None:
            cal = self._adopt_persisted(key)
        fwd = max(compute, mem_time) * cal + self.op_overhead
        # backward: measured per-key ratio when calibrated on device
        # (calibrate_from_pcg times value_and_grad standalone); analytical
        # 2x/1x heuristic otherwise
        bwd = fwd * self._key_bwd_ratio.get(
            key, 2.0 if w_bytes else 1.0)
        # rematerialization recompute rides the backward pass: `full`
        # re-runs every forward once inside the VJP (the GPipe stage-remat
        # trade simulate_pipeline previously hand-rolled); `selective`
        # (dots_saveable) re-runs only the non-contraction tail. Block
        # boundaries under `full` are saved, not recomputed — one node per
        # ~segment_size, absorbed into this per-node bound.
        if sh.remat == "full" or (sh.remat == "selective"
                                  and self.remat_keep_fraction(
                                      node, "selective") < 1.0):
            bwd += fwd

        # DCN subfactors of each axis for the candidate being costed (clamped
        # when this op's sharding does not span the full axis)
        tp_dcn = self.tp_dcn if sh.tp % self.tp_dcn == 0 else 1
        tp_ici = max(sh.tp // tp_dcn, 1)

        # intra-op collective: row-parallel / head-parallel psum of the output
        comm = 0.0
        if sh.kind in ("row", "heads", "table") and sh.tp > 1:
            comm = m.hier_allreduce_time(
                out_bytes // max(sh.dp, 1), tp_ici, tp_dcn,
                nic_sharers=self._nic_sharers(tp_ici))
        elif sh.kind == "ring" and sh.tp > 1:
            # sequence parallel: cost the schedule the emission will pick
            # (ring k/v rotation or all-to-all head re-partition) so the
            # DP's numbers match the executed program
            _, comm = sequence_schedule(node, in_shapes, sh, m,
                                        tp_dcn=tp_dcn)
        elif sh.kind == "expert" and sh.tp > 1:
            # expert parallel: all-to-all token exchange in and out
            comm = 2 * m.hier_alltoall_time(
                in_bytes // deg, tp_ici, tp_dcn,
                nic_sharers=self._nic_sharers(tp_ici))
        elif sh.kind == "spatial" and sh.tp > 1:
            # spatial (height) partition: halo exchange of (kernel_h - 1)
            # boundary input rows with ring neighbors per step (reference:
            # the ghost regions of create_mapping_xfers<Conv2D/Pool2D>,
            # substitution.cc:1797-1800; XLA SPMD materializes them as
            # collective-permutes)
            kh = int(op.attrs.get("kernel_h", 1))
            in0 = in_shapes[0] if in_shapes else None
            if in0 is not None and len(in0) == 4 and in0[2] > 0 and kh > 1:
                row_bytes = int(np.prod(in0)) * el // in0[2]
                comm = m.p2p_time((kh - 1) * row_bytes // max(sh.dp, 1),
                                  "ici")

        # every forward activation collective has a mirror in backward
        # (Megatron's f/g conjugate operators; ring attention re-rotates k/v
        # and reduces dk/dv; EP re-runs the token all-to-all) — the
        # reference prices fwd and bwd comm separately (simulator.cc:489,537)
        comm *= 2.0

        # gradient sync: weights replicated over dp -> allreduce over dp;
        # ring attention, spatial partitioning and pass-through SP states
        # replicate weights over tp too, so their grads reduce over dp*tp
        sync = 0.0
        sync_n = sh.dp * (sh.tp if sh.kind in ("ring", "spatial")
                          else sh.act_tp)
        if w_bytes and sync_n > 1:
            spans_tp = sh.kind in ("ring", "spatial") or sh.act_tp > 1
            sync_dcn = (self.dp_dcn if sh.dp % self.dp_dcn == 0 else 1) * \
                (tp_dcn if spans_tp else 1)
            if sync_n % sync_dcn != 0:
                sync_dcn = 1
            sync_ici = sync_n // sync_dcn
            sync = m.hier_allreduce_time(
                w_bytes // w_div, sync_ici, sync_dcn,
                nic_sharers=self._nic_sharers(sync_ici))

        # optimizer step: elementwise over this op's weight shard, HBM-bound
        # (reference prices update explicitly via optimizer kernels,
        # src/runtime/optimizer_kernel.cu) — at BERT-Large scale Adam moves
        # ~7x the weight bytes and is a double-digit % of the step
        # the 7-stream update runs at the machine's MEASURED multi-stream
        # HBM fraction, not the single-stream hbm_efficiency (2.3x DLRM
        # under-pricing otherwise — see GPUMachineModel.update_hbm_efficiency)
        update = 0.0
        if w_bytes:
            update = (self.update_bytes_factor * w_bytes / w_div
                      / (m.hbm_bandwidth * m.update_hbm_efficiency))

        return CostMetrics(
            forward_time=fwd, backward_time=bwd, sync_time=sync,
            comm_time=comm, update_time=update,
            inputs_memory=int(in_bytes / deg),
            outputs_memory=int(out_bytes / deg),
            weights_memory=int(w_bytes / w_div))

    # ----------------------------------------------------- transition costs
    def resharding_cost(self, bytes_total: int, src_state: str,
                        dst_state: str, dp: int, tp: int) -> float:
        """Cost of moving an activation between sharding states.

        States: 'R' = sharded over data only (replicated over model axis),
        'S' = additionally sharded over the model (hidden) axis, 'Q' =
        additionally sharded over the sequence dim, 'H' = over the spatial
        height dim (NCHW CNNs). These transitions are the Repartition/
        Combine/AllToAll parallel ops of the reference (src/parallel_ops/):
        R->{S,Q,H} is a local slice (free), {S,Q,H}->R is an all-gather
        over tp, and any sharded<->differently-sharded pair is an
        all-to-all over tp.
        """
        if src_state == dst_state or tp <= 1:
            return 0.0
        key = (bytes_total, src_state, dst_state, dp, tp, self.tp_dcn)
        cached = self._reshard_cache.get(key)
        if cached is not None:
            self._reshard_cache.move_to_end(key)
            return cached
        per_chip = bytes_total // max(dp * tp, 1)
        tp_dcn = self.tp_dcn if tp % self.tp_dcn == 0 else 1
        tp_ici = max(tp // tp_dcn, 1)
        sharers = self._nic_sharers(tp_ici)
        if dst_state == "R":
            cost = self.machine.hier_allgather_time(per_chip, tp_ici, tp_dcn,
                                                    nic_sharers=sharers)
        elif src_state == "R":
            cost = 0.0  # R->S / R->Q: local slice
        else:  # S<->Q
            cost = self.machine.hier_alltoall_time(per_chip, tp_ici, tp_dcn,
                                                   nic_sharers=sharers)
        if self.cost_cache_size > 0:
            self._reshard_cache[key] = cost
            if len(self._reshard_cache) > self.cost_cache_size:
                self._reshard_cache.popitem(last=False)
        return cost

    # ------------------------------------------------------- whole-graph sim
    def simulate(self, pcg: PCG,
                 assignment: Dict[int, OpSharding],
                 states: Optional[Dict[int, str]] = None
                 ) -> Tuple[float, int]:
        """Estimate one training-step time (s) and per-chip memory (bytes)
        for a full per-op assignment (reference: simulate_runtime,
        simulator.cc:815). Sequential compute + exposed communication; with
        ``--overlap`` gradient sync hides behind backward compute."""
        total_compute = 0.0
        total_comm = 0.0
        total_sync = 0.0
        total_bwd = 0.0
        total_update = 0.0
        resident_w = 0
        resident_act = 0
        transient = 0
        states = states or {}
        el_cache: Dict[int, CostMetrics] = {}
        for node in pcg.compute_nodes():
            sh = assignment.get(node.guid, OpSharding())
            in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            cm = self.op_cost(node, in_shapes, sh)
            el_cache[node.guid] = cm
            total_compute += cm.forward_time + cm.backward_time
            total_bwd += cm.backward_time
            total_comm += cm.comm_time
            total_sync += cm.sync_time
            total_update += cm.update_time
            # Per-chip peak memory, liveness-aware (validated against XLA's
            # Compiled.memory_analysis peak, which is ~ arguments + temps
            # with donated outputs aliased):
            #  - weights: master param + optimizer moments resident all step
            #    (f32 p/m/v under Adam = x(1 + opt_state_words)), plus every
            #    weight GRAD in the compute dtype — XLA materializes all of
            #    them before the optimizer-update phase consumes them
            #  - activations: every saved-for-backward output is live at
            #    once when backward starts, in the COMPUTE dtype (bf16
            #    halves it under mixed precision) — x1, not x2: activation
            #    grads are freed as backward consumes them. Remat scales
            #    this by the keep-fraction; `full`-level nodes keep nothing
            #    here (block boundaries + recompute transient added below)
            #  - transient: the widest node's working set (its output grad +
            #    recomputed output + weight grad)
            act = self.act_bytes(node, cm)
            wgrad = self.scaled_bytes(cm.weights_memory, node)
            resident_act += int(act * self.remat_keep_fraction(node,
                                                               sh.remat))
            resident_w += cm.weights_memory * (1 + self.opt_state_words) \
                + wgrad
            transient = max(transient, 2 * act + wgrad)
            # resharding on input edges (against the state the op consumes)
            my_state = op_in_state(sh, states.get(node.guid, "R"))
            for g, i in node.inputs:
                src = pcg.nodes[g]
                if src.op.op_type in (OperatorType.OP_INPUT,
                                      OperatorType.OP_WEIGHT):
                    continue
                src_state = states.get(g, "R")
                nbytes = int(np.prod(src.out_shapes[i])) * size_of_datatype(
                    src.op.data_type)
                # x2: the backward pass runs the transposed resharding
                total_comm += 2 * self.resharding_cost(
                    nbytes, src_state, my_state, sh.dp, sh.tp)
        # `full`-remat blocks: jax.checkpoint(nothing_saveable) over the
        # SAME segments the Executor cuts (execution.remat.remat_segments —
        # one segmentation, two consumers) saves only each block's exposed
        # boundary outputs; during a block's backward the whole block's
        # activations rematerialize transiently. Price exactly that: every
        # cross-block-consumed tensor (the Executor's `needed` set — a
        # forced, non-bottleneck cut can expose several per boundary, e.g.
        # a skip connection) plus the graph sinks stay resident, and the
        # widest block is the transient floor.
        full_guids = {g for g, s in assignment.items()
                      if getattr(s, "remat", "none") == "full"}
        if full_guids:
            segs = self._remat_segments_for(pcg)
            seg_of = {g: k for k, seg in enumerate(segs) for g in seg}
            boundary: Set[int] = set()
            for n in pcg.compute_nodes():
                k = seg_of.get(n.guid)
                for pg, _i in n.inputs:
                    pk = seg_of.get(pg)
                    if pk is not None and pk != k:
                        boundary.add(pg)
            boundary.update(n.guid for n in pcg.sinks()
                            if n.guid in seg_of)
            for seg in segs:
                seg_live = sum(self.act_bytes(pcg.nodes[g], el_cache[g])
                               for g in seg
                               if g in full_guids and g in el_cache)
                transient = max(transient, seg_live)
            resident_act += sum(
                self.act_bytes(pcg.nodes[g], el_cache[g])
                for g in boundary if g in full_guids and g in el_cache)
        if getattr(self, "block_overlap", False):
            # collective-compute overlap (--collective-overlap on):
            # gradient psums issue per remat block as each block's
            # backward completes (executor._blockwise_value_and_grad), so
            # all but the LAST block's sync hides behind the remaining
            # backward compute; the tail block's reduction is always
            # exposed (nothing left to hide behind — with ONE block the
            # executor genuinely hides nothing). K is the executor's own
            # block count — the same segmentation, two consumers
            # (execution.remat.remat_segments).
            k = max(len(self._remat_segments_for(pcg)), 1)
            total_sync = max(total_sync - total_bwd * (k - 1) / k,
                             total_sync / k)
        elif self.overlap:
            # legacy --overlap (overlap backward with optimizer update):
            # the coarse earlier hiding model, kept verbatim so
            # existing --overlap users' rankings don't shift
            total_sync = max(0.0, total_sync - 0.7 * total_bwd)
        return (total_compute + total_comm + total_sync + total_update,
                resident_w + resident_act + transient)

    def simulate_event_driven(self, pcg: PCG,
                              assignment: Dict[int, OpSharding],
                              states: Optional[Dict[int, str]] = None
                              ) -> float:
        """Event-driven makespan via the native task-graph core
        (reference: simulate_runtime's per-device timelines). Two logical
        execution units per chip: the compute stream (0) and the async
        collective/DMA stream (1) — collectives overlap independent compute,
        which the additive model in simulate() cannot express."""
        from ..ffconst import size_of_datatype
        from ..native import simulate_taskgraph

        states = states or {}
        nodes = pcg.compute_nodes()
        idx = {}
        costs: List[float] = []
        devs: List[int] = []
        esrc: List[int] = []
        edst: List[int] = []
        cm_cache: Dict[int, CostMetrics] = {}

        def add_task(cost: float, dev: int) -> int:
            costs.append(cost)
            devs.append(dev)
            return len(costs) - 1

        for node in nodes:
            sh = assignment.get(node.guid, OpSharding())
            in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            cm = self.op_cost(node, in_shapes, sh)
            cm_cache[node.guid] = cm
            fwd = add_task(cm.forward_time, 0)
            idx[node.guid] = fwd
            if cm.comm_time > 0:
                comm = add_task(cm.comm_time, 1)
                esrc.append(fwd)
                edst.append(comm)
                idx[node.guid] = comm  # consumers wait for the collective
            my_state = op_in_state(sh, states.get(node.guid, "R"))
            for g, i in node.inputs:
                if g not in idx:
                    continue
                src_task = idx[g]
                # resharding between states rides the collective stream
                # (reference: comm SimTasks between differently-viewed
                # producer/consumer shards, simulator.cc:815)
                src_state = states.get(g, "R")
                if src_state != my_state:
                    src_node = pcg.nodes[g]
                    nbytes = int(np.prod(src_node.out_shapes[i])) * \
                        size_of_datatype(src_node.op.data_type)
                    # x2: the backward pass runs the transposed resharding
                    xfer = 2 * self.resharding_cost(
                        nbytes, src_state, my_state, sh.dp, sh.tp)
                    if xfer > 0:
                        r = add_task(xfer, 1)
                        esrc.append(src_task)
                        edst.append(r)
                        src_task = r
                esrc.append(src_task)
                edst.append(fwd)
        # backward + sync: mirror the forward chain; grad allreduces go on the
        # collective stream and overlap the rest of the backward pass
        bwd_prev = None
        for node in reversed(nodes):
            cm = cm_cache[node.guid]
            bwd = add_task(cm.backward_time, 0)
            if bwd_prev is not None:
                esrc.append(bwd_prev)
                edst.append(bwd)
            else:
                esrc.append(idx[nodes[-1].guid])
                edst.append(bwd)
            bwd_prev = bwd
            last = bwd
            if cm.sync_time > 0:
                sync = add_task(cm.sync_time, 1)
                esrc.append(bwd)
                edst.append(sync)
                last = sync
            if cm.update_time > 0:
                # optimizer update streams HBM on the compute stream once
                # the (synced) grads are ready
                upd = add_task(cm.update_time, 0)
                esrc.append(last)
                edst.append(upd)
        return simulate_taskgraph(
            np.asarray(costs), np.asarray(devs), 2,
            np.asarray(esrc, dtype=np.int32),
            np.asarray(edst, dtype=np.int32))

    # -------------------------------------------- measured mode (on device)
    @staticmethod
    def _op_key(node: PCGNode, in_shapes: List[Tuple[int, ...]]) -> Tuple:
        return (node.op.params_key(), tuple(map(tuple, in_shapes)))

    def calibrate_from_pcg(self, pcg: PCG, max_ops: int = 64,
                           compute_dtype=None, device=None) -> int:
        """Measure every distinct op shape in the graph on the current backend
        and store per-key measured/analytical ratios, so ``op_cost`` returns
        device-calibrated times (reference: Simulator::measure_operator_cost
        ground truth feeding graph_cost, simulator.cc:489). Returns the number
        of distinct ops measured. Cheap on repetitive graphs: BERT-Large has
        ~7 distinct op shapes across 24 layers.

        Also records the compute dtype's element size for the peak-memory
        model (saved activations live in the compute dtype)."""
        # flush the delta-cost tables on both sides of calibration: entries
        # priced before the per-key ratios land are stale the moment they do
        self.invalidate_cost_tables()
        if compute_dtype is not None:
            self.activation_el = compute_dtype.itemsize
        from ..obs import get_tracer

        tracer = get_tracer()
        measured = 0
        for node in pcg.compute_nodes():
            in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            in_dtypes = [pcg.nodes[g].out_dtypes[i] for g, i in node.inputs]
            key = self._op_key(node, in_shapes)
            if key in self._key_calibration:
                continue
            if measured >= max_ops:
                break
            # calibrate against the ROOFLINE term alone: op_cost predicts
            # roofline*cal + op_overhead, so the ratio must be computed on
            # (measured - overhead)/roofline or calibrated predictions
            # would not reproduce the measurement for small ops
            analytical = self.op_cost(node, in_shapes,
                                      OpSharding()).forward_time \
                - self.op_overhead
            if analytical <= 0:
                continue
            try:
                t = self.measure_operator_cost(
                    node, in_shapes, compute_dtype=compute_dtype,
                    in_dtypes=in_dtypes, device=device)
            except Exception:
                continue  # op not measurable standalone (e.g. host-side)
            if t > 0:
                self._key_calibration[key] = \
                    max(t - self.op_overhead, 0.1 * t) / analytical
                measured += 1
                if tracer.enabled:
                    # calibration record: how far the roofline was off for
                    # this op shape (the search's ground-truth anchor)
                    tracer.event(
                        "op_calibration", op=node.name,
                        op_type=node.op.op_type.name,
                        measured_us=round(t * 1e6, 2),
                        analytical_us=round(
                            (analytical + self.op_overhead) * 1e6, 2),
                        ratio=round(self._key_calibration[key], 4))
                # measured backward: time fwd+bwd together (what training
                # compiles) and store the bwd/fwd ratio, replacing the
                # flat 2x heuristic (reference: simulator.cc:537)
                try:
                    tg = self.measure_operator_cost(
                        node, in_shapes, compute_dtype=compute_dtype,
                        direction="grad", in_dtypes=in_dtypes,
                        device=device)
                except Exception:
                    continue  # not differentiable standalone — keep 2x
                if tg > t:
                    # clamp to the physically plausible band (bwd recomputes
                    # ~2 forward-sized passes plus extra HBM traffic) so a
                    # noisy micro-measurement cannot distort the ranking
                    self._key_bwd_ratio[key] = min(
                        max((tg - t) / t, 0.25), 4.0)
        self.invalidate_cost_tables()
        return measured

    def calibrate_from_profile(self, profile, pcg: PCG,
                               min_rel_change: float = 0.05
                               ) -> Dict[str, Any]:
        """Fold MEASURED per-op timings (an ``obs.profile.OpProfile`` —
        the ProfiledStep pass of a live fit, or a ``--profile-ops`` JSONL
        replayed via ``--calibrate-from-trace``) back into the per-key
        calibration, closing the loop the tracer opened: records join the graph
        on
        ``repr(_op_key(node, in_shapes))`` — the SAME signature the
        op-cost cache is keyed by — and each matched key's ratio is
        re-derived from the measurement at the record's own sharding/dcn.

        Only keys whose calibration moves by more than ``min_rel_change``
        (relative) are updated, and ONLY their delta-cost cache entries
        are invalidated (``invalidate_op_keys`` — no full flush; the
        selfcheck env gate re-derives every later hit, so a stale entry
        cannot survive unnoticed). Returns ``{matched, updated,
        invalidated, updates}``; ``updates`` lists
        ``(key_repr, old_cal, new_cal)``."""
        records = getattr(profile, "latest_by_key", None)
        by_key = (records() if records is not None
                  else {r.key: r for r in profile})
        node_map: Dict[str, Tuple[PCGNode, List, Tuple]] = {}
        for node in pcg.compute_nodes():
            in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            k = self._op_key(node, in_shapes)
            node_map.setdefault(repr(k), (node, in_shapes, k))
        matched = 0
        moved: Dict[Tuple, Tuple[float, float]] = {}
        updates = []
        for krepr, rec in by_key.items():
            ent = node_map.get(krepr)
            if ent is None:
                continue
            node, in_shapes, key = ent
            matched += 1
            sh_d = dict(rec.sharding or {})
            sh = OpSharding(
                dp=int(sh_d.get("dp", 1)), tp=int(sh_d.get("tp", 1)),
                kind=str(sh_d.get("kind", "none")),
                act_tp=int(sh_d.get("act_tp", 1)),
                remat=str(sh_d.get("remat", "none")))
            old_dcn = (self.dp_dcn, self.tp_dcn)
            self.set_axis_topology(*(rec.dcn or (1, 1)))
            try:
                predicted = self.op_cost(node, in_shapes, sh).forward_time
            finally:
                self.set_axis_topology(*old_dcn)
            cal_old = self._key_calibration.get(key, self.calibration)
            roofline = (predicted - self.op_overhead) / max(cal_old, 1e-12)
            t = float(rec.measured_fwd_s)
            if roofline <= 0 or t <= 0:
                continue
            cal_new = max(t - self.op_overhead, 0.1 * t) / roofline
            if abs(cal_new - cal_old) <= min_rel_change * \
                    max(abs(cal_old), 1e-12):
                continue
            self._key_calibration[key] = cal_new
            moved[key] = (cal_old, cal_new)
            updates.append((krepr, cal_old, cal_new))
        inval = (self.invalidate_op_keys(moved)
                 if moved else {"cost_entries": 0, "table_entries": 0})
        from ..obs import get_tracer

        tracer = get_tracer()
        if tracer.enabled and moved:
            tracer.event(
                "calibration_applied", matched=matched, updated=len(moved),
                cost_entries_invalidated=inval["cost_entries"],
                table_entries_invalidated=inval["table_entries"])
        return {"matched": matched, "updated": len(moved),
                "invalidated": inval, "updates": updates}

    def measure_operator_cost(self, node: PCGNode,
                              in_shapes: List[Tuple[int, ...]],
                              iters: Optional[int] = None,
                              compute_dtype=None,
                              direction: str = "fwd",
                              in_dtypes=None, device=None) -> float:
        """Time one op standalone, cached by params key (reference:
        measure_operator_cost, simulator.cc:489 — cudaEvents;
        ``direction="grad"`` mirrors inner_measure_operator_cost running
        both directions, model.cu:38: the forward plus
        ``torch.autograd.grad`` of its first output with respect to the
        weights and the floating inputs).

        The op runs through ``ops.base.run_op`` on tensors drawn from a
        ``torch.Generator`` seeded with 0 (integer inputs are zeros, a
        valid index; ``in_dtypes`` gives the inputs' ``DataType``s, floats
        by default), weights from the op's own initializers, floats in
        ``compute_dtype`` (a torch dtype; the op's dtype by default). So
        the attention op reaches the flash kernels B1 (and B2 for
        ``"grad"``) as the training step does. On CUDA, after two warm-up
        calls, ``iters`` calls are captured into one CUDA graph and its
        replays are timed with CUDA events, the median kept (device time,
        without Python's launch cost, as the captured step runs); each
        replay adds the
        captured kernel launches to the kernels' counts, as a step
        program's replay does. ``device`` is the card by default; the CPU
        only when asked for (``device="cpu"``, wall time of ``iters``
        calls)."""
        key = self._op_key(node, in_shapes) + (str(compute_dtype), direction)
        if key in self._measure_cache:
            return self._measure_cache[key]
        import time

        import torch

        from ..ffconst import DataType, dtype_to_torch
        from ..ops.base import OpContext, run_op

        dev = torch.device(device if device is not None else "cuda")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "measure_operator_cost: no CUDA device; pass device='cpu' "
                "to time the op on the CPU")
        op = node.op
        dt = compute_dtype or dtype_to_torch(op.data_type)
        gen = torch.Generator().manual_seed(0)
        in_dtypes = list(in_dtypes or [op.data_type] * len(in_shapes))
        xs = []
        for shape, idt in zip(in_shapes, in_dtypes):
            tdt = dtype_to_torch(idt)
            if tdt.is_floating_point:
                xs.append(torch.randn(shape, generator=gen).to(dev, dt))
            else:
                xs.append(torch.zeros(shape, dtype=tdt, device=dev))
        params = {}
        for wname, (shape, wdt, init) in op.weight_specs(in_shapes).items():
            w = init(gen, shape, dtype_to_torch(wdt))
            if compute_dtype is not None and w.is_floating_point():
                w = w.to(compute_dtype)
            params[wname] = w.to(dev)
        ctx = OpContext(training=False, device=dev)
        float_ix = [i for i, x in enumerate(xs) if x.is_floating_point()]
        if direction == "grad":
            leaves = [p.requires_grad_() for p in params.values()
                      if p.is_floating_point()]
            for i in float_ix:
                xs[i].requires_grad_()
            leaves += [xs[i] for i in float_ix]
            if not leaves:
                raise ValueError(f"{op.name}: nothing differentiable to time")
            shape0 = node.out_shapes[0]
            dout = torch.randn(shape0, generator=gen).to(dev, dt)

            def call():
                out = run_op(op, node.name, params, xs, ctx, False)[0]
                return torch.autograd.grad(out, leaves, dout.to(out.dtype))
        else:
            def call():
                with torch.no_grad():
                    return run_op(op, node.name, params, xs, ctx, False)

        if dev.type != "cuda":
            n = iters or 8
            call()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            t = max((time.perf_counter() - t0) / n, 1e-7)
        else:
            t = _time_captured(call, iters or _MEASURE_ITERS, dev)
        self._measure_cache[key] = t
        return t

    def calibrate(self, measured_step: float, simulated_step: float) -> None:
        """Scale the analytical model so simulated == measured for a known
        config (replaces cudaEvent ground truth)."""
        if simulated_step > 0:
            self.calibration *= measured_step / simulated_step


# calls captured into the graph that measure_operator_cost times
_MEASURE_ITERS = 20
# replays of that graph timed, each between its own CUDA events; the
# median is kept
_TIMED_REPLAYS = 5
# a spin of this many clock cycles (~0.1 ms) queued before each timed
# replay, so the graph is launched while the card is still busy: the
# start event then runs right before the graph's first kernel, and the
# host's launch latency (which a captured step does not pay op by op)
# stays outside the timing. Without it, a launch-bound op (10-20 us a
# call) read up to 50 % more in one smoke run than in another
_SPIN_CYCLES = 200_000


def _time_captured(call, iters: int, dev) -> float:
    """Seconds a call of ``call`` takes on the card: two warm-up calls on
    the capture stream, ``iters`` calls captured into one CUDA graph,
    one untimed replay, then ``_TIMED_REPLAYS`` replays, each behind a
    spin (``_SPIN_CYCLES``) and between CUDA events, of which the median
    counts. The capture counts the launches of the first replay (as a
    step program's does), each timed replay adds them again."""
    import gc

    import torch

    from ..execution.graphs import (_add_launches, _capture_lock,
                                    capture_stream)
    from ..kernels.counts import start_recording, stop_recording

    stream = capture_stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        call()
        call()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph()
    with _capture_lock:
        gc.collect()
        start_recording(stream)
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                for _ in range(iters):
                    call()
        finally:
            launches = stop_recording(stream)
    graph.replay()  # the capture counted this replay's launches
    torch.cuda.synchronize(dev)
    events = []
    for _ in range(_TIMED_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        graph.replay()
        end.record()
        _add_launches(launches)
        events.append((start, end))
    torch.cuda.synchronize(dev)
    ms = sorted(a.elapsed_time(b) for a, b in events)
    return max(ms[len(ms) // 2] * 1e-3 / iters, 1e-9)
