"""Two-level hierarchical strategy search (a copy of
``flexflow_tpu.search.multipod``): a network level across pods over an
NVLink level inside one (the JAX module's DCN and ICI levels).

The flat ``search_all`` sweep enumerates ``(dp, tp)`` factorizations x DCN
placements over the whole machine, which dies combinatorially at pod scale
(ROADMAP item 3; Alpa/OSDI'22 showed the fix shape: decompose into an
inter-mesh and an intra-mesh level). This module is that decomposition for
TPU multi-pod machines:

* **ICI level** — for one pod's chip budget, solve the full per-op
  sharding problem (dp/tp/spatial/remat via the existing ``{R,S,Q,H}``
  DP) with the simulator pinned to the single-pod topology
  ``set_axis_topology(1, 1)``. Each pod-local sub-solution is memoized by
  ``(pod subgraph signature, chip budget, pod count, lambda, remat,
  search-space, batch)`` in the Simulator's bounded table LRU, so it is
  reused across every DCN candidate of this search AND across searches on
  a warm simulator. The per-node cost entries underneath are guid-free
  (unity._node_cost_entries), so BERT's 24 twin blocks still share one
  entry — per-candidate costing is sublinear in model depth.

* **DCN level** — enumerate cross-pod structure over the memoized ICI
  sub-solutions: FSDP-style cross-pod data parallelism (the pod count
  rides the data axis as its outer, DCN-spanning factor) x a
  gradient-accumulation factor. Each candidate is priced by the
  **composition law**: the pod-local time plus the per-weight-group DCN
  delta (``hier_allreduce(w, n/p, p) - allreduce(w, n)`` — exactly the
  term the flat sweep's dcn-keyed pricing would add), with NO new
  ``op_cost`` calls. Cross-pod *pipeline* structure (pods as pipeline
  stages, schedule per cut) is enumerated by ``unity_search``'s pipeline
  block over the pod-aligned grids this module hands it
  (``pipeline_grids``).

The top composed candidates are then re-priced exactly (the simulator's
dcn-keyed entries at the candidate's real topology), so the winner is
always an exactly-priced plan; on meshes small enough to enumerate both
ways (``FLEXFLOW_TPU_SEARCH_SELFCHECK``), every candidate is re-priced
and the hierarchical winner is asserted identical to the flat
``search_all`` winner.

ShardLint (analysis.analyze_candidate) prunes statically ill-formed ICI
sub-solutions before any DCN candidate is built over them — the same
pre-simulation gate the flat sweep applies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..parallel.pcg import PCG
from .machine_model import GPUMachineModel
from .simulator import Simulator

# exhaustive exact re-pricing below this device count (the selfcheck
# regime: candidate spaces small enough to enumerate both ways); above it
# only the REPRICE_TOP_K best composed candidates are re-priced exactly
SELFCHECK_MAX_DEV = 32
REPRICE_TOP_K = 4
# auto mode turns the hierarchical path on at this chip count (below it
# the flat sweep is cheap and covers strictly more DCN placements)
AUTO_MIN_DEV = 64

# simulated multi-node regression topologies (cost model only, CPU):
# cards -> (pods, generation), a pod one NVLink domain of 8 cards
SIMULATED_TOPOLOGIES: Dict[int, Tuple[int, str]] = {
    256: (32, "h100-sxm"),
    1024: (128, "h100-sxm"),
    4096: (512, "h100-sxm"),
}


def simulated_multipod_machine(num_chips: int,
                               dcn_gbps: float = 0.0) -> GPUMachineModel:
    """One of the pinned regression topologies (SIMULATED_TOPOLOGIES)."""
    if num_chips not in SIMULATED_TOPOLOGIES:
        raise ValueError(
            f"no simulated multi-pod topology for {num_chips} chips; "
            f"pinned sizes: {sorted(SIMULATED_TOPOLOGIES)}")
    pods, gen = SIMULATED_TOPOLOGIES[num_chips]
    return GPUMachineModel.multipod(gen, pods, num_chips // pods,
                                    dcn_gbps=dcn_gbps)


def hierarchical_enabled(config, machine: GPUMachineModel,
                         n_dev: int) -> bool:
    """Whether unity_search routes the SPMD sweep through the two-level
    decomposition: ``--hierarchical-search on`` forces it (pods fall
    back to the host count), ``off`` disables it, ``auto`` (default)
    enables it only for machines EXPLICITLY declared multi-pod (--pods,
    a machine file's num_pods, or a simulated topology) at >=
    AUTO_MIN_DEV chips — a plain multi-host machine keeps the flat
    sweep, whose extra DCN placements (tp over DCN) it would otherwise
    silently stop enumerating."""
    mode = (getattr(config, "search_hierarchical", "auto") or "auto")
    if mode == "off":
        return False
    pods = machine.pods
    if pods <= 1 or n_dev % pods or n_dev // pods < 1:
        return False
    if mode == "on":
        return True
    return machine.num_pods >= 2 and n_dev >= AUTO_MIN_DEV


def pipeline_grids(n_dev: int, machine: GPUMachineModel,
                   hierarchical: bool) -> Tuple[int, ...]:
    """Pipeline-parallel degrees the search sweeps. Flat: the classic
    (2, 4, 8). Hierarchical: pod-aligned grids — every stage boundary
    coincides with (or tiles) a pod boundary, so the activation hop at a
    cut is the only DCN traffic and ``simulate_pipeline``'s host-span
    pricing charges exactly it. The schedule per cut (gpipe/1f1b/
    interleaved) stays a searched axis either way."""
    if not hierarchical:
        return (2, 4, 8)
    pods = machine.pods
    out = sorted({pp for pp in (pods, 2 * pods, 4 * pods)
                  if 2 <= pp <= n_dev and n_dev % pp == 0})
    return tuple(out)


# --------------------------------------------------------------- ICI level
@dataclasses.dataclass
class PodSolution:
    """One memoized pod-local sub-solution: the full-graph DP solved at
    ``(dp_total, tp)`` with the simulator pinned to the single-pod
    topology. ``dp_total = pods * dp_ici`` so per-chip work is divided at
    the global scale while every collective is priced pod-local; the DCN
    delta is composed on top per candidate."""

    dp_ici: int
    tp: int
    dp_total: int
    t_ici: float          # simulate_best at topology (1, 1)
    mem: int              # per-chip peak (topology-independent)
    w_resident: int       # weights + opt state + grads part of ``mem``
    # per weight group: (synced grad bytes per chip, participants) — the
    # inputs to the DCN composition delta
    sync_groups: Tuple[Tuple[int, int], ...]
    pcg: PCG
    assignment: Dict
    states: Dict


class ICISubSolver:
    """Memoized pod-local solver. Solutions live in the Simulator's
    bounded table LRU (so a warm simulator serves them across searches)
    keyed by (pod subgraph signature, chip budget, pod count, lambda,
    remat, search-space, batch); hit/miss counters feed the bench leg and
    the memo-law test. Entries whose winning graph was rewritten by a
    GraphXfer are pinned to their concrete PCG object (guids are not
    portable across isomorphic graphs); un-rewritten entries — the common
    case, rewrites are greedy-fused before the sweep — are re-hydrated
    onto any structurally identical graph by topo position."""

    def __init__(self, sim: Simulator):
        self.sim = sim
        self.hits = 0
        self.misses = 0
        # distinct statically-pruned plans (the flat sweep's pruned_keys
        # contract: a pruned PLAN is counted/logged once, not once per
        # lambda iteration)
        self.pruned_static = 0
        self._pruned_keys: set = set()

    def solve(self, pcg: PCG, machine: GPUMachineModel, chips: int,
              pods: int, batch: int, lam: float, remat: str, space,
              xfers, budget: int, alpha: float,
              protected_guids: Sequence[int], split_threshold: int,
              slog, static_on: bool) -> List[PodSolution]:
        from .unity import _space_key

        # every hyperparameter best_first_optimize's answer depends on is
        # part of the key — a warm simulator shared across differently
        # configured searches (elastic replan, drift re-rank) must never
        # serve a solution the new configuration would not have produced
        key = ("ici_pod_solution", pcg.hash(), chips, pods,
               round(lam, 6), remat, _space_key(space), batch,
               tuple(sorted(x.name for x in xfers)), budget,
               round(alpha, 9), tuple(sorted(protected_guids)),
               split_threshold, bool(static_on))
        hit = self.sim.table_get(key)
        if hit is not None:
            sols = self._rehydrate(hit, pcg)
            if sols is not None:
                self.hits += 1
                return sols
        self.misses += 1
        sols = self._solve_uncached(
            pcg, machine, chips, pods, batch, lam, remat, space, xfers,
            budget, alpha, protected_guids, split_threshold, slog,
            static_on)
        self.sim.table_put(key, self._dehydrate(sols, pcg))
        return sols

    def _solve_uncached(self, pcg, machine, chips, pods, batch, lam,
                        remat, space, xfers, budget, alpha,
                        protected_guids, split_threshold, slog,
                        static_on) -> List[PodSolution]:
        from .unity import (assignment_to_strategy, best_first_optimize,
                            factorizations)

        if static_on:
            from ..analysis import analyze_candidate
        sim = self.sim
        sols: List[PodSolution] = []
        saved_topo = (sim.dp_dcn, sim.tp_dcn)
        try:
            sim.set_axis_topology(1, 1)  # pure pod-local pricing
            for dp_ici, tp in factorizations(chips):
                dp_total = dp_ici * pods
                if batch % dp_total:
                    continue
                g, a, s, t = best_first_optimize(
                    pcg, sim, dp_total, tp, batch, xfers,
                    budget=max(budget // 4, 4), alpha=alpha, space=space,
                    lam=lam, protected_guids=protected_guids,
                    split_threshold=split_threshold, search_log=slog,
                    remat=remat)
                if static_on:
                    strat = assignment_to_strategy(g, a, s, dp_total, tp,
                                                   machine=machine)
                    strat.remat = remat
                    rep = analyze_candidate(g, strat)
                    if rep.errors:
                        pk = (dp_total, tp, remat)
                        if pk not in self._pruned_keys:
                            self._pruned_keys.add(pk)
                            self.pruned_static += 1
                            slog.log(event="pruned_static", dp=dp_total,
                                     tp=tp, lam=round(lam, 4),
                                     remat=remat, level="ici",
                                     rules=rep.rules_fired(),
                                     first=rep.errors[0]
                                     .format_line()[:300])
                        continue
                _, mem = sim.simulate(g, a, s)
                w_res, groups = _sync_profile(sim, g, a)
                sols.append(PodSolution(
                    dp_ici=dp_ici, tp=tp, dp_total=dp_total, t_ici=t,
                    mem=mem, w_resident=w_res, sync_groups=groups,
                    pcg=g, assignment=a, states=s))
        finally:
            sim.set_axis_topology(*saved_topo)
        return sols

    # --- memo (de)hydration: guid-free by topo position ------------------
    def _dehydrate(self, sols: List[PodSolution], base: PCG):
        import weakref

        out = []
        for sol in sols:
            if sol.pcg is not base:
                # a rewrite won: the solution's guids are private to the
                # rewritten graph, so the entry is only valid for callers
                # passing the SAME base graph it was solved from (the
                # within-search λ/remat re-solve case) — pin via weakref
                # so a dead candidate graph never anchors the LRU
                out.append(("pinned", (weakref.ref(base), sol)))
                continue
            order = [n.guid for n in base.compute_nodes()]
            a_list = [sol.assignment.get(gg) for gg in order]
            s_list = [sol.states.get(gg, "R") for gg in order]
            out.append(("portable",
                        (sol.dp_ici, sol.tp, sol.dp_total, sol.t_ici,
                         sol.mem, sol.w_resident, sol.sync_groups,
                         a_list, s_list)))
        return tuple(out)

    def _rehydrate(self, stored, pcg: PCG) -> Optional[List[PodSolution]]:
        sols: List[PodSolution] = []
        order = [n.guid for n in pcg.compute_nodes()]
        for kind, payload in stored:
            if kind == "pinned":
                base_ref, sol = payload
                if base_ref() is not pcg:
                    # solved from a different base graph: the whole entry
                    # is for another graph generation — re-solve
                    return None
                sols.append(sol)
                continue
            (dp_ici, tp, dp_total, t_ici, mem, w_res, groups,
             a_list, s_list) = payload
            if len(a_list) != len(order):
                return None
            sols.append(PodSolution(
                dp_ici=dp_ici, tp=tp, dp_total=dp_total, t_ici=t_ici,
                mem=mem, w_resident=w_res, sync_groups=groups, pcg=pcg,
                assignment={gg: sh for gg, sh in zip(order, a_list)
                            if sh is not None},
                states={gg: st for gg, st in zip(order, s_list)}))
        return sols


def _sync_profile(sim: Simulator, g: PCG, assignment: Dict
                  ) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    """(weights-resident bytes, per-group (synced grad bytes, n)) from a
    solution's cached CostMetrics — all ``op_cost`` lookups hit when
    called at the topology the solution was priced under."""
    w_res = 0
    groups: List[Tuple[int, int]] = []
    for node in g.compute_nodes():
        sh = assignment.get(node.guid)
        if sh is None:
            continue
        in_shapes = [g.nodes[gg].out_shapes[i] for gg, i in node.inputs]
        cm = sim.op_cost(node, in_shapes, sh)
        w_res += cm.weights_memory * (1 + sim.opt_state_words) \
            + sim.scaled_bytes(cm.weights_memory, node)
        sync_n = sh.dp * (sh.tp if sh.kind in ("ring", "spatial")
                          else sh.act_tp)
        if cm.weights_memory and sync_n > 1:
            groups.append((cm.weights_memory, sync_n))
    return w_res, tuple(groups)


# --------------------------------------------------------------- DCN level
@dataclasses.dataclass
class DCNCandidate:
    """One cross-pod candidate: an ICI sub-solution lifted to the full
    machine with the pod count on the data axis plus a gradient-
    accumulation factor. ``est_*`` are the composition-law estimates;
    exact pricing is filled by the reprice pass for the top candidates."""

    sol: PodSolution
    remat: str
    ga: int
    est_t: float
    est_mem: int
    exact: bool = False
    t: float = 0.0
    mem: int = 0


def compose_dcn_sync(machine: GPUMachineModel, sim: Simulator,
                     sol: PodSolution, pods: int) -> float:
    """The composition law's DCN term: for every weight group the delta
    between the hierarchical allreduce the flat dcn-keyed pricing would
    charge (``hier_allreduce(w, n/p, p)``) and the pod-local allreduce
    already inside ``t_ici`` (``allreduce(w, n)``). Groups whose
    participant count the pod factor does not divide stay pod-local (the
    same clamp ``Simulator._op_cost_uncached`` applies)."""
    delta = 0.0
    for w_bytes, sync_n in sol.sync_groups:
        if sync_n % pods:
            continue
        sync_ici = sync_n // pods
        delta += (machine.hier_allreduce_time(
            w_bytes, sync_ici, pods,
            nic_sharers=sim._nic_sharers(sync_ici))
            - machine.allreduce_time(w_bytes, sync_n))
    return max(delta, 0.0)


def _accum_overhead(sol: PodSolution, ga: int, sim: Simulator) -> float:
    """Extra per-step time of ``ga`` gradient-accumulation microsteps:
    compute and sync totals are unchanged (same flops, one reduction),
    but each extra microstep re-dispatches the graph."""
    if ga <= 1:
        return 0.0
    n_nodes = len(sol.pcg.compute_nodes())
    return (ga - 1) * n_nodes * 2 * sim.op_overhead


def _ga_mem(sol: PodSolution, ga: int) -> int:
    """Gradient accumulation scales the activation+transient part of the
    peak by 1/ga (each microstep materializes 1/ga of the batch); weights,
    optimizer state and grads stay resident."""
    act = max(sol.mem - sol.w_resident, 0)
    return sol.w_resident + -(-act // ga)


def hierarchical_sweep(base_pcg: PCG, sim: Simulator,
                       machine: GPUMachineModel, n_dev: int, batch: int,
                       lam: float, mem_budget: Optional[int],
                       space, remat_levels: Sequence[str], xfers,
                       budget: int, alpha: float,
                       protected_guids: Sequence[int],
                       split_threshold: int, slog,
                       solver: ICISubSolver, static_on: bool,
                       pool_consider: Callable, stats: Dict):
    """One sweep of the two-level search at a fixed lambda — the
    hierarchical replacement for ``unity_search``'s flat ``search_all``
    closure. Returns the chosen SearchResult (or None), applying the same
    selection rule: best feasible candidate by exact time, falling back
    to minimum memory."""
    from .unity import SearchResult

    pods = machine.pods
    chips = n_dev // pods

    # ---- ICI level: memoized pod-local sub-solutions per remat level
    sols_by_remat: Dict[str, List[PodSolution]] = {}
    for remat in remat_levels:
        sols_by_remat[remat] = solver.solve(
            base_pcg, machine, chips, pods, batch, lam, remat, space,
            xfers, budget, alpha, protected_guids, split_threshold, slog,
            static_on)

    # ---- DCN level: compose candidates over the memoized solutions.
    # Zero op_cost work happens in this loop — the miss counter delta is
    # the memo law's ground truth (stats["dcn_enum_op_cost_misses"]).
    misses0 = sim.cost_cache_misses
    cands: List[DCNCandidate] = []
    ga_levels = (1, 2, 4) if mem_budget is not None else (1,)
    for remat, sols in sols_by_remat.items():
        for sol in sols:
            dcn_delta = compose_dcn_sync(machine, sim, sol, pods)
            for ga in ga_levels:
                if batch % (sol.dp_total * ga):
                    continue
                est_t = sol.t_ici + dcn_delta + _accum_overhead(sol, ga,
                                                                sim)
                est_mem = _ga_mem(sol, ga)
                cands.append(DCNCandidate(sol=sol, remat=remat, ga=ga,
                                          est_t=est_t, est_mem=est_mem))
                slog.log(event="dcn_candidate", dp=sol.dp_total,
                         tp=sol.tp, pods=pods, ga=ga, lam=round(lam, 4),
                         remat=remat, cost_ms=round(est_t * 1e3, 4),
                         mem_mib=round(est_mem / 2 ** 20, 1),
                         feasible=bool(mem_budget is None
                                       or est_mem <= mem_budget))
    stats["dcn_candidates"] = stats.get("dcn_candidates", 0) + len(cands)
    stats["dcn_enum_op_cost_misses"] = stats.get(
        "dcn_enum_op_cost_misses", 0) + (sim.cost_cache_misses - misses0)
    if not cands:
        return None

    # ---- exact re-pricing of the top composed candidates at their real
    # topology (exhaustive on small meshes — the selfcheck regime)
    def _order(c: DCNCandidate):
        feas = mem_budget is None or c.est_mem <= mem_budget
        return (not feas, c.est_t)

    cands.sort(key=_order)
    k = len(cands) if n_dev <= SELFCHECK_MAX_DEV else REPRICE_TOP_K
    repriced: List[Tuple[DCNCandidate, SearchResult]] = []
    # `accepted` mirrors THIS sweep's actual selection rule (feasibility
    # included) and best_ms is monotone — the same search-log invariant
    # the flat sweep keeps, so replaying the log reconstructs the sweep
    sweep_best = float("inf")
    for cand in cands[:k]:
        res = _reprice_exact(base_pcg, sim, machine, pods, batch, lam,
                             cand, space, xfers, budget, alpha,
                             protected_guids, split_threshold, slog,
                             static_on, solver)
        if res is None:
            continue  # ShardLint pruned the repriced assignment
        repriced.append((cand, res))
        pool_consider(res)
        feasible = mem_budget is None or cand.mem <= mem_budget
        accepted = feasible and cand.t < sweep_best
        if accepted:
            sweep_best = cand.t
        slog.log(event="candidate", dp=cand.sol.dp_total, tp=cand.sol.tp,
                 dcn=[pods, 1], pods=pods, ga=cand.ga,
                 lam=round(lam, 4), remat=cand.remat,
                 cost_ms=round(cand.t * 1e3, 4),
                 mem_mib=round(cand.mem / 2 ** 20, 1),
                 feasible=bool(feasible),
                 accepted=bool(accepted),
                 best_ms=round((sweep_best if sweep_best != float("inf")
                                else cand.t) * 1e3, 4))
    stats["repriced"] = stats.get("repriced", 0) + len(repriced)
    stats["ici_memo_hits"] = solver.hits
    stats["ici_memo_misses"] = solver.misses
    if not repriced:
        return None

    if mem_budget is not None:
        ok = [r for _c, r in repriced if r.sim_memory <= mem_budget]
        if ok:
            return min(ok, key=lambda r: r.sim_time)
        return min((r for _c, r in repriced),
                   key=lambda r: r.sim_memory)
    return min((r for _c, r in repriced), key=lambda r: r.sim_time)


def _reprice_exact(base_pcg, sim, machine, pods, batch, lam, cand,
                   space, xfers, budget, alpha, protected_guids,
                   split_threshold, slog, static_on, solver):
    """Exact pricing of one DCN candidate: the same calls the flat sweep
    makes at the candidate's topology, served almost entirely from the
    dcn-keyed caches the ICI solve warmed. Returns None when ShardLint
    rejects the repriced assignment — the (pods, 1) pricing can steer
    the DP/rewrites to a different assignment than the pod-local solve,
    so the static gate re-runs here exactly like the flat sweep's."""
    from .unity import (SearchResult, assignment_to_strategy,
                        best_first_optimize)

    sol = cand.sol
    saved_topo = (sim.dp_dcn, sim.tp_dcn)
    try:
        sim.set_axis_topology(pods, 1)
        g, a, s, t = best_first_optimize(
            base_pcg, sim, sol.dp_total, sol.tp, batch, xfers,
            budget=max(budget // 4, 4), alpha=alpha, space=space,
            lam=lam, protected_guids=protected_guids,
            split_threshold=split_threshold, search_log=slog,
            remat=cand.remat)
        strat = assignment_to_strategy(g, a, s, sol.dp_total, sol.tp,
                                       machine=machine, dcn=(pods, 1))
        strat.remat = cand.remat
        if static_on:
            from ..analysis import analyze_candidate

            rep = analyze_candidate(g, strat)
            if rep.errors:
                pk = (sol.dp_total, sol.tp, cand.remat)
                if pk not in solver._pruned_keys:
                    solver._pruned_keys.add(pk)
                    solver.pruned_static += 1
                    slog.log(event="pruned_static", dp=sol.dp_total,
                             tp=sol.tp, dcn=[pods, 1],
                             lam=round(lam, 4), remat=cand.remat,
                             level="dcn", rules=rep.rules_fired(),
                             first=rep.errors[0].format_line()[:300])
                return None
        _, mem = sim.simulate(g, a, s)
        if cand.ga > 1:
            # inside the topology scope: every op_cost lookup hits the
            # entries the simulate() above just touched
            w_res, _ = _sync_profile(sim, g, a)
            mem = w_res + -(-max(mem - w_res, 0) // cand.ga)
    finally:
        sim.set_axis_topology(*saved_topo)
    t += _accum_overhead(sol, cand.ga, sim)
    cand.exact, cand.t, cand.mem = True, t, mem
    strat.pods = (pods, "dp", cand.ga)
    return SearchResult(
        strategy=strat, assignment=a, sim_time=t, sim_memory=mem,
        mesh_shape=(sol.dp_total, sol.tp), pcg=g, states=s,
        dcn=(pods, 1), remat=cand.remat, pod_plan=(pods, "dp", cand.ga))


def assert_selfcheck_matches_flat(hier_best, flat_best) -> None:
    """FLEXFLOW_TPU_SEARCH_SELFCHECK extension (docs/multipod.md): on a
    mesh small enough to enumerate both ways, the two-level decomposition
    must choose the same plan as the flat sweep — same mesh, DCN
    placement and remat level. A mismatch means either the composition
    law mis-ranked the candidates or the decomposition's pruning
    assumption (tensor parallelism never spans DCN) cost the winner."""
    if hier_best is None or flat_best is None:
        if (hier_best is None) != (flat_best is None):
            raise AssertionError(
                "multipod selfcheck: hierarchical and flat sweeps "
                f"disagree on feasibility: hier={hier_best!r} "
                f"flat={flat_best!r}")
        return
    h = (tuple(hier_best.mesh_shape), tuple(hier_best.dcn),
         hier_best.remat)
    f = (tuple(flat_best.mesh_shape), tuple(flat_best.dcn),
         flat_best.remat)
    if h != f:
        raise AssertionError(
            "multipod selfcheck: hierarchical winner "
            f"(mesh, dcn, remat)={h} != flat search_all winner {f} — "
            "the DCN x ICI composition law diverged from flat pricing "
            "(or the winner needed a DCN placement outside the "
            "decomposition's space)")


def naive_dp_pods_time(pcg: PCG, sim: Simulator,
                       machine: GPUMachineModel) -> float:
    """Simulated step time of the naive baseline at pod scale: pure data
    parallelism over every chip with the pod factor on the data axis —
    what running the single-pod default at dp x pods would cost. The
    bench leg's denominator."""
    from .simulator import OpSharding
    from .unity import simulate_best

    n = machine.num_chips
    pods = machine.pods
    assignment = {node.guid: OpSharding(dp=n)
                  for node in pcg.compute_nodes()}
    saved_topo = (sim.dp_dcn, sim.tp_dcn)
    try:
        sim.set_axis_topology(pods, 1)
        return simulate_best(sim, pcg, assignment, {})
    finally:
        sim.set_axis_topology(*saved_topo)
