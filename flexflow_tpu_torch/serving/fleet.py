"""The serving fleet: N engines as fault domains behind one router (port
of ``flexflow_tpu.serving.fleet``).

A lone :class:`~.engine.ServingEngine` survives deadlines, overload,
poisoned decodes, SIGTERM and device loss, but it is still one point of
total failure. :class:`ServingFleet` is the layer above: N engines are
independent fault domains behind a router that keeps serving — and keeps
"every admitted request leaves under exactly one outcome" — while replicas
die, degrade, drain and rejoin underneath it.

The router owns N replicas (each may carry its own searched serving plan;
:func:`plan_replicas` prices each on its own ``GPUMachineModel`` and
per-(card generation, dtype) calibration table) and drives them in one
host loop: each **fleet tick** advances every live replica by one
scheduler action through the engine's ``start_serve`` / ``tick`` hook. The
replicas share one compiled model; each engine keeps its own pool-bound
programs (chunk prefill, decode, guarded decode), so replicas that tick in
turn each replay their own graphs. On top of that loop:

* **load-aware, prefix-aware dispatch** — each queued request is scored
  per replica as its estimated drain time minus the priced cache-affinity
  saving (cached prefix tokens x the replica's warm per-token cost); the
  migration re-prefills flow through the same gate.
* **health-checked failover** — per-replica health (``healthy | degraded
  | quarantined | draining | dead``) from a probe prefill
  (``ServingEngine.health_probe``) and passive signals (decode
  quarantines, dispatch timeouts, replica-fatal errors), with a
  per-replica **circuit breaker** (closed -> open after
  ``--circuit-open-after`` consecutive failures -> a half-open probe with
  bounded linear backoff). A circuit-open replica receives no dispatch
  until its probe passes.
* **request migration** — a replica that dies mid-decode has its
  in-flight streams harvested (no terminal outcome) and re-submitted to
  survivors, re-prefilled from their committed tokens; the sampler keys
  on (tag, tokens emitted), so a stream goes on where it stopped. Its
  queued requests re-route through the fleet queue.
* **hedged retries** — a request whose replica blows
  ``--hedge-after-pctl`` percent of its predicted service time gets a
  hedge on an idle second replica; the first new committed token wins and
  the loser is cancelled with no ledger entry; hedges are capped.
* **fleet-level shedding** — :meth:`ServingFleet.submit` sheds at the
  fleet door on the aggregate backlog of the healthy replicas, with
  ``retry_after_ms`` from the best replica's drain estimate, never 0 while
  any replica is draining or circuit-open
  (:data:`FLEET_MIN_RETRY_AFTER_MS`).
* **tenancy at the door** — a weighted fair queue over tenant tiers,
  token-rate quotas (``quota_exceeded``), per-tier shed thresholds and
  deadline defaults, per-tenant ledgers, and a backlog-forecast
  autoscaler (``--autoscale``).
* **crash durability** — ``--request-journal``: a write-ahead journal at
  the door (``serving/journal.py``), and :meth:`ServingFleet.recover`,
  which replays every journaled request without an outcome.
* **rolling drain / rejoin** — :meth:`ServingFleet.drain` wraps the
  engine's graceful drain per replica; a rejoining replica re-enters
  through half-open probation.

Chaos: :class:`~..resilience.chaos.FleetChaosPlan` scripts replica kills,
sustained decode-poison degradations, router-replica partitions, drains,
rejoins, traffic steps, tenant storms and whole-process crashes.

Errors: a replica's tick that raises is that fault domain's death (its
work migrates), except a fault of the program (an illegal address, a
launch failure, a kernel build error), which propagates: the router never
routes around a kernel fault.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.reqtrace import FleetTimeSeries, get_reqtrace
from .engine import ServingEngine, _ServeLoop
from .journal import RequestJournal, journal_from_config
from .resilience import (AdmissionController, OverloadError,
                         looks_like_program_fault)
from .scheduler import (ContinuousBatchScheduler, QueueFullError, Request,
                        ServingRejection, now_ms, remove_by_identity,
                        reserve_rids)
from .tenancy import (QuotaExceededError, TenantRegistry,
                      WeightedFairQueue)

#: health states a replica moves through
FLEET_HEALTH = ("healthy", "degraded", "quarantined", "draining", "dead")

#: lower bound on the fleet door's ``retry_after_ms`` hint while ANY
#: replica is draining, circuit-open or dead: a 0 hint — e.g. from a
#: cold EWMA — invites an immediate client retry
#: storm into a fleet that is already degraded.
FLEET_MIN_RETRY_AFTER_MS = 50.0


class FleetCrashed(RuntimeError):
    """The in-process stand-in for whole-process death
    (``FleetChaosPlan.crash_at={tick: "hard"}``): raised from
    inside the fleet tick so NO drain, finish or ledger path runs —
    exactly what SIGKILL denies a real process. The journal's
    group-commit buffer is dropped first (un-fsynced tail lost), and
    recovery goes through :meth:`ServingFleet.recover` on the journal
    directory."""


class CircuitBreaker:
    """Per-replica dispatch circuit (closed -> open -> half-open).

    ``record_failure`` counts CONSECUTIVE failures; at ``open_after`` the
    circuit opens and stays open for a bounded-linearly growing backoff
    (``backoff_ticks * opens``, capped at ``max_backoff_ticks`` — the
    engine's replan backoff in tick time). ``ready_to_probe`` then
    admits exactly one half-open probe: success closes the circuit,
    failure reopens it with a longer backoff. Failures while already
    open are ignored (they carry no new information and must not push
    the probe point forever into the future)."""

    def __init__(self, open_after: int = 3, backoff_ticks: int = 4,
                 max_backoff_ticks: int = 32):
        self.open_after = max(int(open_after), 1)
        self.backoff_ticks = max(int(backoff_ticks), 1)
        self.max_backoff_ticks = int(max_backoff_ticks)
        self.state = "closed"  # "closed" | "open" | "half_open"
        self.failures = 0      # consecutive, while closed/half-open
        self.opens = 0
        self.half_open_at: Optional[int] = None

    def record_failure(self, tick: int) -> None:
        if self.state == "open":
            return
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.open_after:
            self.state = "open"
            self.opens += 1
            self.half_open_at = tick + min(
                self.backoff_ticks * self.opens, self.max_backoff_ticks)

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"
        self.half_open_at = None

    def ready_to_probe(self, tick: int) -> bool:
        # half_open_at None = held open with no scheduled probe (a killed
        # or drained replica re-enters only via rejoin's probation)
        return (self.state == "open" and self.half_open_at is not None
                and tick >= self.half_open_at)

    def half_open(self) -> None:
        self.state = "half_open"

    def force_open(self, half_open_at: Optional[int] = None) -> None:
        """Open without counting a failure (kill/drain transitions)."""
        if self.state != "open":
            self.state = "open"
            self.opens += 1
        self.failures = 0
        self.half_open_at = half_open_at


class FleetReplica:
    """One fault domain: an engine + its scheduler + its serve loop,
    plus the router-side health bookkeeping."""

    def __init__(self, idx: int, engine: ServingEngine,
                 plan=None, open_after: int = 3):
        self.idx = idx
        self.engine = engine
        self.plan = plan
        self.sched: Optional[ContinuousBatchScheduler] = None
        self.loop: Optional[_ServeLoop] = None
        self.health = "healthy"
        self.circuit = CircuitBreaker(open_after=open_after)
        self.dispatches = 0
        self.probes = 0
        self.probe_failures = 0
        self.quarantine_events = 0
        # scripted degrade (FleetChaosPlan.degrade_replica_at): poison one
        # live slot's KV rows every Nth decode step; 0 = off
        self.degrade_every = 0
        self.degrade_counter = 0
        # scripted partition: router<->replica dispatch raises timeouts
        # until this fleet tick; None = reachable
        self.partitioned_until: Optional[int] = None
        # stats of retired serve loops (drain/rejoin rebuilds the loop)
        self.retired_tokens = 0
        self.retired_decode_steps = 0
        # host-overhead seconds of retired loops: [dispatch, device,
        # bookkeep, overlap] — the fleet roll-up must not
        # lose the wall split of a loop a drain/rejoin rebuilt
        self.retired_host = [0.0, 0.0, 0.0, 0.0]
        self.retired_syncs = 0

    @property
    def alive(self) -> bool:
        return self.health != "dead"

    def outstanding_tokens(self) -> int:
        """Queued + in-flight remaining tokens on this replica — the
        load-aware dispatch signal."""
        if self.sched is None:
            return 0
        return AdmissionController._backlog_tokens(self.sched)

    def drain_estimate_ms(self) -> float:
        """Estimated time to drain this replica's backlog, from its warm
        EWMA per-token cost (0.0 while the cost model is cold)."""
        if self.sched is None:
            return 0.0
        cost = self.engine.admission.token_cost_ms
        return cost * self.outstanding_tokens() / max(self.sched.n_slots, 1)

    def tokens_generated(self) -> int:
        live = self.loop.stats.tokens_generated if self.loop is not None \
            else 0
        return self.retired_tokens + live

    def decode_steps(self) -> int:
        live = self.loop.stats.decode_steps if self.loop is not None else 0
        return self.retired_decode_steps + live


@dataclasses.dataclass
class _Hedge:
    """One launched hedge pair: ``primary`` is the externally-submitted
    request, ``twin`` its internal copy on a second replica, ``fork`` the
    committed-token count both copies share at launch. First copy to
    commit a NEW token (or finish) wins; the loser is cancelled with no
    ledger entry."""

    primary: Request
    twin: Request
    fork: int
    primary_replica: int
    twin_replica: int
    winner: Optional[Request] = None
    mirrored: bool = False


@dataclasses.dataclass
class FleetStats:
    """Host-side counters of one fleet run — the bench ``fleet_leg`` and
    the StepTelemetry ``fleet`` block read these. ``outcomes`` is the
    FLEET-WIDE ledger over externally-submitted requests (hedge twins
    are internal and never counted)."""

    replicas: int = 0
    ticks: int = 0
    wall_s: float = 0.0
    requests: int = 0
    tokens_generated: int = 0
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)
    sheds: int = 0
    dispatches: List[int] = dataclasses.field(default_factory=list)
    migrations: int = 0
    requeued: int = 0
    failovers: int = 0
    hedges: int = 0
    hedge_twin_wins: int = 0
    hedges_cancelled: int = 0
    # prefix-aware routing: dispatches whose replica choice
    # was driven by a cache-affinity hit (the chosen replica's radix
    # trie held a prefix of the request), and the token volume matched
    affinity_hits: int = 0
    affinity_tokens: int = 0
    probes: int = 0
    probe_failures: int = 0
    circuit_opens: int = 0
    drains: int = 0
    rejoins: int = 0
    degrade_poisons: int = 0
    # (tick, replica, from, to, reason) — the health-transition trail
    health_transitions: List[Tuple[int, int, str, str, str]] = \
        dataclasses.field(default_factory=list)
    kill_ticks: List[int] = dataclasses.field(default_factory=list)
    # tokens committed per fleet tick — the failover-recovery series
    tokens_history: List[int] = dataclasses.field(default_factory=list)
    # host-overhead accounting: the replica loops'
    # dispatch/device/bookkeeping splits summed at _finish, plus the
    # router's own host work (dispatch, probes, hedges) in
    # host_dispatch_s
    host_dispatch_s: float = 0.0
    host_device_s: float = 0.0
    host_bookkeep_s: float = 0.0
    # host work overlapped with in-flight device steps (the async serve
    # loop): wall that exists but is NOT overhead — it widens
    # the denominator only
    host_overlap_s: float = 0.0
    # blocking host transfers across all replica loops: the
    # fleet analog of ServingStats.host_syncs
    host_syncs: int = 0
    # multi-tenant accounting: per-tenant ledgers over requests that
    # carried an explicit tenant label — tenant_outcomes conserves
    # exactly-one-outcome per tenant;
    # quota_sheds counts door rejections under the token-rate quota
    tenant_requests: Dict[str, int] = dataclasses.field(default_factory=dict)
    tenant_outcomes: Dict[str, Dict[str, int]] = \
        dataclasses.field(default_factory=dict)
    tenant_tokens: Dict[str, int] = dataclasses.field(default_factory=dict)
    quota_sheds: int = 0
    # requests injected by the FleetChaosPlan traffic-step/tenant-storm
    # generator (they ARE externally-visible requests and ride the same
    # ledgers; this just says how many came from chaos)
    storm_requests: int = 0
    # autoscaler: (tick, "up"|"down", serving replicas after)
    autoscale_ups: int = 0
    autoscale_downs: int = 0
    autoscale_events: List[Tuple[int, str, int]] = \
        dataclasses.field(default_factory=list)
    # waiting requests per fleet tick (door + replica scheduler queues:
    # dispatch drains the door eagerly, so the door alone sees nothing)
    # — the surge-recovery series
    queue_depth_history: List[int] = dataclasses.field(default_factory=list)

    def count_tenant_outcome(self, tenant: Optional[str],
                             outcome: str) -> None:
        if not tenant:
            return  # untenanted traffic stays aggregate-only
        led = self.tenant_outcomes.setdefault(tenant, {})
        led[outcome] = led.get(outcome, 0) + 1

    def surge_recovery_ticks(self, step_tick: int,
                             baseline: Optional[int] = None
                             ) -> Optional[int]:
        """Ticks after ``step_tick`` until the waiting-request depth
        first returns to its pre-step level (or ``baseline``) — the
        traffic-surge analog of :meth:`recovery_ticks`. None when it
        never drained."""
        hist = self.queue_depth_history
        if step_tick >= len(hist):
            return None
        if baseline is None:
            baseline = hist[step_tick - 1] if step_tick > 0 else 0
        for t in range(step_tick + 1, len(hist)):
            if hist[t] <= baseline:
                return t - step_tick
        return None

    def count_outcome(self, outcome: str, n: int = 1) -> None:
        if n:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + int(n)

    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 \
            else 0.0

    def occupancy(self, total_slots: int) -> float:
        """Fraction of decode-slot-ticks that produced a token, over the
        whole run (fleet analog of ``ServingStats.batch_occupancy``)."""
        denom = self.ticks * max(total_slots, 1)
        return min(self.tokens_generated / denom, 1.0) if denom else 0.0

    def recovery_ticks(self, kill_tick: int, frac: float,
                       window: int = 4) -> Optional[int]:
        """Ticks after ``kill_tick`` until the trailing-``window`` mean
        tokens/tick first reaches ``frac`` x the pre-kill trailing mean
        — the failover-recovery-time metric. None when it never
        recovered (or the kill tick has no pre-history)."""
        hist = self.tokens_history
        pre = hist[max(kill_tick - window, 0):kill_tick]
        if not pre or kill_tick >= len(hist):
            return None
        target = frac * (sum(pre) / len(pre))
        for t in range(kill_tick + 1, len(hist) + 1):
            w = hist[max(t - window, kill_tick):t]
            if w and sum(w) / len(w) >= target:
                return t - kill_tick
        return None

    def host_overhead_fraction(self) -> Optional[float]:
        """Fleet-wide fraction of serve wall spent on the host rather
        than waiting on devices (the ServingStats analog)."""
        total = self.host_dispatch_s + self.host_device_s + \
            self.host_bookkeep_s + self.host_overlap_s
        if total <= 0.0:
            return None
        return (self.host_dispatch_s + self.host_bookkeep_s) / total

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "replicas": self.replicas,
            "ticks": self.ticks,
            "requests": self.requests,
            "tokens_generated": self.tokens_generated,
            "wall_s": round(self.wall_s, 4),
            "tokens_per_s": round(self.tokens_per_s(), 2),
            "dispatches": list(self.dispatches),
        }
        hof = self.host_overhead_fraction()
        if hof is not None:
            out["host_overhead_fraction"] = round(hof, 4)
        if self.host_syncs:
            out["host_syncs"] = self.host_syncs
        if self.outcomes:
            out["outcomes"] = dict(self.outcomes)
        for k in ("sheds", "migrations", "requeued", "failovers", "hedges",
                  "hedge_twin_wins", "hedges_cancelled", "affinity_hits",
                  "affinity_tokens", "probes",
                  "probe_failures", "circuit_opens", "drains", "rejoins",
                  "degrade_poisons", "quota_sheds", "storm_requests"):
            v = getattr(self, k)
            if v:
                out[k] = v
        if self.tenant_outcomes:
            out["tenants"] = {
                t: {"requests": self.tenant_requests.get(t, 0),
                    "tokens": self.tenant_tokens.get(t, 0),
                    "outcomes": dict(led)}
                for t, led in sorted(self.tenant_outcomes.items())}
        if self.autoscale_ups or self.autoscale_downs:
            out["autoscale"] = {"ups": self.autoscale_ups,
                                "downs": self.autoscale_downs,
                                "events": list(self.autoscale_events)}
        if self.health_transitions:
            out["health_transitions"] = len(self.health_transitions)
        return out


def lint_replica_plans(pcg, plans: Sequence) -> None:
    """Per-replica plan lint before the fleet starts: run ShardLint's FF005 serving-graph check and the FF006
    shape/divisibility dataflow against EACH replica's (possibly
    heterogeneous) plan at fleet construction, so one replica's
    fused-stateful or indivisible plan fails fast WITH THE REPLICA
    NAMED instead of surfacing as mid-serve garbage on 1/N of traffic.
    ``plans`` entries may be ``ServingPlan`` (materialized via
    ``to_strategy``), executor ``Strategy`` objects, or None (naive dp
    — nothing sharded, nothing to misdivide)."""
    from ..analysis import (AnalysisReport, Diagnostic,
                            StaticAnalysisError, check_serving_graph,
                            check_shapes)

    diags: List[Diagnostic] = []
    ff005 = check_serving_graph(pcg)
    for i, plan in enumerate(plans):
        for d in ff005:
            diags.append(dataclasses.replace(
                d, message=f"replica {i}: {d.message}"))
        if plan is None:
            continue
        strategy = plan.to_strategy(pcg) if hasattr(plan, "to_strategy") \
            else plan
        if strategy is None:
            continue
        for d in check_shapes(pcg, strategy):
            diags.append(dataclasses.replace(
                d, message=f"replica {i}: {d.message}"))
    if diags:
        raise StaticAnalysisError(
            AnalysisReport(diagnostics=diags,
                           checked=("FF005", "FF006")),
            context="fleet per-replica plan lint")


def plan_replicas(pcg, config, replica_devices: Sequence[int],
                  generations: Optional[Sequence[str]] = None,
                  device=None) -> List:
    """One searched ServingPlan per replica — heterogeneous device
    counts and card generations allowed. Each replica is priced on its
    OWN ``GPUMachineModel`` (``generations`` are its keys: ``h100-sxm``,
    ``h100-pcie``, ``h100-nvl``; without them the card is read, or with
    ``device="cpu"`` the fixed ``h100-sxm`` entry), and (when
    ``--calibration-dir`` is set) its own persistent per-(generation,
    dtype) calibration table, so replicas on different cards are costed
    honestly rather than by one blended ruler."""
    from ..search.calibration import dtype_label
    from ..search.machine_model import GPUMachineModel
    from ..search.simulator import Simulator
    from .search import serving_search

    plans = []
    cal_dir = getattr(config, "calibration_dir", "") or None
    for i, n_dev in enumerate(replica_devices):
        gen = generations[i] if generations else None
        machine = GPUMachineModel.from_generation(gen, int(n_dev)) \
            if gen else GPUMachineModel.detect(int(n_dev), device=device)
        sim = Simulator(machine, calibration_dir=cal_dir,
                        dtype_label=dtype_label(config))
        plans.append(serving_search(pcg, config, int(n_dev),
                                    machine=machine, sim=sim))
    return plans


class ServingFleet:
    """N ServingEngine fault domains behind one load-aware,
    health-checked router (module docstring has the full story).

    The replicas share one compiled model, as in the JAX package (a
    replica on a card of its own is not built); the ``plans`` argument
    carries the per-replica layouts and is linted at construction.
    ``generate`` / ``submit`` + ``run`` mirror the engine's API one level
    up."""

    def __init__(self, model, n_replicas: Optional[int] = None,
                 n_slots: Optional[int] = None,
                 max_decode_len: Optional[int] = None,
                 max_queue: int = 64, eos_id: Optional[int] = None,
                 exact_decode: bool = False,
                 plans: Optional[Sequence] = None,
                 buckets: Optional[Sequence[int]] = None,
                 clock=None, serve_loop: Optional[str] = None,
                 journal=None):
        assert model.executor is not None, "call model.compile() first"
        config = model.config
        n = int(n_replicas or getattr(config, "fleet_replicas", 0) or 2)
        if n < 1:
            raise ValueError(f"a fleet needs >= 1 replica (got {n})")
        if plans is not None and len(plans) != n:
            raise ValueError(
                f"one plan per replica: got {len(plans)} plans for {n} "
                "replicas")
        if plans is not None:
            # satellite: fail fast at construction, replica named —
            # before any engine (or its compile cache) exists
            lint_replica_plans(model.executor.pcg, plans)
        self.model = model
        self.config = config
        self.n_replicas = n
        self.max_queue = int(max_queue)
        self.eos_id = eos_id
        self.shed_policy = (getattr(config, "shed_policy", "off") or "off")
        self.hedge_after_pctl = float(
            getattr(config, "hedge_after_pctl", 0.0) or 0.0)
        self.health_probe_every = int(
            getattr(config, "health_probe_every", 16) or 16)
        open_after = int(getattr(config, "circuit_open_after", 3) or 3)
        self.replicas = [
            FleetReplica(i, ServingEngine(
                model, n_slots=n_slots, max_decode_len=max_decode_len,
                buckets=buckets, max_queue=max_queue, eos_id=eos_id,
                exact_decode=exact_decode, serve_loop=serve_loop),
                plan=(plans[i] if plans else None),
                open_after=open_after)
            for i in range(n)]
        for rep in self.replicas:
            rep.engine.plan = rep.plan or rep.engine.plan
        # hedge amplification cap: at most this many hedges outstanding,
        # and a hedge only targets an IDLE replica (free slot, empty
        # queue) — a hedge must never displace first-try traffic
        self.hedge_cap = max(1, n - 1)
        # multi-tenant door: the tier
        # registry (policies + quota buckets) and the weighted fair
        # queue replacing the single FIFO — untenanted traffic rides
        # the standard tier and degenerates to exact FIFO
        self.tenants = TenantRegistry.from_config(config)
        self.queue: WeightedFairQueue = WeightedFairQueue(self.tenants)
        # backlog-forecast autoscaler: off unless --autoscale on; bounds default to
        # [initial N, 2N]; hysteresis = the up/down factor gap plus the
        # consecutive-tick patience plus a post-action cooldown
        self.autoscale = (getattr(config, "autoscale", "off")
                          or "off") == "on"
        self.min_replicas = int(getattr(config, "min_replicas", 0)
                                or 0) or n
        self.max_replicas = max(
            int(getattr(config, "max_replicas", 0) or 0) or 2 * n,
            self.min_replicas)
        self.autoscale_up_after = 2      # consecutive over-SLO ticks
        self.autoscale_down_after = 8    # consecutive slack ticks
        self.autoscale_cooldown = 4      # ticks after any action
        self.autoscale_down_factor = 0.3
        self._forecast_ewma: Optional[float] = None
        self._surge_ticks = 0
        self._slack_ticks = 0
        self._cooldown_until = 0
        self._storm_seq = 0
        self.drained_requests: List[Request] = []
        self.clock = clock if clock is not None else now_ms
        # crash-durable door: an explicit
        # journal argument wins (recover() hands over the scanned one);
        # otherwise --request-journal DIR builds a fresh journal; the
        # default is the shared allocation-free NOOP_JOURNAL singleton.
        self.journal = (journal if journal is not None
                        else journal_from_config(config, clock=self.clock))
        self._journal_replaying = False
        self.chaos = None
        self.stats = FleetStats(replicas=n, dispatches=[0] * n)
        self.tick_no = 0
        self.max_idle_ticks = 256
        self._requests: List[Request] = []
        self._hedges: List[_Hedge] = []
        self._hedged_ids: set = set()
        self._adopted: List[_Hedge] = []
        self._fleet_draining = False
        self._running = False
        self._serve_args: Dict[str, Any] = {}
        self._tick_tokens = 0
        # fleet time-series ring buffers (created lazily in
        # run() when request tracing is live, or attached by a caller)
        # and the router's own host-time outside replica ticks
        self.timeseries: Optional[FleetTimeSeries] = None
        self._host_router_s = 0.0

    # ------------------------------------------------------------- obs hooks
    def _tracer(self):
        return self.model._obs_tracer()

    def _set_health(self, rep: FleetReplica, new: str, reason: str) -> None:
        old = rep.health
        if old == new:
            return
        rep.health = new
        self.stats.health_transitions.append(
            (self.tick_no, rep.idx, old, new, reason))
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("replica_health", replica=rep.idx, tick=self.tick_no,
                         from_state=old, to_state=new, reason=reason)

    # ------------------------------------------------------------- admission
    def total_slots(self) -> int:
        return sum(r.engine.n_slots for r in self.replicas)

    def _stamp_deadline(self, req: Request) -> None:
        timeout = float(getattr(self.config, "request_timeout_ms", 0.0)
                        or 0.0)
        if req.deadline_ms is None and timeout > 0:
            req.deadline_ms = timeout

    def _healthy(self) -> List[FleetReplica]:
        return [r for r in self.replicas
                if r.alive and r.health != "draining"
                and r.circuit.state == "closed"]

    def retry_after_ms(self, tenant: Optional[str] = None) -> float:
        """The fleet door's backoff hint: the MINIMUM over healthy
        replicas' drain estimates (the best replica frees up first — a
        fleet sick on one replica must not shed like a fleet sick
        everywhere), floored at :data:`FLEET_MIN_RETRY_AFTER_MS`
        whenever any replica is draining, circuit-open or dead (the 0
        hint of a cold EWMA would invite an immediate retry storm into a
        degraded fleet).

        With ``tenant`` the hint additionally prices that tenant's OWN
        virtual queue position under WFQ: the door
        tokens scheduled ahead of a new request of this tenant, at the
        tenant's per-token cost. Without it a rejected batch client
        would be handed the interactive tenant's optimistic hint and
        resubmit straight into another rejection."""
        healthy = self._healthy()
        est = min((r.drain_estimate_ms() for r in healthy), default=0.0)
        if tenant is not None and healthy:
            ahead = self.queue.backlog_tokens_ahead(tenant)
            cost = max((r.engine.admission.token_cost_ms_for(tenant)
                        for r in healthy), default=0.0)
            capacity = sum(r.engine.n_slots for r in healthy)
            est += cost * ahead / max(capacity, 1)
        degraded = any(
            (not r.alive) or r.health == "draining"
            or r.circuit.state != "closed" for r in self.replicas)
        if degraded:
            est = max(est, FLEET_MIN_RETRY_AFTER_MS)
        return est

    def _total_queued(self) -> int:
        return len(self.queue) + sum(
            r.sched.queued for r in self.replicas
            if r.alive and r.sched is not None)

    def submit(self, req: Request) -> None:
        """Fleet-door admission: deadline stamp + fleet-level shed gate +
        enqueue for load-aware dispatch. Raises ``OverloadError`` (policy
        shed on aggregate backlog) or ``QueueFullError`` (hard fleet
        queue wall) — both ``ServingRejection`` carrying the
        fleet-derived ``retry_after_ms`` — and either way the request is
        ledgered (outcome ``shed``): exactly-one-outcome holds at the
        fleet door too.

        Journaled mode: the submit record is WRITTEN AHEAD
        of every admission decision, and a rid the journal has already
        seen — a client retrying a request that survived the crash, or
        is already finished — dedupes silently at the door instead of
        double-admitting. Recovery replay bypasses the dedupe (the
        replayed rids are exactly the ones already journaled)."""
        jr = self.journal
        if jr.enabled and not self._journal_replaying:
            if not jr.log_submit(req):
                # rid-keyed idempotent dedupe: this request is already
                # journaled (pending or finished) — a retry must not
                # enter the door twice
                return
        self._requests.append(req)
        pol = self.tenants.policy(req.tenant)
        if req.tenant:
            self.stats.tenant_requests[req.tenant] = \
                self.stats.tenant_requests.get(req.tenant, 0) + 1
        # tier deadline default: most specific wins — an
        # explicit per-request deadline, then the tenant tier's default,
        # then --request-timeout-ms via _stamp_deadline
        if req.deadline_ms is None and pol.deadline_ms > 0:
            req.deadline_ms = float(pol.deadline_ms)
        self._stamp_deadline(req)
        # the relative deadline budget starts at the FLEET DOOR: waiting
        # here burns it exactly like waiting in a replica queue (the
        # dispatch preserves this stamp across sched.submit's re-stamp)
        if not req.submit_ms:
            req.submit_ms = float(self.clock())
        rt = get_reqtrace()
        if rt.enabled:
            # the timeline opens at the FLEET door (a later replica
            # sched.submit adds a second "submit" note = re-queue edge)
            rt.note(req.rid, "submit", req.submit_ms,
                    prompt_len=req.prompt_len,
                    max_new=req.max_new_tokens,
                    deadline_ms=req.deadline_ms, replica=None,
                    tenant=req.tenant)
        # token-rate quota: charged on the
        # REQUESTED tokens before any shed gate — a quota breach is the
        # tenant's own doing and must not consume shed headroom
        if pol.quota_tokens_per_s > 0:
            ok, wait_ms = self.tenants.charge(
                req.tenant, req.max_new_tokens, float(self.clock()))
            if not ok:
                self.stats.quota_sheds += 1
                req.outcome = "quota_exceeded"
                if jr.enabled:
                    jr.log_outcome(req)
                self.stats.count_tenant_outcome(req.tenant,
                                                "quota_exceeded")
                if rt.enabled:
                    rt.finish(req.rid, float(self.clock()),
                              "quota_exceeded", policy="quota",
                              tenant=req.tenant,
                              refill_ms=round(wait_ms, 3))
                raise QuotaExceededError(
                    f"request {req.rid} rejected: tenant "
                    f"{pol.name!r} token-rate quota "
                    f"({pol.quota_tokens_per_s:g} tokens/s) exhausted",
                    queued=self._total_queued(), active=0,
                    retry_after_ms=max(
                        wait_ms, self.retry_after_ms(req.tenant)))
        healthy = self._healthy()
        policy = self.shed_policy
        total_queued = self._total_queued()
        if policy == "queue":
            highwater = self._shed_highwater(pol)
            if total_queued >= highwater:
                self.stats.sheds += 1
                req.outcome = "shed"
                if jr.enabled:
                    jr.log_outcome(req)
                self.stats.count_tenant_outcome(req.tenant, "shed")
                if rt.enabled:
                    rt.finish(req.rid, float(self.clock()), "shed",
                              policy="queue", queued=total_queued,
                              highwater=highwater, tenant=req.tenant)
                raise OverloadError(
                    f"request {req.rid} shed at the fleet door (policy "
                    f"'queue'): aggregate queue depth {total_queued} >= "
                    f"high-water {highwater} for tier "
                    f"{pol.name!r} (fleet max_queue {self.max_queue})",
                    queued=total_queued,
                    active=sum(r.sched.active for r in self.replicas
                               if r.sched is not None),
                    retry_after_ms=self.retry_after_ms(req.tenant))
        elif policy == "deadline" and req.deadline_ms is not None \
                and req.deadline_ms > 0 and healthy:
            backlog = sum(r.outstanding_tokens() for r in healthy)
            capacity = sum(r.engine.n_slots for r in healthy)
            cost = min(
                (r.engine.admission.token_cost_ms_for(req.tenant)
                 for r in healthy
                 if r.engine.admission.token_cost_ms_for(req.tenant) > 0),
                default=0.0)
            est = cost * (backlog / max(capacity, 1) + req.max_new_tokens)
            if est > req.deadline_ms:
                self.stats.sheds += 1
                req.outcome = "shed"
                if jr.enabled:
                    jr.log_outcome(req)
                self.stats.count_tenant_outcome(req.tenant, "shed")
                if rt.enabled:
                    # the PRICED estimate that made the decision rides
                    # on the terminal record — sheds are explainable
                    rt.finish(req.rid, float(self.clock()), "shed",
                              policy="deadline", est_ms=round(est, 3),
                              deadline_ms=req.deadline_ms,
                              tenant=req.tenant)
                raise OverloadError(
                    f"request {req.rid} shed at the fleet door (policy "
                    f"'deadline'): estimated completion {est:.1f} ms "
                    f"across {len(healthy)} healthy replica(s) exceeds "
                    f"deadline {req.deadline_ms:.1f} ms",
                    queued=total_queued, active=0,
                    retry_after_ms=self.retry_after_ms(req.tenant))
        if total_queued >= self.max_queue:
            self.stats.sheds += 1
            req.outcome = "shed"
            if jr.enabled:
                jr.log_outcome(req)
            self.stats.count_tenant_outcome(req.tenant, "shed")
            if rt.enabled:
                rt.finish(req.rid, float(self.clock()), "shed",
                          policy="hard_wall", queued=total_queued,
                          tenant=req.tenant)
            raise QueueFullError(
                f"fleet queue full ({total_queued} waiting across "
                f"{self.n_replicas} replicas, shed policy "
                f"'{policy}'); retry later",
                queued=total_queued, active=0,
                retry_after_ms=self.retry_after_ms(req.tenant))
        self.queue.append(req)

    def _shed_highwater(self, pol) -> int:
        """Per-tier queue-shed threshold: the
        standard tier keeps the pre-tenant ``max_queue // 2`` high-water
        exactly; lower shed priority halves it (batch backs off first,
        preserving headroom for the tiers above), higher priority sheds
        only at the hard wall."""
        base = max(self.max_queue // 2, 1)
        if pol.shed_priority <= 0:
            return max(base // 2, 1)
        if pol.shed_priority == 1:
            return base
        return self.max_queue

    # -------------------------------------------------------------- lifecycle
    def _make_loop(self, rep: FleetReplica) -> None:
        """(Re)build a replica's scheduler + serve loop. Per-replica rng
        base seeds are IDENTICAL across replicas — streams key on
        (submission tag, tokens emitted), so a migrated or hedged stream
        continues bit-identically wherever it lands."""
        if rep.loop is not None:
            # retire the old loop's throughput into the replica's
            # cumulative counters before dropping it
            rep.retired_tokens += rep.loop.stats.tokens_generated
            rep.retired_decode_steps += rep.loop.stats.decode_steps
            rep.retired_host[0] += rep.loop.stats.host_dispatch_s
            rep.retired_host[1] += rep.loop.stats.host_device_s
            rep.retired_host[2] += rep.loop.stats.host_bookkeep_s
            rep.retired_host[3] += rep.loop.stats.host_overlap_s
            rep.retired_syncs += rep.loop.stats.host_syncs
        eng = rep.engine
        sched = ContinuousBatchScheduler(
            n_slots=eng.n_slots, max_queue=eng.max_queue,
            buckets=eng.buckets, max_len=eng.max_decode_len,
            clock=eng.resilience_clock or self.clock)
        sched.replica_idx = rep.idx  # request-trace notes carry the domain
        if self.journal.enabled and self.journal.commit_every > 0:
            # progress journaling rides the scheduler's commit point
            # (--journal-commit-every tokens batch into one record);
            # journal-off leaves on_commit None — the hot path stays
            # one never-taken branch, allocation-free
            sched.on_commit = self.journal.log_progress
        rep.sched = sched
        a = self._serve_args
        rep.loop = eng.start_serve(
            sched, temperature=a.get("temperature", 0.0),
            top_k=a.get("top_k", 0), seed=a.get("seed", 0),
            publish_telemetry=False)
        # the router health-checks every replica: keep the guarded decode
        # live so a poisoned slot quarantines instead of committing junk
        rep.loop.res.force_armed = True
        rep.loop.res_active = True
        rep.loop.guard = True
        eng._last_guard = True

    def _start(self, temperature: float, top_k: int, seed: int) -> None:
        self._serve_args = {"temperature": temperature, "top_k": top_k,
                            "seed": seed}
        if self.journal.enabled:
            # the run record makes recovery self-contained: the exact
            # sampling configuration rides in the journal
            self.journal.log_run(**self._serve_args)
        for rep in self.replicas:
            if rep.loop is None:
                self._make_loop(rep)
        self._running = True

    def drain(self, replica: int) -> None:
        """Rolling zero-downtime restart, one fault domain at a time:
        wraps the engine's graceful drain — the replica stops admitting, its
        in-flight requests finish inside ``--drain-grace-s``, its queued
        requests re-route through the fleet queue, and the replica goes
        out of rotation until :meth:`rejoin`."""
        rep = self.replicas[replica]
        if not rep.alive:
            raise ValueError(f"replica {replica} is dead; rejoin() it "
                             "instead of draining")
        if rep.loop is None:
            self._make_loop(rep)
        assert rep.loop is not None
        rep.loop.request_drain()
        self._set_health(rep, "draining", "drain_requested")
        self.stats.drains += 1

    def rejoin(self, replica: int) -> None:
        """Bring a killed/drained replica back — through half-open
        probation: the circuit stays open until the next probe decode
        passes, so a still-sick replica never rejoins rotation. A still-
        alive (degraded/quarantined) replica may hold work the circuit
        deliberately left in place: it is rescued to the fleet queue
        BEFORE the rebuild — the restart must not lose streams."""
        rep = self.replicas[replica]
        inflight, queued = self._harvest(rep)
        for req in reversed(queued):
            self.queue.appendleft(req)
        for req in reversed(inflight):
            self.queue.appendleft(req)
        self.stats.migrations += len(inflight)
        self.stats.requeued += len(queued)
        rep.degrade_every = 0
        rep.degrade_counter = 0
        rep.partitioned_until = None
        rep.engine.reset_decode_pool()
        self._make_loop(rep)
        rep.circuit.force_open(half_open_at=self.tick_no + 1)
        self._set_health(rep, "quarantined", "rejoin_probation")
        self.stats.rejoins += 1

    # --------------------------------------------------------------- routing
    def _dispatchable(self, rep: FleetReplica) -> bool:
        return (rep.alive and rep.loop is not None
                and rep.health != "draining"
                and rep.circuit.state == "closed"
                and (rep.partitioned_until is None
                     or self.tick_no >= rep.partitioned_until)
                and not self._fleet_draining)

    def _dispatch(self) -> None:
        """Prefix-aware, load-aware routing: each queued
        request is scored per replica as estimated drain time MINUS the
        priced cache-affinity saving — the tokens of its prompt the
        replica's radix trie already holds, times that replica's EWMA
        per-token cost (prefilling them there costs nothing; doing it
        on a trie-cold replica throws the win away — and migration
        re-prefills flow through the same gate, so survivors' tries are
        consulted). Pricing rather than strict affinity-first keeps the
        router honest under load: a bounded prefill saving can never
        buy unbounded queueing on one warm replica. Raw affinity, then
        outstanding tokens, then index, stay the deterministic
        tie-breaks (a cold cost model scores every replica 0, where
        affinity alone decides). Expired door-queued requests are
        dropped first
        (outcome ``deadline_exceeded``) — a request stuck at the door
        while every circuit is open must not be served seconds past its
        deadline with zero misses recorded."""
        now = self.clock()
        rt = get_reqtrace()
        expired = [r for r in self.queue if r.expired(now)]
        for req in expired:
            remove_by_identity(self.queue, req)
            req.outcome = "deadline_exceeded"
            req.done = True
            if self.journal.enabled:
                self.journal.log_outcome(req)
            if rt.enabled:
                # dropped at the door, never reaches a scheduler _finish
                rt.finish(req.rid, float(now), "deadline_exceeded",
                          reason="door_expired",
                          new_tokens=len(req.generated))
        while self.queue:
            targets = [r for r in self.replicas
                       if self._dispatchable(r) and r.sched is not None
                       and r.sched.queued < r.sched.max_queue]
            if not targets:
                return
            req = self.queue.popleft()
            # hoist the prompt materialization (np.concatenate) out of
            # the per-replica probe loop
            toks = req.current_prompt()
            cap = req.effective_len - 1
            aff = {r.idx: r.engine.prefix_peek(toks, cap=cap)
                   for r in targets}
            # the affinity term is PRICED, not absolute: a cached
            # prefix is worth its skipped prefill compute (matched
            # tokens x the replica's EWMA per-token cost), so the
            # effective score is drain-time minus that saving — a
            # warm-trie replica loses the request the moment its
            # queueing delay exceeds what the cache would save
            # (concentrating unbounded traffic on one replica for a
            # bounded prefill win would invert the feature). With a
            # cold EWMA every term is 0 and the raw affinity breaks
            # the tie.
            def score(r):
                cost = r.engine.admission.token_cost_ms
                return (r.drain_estimate_ms() - aff[r.idx] * cost,
                        -aff[r.idx], r.outstanding_tokens(), r.idx)

            rep = min(targets, key=score)
            if aff[rep.idx] > 0:
                self.stats.affinity_hits += 1
                self.stats.affinity_tokens += aff[rep.idx]
                tracer = self._tracer()
                if tracer.enabled:
                    tracer.event("fleet_affinity", rid=req.rid,
                                 tick=self.tick_no, replica=rep.idx,
                                 tokens=aff[rep.idx])
            assert rep.loop is not None and rep.sched is not None
            rep.loop.res.stamp_deadline(req)
            # a migrated/rescued request already carries a submit stamp:
            # preserve it across the re-dispatch — sched.submit would
            # re-stamp and silently restart the relative deadline budget
            # exactly when replicas fail (the engine's own quarantine
            # retry preserves the budget; migration must match)
            prior_submit = req.submit_ms
            try:
                rep.sched.submit(req)
            except (ValueError, ServingRejection):
                # a migrated stream whose prompt+committed tokens no
                # bucket covers can re-enter nowhere: preempted, exactly
                # once (the caller keeps the partial continuation).
                # ServingRejection covers the max-context bound
                # (ContextOverflowError) — every replica shares the
                # model's position table, so no other replica can take
                # it either; one request must never crash the fleet
                req.outcome = "preempted"
                req.done = True
                if self.journal.enabled:
                    self.journal.log_outcome(req)
                if rt.enabled:
                    rt.finish(req.rid, float(self.clock()), "preempted",
                              reason="unadmittable",
                              new_tokens=len(req.generated))
                continue
            if prior_submit:
                req.submit_ms = prior_submit
            rep.dispatches += 1
            self.stats.dispatches[rep.idx] += 1

    # ---------------------------------------------------------------- health
    def _circuit_failure(self, rep: FleetReplica, reason: str,
                         n: int = 1) -> None:
        was_open = rep.circuit.state == "open"
        for _ in range(max(n, 1)):
            rep.circuit.record_failure(self.tick_no)
        if rep.circuit.state == "open" and not was_open:
            self.stats.circuit_opens += 1
            if rep.health in ("healthy", "degraded"):
                self._set_health(rep, "quarantined", reason)
            # stop feeding the sick replica AND rescue what was already
            # fed: its queued requests (including engine-level quarantine
            # retries parked at its queue front) re-route through the
            # fleet queue to a healthy replica, where each stream goes on
            # from its committed tokens. In-flight slots stay:
            # they are mid-stream and the replica may still finish them.
            if rep.sched is not None and rep.sched.queued:
                rescued = list(rep.sched.queue)
                rep.sched.queue.clear()
                for req in reversed(rescued):
                    self.queue.appendleft(req)
                self.stats.requeued += len(rescued)
        elif rep.health == "healthy":
            self._set_health(rep, "degraded", reason)

    def _circuit_success(self, rep: FleetReplica) -> None:
        """Passive clean-decode signal: resets the consecutive-failure
        count on a CLOSED circuit only. An open (or half-open) circuit
        re-closes exclusively through the half-open probe — a
        quarantined replica still finishing its in-flight slots must
        not talk itself back into rotation with one clean decode."""
        if rep.circuit.state != "closed":
            return
        rep.circuit.record_success()
        if rep.health == "degraded":
            self._set_health(rep, "healthy", "clean_decode")

    def _probe(self, rep: FleetReplica) -> bool:
        """One probe decode against the replica (through the partition
        shim: an unreachable replica fails its probe). Gates half-open
        -> closed; periodic probes on closed circuits feed the passive
        failure count instead."""
        half_open = rep.circuit.state == "open"
        if half_open:
            rep.circuit.half_open()
        reachable = (rep.partitioned_until is None
                     or self.tick_no >= rep.partitioned_until)
        ok = bool(reachable and rep.alive and rep.engine.health_probe())
        rep.probes += 1
        self.stats.probes += 1
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("replica_probe", replica=rep.idx,
                         tick=self.tick_no, ok=ok, half_open=half_open)
        if ok:
            rep.circuit.record_success()
            if rep.health in ("degraded", "quarantined"):
                self._set_health(rep, "healthy", "probe_pass")
        else:
            rep.probe_failures += 1
            self.stats.probe_failures += 1
            self._circuit_failure(rep, "probe_fail")
        return ok

    def _run_probes(self) -> None:
        tick = self.tick_no
        for rep in self.replicas:
            if not rep.alive or rep.health == "draining" \
                    or rep.loop is None:
                continue
            if rep.circuit.ready_to_probe(tick):
                self._probe(rep)
            elif rep.circuit.state == "closed" and self.health_probe_every \
                    and tick > 0 and tick % self.health_probe_every == 0:
                self._probe(rep)

    # ------------------------------------------------------------- autoscale
    def _slo_target_ms(self) -> float:
        """The SLO the forecast is judged against: the TIGHTEST deadline
        present in current traffic (door + in-flight), falling back to
        --request-timeout-ms. The tier with the least headroom sets the
        bar — scaling for the batch tier's deadline while interactive
        burns would invert the feature."""
        deadlines = [float(r.deadline_ms) for r in self.queue
                     if r.deadline_ms and r.deadline_ms > 0]
        for rep in self.replicas:
            if rep.alive and rep.sched is not None:
                deadlines.extend(
                    float(r.deadline_ms)
                    for r in list(rep.sched.queue)
                    + [s for s in rep.sched.slots if s is not None]
                    if r.deadline_ms and r.deadline_ms > 0)
        if deadlines:
            return min(deadlines)
        return float(getattr(self.config, "request_timeout_ms", 0.0)
                     or 0.0)

    def _serving_replicas(self) -> List[FleetReplica]:
        return [r for r in self.replicas
                if r.alive and r.health != "draining"]

    def _waiting_requests(self) -> int:
        """Requests admitted but not yet in a decode slot, fleet-wide:
        the door PLUS the replica scheduler queues (dispatch drains the
        door eagerly, so the door alone under-counts a surge)."""
        return len(self.queue) + sum(
            r.sched.queued for r in self.replicas
            if r.alive and r.sched is not None)

    def _autoscale_tick(self) -> None:
        """Backlog-forecast autoscaler: forecast = EWMA of (per-token cost x total outstanding
        tokens / serving slots) — the time the current backlog needs to
        drain. Over-SLO for ``autoscale_up_after`` consecutive ticks
        grows the pool (through half-open probation, like rejoin); under
        ``autoscale_down_factor`` x SLO for ``autoscale_down_after``
        ticks shrinks it through the existing migrate-and-drain. A
        cooldown after each action keeps the controller from flapping on
        its own transient."""
        serving = self._serving_replicas()
        slots = sum(r.engine.n_slots for r in serving)
        cost = max((r.engine.admission.token_cost_ms for r in serving),
                   default=0.0)
        door = sum(r.max_new_tokens - len(r.generated)
                   for r in self.queue)
        backlog = door + sum(r.outstanding_tokens() for r in serving)
        forecast = cost * backlog / max(slots, 1)
        if self._forecast_ewma is None:
            self._forecast_ewma = forecast
        else:
            self._forecast_ewma += 0.2 * (forecast - self._forecast_ewma)
        slo = self._slo_target_ms()
        if slo > 0:
            over = self._forecast_ewma > slo
            under = self._forecast_ewma < self.autoscale_down_factor * slo \
                and len(self.queue) == 0
        else:
            # no deadline anywhere: fall back to waiting-request
            # pressure — more than two full refills queued per slot is
            # a surge, an empty wait line with the in-flight work
            # fitting the slots is slack
            waiting = self._waiting_requests()
            over = waiting >= 2 * max(slots, 1)
            under = waiting == 0 and backlog <= slots
        if over:
            self._surge_ticks += 1
            self._slack_ticks = 0
        elif under:
            self._slack_ticks += 1
            self._surge_ticks = 0
        else:
            self._surge_ticks = 0
            self._slack_ticks = 0
        if self.tick_no < self._cooldown_until:
            return
        if self._surge_ticks >= self.autoscale_up_after \
                and len(serving) < self.max_replicas:
            self._scale_up()
            self._surge_ticks = 0
            self._cooldown_until = self.tick_no + self.autoscale_cooldown
        elif self._slack_ticks >= self.autoscale_down_after \
                and len(serving) > self.min_replicas:
            self._scale_down()
            self._slack_ticks = 0
            self._cooldown_until = self.tick_no + self.autoscale_cooldown

    def _autoscale_plan(self):
        """A searched plan for the new replica's mesh, warm-started from
        the per-(generation, dtype) calibration store via
:func:`plan_replicas` — None when the seed fleet itself runs
        planless or the search cannot run here."""
        if all(r.plan is None for r in self.replicas):
            return None
        ex = self.model.executor
        n_dev = int(ex.mesh.numel) if ex.mesh is not None else 1
        try:
            return plan_replicas(
                ex.pcg, self.config, [n_dev],
                device="cpu" if self.model.device.type == "cpu" else None
            )[0]
        except Exception as e:  # noqa: BLE001 — planless beats no scale-up
            if looks_like_program_fault(e):
                raise
            return None

    def _scale_up(self) -> None:
        """Grow the pool by one replica cloned from replica 0's shape.
        The newcomer enters service through the SAME half-open probation
        as a rejoin — its first dispatch waits for a passing probe — and
        its admission controller warm-starts from the warmest sibling
        (post-scale shedding must not be blind)."""
        ref = self.replicas[0].engine
        idx = len(self.replicas)
        eng = ServingEngine(
            self.model, n_slots=ref.n_slots,
            max_decode_len=ref.max_decode_len, buckets=ref.buckets,
            max_queue=ref.max_queue, eos_id=self.eos_id,
            exact_decode=ref.exact_decode,
            serve_loop=getattr(ref, "serve_loop", None))
        warmest = max((r.engine.admission for r in self.replicas),
                      key=lambda a: a.observed_steps)
        eng.admission.warm_start(warmest)
        plan = self._autoscale_plan()
        eng.plan = plan or eng.plan
        rep = FleetReplica(
            idx, eng, plan=plan,
            open_after=int(getattr(self.config, "circuit_open_after", 3)
                           or 3))
        self.replicas.append(rep)
        self.n_replicas = len(self.replicas)
        self.stats.replicas = self.n_replicas
        self.stats.dispatches.append(0)
        self.hedge_cap = max(1, self.n_replicas - 1)
        self._make_loop(rep)
        rep.circuit.force_open(half_open_at=self.tick_no + 1)
        self._set_health(rep, "quarantined", "autoscale_probation")
        self.stats.autoscale_ups += 1
        self.stats.autoscale_events.append(
            (self.tick_no, "up", len(self._serving_replicas())))
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("fleet_autoscale", action="up",
                         tick=self.tick_no, replica=idx,
                         serving=len(self._serving_replicas()),
                         forecast_ms=round(self._forecast_ewma or 0.0, 3))

    def _scale_down(self) -> None:
        """Shrink by one through the existing migrate-and-drain: the
        chosen replica stops admitting, finishes its in-flight streams,
        and its queued work re-routes — scale-down NEVER drops a live
        stream. Deterministic victim: the least-loaded closed-circuit
        replica, highest index breaking ties (LIFO, so the seed replicas
        outlive the surge capacity)."""
        cands = [r for r in self._serving_replicas()
                 if r.loop is not None and r.circuit.state == "closed"]
        if len(cands) <= self.min_replicas:
            return
        rep = min(cands, key=lambda r: (r.outstanding_tokens(), -r.idx))
        self.drain(rep.idx)
        self.stats.autoscale_downs += 1
        self.stats.autoscale_events.append(
            (self.tick_no, "down", len(self._serving_replicas())))
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("fleet_autoscale", action="down",
                         tick=self.tick_no, replica=rep.idx,
                         serving=len(self._serving_replicas()),
                         forecast_ms=round(self._forecast_ewma or 0.0, 3))

    # -------------------------------------------------------------- failover
    def _harvest(self, rep: FleetReplica) -> Tuple[List[Request],
                                                   List[Request]]:
        """Pull every request off a dying replica WITHOUT terminal
        outcomes: (in-flight, queued). In-flight requests keep their
        host-side committed tokens — the migration re-prefill resumes
        them exactly."""
        sched = rep.sched
        inflight: List[Request] = []
        if sched is None:
            return [], []
        # settle the async loop's in-flight decode step first: tokens
        # already sampled on-device belong to the stream — migrating
        # without committing them would fork it. A kill may leave the
        # pending buffers dead; dropping them is then correct (the
        # uncommitted step is simply lost, as on a real crash).
        if rep.loop is not None:
            try:
                rep.loop.settle()
            except Exception as e:  # noqa: BLE001 — dead device buffers
                if looks_like_program_fault(e):
                    raise
        for slot, req in enumerate(list(sched.slots)):
            if req is not None:
                sched.cancel_slot(slot)
                inflight.append(req)
        queued = list(sched.queue)
        sched.queue.clear()
        rt = get_reqtrace()
        if rt.enabled:
            ts = float(self.clock())
            for req in inflight:
                rt.note(req.rid, "migrate", ts, src=rep.idx,
                        tick=self.tick_no, inflight=True)
            for req in queued:
                rt.note(req.rid, "migrate", ts, src=rep.idx,
                        tick=self.tick_no, inflight=False)
        return inflight, queued

    def _kill(self, rep: FleetReplica, reason: str) -> None:
        """A replica died abruptly (its mesh is gone): migrate its work
        to the fleet queue — in-flight streams ahead of its queued ones,
        both ahead of the door queue, preserving progress — and take it
        out of rotation until rejoin."""
        inflight, queued = self._harvest(rep)
        rep.engine.reset_decode_pool()
        rep.circuit.force_open(half_open_at=None)  # probe only via rejoin
        self._set_health(rep, "dead", reason)
        for req in reversed(queued):
            self.queue.appendleft(req)
        for req in reversed(inflight):
            self.queue.appendleft(req)
        self.stats.migrations += len(inflight)
        self.stats.requeued += len(queued)
        self.stats.failovers += 1
        self.stats.kill_ticks.append(self.tick_no)
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("fleet_failover", replica=rep.idx,
                         tick=self.tick_no, migrated=len(inflight),
                         requeued=len(queued), reason=reason)

    def _finish_drain(self, rep: FleetReplica) -> None:
        """A draining replica went idle: close its loop, hand its queued
        requests back (fleet-level drain) or re-route them (rolling
        restart), and take it out of rotation.

        ``ledger_drained=False``: the loop must NOT close the handed
        requests' reqtrace timelines — the rolling-restart branch below
        clears their outcome and re-admits them, and a premature
        "preempted" terminal would wrongly pin (first-terminal-wins) a
        stream that goes on to finish "ok". The fleet-level drain branch
        IS the terminal, so it journals + ledgers there (a drained rid
        must not leak outcome-less into a crash)."""
        assert rep.loop is not None
        rep.loop.finish(ledger_drained=False)
        handed = list(rep.engine.drained_requests)
        rep.engine.drained_requests = []
        if self._fleet_draining:
            jr = self.journal
            if jr.enabled:
                for req in handed:
                    jr.log_outcome(req, "preempted")
                jr.sync()
            self.drained_requests.extend(handed)
        else:
            for req in handed:
                req.outcome = None
                self.queue.append(req)
            self.stats.requeued += len(handed)
        rep.circuit.force_open(half_open_at=None)
        self._set_health(rep, "dead", "drained")

    # ----------------------------------------------------------------- hedge
    def _launch_hedges(self) -> None:
        if self.hedge_after_pctl <= 0 or self._fleet_draining:
            return
        now = self.clock()
        for rep in self.replicas:
            if len(self._hedges) >= self.hedge_cap:
                return
            if not rep.alive or rep.sched is None:
                continue
            cost = rep.engine.admission.token_cost_ms
            if cost <= 0:
                continue  # cold EWMA: no prediction to blow yet
            slow = [r for r in list(rep.sched.queue)
                    + [s for s in rep.sched.slots if s is not None]
                    if not r.done and id(r) not in self._hedged_ids]
            for req in slow:
                if len(self._hedges) >= self.hedge_cap:
                    return
                est = cost * req.max_new_tokens
                if (now - req.submit_ms) <= \
                        est * self.hedge_after_pctl / 100.0:
                    continue
                # anti-amplification: a hedge only goes to an IDLE
                # replica — free slot, empty queue — never displacing
                # first-try traffic on a loaded one
                idle = [t for t in self.replicas
                        if t is not rep and self._dispatchable(t)
                        and t.sched is not None and t.sched.queued == 0
                        and t.sched.active < t.engine.n_slots]
                if not idle:
                    continue
                target = min(idle, key=lambda t: (
                    t.drain_estimate_ms(), t.outstanding_tokens(), t.idx))
                assert target.sched is not None
                twin = Request(prompt=req.prompt,
                               max_new_tokens=req.max_new_tokens,
                               eos_id=req.eos_id,
                               generated=list(req.generated),
                               rng_tag=req.rng_tag,
                               deadline_ms=req.deadline_ms)
                try:
                    target.sched.submit(twin)
                except ValueError:
                    continue
                target.dispatches += 1
                self.stats.dispatches[target.idx] += 1
                self._hedges.append(_Hedge(
                    primary=req, twin=twin, fork=len(req.generated),
                    primary_replica=rep.idx, twin_replica=target.idx))
                self._hedged_ids.add(id(req))
                self.stats.hedges += 1
                rt = get_reqtrace()
                if rt.enabled:
                    # fold the twin's timeline into the primary's: the
                    # twin's submit note (just emitted) moves over, and
                    # every later note on either copy lands on ONE
                    # connected per-request timeline
                    rt.link(twin.rid, req.rid)
                    rt.note(req.rid, "hedge", float(now), src=rep.idx,
                            replica=target.idx,
                            fork=len(req.generated))
                tracer = self._tracer()
                if tracer.enabled:
                    tracer.event("fleet_hedge", rid=req.rid,
                                 tick=self.tick_no, source=rep.idx,
                                 target=target.idx,
                                 fork=len(req.generated))

    def _cancel_copy(self, req: Request) -> None:
        """Cancel the losing hedge copy wherever it lives — slot, queue,
        finished ledger, or the fleet door queue — with NO terminal
        outcome (the winner owns the ledger entry)."""
        for rep in self.replicas:
            sched = rep.sched
            if sched is None:
                continue
            for i, q in enumerate(sched.slots):
                if q is req:
                    sched.cancel_slot(i)
                    self.stats.hedges_cancelled += 1
                    return
            try:
                sched.cancel_queued(req)
                self.stats.hedges_cancelled += 1
                return
            except ValueError:
                pass
            if sched.remove_finished(req):
                # the loser finished inside the same router tick its twin
                # won: withdraw its ledger entry (the winner's stands)
                req.outcome = None
                req.done = False
                self.stats.hedges_cancelled += 1
                return
        if remove_by_identity(self.queue, req):
            self.stats.hedges_cancelled += 1

    def _resolve_hedges(self) -> None:
        tracer = self._tracer()
        for h in list(self._hedges):
            p_tok = len(h.primary.generated) > h.fork
            t_tok = len(h.twin.generated) > h.fork
            p_failed = h.primary.done and \
                (h.primary.outcome or "ok") != "ok"
            t_failed = h.twin.done and (h.twin.outcome or "ok") != "ok"
            if not (p_tok or t_tok or p_failed or t_failed):
                continue
            # first NEW committed token wins, the primary winning ties
            # (its replica ticked first this round) — EXCEPT that a
            # failed copy (evicted as deadline_exceeded / decode_fault /
            # preempted) never beats a still-viable rival: the hedge
            # exists precisely to rescue a request whose first try died
            if p_failed and not t_failed:
                winner, loser = h.twin, h.primary
            elif t_failed and not p_failed:
                winner, loser = h.primary, h.twin
            elif p_tok or p_failed:
                winner, loser = h.primary, h.twin
            else:
                winner, loser = h.twin, h.primary
            h.winner = winner
            self._cancel_copy(loser)
            if winner is h.twin:
                self.stats.hedge_twin_wins += 1
                self._adopted.append(h)
            self._hedges.remove(h)
            self._hedged_ids.discard(id(h.primary))
            if tracer.enabled:
                tracer.event("fleet_hedge_resolved", rid=h.primary.rid,
                             tick=self.tick_no,
                             winner=("twin" if winner is h.twin
                                     else "primary"))

    def _mirror_adopted(self) -> None:
        """A hedge whose TWIN won streams on under the twin object; the
        caller holds the primary. Mirror the twin's tokens/outcome onto
        the primary as they land so the external view — and the
        exactly-one-outcome ledger — is always the primary's."""
        for h in self._adopted:
            if h.mirrored:
                continue
            h.primary.generated = list(h.twin.generated)
            # the latency stamps must migrate with the tokens: an adopted
            # twin's TTFT / completion times ARE the request's real
            # latencies — without them the caller's primary reports
            # first_token_ms/finish_ms of 0 and bench TTFT goes negative
            if h.twin.first_token_ms and not h.primary.first_token_ms:
                h.primary.first_token_ms = h.twin.first_token_ms
            if h.twin.done:
                h.primary.done = True
                h.primary.finish_reason = h.twin.finish_reason
                h.primary.outcome = h.twin.outcome
                h.primary.finish_ms = h.twin.finish_ms
                h.mirrored = True

    # ----------------------------------------------------------------- chaos
    def _apply_chaos(self, chaos) -> None:
        tick = self.tick_no
        # the base ChaosPlan's serving preemption doubles as the fleet's
        # scripted SIGTERM (keyed on fleet ticks here): os.kill drives
        # the REAL flag-only handler, and the run loop turns it into the
        # fleet-wide graceful drain
        chaos.maybe_preempt_serving(tick)
        kill = getattr(chaos, "maybe_kill_replica", None)
        if kill is None:
            return  # a plain ChaosPlan has no fleet-replica hooks
        crash = getattr(chaos, "maybe_crash", None)
        if crash is not None:
            mode = crash(tick)
            if mode is not None:
                self._crash(mode)
        r = chaos.maybe_kill_replica(tick)
        if r is not None:
            self._kill(self.replicas[r], "chaos_kill")
        r = chaos.maybe_degrade_replica(tick)
        if r is not None:
            rep = self.replicas[r]
            rep.degrade_every = chaos.degrade_poison_every
            rep.degrade_counter = 0
        r = chaos.maybe_partition_replica(tick)
        if r is not None:
            self.replicas[r].partitioned_until = \
                tick + chaos.partition_ticks
        r = chaos.maybe_drain_replica(tick)
        if r is not None and self.replicas[r].alive:
            self.drain(r)
        r = chaos.maybe_rejoin_replica(tick)
        if r is not None:
            self.rejoin(r)
        storm = getattr(chaos, "maybe_fleet_storm", None)
        if storm is not None:
            for tenant, n in storm(tick):
                self._inject_storm(tenant, n, chaos)

    def _inject_storm(self, tenant: Optional[str], n: int,
                      chaos) -> None:
        """Scripted traffic-step/tenant-storm injection: ``n``
        synthetic requests of ``tenant`` through the REAL door —
        submit(), quota, shed gates, WFQ and the ledgers all see them as
        ordinary traffic. Storm rng tags live in their own range
        (2_000_000+) so they can never collide with caller tags or the
        engine-level storm's 1_000_000 range."""
        max_new = int(getattr(chaos, "fleet_storm_max_new", 8) or 8)
        plen = int(getattr(chaos, "fleet_storm_prompt_tokens", 3) or 3)
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("fleet_tenant_storm", tick=self.tick_no,
                         tenant=tenant, requests=n)
        for _ in range(int(n)):
            seq = self._storm_seq
            self._storm_seq += 1
            req = Request(
                prompt=np.asarray([(seq % 7) + 1] * plen, np.int32),
                max_new_tokens=max_new, eos_id=self.eos_id,
                rng_tag=2_000_000 + seq, tenant=tenant)
            self.stats.storm_requests += 1
            try:
                self.submit(req)
            except ServingRejection:
                pass  # ledgered at the door; the storm presses on

    def _maybe_degrade_tick(self, rep: FleetReplica) -> None:
        """Scripted sustained decode poison (FleetChaosPlan degrade):
        NaN one live slot's KV rows every Nth decode opportunity — the
        guarded decode quarantines it, and the quarantine rate is the
        passive signal that opens the circuit."""
        sched = rep.sched
        if not rep.degrade_every or rep.engine.state is None \
                or sched is None or not sched.active:
            return
        rep.degrade_counter += 1
        if rep.degrade_counter % rep.degrade_every:
            return
        live = [i for i, r in enumerate(sched.slots) if r is not None]
        if not live:
            return
        import torch

        from ..resilience.chaos import poison_decode_state

        # in place, on the blocks the victim occupies, as the engine's
        # scripted poison does (no sync, nothing captured anew)
        with torch.inference_mode():
            poison_decode_state(rep.engine.state, live[0],
                                rep.loop._occupied_blocks(live[0]),
                                rep.engine._ids)
        self.stats.degrade_poisons += 1

    # ------------------------------------------------------------------ tick
    def _tick_replica(self, rep: FleetReplica) -> bool:
        if not rep.alive or rep.loop is None:
            return False
        if rep.partitioned_until is not None:
            if self.tick_no < rep.partitioned_until:
                # the router cannot reach the replica: its progress is
                # invisible (not ticked); each blocked round-trip counts
                # one timeout against the circuit
                if rep.circuit.state != "open":
                    self._circuit_failure(rep, "partition_timeout")
                return False
            rep.partitioned_until = None  # healed; probe re-admits it
        self._maybe_degrade_tick(rep)
        loop = rep.loop
        assert loop is not None
        q_before = loop.res.quarantines
        d_before = loop.stats.decode_steps
        t_before = loop.stats.tokens_generated
        try:
            worked = loop.tick()
        except Exception as e:  # noqa: BLE001 — the fault-domain boundary
            # an error the engine's OWN failover (elastic replan, state
            # rebuild) could not absorb is a replica death: migrate its
            # work and keep the fleet serving. A fault of the program is
            # no replica's death: it propagates
            if looks_like_program_fault(e):
                raise
            self._kill(rep, f"{type(e).__name__}: {e}"[:120])
            return True
        self._tick_tokens += loop.stats.tokens_generated - t_before
        dq = loop.res.quarantines - q_before
        if dq:
            rep.quarantine_events += dq
            self._circuit_failure(rep, "decode_quarantine", n=dq)
        elif loop.stats.decode_steps > d_before:
            self._circuit_success(rep)
        if rep.health == "draining" and not worked:
            self._finish_drain(rep)
        return worked

    # ------------------------------------------------------------------- run
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, eos_id: Optional[int] = None,
                 seed: int = 0, chaos=None,
                 deadline_ms: Optional[float] = None) -> List[List[int]]:
        """Generate continuations through the fleet; returns the token
        lists in submission order (shed requests return their — empty —
        partials; read ``self.stats.outcomes`` for the ledger). The
        fleet analog of ``ServingEngine.generate``."""
        reqs = []
        for i, p in enumerate(prompts):
            r = Request(prompt=np.asarray(p, dtype=np.int32),
                        max_new_tokens=max_new_tokens,
                        eos_id=self.eos_id if eos_id is None else eos_id,
                        rng_tag=i, deadline_ms=deadline_ms)
            try:
                self.submit(r)
            except ServingRejection:
                pass  # outcome shed; the fleet ledger picks it up
            reqs.append(r)
        self.run(chaos=chaos, temperature=temperature, top_k=top_k,
                 seed=seed)
        return [list(r.generated) for r in reqs]

    def run(self, chaos=None, temperature: float = 0.0, top_k: int = 0,
            seed: int = 0) -> FleetStats:
        """Drive the fleet until every submitted request has left under
        exactly one outcome. One fleet tick = chaos hooks, probes,
        dispatch, one scheduler action per live replica, hedge
        resolution/launch. Installs the flag-only SIGTERM handler: a
        preemption drains EVERY replica gracefully and hands the
        leftover queue back via ``self.drained_requests``."""
        from ..resilience.session import ResilienceSession

        if chaos is not None:
            self.chaos = chaos
        chaos = self.chaos
        self._start(temperature, top_k, seed)
        session = ResilienceSession(self.model, signals_only=True)
        session.install_signal_handlers()
        t0 = time.perf_counter()
        idle = 0
        if get_reqtrace().enabled and self.timeseries is None:
            self.timeseries = FleetTimeSeries()
        try:
            while True:
                t_iter = time.perf_counter()
                if chaos is not None:
                    self._apply_chaos(chaos)
                self._run_probes()
                if self.autoscale:
                    self._autoscale_tick()
                if session.preempted and not self._fleet_draining:
                    # flag-only handler fired: fleet-wide graceful drain
                    # — checked BEFORE dispatch so admission stops in
                    # the same tick the signal landed
                    self._fleet_draining = True
                    self.stats.drains += 1
                    for rep in self.replicas:
                        if rep.alive and rep.loop is not None:
                            rep.loop.request_drain(session=session)
                            self._set_health(rep, "draining",
                                             "fleet_sigterm")
                self._dispatch()
                self._tick_tokens = 0
                worked = False
                # router host time = loop wall OUTSIDE replica ticks
                # (chaos/probes/dispatch above, hedge machinery below);
                # the per-replica serve loops split their own tick wall
                self._host_router_s += time.perf_counter() - t_iter
                # under --serve-loop async each replica tick leaves one
                # decode transfer in flight and returns immediately, so
                # this plain round-robin already interleaves N replicas'
                # device work on one host: replica i+1's dispatch and
                # bookkeeping run while replica i's step is on the wire
                for rep in self.replicas:
                    worked = self._tick_replica(rep) or worked
                t_post = time.perf_counter()
                self._resolve_hedges()
                self._mirror_adopted()
                self._launch_hedges()
                self._journal_tick()
                self.stats.tokens_history.append(self._tick_tokens)
                self.stats.queue_depth_history.append(
                    self._waiting_requests())
                if self.timeseries is not None:
                    self.timeseries.sample(
                        self.tick_no, len(self.queue), self._tick_tokens,
                        sum(r.drain_estimate_ms() for r in self.replicas
                            if r.alive),
                        [(r.sched.active / max(r.engine.n_slots, 1))
                         if (r.alive and r.sched is not None) else 0.0
                         for r in self.replicas],
                        [r.health for r in self.replicas],
                        tenants=self.queue.queued_by_tenant())
                self.tick_no += 1
                self._host_router_s += time.perf_counter() - t_post
                if worked:
                    idle = 0
                    continue
                # work stranded on a non-tickable replica (a partition
                # that will heal) counts as pending: breaking on it
                # would truncate streams one tick from recovery
                stranded = any(
                    r.alive and r.sched is not None
                    and (r.sched.active or r.sched.queued)
                    for r in self.replicas)
                pending = bool(self.queue) or bool(self._hedges) \
                    or stranded
                if not pending:
                    break
                idle += 1
                none_alive = not any(r.alive for r in self.replicas)
                if none_alive or idle > self.max_idle_ticks:
                    # nowhere left to route: break and let _finish mark
                    # the leftovers preempted — and, under a fleet-level
                    # drain, hand them back via drained_requests (marking
                    # them here would make that handback unreachable)
                    break
        finally:
            self._running = False
            session.close()
        return self._finish(t0)

    def _journal_tick(self) -> None:
        """Per-tick journal sweep: every request that
        reached a terminal this tick gets its outcome record (placed
        AFTER the hedge machinery — ``_resolve_hedges``/``_cancel_copy``
        may withdraw a losing copy's outcome the same tick, and an
        outcome record, once written, is forever), then the group-commit
        window is checked. Journal-off cost: one attribute read."""
        jr = self.journal
        if not jr.enabled:
            return
        for req in self._requests:
            if req.done or req.outcome:
                jr.log_outcome(req)
        jr.maybe_sync()

    def _crash(self, mode: str) -> None:
        """Scripted whole-process death (``FleetChaosPlan.crash_at``):
        the journal drops its un-group-committed buffer FIRST — a dead
        process flushes nothing — then ``sigkill`` mode delivers the
        real signal (run the fleet in a child process for this mode)
        while ``hard`` mode raises :class:`FleetCrashed` past every
        drain/finish/ledger path (the in-process stand-in). The
        fleet_crash tracer event survives in the shared in-memory
        tracer: the RECOVERY run's trace write publishes it."""
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("fleet_crash", tick=self.tick_no, mode=mode)
        if self.journal.enabled:
            self.journal.crash()
        if mode == "sigkill":
            import os
            import signal as _signal
            os.kill(os.getpid(), _signal.SIGKILL)
        raise FleetCrashed(
            f"fleet crashed at tick {self.tick_no} "
            f"(chaos crash_at, mode {mode!r})")

    @classmethod
    def recover(cls, model, journal_dir: Optional[str] = None, **kw):
        """Restart-after-crash entry point: scan the journal directory (truncating any
        torn tail), then replay every rid with a submit record but no
        outcome record through the REAL fleet door — WFQ, tenancy,
        quota and shed policies all apply to replayed traffic, and a
        progress-journaled stream re-enters carrying its committed
        tokens (the re-prefill path resumes it where it stopped). Returns the fleet with the backlog queued; call
        :meth:`run` to serve it. The relative deadline budget restarts
        at recovery — monotonic clocks do not survive a process."""
        config = model.config
        root = journal_dir or getattr(config, "request_journal", "") \
            or ""
        if not root:
            raise ValueError("ServingFleet.recover() needs a journal "
                             "directory (--request-journal DIR or "
                             "journal_dir=)")
        t0 = time.perf_counter()
        jr = RequestJournal(
            root,
            sync_ms=float(getattr(config, "journal_sync_ms", 0.0)
                          or 0.0),
            commit_every=int(getattr(config, "journal_commit_every", 0)
                             or 0),
            clock=kw.get("clock"))
        fleet = cls(model, journal=jr, **kw)
        fleet._replay_journal(t0)
        return fleet

    def _replay_journal(self, t0: float) -> None:
        jr = self.journal
        pending = jr.pending_requests()
        # fresh submits must never collide with a replayed rid: skip
        # the counter past everything the dead process ever issued
        reserve_rids(jr.max_rid())
        rt = get_reqtrace()
        self._journal_replaying = True
        try:
            for req in pending:
                if rt.enabled:
                    rt.note(req.rid, "replay", float(self.clock()),
                            new_tokens=len(req.generated),
                            tenant=req.tenant)
                jr.replayed += 1
                try:
                    self.submit(req)
                except ServingRejection:
                    pass  # door policies hold for replayed traffic too
        finally:
            self._journal_replaying = False
        jr.recovery_wall_s = time.perf_counter() - t0
        tracer = self._tracer()
        if tracer.enabled:
            tracer.event("journal_recover", replayed=jr.replayed,
                         truncated=jr.truncated_records,
                         wall_s=round(jr.recovery_wall_s, 6))

    def _finish(self, t0: float) -> FleetStats:
        st = self.stats
        for rep in self.replicas:
            if rep.loop is not None and not rep.loop.finished:
                # ledger_drained=False: the fleet-wide sweep below is
                # the one place fleet requests' timelines close
                rep.loop.finish(ledger_drained=False)
        # a fleet-level drain hands the door queue back too
        leftovers = list(self.queue)
        self.queue.clear()
        for req in leftovers:
            req.outcome = "preempted"
            req.done = True
        if self._fleet_draining:
            self.drained_requests.extend(leftovers)
        self._mirror_adopted()
        st.ticks = self.tick_no
        st.wall_s = time.perf_counter() - t0
        st.requests = len(self._requests)
        st.tokens_generated = sum(r.tokens_generated()
                                  for r in self.replicas)
        # the FLEET-WIDE outcome ledger: every externally-submitted
        # request under exactly one outcome; hedge twins are internal
        # and never counted (their winner's entry lives on the primary)
        st.outcomes = {}
        # per-tenant ledgers rebuilt from the same sweep (door-time
        # counts were provisional): one outcome per request per tenant
        st.tenant_outcomes = {}
        st.tenant_tokens = {}
        rt = get_reqtrace()
        jr = self.journal
        for req in self._requests:
            outcome = req.outcome or ("ok" if req.done else "preempted")
            if jr.enabled:
                # the journal's exactly-one-outcome terminal mirrors the
                # ledger's (idempotent: ticked-in outcomes drop here)
                jr.log_outcome(req, outcome)
            st.count_outcome(outcome)
            st.count_tenant_outcome(req.tenant, outcome)
            if req.tenant and req.generated:
                st.tenant_tokens[req.tenant] = \
                    st.tenant_tokens.get(req.tenant, 0) + \
                    len(req.generated)
            if rt.enabled:
                # finalize is idempotent (first terminal note wins):
                # requests the schedulers already finished drop this; only
                # paths with no scheduler _finish — door leftovers,
                # streams stranded on a dead/partitioned replica — close
                # their timeline here, mirroring the ledger's outcome
                rt.finish(req.rid, float(self.clock()), outcome,
                          reason=req.finish_reason or outcome,
                          new_tokens=len(req.generated))
        # host-overhead roll-up: every replica serve loop's wall split
        # (live + retired across drain/rejoin rebuilds) plus the
        # router's own chaos/probe/dispatch/hedge time
        st.host_dispatch_s = self._host_router_s
        st.host_device_s = 0.0
        st.host_bookkeep_s = 0.0
        st.host_overlap_s = 0.0
        st.host_syncs = 0
        for rep in self.replicas:
            d, v, b, o = rep.retired_host
            n = rep.retired_syncs
            if rep.loop is not None:
                d += rep.loop.stats.host_dispatch_s
                v += rep.loop.stats.host_device_s
                b += rep.loop.stats.host_bookkeep_s
                o += rep.loop.stats.host_overlap_s
                n += rep.loop.stats.host_syncs
            st.host_dispatch_s += d
            st.host_device_s += v
            st.host_bookkeep_s += b
            st.host_overlap_s += o
            st.host_syncs += n
        tracer = self._tracer()
        if jr.enabled:
            # group-commit the ledger tail, then drop fully-retired
            # segments; close() stays with the CALLER — a fleet object
            # may run() again (rolling batches share one journal)
            jr.sync()
            dropped = jr.compact()
            if tracer.enabled and dropped:
                tracer.event("journal_compact", segments=dropped,
                             tick=self.tick_no)
        self._merge_telemetry(st)
        if tracer.enabled and self.model.config.trace_file:
            tracer.write(self.model.config.trace_file)
        return st

    # -------------------------------------------------------------- telemetry
    def _merge_telemetry(self, st: FleetStats) -> None:
        """Publish the run into a StepTelemetry ``fleet`` block (next to
        the serving / serving_resilience blocks) when a sink wants one."""
        tracer = self._tracer()
        tel = self.model._make_telemetry(tracer,
                                         batch_size=self.total_slots(),
                                         phase="fleet")
        self.model._telemetry = tel or getattr(self.model, "_telemetry",
                                               None)
        if tel is None:
            return
        tel.fleet_replicas = st.replicas
        tel.fleet_ticks = st.ticks
        tel.fleet_requests = st.requests
        tel.fleet_tokens_generated = st.tokens_generated
        tel.fleet_outcomes = dict(st.outcomes)
        tel.fleet_sheds = st.sheds
        tel.fleet_dispatches = list(st.dispatches)
        tel.fleet_migrations = st.migrations
        tel.fleet_hedges = st.hedges
        tel.fleet_hedge_twin_wins = st.hedge_twin_wins
        tel.fleet_affinity_hits = st.affinity_hits
        tel.fleet_probes = st.probes
        tel.fleet_circuit_opens = st.circuit_opens
        tel.fleet_failovers = st.failovers
        tel.fleet_health_transitions = len(st.health_transitions)
        tel.fleet_host_overhead_fraction = st.host_overhead_fraction()
        tel.fleet_tenants = {
            t: {"requests": st.tenant_requests.get(t, 0),
                "tokens": st.tenant_tokens.get(t, 0),
                "outcomes": dict(led)}
            for t, led in sorted(st.tenant_outcomes.items())}
        tel.fleet_quota_sheds = st.quota_sheds
        tel.fleet_autoscale_ups = st.autoscale_ups
        tel.fleet_autoscale_downs = st.autoscale_downs
        jr = self.journal
        if jr.enabled:
            tel.journal_appended = jr.appended
            tel.journal_syncs = jr.syncs
            tel.journal_replayed = jr.replayed
            tel.journal_dedupe_hits = jr.dedupe_hits
            tel.journal_compacted_segments = jr.compacted_segments
            tel.journal_truncated_records = jr.truncated_records
            tel.journal_recovery_wall_s = jr.recovery_wall_s
        tel.finalize()
        if self.model.config.telemetry_file:
            tel.write(self.model.config.telemetry_file)
