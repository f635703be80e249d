"""Request-level distributed tracing for the serving stack (a copy of
``flexflow_tpu.obs.reqtrace``, which imports nothing but ``.trace``).

The obs layer saw training steps and search iterations; the serving
fleet — continuous batching, chunked prefill, prefix cache, migration,
hedging across N replicas — exposed only end-of-run aggregates. This
module is the Dapper-style per-request causal timeline applied to the
token-serving data path: every lifecycle edge (submit → queue wait →
admission → prefix hit/COW → per-chunk prefill → per-tick decode →
quarantine/retry/migration/hedge hops across replicas → terminal
outcome) lands as a timestamped note on ONE timeline per request, and
each finished request is finalized exactly once into:

* a ``RequestRecord`` — one JSON object (schema version
  ``RECORD_VERSION``) on the JSONL stream: arrival time, prompt /
  new-token lengths, per-phase durations (queue / prefill / decode /
  stall), replica hops, terminal outcome. This stream doubles as a
  replayable trace format: a capacity planner can re-run
  the arrival process and per-request token counts against a synthetic
  fleet.
* Perfetto-compatible spans through the process :class:`~.trace.Tracer`
  (``span_at`` / ``event_at`` — explicit timestamps on the scheduler's
  injectable clock, so a fake-clock test renders the same trace every
  run): a ``request`` umbrella span per request (tid = rid) with
  ``req_queue`` / ``req_prefill`` / ``req_decode`` / ``req_stall``
  phase spans nested inside it and ``req_hop`` / ``req_shed`` /
  ``req_outcome`` instants at the edges.

Zero-overhead contract (the tracer's idiom): the module singleton
starts as :class:`NoopRequestTrace`; instrumented hot paths pay one
attribute load + truth test (``if rt.enabled:``) when tracing is off,
and the request path stays bitwise-identical and allocation-free
(pinned in the tests).

Hedge causality: a hedged twin is ``link()``-ed to its primary at
launch, so every note the twin makes folds into the primary's timeline
(parent-span causality — a hedged or migrated request is one connected
timeline ending in exactly one outcome, whichever copy finishes first).
Migration needs no linking: the same Request object (same rid) crosses
replicas, each admission note carrying its replica id.

Phase decomposition is a deterministic walk of the note timeline:
``queue`` is the wait before the FIRST admission; ``stall`` is every
later wait (quarantine requeue, migration, hedge re-dispatch);
``prefill`` runs from each admission to the first token committed after
it; ``decode`` is the rest. While hedge copies run concurrently the
walk attributes elapsed time to the most recent edge — an approximation
(the copies overlap in wall time) that stays exact for the common
un-hedged case and deterministic always.

``FleetTimeSeries`` rides along: bounded per-tick ring buffers of door
queue depth, per-replica occupancy/health, tokens per tick, and a
backlog EWMA, sampled once per :meth:`ServingFleet.run` loop iteration
when request tracing is enabled.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from .trace import get_tracer

RECORD_VERSION = 1

# phase-bucket name -> Perfetto span name (literal names also live in
# _finalize below so scripts/check_trace_events.py can extract them)
_PHASE_SPANS = {
    "queue": "req_queue",
    "prefill": "req_prefill",
    "decode": "req_decode",
    "stall": "req_stall",
}

# notes a request timeline can carry; anything else raises in note()
# so a typo'd edge never silently vanishes from the record
NOTE_KINDS = ("submit", "admit", "chunk", "cow", "token", "quarantine",
              "migrate", "hedge", "replay", "finish")

# a runaway decode could otherwise grow one request's note list without
# bound; past the cap notes are counted, not stored
MAX_NOTES_PER_REQUEST = 100_000


class NoopRequestTrace:
    """Disabled request tracer: every method is a no-op; the hot-path
    guard is ``rt.enabled`` (one attribute load, no allocation)."""

    __slots__ = ()
    enabled = False

    def note(self, rid: int, kind: str, ts_ms: float, **fields) -> None:
        pass

    def link(self, twin_rid: int, primary_rid: int) -> None:
        pass

    def finish(self, rid: int, ts_ms: float, outcome: str,
               **fields) -> None:
        pass

    def records(self) -> list:
        return []


class RequestTrace:
    """Per-request timeline recorder (module docstring has the design).

    ``note()`` appends one timestamped edge; ``link()`` folds a hedge
    twin's future notes into its primary's timeline; ``finish()``
    finalizes the timeline exactly once (idempotent per rid — the first
    terminal note wins, which by construction is the winning hedge
    copy's) into a RequestRecord + Perfetto spans.
    """

    enabled = True

    def __init__(self, jsonl_file: Optional[str] = None,
                 tracer=None, max_records: int = 100_000):
        self._lock = threading.Lock()
        self._notes: Dict[int, List[tuple]] = {}
        self._dropped: Dict[int, int] = {}
        self._alias: Dict[int, int] = {}     # twin rid -> primary rid
        self._linked: Dict[int, List[int]] = {}  # primary -> twin rids
        self._done: set = set()
        self._records: deque = deque(maxlen=max_records)
        self.dropped_records = 0
        self.jsonl_file = jsonl_file
        self._jsonl_fh = None
        self._tracer = tracer

    # ------------------------------------------------------------ recording
    def note(self, rid: int, kind: str, ts_ms: float, **fields) -> None:
        """Append one lifecycle edge to ``rid``'s timeline (``ts_ms`` on
        the scheduler clock). Notes on a linked twin fold into the
        primary's timeline."""
        if kind not in NOTE_KINDS:
            raise ValueError(f"unknown request-trace note kind {kind!r}")
        with self._lock:
            rid = self._alias.get(rid, rid)
            if rid in self._done:
                return  # post-terminal stragglers (losing hedge copy)
            notes = self._notes.setdefault(rid, [])
            if len(notes) >= MAX_NOTES_PER_REQUEST:
                self._dropped[rid] = self._dropped.get(rid, 0) + 1
                return
            notes.append((float(ts_ms), kind, fields))

    def link(self, twin_rid: int, primary_rid: int) -> None:
        """Fold ``twin_rid``'s timeline into ``primary_rid``'s (hedge
        parent-span causality): notes the twin already made are moved
        over, future ones are redirected, and the twin never finalizes
        a record of its own."""
        with self._lock:
            primary_rid = self._alias.get(primary_rid, primary_rid)
            self._alias[twin_rid] = primary_rid
            self._linked.setdefault(primary_rid, []).append(twin_rid)
            moved = self._notes.pop(twin_rid, None)
            if moved:
                notes = self._notes.setdefault(primary_rid, [])
                notes.extend(moved)
                notes.sort(key=lambda n: n[0])

    def finish(self, rid: int, ts_ms: float, outcome: str,
               **fields) -> None:
        """Terminal edge + finalization. Idempotent: a second terminal
        note for the same timeline (the losing hedge copy, the fleet's
        defensive re-finish) is dropped — every request ends in exactly
        one outcome."""
        with self._lock:
            rid = self._alias.get(rid, rid)
            if rid in self._done:
                return
            notes = self._notes.pop(rid, [])
            notes.append((float(ts_ms), "finish",
                          dict(fields, outcome=outcome)))
            self._done.add(rid)
            record = self._build_record(rid, notes)
            if len(self._records) == self._records.maxlen:
                self.dropped_records += 1
            self._records.append(record)
            if self.jsonl_file is not None:
                if self._jsonl_fh is None:
                    # line-buffered: tail-able mid-run, crash-safe
                    self._jsonl_fh = open(self.jsonl_file, "a",
                                          buffering=1)
                self._jsonl_fh.write(
                    json.dumps(record, default=str) + "\n")
        self._export_spans(record, notes)

    # ----------------------------------------------------------- finalizing
    def _build_record(self, rid: int, notes: List[tuple]
                      ) -> Dict[str, Any]:
        buckets = {"queue": 0.0, "prefill": 0.0, "decode": 0.0,
                   "stall": 0.0}
        state: Optional[str] = None
        t_state = 0.0
        arrival = None
        first_token = None
        finish_ts = None
        outcome = None
        reason = None
        prompt_len = None
        max_new = None
        deadline = None
        hit = 0
        chunks = 0
        cow = False
        ticks = 0
        occ_sum = 0
        hops: List[Dict[str, Any]] = []
        replicas: List[Any] = []
        shed: Optional[Dict[str, Any]] = None
        seen_admit = False
        tenant = None

        def close(ts: float) -> None:
            nonlocal t_state
            if state is not None:
                buckets[state] += max(ts - t_state, 0.0)
            t_state = ts

        def saw_replica(fields: Dict[str, Any]) -> None:
            rep = fields.get("replica")
            if rep is not None and rep not in replicas:
                replicas.append(rep)

        for ts, kind, fields in notes:
            if kind == "submit":
                close(ts)
                if arrival is None:
                    arrival = ts
                    prompt_len = fields.get("prompt_len")
                    max_new = fields.get("max_new")
                    deadline = fields.get("deadline_ms")
                if tenant is None:
                    tenant = fields.get("tenant")
                state = "stall" if seen_admit else "queue"
            elif kind == "admit":
                close(ts)
                state = "prefill"
                seen_admit = True
                hit = max(hit, int(fields.get("hit", 0) or 0))
                cow = cow or bool(fields.get("cow"))
                saw_replica(fields)
            elif kind == "token":
                close(ts)
                if first_token is None:
                    first_token = ts
                state = "decode"
                ticks += 1
                occ_sum += int(fields.get("occ", 0) or 0)
            elif kind in ("quarantine", "migrate", "hedge", "replay"):
                if kind not in ("hedge", "replay"):
                    # the primary keeps running while its hedge
                    # launches; a replay note precedes its re-submit
                    # so it opens no phase of its own
                    close(ts)
                    state = "stall"
                hops.append(dict(fields, t=round(ts, 3), kind=kind))
                saw_replica(fields)
            elif kind == "chunk":
                chunks += 1
            elif kind == "cow":
                cow = True
            elif kind == "finish":
                close(ts)
                state = None
                finish_ts = ts
                outcome = fields.get("outcome")
                reason = fields.get("reason")
                saw_replica(fields)
                if outcome == "shed":
                    shed = {k: v for k, v in fields.items()
                            if k not in ("outcome", "reason", "replica")}
        finish_fields = notes[-1][2] if notes else {}
        return {
            "v": RECORD_VERSION,
            "kind": "request",
            "rid": rid,
            "arrival_ms": arrival,
            "prompt_len": prompt_len,
            "max_new_tokens": max_new,
            "deadline_ms": deadline,
            # an additive field, RECORD_VERSION unchanged — old
            # readers ignore it, trace_summary degrades when absent
            "tenant": tenant,
            "new_tokens": finish_fields.get("new_tokens", ticks),
            "outcome": outcome,
            "finish_reason": reason,
            "first_token_ms": first_token,
            "finish_ms": finish_ts,
            "queue_ms": round(buckets["queue"], 3),
            "prefill_ms": round(buckets["prefill"], 3),
            "decode_ms": round(buckets["decode"], 3),
            "stall_ms": round(buckets["stall"], 3),
            "decode_ticks": ticks,
            "occupancy_avg": round(occ_sum / ticks, 3) if ticks else 0.0,
            "prefix_hit_tokens": hit,
            "chunks": chunks,
            "cow": cow,
            "hops": hops,
            "replicas": replicas,
            "hedged": bool(self._linked.get(rid)),
            "dropped_notes": self._dropped.pop(rid, 0),
            "shed": shed,
        }

    def _export_spans(self, record: Dict[str, Any],
                      notes: List[tuple]) -> None:
        tracer = self._tracer if self._tracer is not None \
            else get_tracer()
        if not tracer.enabled:
            return
        rid = record["rid"]
        arrival = record["arrival_ms"]
        finish_ts = record["finish_ms"]
        if arrival is not None and finish_ts is not None:
            tracer.span_at("request", arrival * 1e3,
                           (finish_ts - arrival) * 1e3, tid=rid,
                           rid=rid, outcome=record["outcome"])
        # phase spans: replay the same walk, emitting each closed episode
        state: Optional[str] = None
        t_state = 0.0
        seen_admit = False

        def close(ts: float) -> None:
            nonlocal t_state
            if state is not None:
                tracer.span_at(_PHASE_SPANS[state], t_state * 1e3,
                               (ts - t_state) * 1e3, tid=rid, rid=rid)
            t_state = ts

        for ts, kind, fields in notes:
            if kind == "submit":
                close(ts)
                state = "queue" if not seen_admit else "stall"
            elif kind == "admit":
                close(ts)
                state = "prefill"
                seen_admit = True
            elif kind == "token":
                if state != "decode":
                    close(ts)
                    state = "decode"
            elif kind in ("quarantine", "migrate"):
                close(ts)
                state = "stall"
                tracer.event_at("req_hop", ts * 1e3, tid=rid, rid=rid,
                                hop=kind, **fields)
            elif kind in ("hedge", "replay"):
                tracer.event_at("req_hop", ts * 1e3, tid=rid, rid=rid,
                                hop=kind, **fields)
            elif kind == "finish":
                close(ts)
                state = None
                if fields.get("outcome") == "shed":
                    tracer.event_at("req_shed", ts * 1e3, tid=rid,
                                    rid=rid, **fields)
                tracer.event_at("req_outcome", ts * 1e3, tid=rid,
                                rid=rid, outcome=fields.get("outcome"))

    # -------------------------------------------------------------- reading
    def records(self) -> List[Dict[str, Any]]:
        """Finalized RequestRecords, oldest first (bounded)."""
        with self._lock:
            return list(self._records)

    def open_timelines(self) -> List[int]:
        """rids with notes but no terminal outcome yet — empty after a
        clean run (every admitted request must end exactly once)."""
        with self._lock:
            return sorted(self._notes)

    def write(self, path: str) -> str:
        """Dump every finalized record as JSONL to ``path``."""
        with self._lock, open(path, "w") as f:
            for rec in self._records:
                f.write(json.dumps(rec, default=str) + "\n")
        return path

    def close(self) -> None:
        with self._lock:
            if self._jsonl_fh is not None:
                self._jsonl_fh.close()
                self._jsonl_fh = None


class FleetTimeSeries:
    """Bounded per-tick ring buffers of fleet state, sampled once per
    :meth:`ServingFleet.run` loop iteration: door queue depth,
    per-replica occupancy fraction and health, tokens committed that
    tick, and an EWMA of the fleet-wide backlog drain estimate. Ring
    buffers (not full history) so a long-lived fleet cannot eat host
    memory; ``summary()`` digests what is retained."""

    EWMA_ALPHA = 0.2

    def __init__(self, maxlen: int = 4096):
        self.maxlen = int(maxlen)
        self.ticks: deque = deque(maxlen=self.maxlen)
        self.queue_depth: deque = deque(maxlen=self.maxlen)
        self.tokens: deque = deque(maxlen=self.maxlen)
        self.backlog_ewma_ms: deque = deque(maxlen=self.maxlen)
        self.occupancy: deque = deque(maxlen=self.maxlen)
        self.health: deque = deque(maxlen=self.maxlen)
        # per-tenant door depth rows: {tenant: queued} per
        # tick, {} when the traffic carries no tenant labels
        self.tenant_queue: deque = deque(maxlen=self.maxlen)
        self._ewma: Optional[float] = None

    def sample(self, tick: int, queue_depth: int, tokens: int,
               backlog_ms: float, occupancy, health,
               tenants: Optional[Dict[str, int]] = None) -> None:
        """Append one tick: ``occupancy`` is a per-replica sequence of
        live-slot fractions, ``health`` the matching health strings,
        ``tenants`` the door depth per explicit tenant."""
        b = float(backlog_ms)
        self._ewma = b if self._ewma is None else \
            self.EWMA_ALPHA * b + (1 - self.EWMA_ALPHA) * self._ewma
        self.ticks.append(int(tick))
        self.queue_depth.append(int(queue_depth))
        self.tokens.append(int(tokens))
        self.backlog_ewma_ms.append(round(self._ewma, 3))
        self.occupancy.append(tuple(round(float(o), 4)
                                    for o in occupancy))
        self.health.append(tuple(health))
        self.tenant_queue.append(dict(tenants or {}))

    def __len__(self) -> int:
        return len(self.ticks)

    def summary(self) -> Dict[str, Any]:
        n = len(self.ticks)
        if not n:
            return {"ticks": 0}
        occ_flat = [o for tick in self.occupancy for o in tick]
        return {
            "ticks": n,
            "queue_depth_last": self.queue_depth[-1],
            "queue_depth_max": max(self.queue_depth),
            "tokens_total": sum(self.tokens),
            "backlog_ewma_ms_last": self.backlog_ewma_ms[-1],
            "occupancy_mean": round(sum(occ_flat) / len(occ_flat), 4)
            if occ_flat else 0.0,
            "unhealthy_ticks": sum(
                1 for tick in self.health
                if any(h != "healthy" for h in tick)),
        }

    def tenant_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-tenant door-depth digest over retained ticks: max and
        last queued per tenant ({} on pre-tenant series)."""
        out: Dict[str, Dict[str, int]] = {}
        for row in self.tenant_queue:
            for t, n in row.items():
                d = out.setdefault(t, {"queued_max": 0, "queued_last": 0})
                d["queued_max"] = max(d["queued_max"], int(n))
        if self.tenant_queue:
            last = self.tenant_queue[-1]
            for t, d in out.items():
                d["queued_last"] = int(last.get(t, 0))
        return out


# ------------------------------------------------------------- the singleton
_REQTRACE = NoopRequestTrace()


def get_reqtrace():
    """The process-wide request tracer (:class:`NoopRequestTrace` unless
    :func:`enable_reqtrace` was called)."""
    return _REQTRACE


def set_reqtrace(rt) -> None:
    global _REQTRACE
    _REQTRACE = rt


def enable_reqtrace(jsonl_file: Optional[str] = None,
                    tracer=None) -> RequestTrace:
    """Install (and return) a live :class:`RequestTrace` as the process
    singleton; a second enable returns the existing instance unchanged
    (the trace.py composition rule)."""
    global _REQTRACE
    if not _REQTRACE.enabled:
        _REQTRACE = RequestTrace(jsonl_file=jsonl_file, tracer=tracer)
    return _REQTRACE


def disable_reqtrace():
    """Swap back to the no-op singleton; returns the previous tracer (a
    caller can still read ``records()`` / ``write()`` it)."""
    global _REQTRACE
    prev = _REQTRACE
    if prev.enabled:
        prev.close()
    _REQTRACE = NoopRequestTrace()
    return prev
