"""Structured span/event tracer with Chrome trace-event export (a copy
of ``flexflow_tpu.obs.trace``, which imports no JAX; the port keeps its
own).

The observability analog of the reference's Legion Prof integration
(``-lg:prof``) plus the per-op ``--profiling`` kernel-timing prints: nested
spans for compile / train-step / epoch / eval / search phases, instant
events, counters and gauges, exported as Chrome trace-event JSON
(Perfetto-loadable, ``chrome://tracing``) and optionally streamed to a JSONL
event sink as spans complete.

Disabled-by-default design: the module-level singleton starts as a
``NoopTracer`` whose ``span()`` returns one shared, reusable null context
manager — entering it allocates nothing, so instrumented hot loops pay a
single attribute load + truth test when tracing is off. Nothing here runs
inside a captured step; all timestamps are host wall-clock
(``time.perf_counter`` against the tracer's epoch). The resilience session
writes its recovery spans and fault events here.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


def atomic_write_json(path: str, obj) -> str:
    """Write ``obj`` as JSON via a same-directory temp file + rename, so a
    killed process never leaves a truncated artifact. The pid in the temp
    name keeps two concurrent writers from clobbering each other's staging
    file. Shared by every JSON artifact this subsystem emits."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=str)
    os.replace(tmp, path)
    return path


class _NullSpan:
    """Allocation-free context manager returned by the disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NoopTracer:
    """Disabled tracer: every method is a no-op and ``span`` returns the one
    shared null context manager (no per-call allocation in hot loops)."""

    enabled = False
    events: tuple = ()

    def span(self, name: str, **args):
        return _NULL_SPAN

    def event(self, name: str, **args) -> None:
        pass

    def complete(self, name: str, wall_s: float, **args) -> None:
        pass

    def span_at(self, name: str, ts_us: float, dur_us: float,
                tid=None, **args) -> None:
        pass

    def event_at(self, name: str, ts_us: float, tid=None, **args) -> None:
        pass

    def counter(self, name: str, value) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def to_chrome_trace(self) -> Dict[str, Any]:
        return {"traceEvents": []}

    def write(self, path: Optional[str] = None) -> None:
        pass

    def close(self) -> None:
        pass


class _Span:
    """One live span; appended to the tracer as a complete ('ph': 'X') event
    on exit. Nesting is expressed by timestamp containment, which is how the
    Chrome trace format renders stacks for same-tid complete events."""

    __slots__ = ("tracer", "name", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = self.tracer._now_us()
        self.tracer._enter_span()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self.tracer._now_us()
        depth = self.tracer._exit_span()
        self.tracer._emit({
            "name": self.name, "cat": "flexflow", "ph": "X",
            "ts": round(self.t0, 3), "dur": round(end - self.t0, 3),
            "pid": self.tracer.pid, "tid": threading.get_ident(),
            "args": dict(self.args, depth=depth) if self.args
            else {"depth": depth},
        })
        return False


class Tracer:
    """Thread-safe span/event recorder.

    * ``span(name, **args)``: context manager; emits a complete ('X') event.
    * ``event(name, **args)``: instant ('i') event.
    * ``counter(name, value)`` / ``gauge``: 'C' events Perfetto plots as
      time series.
    * ``to_chrome_trace()`` / ``write(path)``: Chrome trace-event JSON.
    * ``jsonl_file``: when set, every emitted event is also appended to this
      file as one JSON object per line (the machine-readable event sink).
    """

    enabled = True

    # in-memory event cap: a multi-day fit with tracing on emits one event
    # per step — unbounded growth would eat host RAM and make every
    # trace-file rewrite slower. Oldest events roll off (the JSONL sink,
    # when set, still has them all); dropped count lands in otherData.
    DEFAULT_MAX_EVENTS = 500_000

    def __init__(self, trace_file: Optional[str] = None,
                 jsonl_file: Optional[str] = None, pid: int = 0,
                 max_events: int = DEFAULT_MAX_EVENTS):
        import collections

        self._lock = threading.Lock()
        self._local = threading.local()
        self.events = collections.deque(maxlen=max_events)
        self.dropped_events = 0
        self.trace_file = trace_file
        self.jsonl_file = jsonl_file
        self._jsonl_fh = None
        self.pid = pid
        self._t0 = time.perf_counter()

    # -- clock / span-stack internals -------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _enter_span(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit_span(self) -> int:
        d = getattr(self._local, "depth", 1) - 1
        self._local.depth = d
        return d

    @property
    def depth(self) -> int:
        """Current nesting depth on the calling thread."""
        return getattr(self._local, "depth", 0)

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if self.events.maxlen is not None and \
                    len(self.events) == self.events.maxlen:
                self.dropped_events += 1  # deque drops the oldest
            self.events.append(ev)
            if self.jsonl_file is not None:
                if self._jsonl_fh is None:
                    # line-buffered: the sink is tail-able mid-run and
                    # survives a crash without losing buffered events
                    self._jsonl_fh = open(self.jsonl_file, "a", buffering=1)
                self._jsonl_fh.write(json.dumps(ev, default=str) + "\n")

    # -- public recording API ---------------------------------------------
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def event(self, name: str, **args) -> None:
        self._emit({"name": name, "cat": "flexflow", "ph": "i", "s": "t",
                    "ts": round(self._now_us(), 3), "pid": self.pid,
                    "tid": threading.get_ident(), "args": args})

    def complete(self, name: str, wall_s: float, **args) -> None:
        """Retroactive complete ('X') event ending now and lasting
        ``wall_s`` — for hot loops that time a phase themselves and report
        it afterwards instead of holding a span open."""
        end = self._now_us()
        self._emit({"name": name, "cat": "flexflow", "ph": "X",
                    "ts": round(max(end - wall_s * 1e6, 0.0), 3),
                    "dur": round(wall_s * 1e6, 3), "pid": self.pid,
                    "tid": threading.get_ident(), "args": args})

    def span_at(self, name: str, ts_us: float, dur_us: float,
                tid=None, **args) -> None:
        """Complete ('X') event at an EXPLICIT timestamp (µs), on a
        caller's own clock instead of the tracer's perf_counter epoch;
        such spans carry their own time base (one pid lane per source),
        so nesting is judged within a lane, never across lanes."""
        self._emit({"name": name, "cat": "flexflow", "ph": "X",
                    "ts": round(float(ts_us), 3),
                    "dur": round(max(float(dur_us), 0.0), 3),
                    "pid": self.pid,
                    "tid": threading.get_ident() if tid is None else tid,
                    "args": args})

    def event_at(self, name: str, ts_us: float, tid=None, **args) -> None:
        """Instant ('i') event at an explicit timestamp (µs) — the
        ``event()`` analog of :meth:`span_at`."""
        self._emit({"name": name, "cat": "flexflow", "ph": "i", "s": "t",
                    "ts": round(float(ts_us), 3), "pid": self.pid,
                    "tid": threading.get_ident() if tid is None else tid,
                    "args": args})

    def counter(self, name: str, value) -> None:
        self._emit({"name": name, "cat": "flexflow", "ph": "C",
                    "ts": round(self._now_us(), 3), "pid": self.pid,
                    "tid": threading.get_ident(),
                    "args": {name: value}})

    gauge = counter  # same Chrome event shape; kept as a semantic alias

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
            dropped = self.dropped_events
        other: Dict[str, Any] = {"tracer": "flexflow_tpu_torch.obs"}
        if dropped:
            other["dropped_oldest_events"] = dropped
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def write(self, path: Optional[str] = None) -> str:
        path = path or self.trace_file
        if not path:
            raise ValueError("no trace file path given")
        return atomic_write_json(path, self.to_chrome_trace())

    def close(self) -> None:
        with self._lock:
            if self._jsonl_fh is not None:
                self._jsonl_fh.close()
                self._jsonl_fh = None
        if self.trace_file:
            self.write(self.trace_file)


# ------------------------------------------------------------- the singleton
_TRACER = NoopTracer()


def get_tracer():
    """The process-wide tracer (NoopTracer unless ``enable()`` was called)."""
    return _TRACER


def set_tracer(tracer) -> None:
    global _TRACER
    _TRACER = tracer


def enable(trace_file: Optional[str] = None,
           jsonl_file: Optional[str] = None) -> Tracer:
    """Install (and return) a live Tracer as the process singleton. If one is
    already installed it is returned unchanged, so a config-driven enable and
    an explicit user enable compose."""
    global _TRACER
    if not _TRACER.enabled:
        _TRACER = Tracer(trace_file=trace_file, jsonl_file=jsonl_file)
    return _TRACER


def disable():
    """Swap the singleton back to the NoopTracer; returns the previous tracer
    (so a caller can still ``write()`` it). JSONL sinks are closed."""
    global _TRACER
    prev = _TRACER
    if prev.enabled:
        with prev._lock:
            if prev._jsonl_fh is not None:
                prev._jsonl_fh.close()
                prev._jsonl_fh = None
    _TRACER = NoopTracer()
    return prev
