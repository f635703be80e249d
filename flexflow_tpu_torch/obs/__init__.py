"""Observability (port of ``flexflow_tpu.obs``): the span/event tracer
(``trace``), step telemetry (``telemetry``), request-level tracing of the
serving stack (``reqtrace``), and passthroughs to ``torch.profiler``.

* ``start_trace`` / ``stop_trace`` / ``trace`` (alias ``trace_dir``) run
  ``torch.profiler.profile`` over CPU and, where there is a card, CUDA
  activity, and export one Chrome trace into the directory at the end
  (``<dir>/flexflow_torch_<pid>_<n>.pt.trace.json``). The executor's
  per-node ``record_function`` ranges (entered only while a profiler runs)
  name the graph's nodes on eager steps; a captured step's replay shows
  its kernels but not the ranges, which a CUDA graph does not record.
* ``start_server`` (the JAX package's xprof server) has no torch
  counterpart and raises.

Nothing here runs inside a captured step; every instrument is host-side
and gated on ``get_tracer().enabled`` / ``get_reqtrace().enabled``.
"""
import itertools
import os

from .trace import (NoopTracer, Tracer, atomic_write_json,  # noqa: F401
                    disable, enable, get_tracer, set_tracer)
from .reqtrace import (FleetTimeSeries, NoopRequestTrace,  # noqa: F401
                       RequestTrace, disable_reqtrace, enable_reqtrace,
                       get_reqtrace, set_reqtrace)
from .telemetry import (SearchLog, StepTelemetry,  # noqa: F401
                        capture_memory_analysis, detect_peak_flops,
                        model_flops_per_step)

_exports = itertools.count(1)
_running = []  # the profile start_trace began, until stop_trace


def start_server(port: int = 9012):
    raise NotImplementedError(
        "obs.start_server (the xprof profiler server) has no torch "
        "counterpart; use obs.trace(dir) / --profiler-trace-dir, whose "
        "Chrome trace loads in Perfetto or chrome://tracing")


class trace:
    """``with obs.trace(dir): ...`` — a ``torch.profiler.profile`` of the
    block (CPU, and CUDA where there is a card; ``kwargs`` go to the
    profile) exported as one Chrome trace into ``log_dir``; the path is
    :attr:`path` after the block."""

    def __init__(self, log_dir: str, **kwargs):
        self.log_dir = log_dir
        self.kwargs = kwargs
        self.path = None
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, **self.kwargs)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(
            self.log_dir,
            f"flexflow_torch_{os.getpid()}_{next(_exports)}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        return False


trace_dir = trace  # surface alias: obs.trace_dir(dir) reads naturally too


def start_trace(log_dir: str, **kwargs) -> None:
    """Begin a profiler trace into ``log_dir`` (:class:`trace` without the
    block); :func:`stop_trace` ends and exports it."""
    if _running:
        raise RuntimeError("a profiler trace is already running; call "
                           "obs.stop_trace() first")
    t = trace(log_dir, **kwargs)
    t.__enter__()
    _running.append(t)


def stop_trace():
    """End the trace :func:`start_trace` began and export it; returns the
    Chrome trace's path."""
    if not _running:
        raise RuntimeError("no profiler trace is running")
    t = _running.pop()
    t.__exit__(None, None, None)
    return t.path
