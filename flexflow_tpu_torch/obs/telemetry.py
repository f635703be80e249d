"""Step telemetry: machine-readable training and serving records (port of
``flexflow_tpu.obs.telemetry``).

``StepTelemetry`` is filled by ``FFModel.fit`` and the serving engine:
per-step wall time, loss and metric history, samples/sec, the first step
(eager, then the capture) split from steady state, estimated MFU from the
graph's op FLOPs, and the card's peak memory over the run
(``capture_memory_analysis``). Its ``summary()`` is the JAX package's,
key for key and with the same rounding, written to ``--telemetry-file``.

Three functions differ from the JAX module because the device does:
``detect_peak_flops`` reads the CUDA card's name, ``capture_memory_analysis``
reads the CUDA allocator's peak counter over the run (XLA's
compiled-memory fields have no counterpart here). ``SearchLog`` is the
search's per-iteration sink (``--search-log``), a copy of the JAX one.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ..ops.base import op_flops

# dense bf16 tensor-core peak FLOP/s per card by name, as the JAX table
# holds each TPU generation's bf16 peak, so ``estimated_mfu`` means the same
# in both packages (NVIDIA H100 data sheet: SXM 989.4 TF/s, PCIe 756 TF/s,
# NVL 835 TF/s, without sparsity)
PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
    "H100 NVL": 835e12,
    "H100 PCIe": 756e12,
}


def detect_peak_flops() -> Optional[float]:
    """Peak bf16 FLOP/s of the current CUDA card, or None on the CPU (an
    MFU against a CPU "peak" would mean nothing) and on a card the table
    does not name: a guessed peak would be a silent fallback."""
    import torch

    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name()
    for key, peak in PEAK_FLOPS.items():
        if key in name:
            return peak
    return None


def model_flops_per_step(pcg, backward: bool = True) -> int:
    """Analytic model FLOPs of one training step from the ops' cost hooks
    (``Op.flops``; an op without one counts one FLOP an output element, the
    JAX package's default, and a fused region the sum of its sub-ops).
    Backward is costed as twice the forward, as in the JAX package. The
    same integer as ``flexflow_tpu.obs.telemetry.model_flops_per_step`` on
    the same graph; ``models.train_flops_per_step`` counts only the ops
    with a hook of their own (the matmul convention of the smoke's MFU),
    and ``ops.base.hookless_flops`` the forward share between the two."""
    total = 0
    for node in pcg.compute_nodes():
        in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        try:
            total += op_flops(node.op, in_shapes, list(node.out_shapes))
        except Exception:
            continue  # an op whose cost hook fails contributes 0
    return total * 3 if backward else total


class StepTelemetry:
    """Accumulates per-step records host-side; nothing device-facing happens
    here (the caller hands in already-transferred host scalars)."""

    def __init__(self, batch_size: int = 0, phase: str = "train"):
        self.phase = phase
        self.batch_size = batch_size
        self.step_wall_s: List[float] = []
        self.loss_history: List[float] = []
        self.epoch_loss: List[float] = []
        self.metric_history: List[Dict[str, float]] = []
        self.flops_per_step: Optional[int] = None
        self.peak_flops: Optional[float] = None
        self.device_memory: Optional[Dict[str, int]] = None
        self.total_wall_s: float = 0.0
        # resilience counters: filled by the fit loop's
        # ResilienceSession at close — fault events (non-finite steps,
        # preemption signals), recovery events (resume/rollback/flush),
        # steps the sentinel skipped, checkpoints committed, and the step
        # the run last resumed/rolled back to
        self.fault_events: int = 0
        self.recovery_events: int = 0
        self.skipped_steps: int = 0
        self.checkpoints_saved: int = 0
        self.last_resume_step: Optional[int] = None
        # strategy-safety counters: filled by the fit loop's
        # StrategyCascade — compile-time fallbacks taken, parallel-
        # correctness audits run/failed, and the strategy the run actually
        # trained under (which may not be the search winner)
        self.strategy_fallbacks: int = 0
        self.audit_runs: int = 0
        self.audit_failures: int = 0
        self.final_strategy: Optional[str] = None
        # static-analysis counters: ShardLint runs from cascade
        # stage 0 — analyses run, candidates statically rejected, and the
        # rule IDs (FF001..FF006) that fired
        self.static_checks: int = 0
        self.static_rejects: int = 0
        self.static_rules: List[str] = []
        # calibration counters: filled by the fit loop's
        # CalibrationLoop after each ProfiledStep pass — profiled key
        # count, sim-vs-measured aggregate/worst ratios, keys outside the
        # --drift-tolerance band, recalibrations applied (with the exact
        # delta-cost cache invalidation count) and the post-repair ratio
        self.calib_profiled_keys: int = 0
        self.calib_aggregate_ratio: Optional[float] = None
        self.calib_worst_key: Optional[str] = None
        self.calib_worst_ratio: Optional[float] = None
        self.calib_out_of_band: int = 0
        self.calib_tolerance: Optional[float] = None
        self.calib_recalibrations: int = 0
        self.calib_invalidated: int = 0
        self.calib_ratio_after: Optional[float] = None
        # serving counters: filled by the ServingEngine after a
        # serve() run — requests completed, tokens emitted, the bounded
        # admission queue's high-water mark and the per-token latency
        # percentiles, mirroring the resilience / strategy_safety blocks
        self.requests_served: int = 0
        self.tokens_generated: int = 0
        self.queue_depth_hwm: int = 0
        self.serving_p50_token_ms: Optional[float] = None
        self.serving_p99_token_ms: Optional[float] = None
        self.serving_tokens_per_s: Optional[float] = None
        # host-overhead split: fraction of serve-loop wall the
        # HOST spent dispatching + bookkeeping (vs blocked on the device)
        # — the ROADMAP "host overhead" baseline, per engine and fleet
        self.serving_host_overhead_fraction: Optional[float] = None
        # sequence-parallel decode: mean per-step occupied KV
        # bytes one shard chip holds (pool bytes at measured fill /
        # seq_shards) — the recorded number behind "KV provably exceeds
        # one chip"
        self.serving_kv_hbm_per_chip_bytes: Optional[int] = None
        # serving-resilience counters: the outcome ledger of a
        # serve() run (every request under exactly one of ok |
        # deadline_exceeded | shed | decode_fault | preempted) plus the
        # shed/deadline/quarantine/drain/replan event counts — filled by
        # ServingEngine._merge_telemetry
        self.serving_outcomes: Dict[str, int] = {}
        self.serving_sheds: int = 0
        self.serving_deadline_misses: int = 0
        self.serving_quarantines: int = 0
        self.serving_drains: int = 0
        self.serving_replans: int = 0
        # prefix-cache / chunked-prefill counters: the
        # ``serving_prefix`` block — trie hits, prompt tokens whose
        # prefill was served from cache vs computed, LRU evictions and
        # chunk-prefill dispatches — filled by
        # ServingEngine._merge_telemetry
        self.serving_prefix_hits: int = 0
        self.serving_prefix_tokens_reused: int = 0
        self.serving_prefill_tokens_computed: int = 0
        self.serving_cache_evictions: int = 0
        self.serving_chunked_prefills: int = 0
        # fleet counters: the multi-replica router's run —
        # fleet-wide outcome ledger, per-replica dispatch split,
        # migrations/hedges/failovers and the health machinery's
        # probe/circuit activity — filled by ServingFleet._merge_telemetry
        self.fleet_replicas: int = 0
        self.fleet_ticks: int = 0
        self.fleet_requests: int = 0
        self.fleet_tokens_generated: int = 0
        self.fleet_outcomes: Dict[str, int] = {}
        self.fleet_sheds: int = 0
        self.fleet_dispatches: List[int] = []
        self.fleet_migrations: int = 0
        self.fleet_hedges: int = 0
        self.fleet_hedge_twin_wins: int = 0
        self.fleet_affinity_hits: int = 0
        self.fleet_probes: int = 0
        self.fleet_circuit_opens: int = 0
        self.fleet_failovers: int = 0
        self.fleet_health_transitions: int = 0
        self.fleet_host_overhead_fraction: Optional[float] = None
        # multi-tenant + autoscale: per-tenant rows
        # {tenant: {requests, tokens, outcomes}} and the autoscaler's
        # action counts — filled by ServingFleet._merge_telemetry
        self.fleet_tenants: Dict[str, Any] = {}
        self.fleet_quota_sheds: int = 0
        self.fleet_autoscale_ups: int = 0
        self.fleet_autoscale_downs: int = 0
        # request-journal counters: the ``serving_journal``
        # block — write-ahead records appended / group-commit fsyncs /
        # rids replayed at recovery / door dedupe hits / segments
        # compacted away / torn-tail records truncated on open, plus the
        # recovery wall — filled by ServingFleet._merge_telemetry when
        # --request-journal is on
        self.journal_appended: int = 0
        self.journal_syncs: int = 0
        self.journal_replayed: int = 0
        self.journal_dedupe_hits: int = 0
        self.journal_compacted_segments: int = 0
        self.journal_truncated_records: int = 0
        self.journal_recovery_wall_s: float = 0.0
        self._t_start = time.perf_counter()

    # -- recording ----------------------------------------------------------
    def record_step(self, wall_s: float, loss: Optional[float] = None,
                    metrics: Optional[Dict[str, float]] = None) -> None:
        self.step_wall_s.append(wall_s)
        if loss is not None:
            self.loss_history.append(float(loss))
        if metrics:
            self.metric_history.append(
                {k: float(v) for k, v in metrics.items()})

    def record_epoch(self, loss: Optional[float] = None) -> None:
        if loss is not None:
            self.epoch_loss.append(float(loss))

    def finalize(self) -> None:
        self.total_wall_s = time.perf_counter() - self._t_start

    # -- derived numbers ----------------------------------------------------
    @property
    def steps(self) -> int:
        return len(self.step_wall_s)

    def first_step_s(self) -> Optional[float]:
        """First-step wall time — dominated by jit compile."""
        return self.step_wall_s[0] if self.step_wall_s else None

    def steady_step_s(self) -> Optional[float]:
        """Median steady-state step time, compile step excluded. None when
        only the compile step was recorded — deriving throughput/MFU from a
        wall that is mostly XLA compile would be silently misleading."""
        rest = sorted(self.step_wall_s[1:])
        return rest[len(rest) // 2] if rest else None

    def samples_per_sec(self) -> Optional[float]:
        st = self.steady_step_s()
        if not st or not self.batch_size:
            return None
        return self.batch_size / st

    def mfu(self) -> Optional[float]:
        st = self.steady_step_s()
        if not st or not self.flops_per_step or not self.peak_flops:
            return None
        return (self.flops_per_step / st) / self.peak_flops

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "phase": self.phase,
            "steps": self.steps,
            "batch_size": self.batch_size,
            "total_wall_s": round(self.total_wall_s, 4),
            "loss_history": self.loss_history,
            "epoch_loss": self.epoch_loss,
        }
        if self.step_wall_s:
            out["first_step_s"] = round(self.first_step_s(), 6)
            steady = self.steady_step_s()
            if steady is not None:
                out["steady_step_s"] = round(steady, 6)
                out["compile_overhead_s"] = round(
                    max(self.first_step_s() - steady, 0.0), 6)
        sps = self.samples_per_sec()
        if sps is not None:
            out["samples_per_sec"] = round(sps, 2)
        if self.flops_per_step:
            out["model_flops_per_step"] = self.flops_per_step
        mfu = self.mfu()
        if mfu is not None:
            out["estimated_mfu"] = round(mfu, 4)
            out["peak_flops"] = self.peak_flops
        if self.device_memory:
            out["device_memory"] = self.device_memory
        if self.metric_history:
            out["metric_history"] = self.metric_history
        if (self.fault_events or self.recovery_events or self.skipped_steps
                or self.checkpoints_saved
                or self.last_resume_step is not None):
            res: Dict[str, Any] = {
                "fault_events": self.fault_events,
                "recovery_events": self.recovery_events,
                "skipped_steps": self.skipped_steps,
                "checkpoints_saved": self.checkpoints_saved,
            }
            if self.last_resume_step is not None:
                res["last_resume_step"] = self.last_resume_step
            out["resilience"] = res
        if (self.strategy_fallbacks or self.audit_runs
                or self.final_strategy is not None):
            ss: Dict[str, Any] = {
                "fallbacks": self.strategy_fallbacks,
                "audit_runs": self.audit_runs,
                "audit_failures": self.audit_failures,
            }
            if self.final_strategy is not None:
                ss["final_strategy"] = self.final_strategy
            out["strategy_safety"] = ss
        if self.static_checks:
            out["strategy_static"] = {
                "checks": self.static_checks,
                "rejects": self.static_rejects,
                "rules": list(self.static_rules),
            }
        if self.calib_profiled_keys:
            cal: Dict[str, Any] = {
                "profiled_keys": self.calib_profiled_keys,
                "out_of_band": self.calib_out_of_band,
                "recalibrations": self.calib_recalibrations,
                "invalidated_entries": self.calib_invalidated,
            }
            if self.calib_aggregate_ratio is not None:
                cal["aggregate_ratio"] = round(self.calib_aggregate_ratio, 4)
            if self.calib_worst_key is not None:
                cal["worst_key"] = self.calib_worst_key
            if self.calib_worst_ratio is not None:
                cal["worst_ratio"] = round(self.calib_worst_ratio, 4)
            if self.calib_tolerance is not None:
                cal["tolerance"] = self.calib_tolerance
            if self.calib_ratio_after is not None:
                cal["ratio_after"] = round(self.calib_ratio_after, 4)
            out["calibration"] = cal
        if self.requests_served or self.tokens_generated:
            sv: Dict[str, Any] = {
                "requests_served": self.requests_served,
                "tokens_generated": self.tokens_generated,
                "queue_depth_hwm": self.queue_depth_hwm,
            }
            if self.serving_tokens_per_s is not None:
                sv["tokens_per_s"] = self.serving_tokens_per_s
            if self.serving_p50_token_ms is not None:
                sv["p50_token_ms"] = round(self.serving_p50_token_ms, 3)
            if self.serving_p99_token_ms is not None:
                sv["p99_token_ms"] = round(self.serving_p99_token_ms, 3)
            if self.serving_host_overhead_fraction is not None:
                sv["host_overhead_fraction"] = round(
                    self.serving_host_overhead_fraction, 4)
            if self.serving_kv_hbm_per_chip_bytes is not None:
                sv["kv_hbm_per_chip_bytes"] = \
                    int(self.serving_kv_hbm_per_chip_bytes)
            out["serving"] = sv
        if self.fleet_replicas:
            total = max(sum(self.fleet_outcomes.values()), 1)
            fl: Dict[str, Any] = {
                "replicas": self.fleet_replicas,
                "ticks": self.fleet_ticks,
                "requests": self.fleet_requests,
                "tokens_generated": self.fleet_tokens_generated,
                "outcomes": dict(self.fleet_outcomes),
                "shed_rate": round(self.fleet_sheds / total, 4),
                "dispatches": list(self.fleet_dispatches),
                "migrations": self.fleet_migrations,
                "hedges": self.fleet_hedges,
                "hedge_twin_wins": self.fleet_hedge_twin_wins,
                "affinity_hits": self.fleet_affinity_hits,
                "probes": self.fleet_probes,
                "circuit_opens": self.fleet_circuit_opens,
                "failovers": self.fleet_failovers,
                "health_transitions": self.fleet_health_transitions,
            }
            if self.fleet_host_overhead_fraction is not None:
                fl["host_overhead_fraction"] = round(
                    self.fleet_host_overhead_fraction, 4)
            if self.fleet_tenants:
                fl["tenants"] = {t: dict(v) for t, v
                                 in self.fleet_tenants.items()}
            if self.fleet_quota_sheds:
                fl["quota_sheds"] = self.fleet_quota_sheds
            if self.fleet_autoscale_ups or self.fleet_autoscale_downs:
                fl["autoscale"] = {"ups": self.fleet_autoscale_ups,
                                   "downs": self.fleet_autoscale_downs}
            out["fleet"] = fl
        if (self.serving_prefix_hits or self.serving_prefix_tokens_reused
                or self.serving_prefill_tokens_computed
                or self.serving_cache_evictions
                or self.serving_chunked_prefills):
            total = (self.serving_prefix_tokens_reused
                     + self.serving_prefill_tokens_computed)
            out["serving_prefix"] = {
                "hits": self.serving_prefix_hits,
                "tokens_reused": self.serving_prefix_tokens_reused,
                "tokens_computed": self.serving_prefill_tokens_computed,
                "reuse_rate": round(
                    self.serving_prefix_tokens_reused / total, 4)
                if total else 0.0,
                "evictions": self.serving_cache_evictions,
                "chunked_prefills": self.serving_chunked_prefills,
            }
        if (self.serving_outcomes or self.serving_sheds
                or self.serving_deadline_misses or self.serving_quarantines
                or self.serving_drains or self.serving_replans):
            total = max(sum(self.serving_outcomes.values()), 1)
            out["serving_resilience"] = {
                "outcomes": dict(self.serving_outcomes),
                "shed_rate": round(self.serving_sheds / total, 4),
                "deadline_miss_rate": round(
                    self.serving_deadline_misses / total, 4),
                "quarantines": self.serving_quarantines,
                "drains": self.serving_drains,
                "replans": self.serving_replans,
            }
        if self.journal_appended or self.journal_replayed:
            out["serving_journal"] = {
                "appended": self.journal_appended,
                "syncs": self.journal_syncs,
                "replayed": self.journal_replayed,
                "dedupe_hits": self.journal_dedupe_hits,
                "compacted_segments": self.journal_compacted_segments,
                "truncated_records": self.journal_truncated_records,
                "recovery_wall_s": round(
                    self.journal_recovery_wall_s, 6),
            }
        return out

    def write(self, path: str) -> str:
        from .trace import atomic_write_json

        return atomic_write_json(path, self.summary())


def capture_memory_analysis(executor, params, opt_state, xs, labels
                            ) -> Optional[Dict[str, int]]:
    """The card's memory of the training run, for the telemetry record:
    ``peak_memory_in_bytes`` is ``torch.cuda.max_memory_allocated()``, the
    peak since ``fit`` reset the counter before its first step (so over the
    run's eager step, its capture and its replays), and
    ``argument_size_in_bytes`` the bytes of the params, the optimizer state
    and the last batch. XLA's other fields (output, temporaries, generated
    code) have no counterpart in the CUDA allocator and are left out. No
    step runs here (the JAX package only compiles one; a step would move
    the weights ``fit`` returns). None on the CPU; on the card an error
    raises."""
    import torch

    from ..execution.checkpoint import tree_bytes

    if executor.device.type != "cuda":
        return None
    torch.cuda.synchronize(executor.device)
    return {
        "argument_size_in_bytes": int(tree_bytes([params, opt_state,
                                                  list(xs), labels])),
        "peak_memory_in_bytes": int(torch.cuda.max_memory_allocated(
            executor.device)),
    }


class SearchLog:
    """Per-iteration search telemetry sink. Every ``log()`` lands as a JSONL
    line (when ``path`` is set) and as an instant event on the process tracer
    (when tracing is enabled) — one call site, both sinks. Safe to construct
    unconditionally: with no path and tracing disabled it degrades to a
    counter."""

    def __init__(self, path: Optional[str] = None, kind: str = "unity"):
        self.path = path
        self.kind = kind
        self.iterations = 0
        # per-event-type record counts (e.g. "candidate", "xfer",
        # "pipeline_candidate"): unity_search derives its candidates/sec
        # metric from these, so the rate in the final record always matches
        # what the log actually streamed
        self.counts: Dict[str, int] = {}
        self._fh = None  # set BEFORE open(): __del__ must find the attr
        # even when open() raises on a bad path
        if path:
            # line-buffered: the log is for WATCHING a live search (tail
            # -f) and must survive a mid-search kill
            self._fh = open(path, "a", buffering=1)

    def log(self, **rec) -> None:
        self.iterations += 1
        ev = rec.get("event")
        if ev:
            self.counts[ev] = self.counts.get(ev, 0) + 1
        rec.setdefault("search", self.kind)
        rec.setdefault("iter", self.iterations)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, default=str) + "\n")
        from .trace import get_tracer

        tracer = get_tracer()
        if tracer.enabled:
            tracer.event(f"{self.kind}_iter", **rec)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __del__(self):
        # a search that raises mid-run drops its SearchLog frame without
        # reaching the explicit close(); refcount collection closes the fd
        # (writes are line-buffered, so no records are lost either way)
        self.close()
