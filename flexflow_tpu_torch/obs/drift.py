"""Sim-vs-measured drift sentinel and the closed calibration loop (port
of ``flexflow_tpu.obs.drift``).

``DriftSentinel`` compares the Simulator's predicted per-op forward cost
with the ProfiledStep's measured times — the two sides join on the
op-cost cache key (``obs.profile``) — and keeps rolling per-key ratios.
Drift beyond ``--drift-tolerance`` becomes an alertable signal:
``calibration_drift`` tracer events per out-of-band key, a
``calibration`` block in StepTelemetry.

``CalibrationLoop`` is the fit loop's orchestrator: one ProfiledStep pass
per fit (``Executor.profile_ops``: each distinct op shape timed on the
card, as the step runs it), the sentinel's evaluation, and, with
``--auto-recalibrate``, the repair: ``Simulator.calibrate_from_profile``
folds the measured ratios into the per-key calibration, invalidating only
the delta-cost entries whose keys moved, persists the repaired table
(``--calibration-dir``) and re-ranks the search's fallback chain
(``search.calibration.rerank_candidates``) when a searched strategy is
live.

Ratio convention: ``measured / predicted`` — 1.0 is a perfect ruler,
> 1 means the simulator under-prices the op. A key is out of band when
its rolling ratio leaves ``[1/(1+tol), 1+tol]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .trace import get_tracer


class DriftSentinel:
    """Rolling predicted-vs-measured comparison for one (sim, graph)."""

    WINDOW = 8  # rolling ratio window per key

    def __init__(self, sim, pcg, tolerance: float = 0.25):
        self.sim = sim
        self.pcg = pcg
        self.tolerance = float(tolerance)
        self._node_map: Optional[Dict[str, Tuple]] = None
        # key_repr -> recent per-pass ratios (newest last)
        self.history: Dict[str, List[float]] = {}

    def _nodes(self) -> Dict[str, Tuple]:
        if self._node_map is None:
            m: Dict[str, Tuple] = {}
            for node in self.pcg.compute_nodes():
                in_shapes = [self.pcg.nodes[g].out_shapes[i]
                             for g, i in node.inputs]
                m.setdefault(repr(self.sim._op_key(node, in_shapes)),
                             (node, in_shapes))
            self._node_map = m
        return self._node_map

    def _predict(self, rec) -> Optional[float]:
        from ..search.simulator import OpSharding

        ent = self._nodes().get(rec.key)
        if ent is None:
            return None
        node, in_shapes = ent
        sh_d = dict(rec.sharding or {})
        sh = OpSharding(
            dp=int(sh_d.get("dp", 1)), tp=int(sh_d.get("tp", 1)),
            kind=str(sh_d.get("kind", "none")),
            act_tp=int(sh_d.get("act_tp", 1)),
            remat=str(sh_d.get("remat", "none")))
        old = (self.sim.dp_dcn, self.sim.tp_dcn)
        self.sim.set_axis_topology(*(rec.dcn or (1, 1)))
        try:
            return self.sim.op_cost(node, in_shapes, sh).forward_time
        finally:
            self.sim.set_axis_topology(*old)

    def ratios(self, records) -> Dict[str, Any]:
        """One-shot predicted-vs-measured evaluation (no history, no
        events) — also the post-repair verification pass: the measured
        side is unchanged, so re-predicting under repaired calibration
        gives the repaired ratio without re-profiling."""
        per_key: Dict[str, Dict[str, Any]] = {}
        tot_meas = 0.0
        tot_pred = 0.0
        for rec in records:
            predicted = self._predict(rec)
            if predicted is None or predicted <= 0:
                continue
            r = rec.measured_fwd_s / predicted
            per_key[rec.key] = {"name": rec.name, "ratio": r,
                                "measured_s": rec.measured_fwd_s,
                                "predicted_s": predicted,
                                "count": rec.count}
            tot_meas += rec.measured_fwd_s * rec.count
            tot_pred += predicted * rec.count
        return {
            "per_key": per_key,
            "aggregate_ratio": (tot_meas / tot_pred) if tot_pred else None,
        }

    def in_band(self, ratio: float) -> bool:
        return 1.0 / (1.0 + self.tolerance) <= ratio <= \
            1.0 + self.tolerance

    def observe(self, records, step: int = 0) -> Dict[str, Any]:
        """Evaluate one profiled pass: fold per-key ratios into the
        rolling history, emit a ``calibration_drift`` tracer event per
        out-of-band key plus an aggregate gauge, and return the summary
        the telemetry block / auto-recalibration consume."""
        ev = self.ratios(records)
        tracer = get_tracer()
        out_of_band: List[str] = []
        worst_key = None
        worst_ratio = None
        worst_dev = -1.0
        for krepr, d in ev["per_key"].items():
            h = self.history.setdefault(krepr, [])
            h.append(d["ratio"])
            del h[:-self.WINDOW]
            rolling = sum(h) / len(h)
            d["rolling_ratio"] = rolling
            dev = max(rolling, 1.0 / rolling) - 1.0 if rolling > 0 \
                else float("inf")
            if dev > worst_dev:
                worst_dev, worst_key, worst_ratio = dev, d["name"], rolling
            if not self.in_band(rolling):
                out_of_band.append(krepr)
                if tracer.enabled:
                    tracer.event(
                        "calibration_drift", op=d["name"], step=step,
                        ratio=round(rolling, 4),
                        measured_us=round(d["measured_s"] * 1e6, 2),
                        predicted_us=round(d["predicted_s"] * 1e6, 2),
                        tolerance=self.tolerance)
        agg = ev["aggregate_ratio"]
        if tracer.enabled and agg is not None:
            tracer.gauge("calibration_aggregate_ratio", round(agg, 4))
        return {
            "profiled_keys": len(ev["per_key"]),
            "aggregate_ratio": agg,
            "worst_key": worst_key,
            "worst_ratio": worst_ratio,
            "out_of_band": out_of_band,
            "tolerance": self.tolerance,
        }

    def forget(self, key_reprs) -> None:
        """Drop rolling history for repaired keys: post-repair passes
        must judge the new ruler, not average it against the old one."""
        for k in key_reprs:
            self.history.pop(k, None)


class CalibrationLoop:
    """Fit-side orchestrator of the closed observability loop."""

    def __init__(self, model):
        from ..search.calibration import build_calibrated_sim

        self.model = model
        cfg = model.config
        # one sim per model, reused across fits (the rolling history and
        # the repaired calibration persist); tests inject a perturbed sim
        sim = getattr(model, "_calibration_sim", None)
        if sim is None:
            sim = build_calibrated_sim(model)
            model._calibration_sim = sim
        self.sim = sim
        self.tolerance = float(
            getattr(cfg, "drift_tolerance", 0.25) or 0.25)
        sent = getattr(model, "_drift_sentinel", None)
        if sent is None or sent.sim is not sim or sent.pcg is not model.pcg:
            sent = DriftSentinel(sim, model.pcg, tolerance=self.tolerance)
            model._drift_sentinel = sent
        sent.tolerance = self.tolerance
        self.sentinel = sent
        self.auto = bool(getattr(cfg, "auto_recalibrate", False))
        self.profile_path = getattr(cfg, "profile_ops", "") or ""
        self.iters = 3
        self.recalibrations = 0
        self.invalidated = 0
        self.ratio_after: Optional[float] = None
        self.last: Optional[Dict[str, Any]] = None

    @classmethod
    def maybe_create(cls, model) -> Optional["CalibrationLoop"]:
        """Armed only by ``--profile-ops`` (the SPMD fit; a pipeline fit
        refuses the flag). A plain fit pays one getattr."""
        if not (getattr(model.config, "profile_ops", "") or ""):
            return None
        if getattr(model, "_pipeline_trainer", None) is not None:
            return None
        return cls(model)

    def run_pass(self, xs, batch_size: int, telemetry,
                 step: int = 0) -> Optional[Dict[str, Any]]:
        """One ProfiledStep pass: measure on the live params and this
        rank's part of the first batch -> export (JSONL by rank 0, tracer
        spans) -> sentinel -> (opt-in) repair + persist + re-rank ->
        telemetry. The records stay on ``model.op_profile``."""
        import numpy as np
        import torch

        from .profile import OpProfile, profile_model

        model = self.model
        n = int(np.asarray(xs[0]).shape[0])
        if n < batch_size:
            import warnings

            warnings.warn(
                f"--profile-ops: dataset ({n} samples) smaller than the "
                f"batch ({batch_size}); skipping the profiled pass")
            return None
        local = model.executor.local_batch(
            [np.asarray(a)[:batch_size] for a in xs])
        bx = [torch.as_tensor(a).to(model.device) for a in local]
        tracer = get_tracer()
        records = profile_model(model, bx, iters=self.iters, step=step,
                                sim=self.sim)
        model.op_profile = records
        if self.profile_path and model._writes_files():
            OpProfile(records).write_jsonl(self.profile_path)
        if tracer.enabled:
            for r in records:
                # retroactive span per profiled op (ends "now", lasting
                # the measured time — a readable per-op lane)
                tracer.complete(f"op_profile:{r.name}", r.measured_fwd_s,
                                op_type=r.op_type, count=r.count,
                                step=step)
        drift = self.sentinel.observe(records, step=step)
        if self.auto and drift["out_of_band"]:
            # min_rel_change stays at the simulator's default (0.05), not
            # the alert tolerance: the band is multiplicative while
            # min_rel_change is relative, so gating repairs at the
            # tolerance would leave a dead zone on the low side
            rep = self.sim.calibrate_from_profile(
                OpProfile(records), model.pcg)
            if rep["updated"]:
                self.recalibrations += 1
                self.invalidated += (rep["invalidated"]["cost_entries"]
                                     + rep["invalidated"]["table_entries"])
                self.sentinel.forget(k for k, _o, _n in rep["updates"])
                post = self.sentinel.ratios(records)
                self.ratio_after = post["aggregate_ratio"]
                drift["ratio_after"] = self.ratio_after
                if tracer.enabled:
                    tracer.event(
                        "calibration_repair", step=step,
                        updated=rep["updated"],
                        invalidated=rep["invalidated"],
                        aggregate_ratio_before=drift["aggregate_ratio"],
                        aggregate_ratio_after=self.ratio_after)
                from ..search.calibration import (rerank_candidates,
                                                  store_persistent_calibration)

                if getattr(model.config, "calibration_dir", "") and \
                        model._writes_files():
                    store_persistent_calibration(self.sim)
                rerank_candidates(model, self.sim)
        self.last = drift
        self._merge_telemetry(telemetry, drift)
        return drift

    def _merge_telemetry(self, telemetry, drift: Dict[str, Any]) -> None:
        if telemetry is None or drift is None:
            return
        telemetry.calib_profiled_keys = drift["profiled_keys"]
        telemetry.calib_aggregate_ratio = drift["aggregate_ratio"]
        telemetry.calib_worst_key = drift["worst_key"]
        telemetry.calib_worst_ratio = drift["worst_ratio"]
        telemetry.calib_out_of_band = len(drift["out_of_band"])
        telemetry.calib_tolerance = drift["tolerance"]
        telemetry.calib_recalibrations = self.recalibrations
        telemetry.calib_invalidated = self.invalidated
        telemetry.calib_ratio_after = self.ratio_after
