"""Strategy fallback cascade: never trust one plan (port of
``flexflow_tpu.resilience.fallback``).

The Unity search hands the executor ONE winning strategy; a plan whose
first step fails, that runs out of memory, or that computes wrong
gradients would cost the whole run. The cascade verifies the plan ONCE
before ``fit``'s loop (``StrategyCascade.preverify``), in order:

0. **static analysis** — ShardLint (``analysis/``) over the live PCG and
   strategy: a statically rejected candidate falls down the ranked chain
   WITHOUT a probe step (the ``compile_probes`` counter shows it);
   ``--static-analysis off`` skips the stage;
1. **preflight** — the divisibility audit (``preflight.py``);
2. **compile probe** — the exact step the loop will run (the guarded one
   under ``--max-bad-steps``, captured as the loop captures it) runs ONE
   step on clones of the params and optimizer state, which stay bitwise
   unchanged, as do the optimizer's step count and ``_rng_counter``; its
   first call warms the program (kernel builds, library workspaces). A
   ``ChaosPlan(fail_compiles=N)`` fails this stage on script;
3. **memory budget** — ``--memory-budget-mb``: the step's measured peak
   (``Executor.train_step_memory_analysis``: the CUDA allocator's peak
   over the step's eager call and its capture; on the CPU the port's own
   count) must fit;
4. **audit** — ``--audit-strategy``: the parallel-correctness probe
   (``audit.py``) against a one-device reference within ``--audit-tol``.

On any failure the cascade degrades: the next ranked search candidate
(``SearchResult.ranked``, re-mapped by node name onto a fresh PCG), then
the data-parallel + full-remat last resort, then it aborts with a
diagnosis listing every rejected plan and why. Weights edited before
``fit`` survive each hop (host-staged onto the new layouts). Every hop
emits a ``strategy_fallback`` obs event and lands in ``StepTelemetry``'s
``strategy_safety`` block; ``--strategy-fallback off`` turns failures into
immediate errors.

The JAX package has one controller; the port has one process a rank, and
ranks that trained different plans would hang at the first collective.
So every stage's verdict is agreed over the world before anyone acts on
it (the coordination group, as the search's digest is agreed): a
rank-local failure (one rank over its budget) is a failure on every rank,
raised there with the failing rank's message. On one process without a
process group, the last resort is the one-device path under full remat.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..analysis.report import StaticAnalysisError
from .audit import AuditError, describe_plan
from .preflight import PreflightError, preflight_strategy


class StrategySafetyError(RuntimeError):
    """The strategy-safety layer rejected the plan (and, with the cascade
    on, every fallback after it)."""


class StrategyCompileError(StrategySafetyError):
    """The candidate failed the compile probe (its first step raised, or a
    scripted chaos injection)."""


class MemoryBudgetError(StrategySafetyError):
    """The step's measured peak exceeds ``--memory-budget-mb``."""


_FAILURE_KINDS = (PreflightError, AuditError, StrategySafetyError,
                  StaticAnalysisError)
# what a rank that passed a stage raises when another rank failed it
_AGREED_KINDS = {cls.__name__: cls for cls in (
    PreflightError, AuditError, StrategySafetyError, StrategyCompileError,
    MemoryBudgetError)}


class StrategyCascade:
    """One fit()'s strategy-safety verification and fallback."""

    def __init__(self, ffmodel, chaos=None):
        cfg = ffmodel.config
        self.model = ffmodel
        self.chaos = chaos
        self.tracer = ffmodel._obs_tracer()
        self.fallback_on = (getattr(cfg, "strategy_fallback", "on")
                            or "on") != "off"
        self.audit_on = bool(getattr(cfg, "audit_strategy", False))
        self.tol = float(getattr(cfg, "audit_tol", 0.05) or 0.05)
        self.budget_bytes = int(
            getattr(cfg, "memory_budget_mb", 0) or 0) * 2 ** 20
        # stage 0: ShardLint, on unless explicitly off; pure Python over
        # graph metadata, free next to any probe the cascade runs anyway
        self.static_on = (getattr(cfg, "static_analysis", "on")
                          or "on") != "off"
        self.static_checks = 0
        self.static_rejects = 0
        self.static_rules: List[str] = []
        # probe executions — a statically rejected candidate never counts
        self.compile_probes = 0
        self.fallbacks = 0
        self.audits = 0
        self.audit_failures = 0
        self.audit_reports: List = []
        # each candidate's measured peak (describe, bytes), in order
        self.memory_peaks: List[Tuple[str, int]] = []
        self._audit_ref_cache: dict = {}
        self.failures: List[Tuple[str, str]] = []
        self.final_desc = describe_plan(ffmodel)
        ranked = list(getattr(ffmodel, "_strategy_candidates", []) or [])
        # rank 0 is the winner the model already compiled; runners-up must
        # be SPMD (the cascade re-enters the SPMD fit loop) and carry a
        # name-re-mappable serialized strategy
        self._pending = [c for c in ranked[1:]
                         if c.strategy_json and not c.pipeline]
        self._dp_tried = False

    @classmethod
    def maybe_create(cls, ffmodel, chaos=None) -> Optional["StrategyCascade"]:
        """The cascade only arms when there is something to verify — the
        audit flag, a memory budget, or pending strategy chaos. A plain fit
        pays nothing (no probe step). ``--strategy-fallback off`` does NOT
        disarm verification: it only turns failures into errors."""
        cfg = ffmodel.config
        audit = bool(getattr(cfg, "audit_strategy", False))
        budget = int(getattr(cfg, "memory_budget_mb", 0) or 0) > 0
        chaos_armed = chaos is not None and getattr(
            chaos, "strategy_chaos_pending", lambda: False)()
        if not (audit or budget or chaos_armed):
            return None
        return cls(ffmodel, chaos)

    # ------------------------------------------------------------- verify --
    def preverify(self, xs, y, batch_size: int) -> None:
        """Run the cascade to a verified strategy (possibly after several
        fallbacks) or raise a :class:`StrategySafetyError` diagnosis. On a
        mesh every rank calls it with the whole arrays."""
        model = self.model
        # probe data is one fit batch; a dataset smaller than the batch
        # yields no training step, so the execution probes are skipped —
        # but preflight still judges the batch size the loop would use
        n = min(int(batch_size), int(np.asarray(xs[0]).shape[0]))
        probe_xs = [np.asarray(a[:n]) for a in xs]
        probe_y = np.asarray(y[:n])
        run_probes = n == int(batch_size)
        # graph-level chaos: a scripted drop/duplicate of a real reduction
        # edge lands in the live PCG here, so the static stage and the
        # audit judge the SAME defect
        if self.chaos is not None and getattr(
                self.chaos, "graph_defect_pending", lambda: False)():
            desc = self.chaos.apply_wrong_reshard(model)
            if desc:
                self.tracer.event("chaos_graph_defect", detail=desc[:300])
        while True:
            desc = describe_plan(model)
            try:
                self._verify_current(desc, probe_xs, probe_y, batch_size,
                                     run_probes)
            except _FAILURE_KINDS as e:
                reason = f"{type(e).__name__}: {e}"
                self.failures.append((desc, reason))
                self.tracer.event("strategy_rejected", strategy=desc,
                                  reason=reason[:300])
                if not self.fallback_on:
                    raise
                self._fall_back(reason, cause=e)
                continue
            self.final_desc = describe_plan(model)
            if self.fallbacks:
                self.tracer.event("strategy_fallback_final",
                                  strategy=self.final_desc,
                                  fallbacks=self.fallbacks)
            return

    def _fall_back(self, reason: str, cause: Exception) -> None:
        """Advance to the next applicable candidate; a candidate that fails
        to APPLY (its own preflight at compile, a bad remap) joins the
        diagnosis and the cascade keeps degrading."""
        while True:
            nxt = self._next_candidate()
            if nxt is None:
                lines = "\n".join(f"  {d}: {r}" for d, r in self.failures)
                raise StrategySafetyError(
                    "strategy-safety cascade exhausted — every candidate "
                    "(ranked search results and the dp+full-remat last "
                    "resort) was rejected:\n" + lines) from cause
            try:
                self._apply(nxt, reason=reason)
                return
            except Exception as e:
                to_desc = (nxt if isinstance(nxt, str) else nxt.describe())
                self.failures.append(
                    (to_desc,
                     f"fallback apply failed: {type(e).__name__}: {e}"))

    def _agreed(self, stage, *args) -> None:
        """Run ``stage(*args)`` and agree its verdict over the world: every
        rank's failure (kind and message) is gathered over the model's
        coordination group, and if any rank failed every rank raises — its
        own error, or the lowest failing rank's as the same kind."""
        err = None
        try:
            stage(*args)
        except _FAILURE_KINDS as e:
            err = e
        group = self.model.coordination
        if group is None:
            if err is not None:
                raise err
            return
        import torch.distributed as dist

        got = [None] * dist.get_world_size(group)
        dist.all_gather_object(
            got, None if err is None else (type(err).__name__, str(err)),
            group=group)
        bad = [(r, v) for r, v in enumerate(got) if v is not None]
        if not bad:
            return
        if err is not None:
            raise err
        r, (kind, msg) = bad[0]
        raise _AGREED_KINDS.get(kind, StrategySafetyError)(
            f"rank {r}: {msg}")

    def _verify_current(self, desc: str, probe_xs, probe_y,
                        batch_size: int, run_probes: bool = True) -> None:
        from ..parallel.mesh import world

        model = self.model
        if self.static_on:
            self._agreed(self._static_check, desc)
        # stage 0's analyzer already ran FF006 (the per-node spec half of
        # preflight) over this exact (pcg, strategy)
        if model.strategy is not None:
            self._agreed(preflight_strategy, model.pcg, model.strategy,
                         world()[1], batch_size, not self.static_on)
        if not run_probes:
            return
        self._agreed(self._compile_check, desc, probe_xs, probe_y)
        if self.budget_bytes:
            self._agreed(self._memory_check, desc, probe_xs, probe_y)
        if self.audit_on:
            self._agreed(self._audit_check, desc, probe_xs, probe_y)

    def _static_check(self, desc: str) -> None:
        """Stage 0: ShardLint over the candidate (the one-device path is
        judged as the JAX package's one-device plan, as ``compile`` under
        ``--static-analysis strict`` judges it). An erroring report raises
        :class:`StaticAnalysisError` with no probe run."""
        from ..analysis import analyze_model
        from ..parallel.strategy import data_parallel_strategy

        model = self.model
        self.static_checks += 1
        live = model.strategy
        model.strategy = live or data_parallel_strategy(model.pcg, 1)
        try:
            report = analyze_model(model)
        finally:
            model.strategy = live
        self.tracer.event("strategy_static", strategy=desc,
                          diagnostics=len(report.diagnostics),
                          errors=len(report.errors),
                          rules=",".join(report.rules_fired()))
        if report.errors:
            self.static_rejects += 1
            for d in report.errors:
                if d.rule_id not in self.static_rules:
                    self.static_rules.append(d.rule_id)
            raise StaticAnalysisError(report, context=desc)

    def _stage_batch(self, probe_xs, probe_y):
        """This rank's part of the probe batch, on the device."""
        import torch

        model = self.model
        local = model.executor.local_batch(
            list(probe_xs) + [model._prep_label(probe_y)])
        dev = model.executor.device
        out = [torch.as_tensor(np.ascontiguousarray(a)).to(dev)
               for a in local]
        return out[:-1], out[-1]

    def _guarded(self) -> bool:
        return int(getattr(self.model.config, "max_bad_steps", 0) or 0) > 0

    def _compile_check(self, desc: str, probe_xs, probe_y) -> None:
        """Run the EXACT step the loop will run (guarded under
        ``--max-bad-steps``, captured as the loop captures it) for one step
        on clones of the params and optimizer state; the live ones, the
        step counter and ``_rng_counter`` are untouched. The program's
        entry, which holds the clones, is dropped after."""
        import torch

        from ..execution.checkpoint import _tree_map

        model = self.model
        self.compile_probes += 1
        if self.chaos is not None and self.chaos.consume_compile_failure():
            raise StrategyCompileError(
                f"chaos: injected compile failure for {desc}")
        ex = model.executor
        step = None
        try:
            step = ex.make_train_step(capture=model._capture_steps,
                                      guard=self._guarded())
            bx, by = self._stage_batch(probe_xs, probe_y)
            args = (_tree_map(lambda t: t.clone(), model.params),
                    _tree_map(lambda t: t.clone(), model.opt_state), bx, by,
                    torch.Generator().manual_seed(0))
            if ex.cache_nodes:
                args = args + (_tree_map(lambda t: t.clone(),
                                         ex.init_cache()),)
            out = step(*args)
            float(out[2])  # the loss reached the host: the step ran
        except _FAILURE_KINDS:
            raise
        except Exception as e:
            raise StrategyCompileError(
                f"{desc}: train-step compile / first-step probe failed: "
                f"{type(e).__name__}: {e}") from e
        finally:
            program = getattr(step, "program", None)
            if program is not None:
                program.reset()

    def _memory_check(self, desc: str, probe_xs, probe_y) -> None:
        from ..obs.telemetry import peak_memory_bytes

        model = self.model
        bx, by = self._stage_batch(probe_xs, probe_y)
        try:
            ma = model.executor.train_step_memory_analysis(
                model.params, model.opt_state, bx, by,
                guard=self._guarded(), capture=model._capture_steps)
        except Exception as e:
            if "out of memory" not in str(e).lower():
                raise
            raise MemoryBudgetError(
                f"{desc}: the step ran out of device memory while its peak "
                f"was measured ({type(e).__name__}), over --memory-budget-mb "
                f"{self.budget_bytes // 2 ** 20} MiB") from e
        peak = peak_memory_bytes(ma)
        self.memory_peaks.append((desc, int(peak or 0)))
        self.tracer.event("strategy_memory", strategy=desc,
                          peak_mib=round((peak or 0) / 2 ** 20, 1),
                          source=ma.get("source", ""))
        if peak is not None and peak > self.budget_bytes:
            raise MemoryBudgetError(
                f"{desc}: measured step peak {peak / 2 ** 20:.1f} MiB "
                f"exceeds --memory-budget-mb "
                f"{self.budget_bytes // 2 ** 20} MiB")

    def _audit_check(self, desc: str, probe_xs, probe_y) -> None:
        from .audit import audit_strategy

        self.audits += 1
        # the one-device reference is candidate-independent (same graph,
        # same weights, same probe): computed once, reused for every
        # candidate this cascade audits
        report = audit_strategy(self.model, probe_xs, probe_y, tol=self.tol,
                                chaos=self.chaos,
                                ref_cache=self._audit_ref_cache)
        self.audit_reports.append(report)
        self.tracer.event("strategy_audit", strategy=desc,
                          passed=bool(report.passed),
                          loss_rel_err=round(report.loss_rel_err, 6),
                          grad_rel_err=round(report.grad_rel_err, 6))
        if not report.passed:
            self.audit_failures += 1
            raise AuditError(
                f"{desc}: parallel-correctness audit failed — "
                + report.detail())

    # ----------------------------------------------------------- fallback --
    def _next_candidate(self):
        if self._pending:
            return self._pending.pop(0)
        if not self._dp_tried:
            self._dp_tried = True
            return "dp_full_remat"
        return None

    def _apply(self, cand, reason: str = "") -> None:
        """Recompile the model under the fallback candidate (every rank
        alike), the live weights host-staged across the hop: pre-fit edits
        survive; shapes do not depend on the strategy."""
        import gc

        from ..parallel.mesh import world
        from ..parallel.strategy import Strategy, data_parallel_strategy

        model = self.model
        from_desc = describe_plan(model)
        host = model.get_params_numpy()
        if cand == "dp_full_remat":
            n_dev = world()[1]

            def strategy_fn(pcg):
                s = data_parallel_strategy(pcg, n_dev)
                s.remat = "full"
                return s

            to_desc = f"mesh=({n_dev},) remat=full"
        else:
            text = cand.strategy_json

            def strategy_fn(pcg):
                return Strategy.from_json(text, pcg)

            to_desc = cand.describe()
        # drop the old plan's programs and their memory before the new
        # plan is measured
        model.executor.invalidate_jit_cache()
        model._one_device_plan = True
        try:
            model.compile(optimizer=model.optimizer,
                          loss_type=model.loss_type,
                          metrics=(model.metrics_obj.measures
                                   if model.metrics_obj else None),
                          strategy_fn=strategy_fn)
        finally:
            model._one_device_plan = False
        gc.collect()
        # counted and emitted only once the hop took effect — a candidate
        # that fails to compile joins the diagnosis instead
        self.fallbacks += 1
        self.tracer.event("strategy_fallback", from_strategy=from_desc,
                          to_strategy=to_desc, reason=reason[:300],
                          fallback=self.fallbacks)
        fresh = model.get_params_numpy()
        for ln, ws in host.items():
            for wn, a in ws.items():
                cur = fresh.get(ln, {}).get(wn)
                if cur is not None and cur.shape == a.shape:
                    fresh[ln][wn] = a
        model.set_params_numpy(fresh)  # fresh optimizer state too

    # ---------------------------------------------------------- telemetry --
    def merge_telemetry(self, telemetry) -> None:
        if telemetry is None:
            return
        telemetry.strategy_fallbacks += self.fallbacks
        telemetry.audit_runs += self.audits
        telemetry.audit_failures += self.audit_failures
        telemetry.final_strategy = self.final_desc
        telemetry.static_checks += self.static_checks
        telemetry.static_rejects += self.static_rejects
        for r in self.static_rules:
            if r not in telemetry.static_rules:
                telemetry.static_rules.append(r)
