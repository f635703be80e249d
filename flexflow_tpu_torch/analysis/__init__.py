"""ShardLint: static verification of parallel plans (a copy of
``flexflow_tpu.analysis``; its command line is ROADMAP A.6 part 2).

Every property the strategy-safety layer verified *dynamically*
— by compiling a candidate and running a probe step — that is actually
decidable from the PCG and the Strategy alone, verified statically: an abstract
interpreter propagates a per-tensor placement
lattice (``replicated | sharded(axis, dim) | partial_sum(axis)``,
``lattice.py``/``interp.py``) and named rules with stable IDs judge the
result (``rules.py``; table in ``docs/static_analysis.md``):

FF001 partial-sum placement · FF002 donation-aliasing · FF003 rng-stream
collision · FF004 remat segmentation · FF005 serving-state reachability ·
FF006 shape/divisibility dataflow.

Wired in three places: stage 0 of ``resilience.fallback.StrategyCascade``
(statically-rejected candidates degrade down the ranked chain without a
compile), candidate pruning in ``search.unity`` before simulation, and
the CLI (``python -m flexflow_tpu.analysis`` / ``scripts/fflint.py``).
The dynamic checks stay as the backstop for what statics cannot see
(an actual XLA miscompile); they no longer run first.
"""
from __future__ import annotations

from typing import List, Optional

from .interp import InterpResult, interpret  # noqa: F401
from .lattice import Placement  # noqa: F401
from .report import (AnalysisReport, Diagnostic,  # noqa: F401
                     StaticAnalysisError)
from .rules import (RULES, BufferRef, DonationSpec,  # noqa: F401
                    check_donation, check_paged_kv, check_remat,
                    check_rng_streams, check_serving_graph, check_shapes,
                    donation_spec_for_training)

__all__ = [
    "AnalysisReport", "Diagnostic", "StaticAnalysisError", "Placement",
    "InterpResult", "interpret", "RULES", "BufferRef", "DonationSpec",
    "check_donation", "check_paged_kv", "check_remat",
    "check_rng_streams", "check_serving_graph", "check_shapes",
    "donation_spec_for_training",
    "analyze_strategy", "analyze_candidate", "analyze_model",
]


def analyze_strategy(pcg, strategy, *, serving: bool = False,
                     remat_level: Optional[str] = None,
                     remat_segment_size: int = 8,
                     donation: Optional[DonationSpec] = None,
                     schedule: Optional[str] = None,
                     virtual_stages: Optional[int] = None
                     ) -> AnalysisReport:
    """The full static pass over one (PCG, Strategy) pair.

    Runs the abstract interpreter (FF001), the rng-stream check (FF003),
    the remat segmentation check (FF004; ``remat_level`` defaults to the
    strategy's searched level), and the shape/divisibility dataflow
    (FF006). ``serving=True`` adds the serving-state reachability check
    (FF005); ``donation`` adds the aliasing contract check (FF002).
    Pure Python over graph metadata — no device, no compile, no step."""
    diags: List[Diagnostic] = []
    checked = ["FF001", "FF003", "FF004", "FF006"]
    res = interpret(pcg, strategy)
    diags.extend(res.diagnostics)
    diags.extend(check_rng_streams(pcg))
    level = remat_level if remat_level is not None else \
        (getattr(strategy, "remat", "") or "none")
    diags.extend(check_remat(pcg, level, remat_segment_size))
    # pipeline strategies: the STAGE-CHUNK segmentation obeys the same two
    # FF004 laws (partition + topological cuts). The interleaved
    # schedule's pp*v round-robin chunks are judged as chunk CUTS, not
    # device placement — a legal interleaved plan passes.
    # ``schedule``/``virtual_stages`` let analyze_model pass the RESOLVED
    # choice (the --schedule flag beats the searched field, exactly as
    # the remat_level resolution above) — defaults read the strategy.
    if strategy is not None and getattr(strategy, "pipeline", None):
        from ..parallel.pipeline import split_stages

        pp = int(strategy.pipeline[0])
        if schedule is None:
            schedule = getattr(strategy, "schedule", "") or ""
        if virtual_stages is None:
            virtual_stages = int(getattr(strategy, "virtual_stages", 1)
                                 or 1)
        v = int(virtual_stages) if schedule == "interleaved" else 1
        n_chunks = pp * max(v, 1)
        if 1 <= n_chunks <= len(pcg.compute_nodes()):
            diags.extend(check_remat(
                pcg, "full", segments=split_stages(pcg, n_chunks),
                kind="stage"))
    if strategy is not None:
        diags.extend(check_shapes(pcg, strategy))
    if serving:
        checked.append("FF005")
        diags.extend(check_serving_graph(pcg))
    if donation is not None:
        checked.append("FF002")
        diags.extend(check_donation(donation))
    desc = strategy.describe() if strategy is not None and \
        hasattr(strategy, "describe") else ""
    return AnalysisReport(diagnostics=diags, checked=tuple(checked),
                          strategy_desc=desc)


def analyze_candidate(pcg, strategy) -> AnalysisReport:
    """The search's fast pruning pass: FF001 (lattice) + FF006 (shapes)
    only — the two rules a search candidate can actually violate, cheap
    enough to run per candidate before the simulator prices it."""
    diags = list(interpret(pcg, strategy).diagnostics)
    diags.extend(check_shapes(pcg, strategy))
    return AnalysisReport(diagnostics=diags, checked=("FF001", "FF006"),
                          strategy_desc=strategy.describe()
                          if strategy is not None else "")


def analyze_model(ffmodel, serving: bool = False,
                  pcg=None) -> AnalysisReport:
    """Analyze a compiled :class:`FFModel` — its live PCG, strategy, remat
    plan, and training-step donation contract. ``pcg`` overrides
    ``ffmodel.pcg`` for callers analyzing mid-compile, before the model
    binds it (the --static-analysis strict path)."""
    from ..execution.remat import resolve_remat_plan

    plan = resolve_remat_plan(ffmodel.config, ffmodel.strategy)
    sched = None
    vstages = None
    if getattr(ffmodel.strategy, "pipeline", None):
        # judge the segmentation the trainer will RUN: --schedule /
        # --virtual-stages beat the searched fields (resolve_schedule),
        # the same flag-beats-searched rule as the remat plan above
        from ..parallel.pipeline import resolve_schedule

        sched, vstages = resolve_schedule(ffmodel.config, ffmodel.strategy)
    return analyze_strategy(
        ffmodel.pcg if pcg is None else pcg, ffmodel.strategy,
        serving=serving, remat_level=plan.level,
        remat_segment_size=plan.segment_size,
        donation=donation_spec_for_training(ffmodel),
        schedule=sched, virtual_stages=vstages)
