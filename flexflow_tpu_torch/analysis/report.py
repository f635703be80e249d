"""ShardLint diagnostics: stable rule IDs, actionable messages, one report.

Every finding is a :class:`Diagnostic` with a rule ID (FF001..FF006 —
documented with examples in ``docs/static_analysis.md``), the offending
node's name, a message saying what is wrong, and a fix hint saying what to
change. A :class:`AnalysisReport` aggregates one analysis run; consumers:

* ``resilience.fallback.StrategyCascade`` — stage 0: an erroring report
  raises :class:`StaticAnalysisError` and the cascade degrades to the next
  ranked candidate WITHOUT paying a compile/probe;
* ``search.unity`` — candidate pruning before simulation;
* the CLI (``python -m flexflow_tpu.analysis`` / ``scripts/fflint.py``) —
  prints ``format_line()`` per diagnostic, exit status 1 on errors;
* ``obs.StepTelemetry`` — ``telemetry_block()`` is the ``strategy_static``
  summary block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    rule_id: str          # "FF001".."FF006"
    node: str             # offending PCG node name ("" = graph/plan level)
    message: str          # what is statically wrong
    fix_hint: str = ""    # what to change
    severity: str = "error"   # "error" | "warning"

    def format_line(self) -> str:
        where = f" node '{self.node}'" if self.node else ""
        line = f"{self.rule_id}{where}: {self.message}"
        if self.fix_hint:
            line += f" [fix: {self.fix_hint}]"
        return line


@dataclasses.dataclass
class AnalysisReport:
    """The result of one static analysis pass over (PCG, Strategy)."""

    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    # which rule checkers ran (rule IDs), independent of whether they fired
    checked: Tuple[str, ...] = ()
    strategy_desc: str = ""

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def rules_fired(self) -> List[str]:
        return sorted({d.rule_id for d in self.diagnostics})

    def describe(self) -> str:
        if not self.diagnostics:
            return "clean (0 diagnostics)"
        return "; ".join(d.format_line() for d in self.diagnostics)

    def format(self) -> str:
        lines = [d.format_line() for d in self.diagnostics]
        lines.append(f"{len(self.errors)} error(s), "
                     f"{len(self.diagnostics) - len(self.errors)} "
                     "warning(s)")
        return "\n".join(lines)

    def telemetry_block(self) -> Dict[str, Any]:
        return {
            "diagnostics": len(self.diagnostics),
            "errors": len(self.errors),
            "rules": self.rules_fired(),
        }


class StaticAnalysisError(ValueError):
    """The analyzer statically rejected the plan — raised by cascade
    stage 0 and by ``FFModel.compile`` under ``--static-analysis strict``.
    The message lists every diagnostic with rule ID, node, and fix hint."""

    def __init__(self, report: AnalysisReport, context: str = ""):
        self.report = report
        head = "static analysis rejected the plan"
        if context:
            head += f" ({context})"
        super().__init__(head + ":\n  " + "\n  ".join(
            d.format_line() for d in report.errors))
