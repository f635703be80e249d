"""Pipeline schedules: the pure helpers a strategy needs to describe and
validate itself.

From ``flexflow_tpu.parallel.pipeline`` (:59-93): the schedule vocabulary
and its one display rule. The stage split, the schedule generator and
``PipelineTrainer`` run pipeline strategies; they are ported with the
pipeline schedules, and until then a ``Strategy.pipeline`` grid and
``--schedule`` are refused at compile and fit.
"""
from __future__ import annotations

# the searched schedule axis; order = the search's sweep order
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def describe_schedule(schedule: str, v: int = 1) -> str:
    """The one display rule for a schedule suffix: '' for gpipe/unset
    (the default needs no annotation), the schedule name otherwise, with
    the interleaved virtual-chunk count appended ('interleaved(v=2)')."""
    if not schedule or schedule == "gpipe":
        return ""
    if schedule == "interleaved" and int(v or 1) > 1:
        return f"{schedule}(v={v})"
    return schedule
