"""Dynamic recompilation: re-shape the model mid-training on a trigger
(port of ``flexflow_tpu.execution.recompile``; reference: RecompileState,
include/flexflow/recompile.h:26-41, FFModel::recompile_on_condition,
model.cc:2422, used by the MoE cache example, moe.cc:180,204).

A user ``trigger`` inspects training state each iteration; when it fires,
``alter`` mutates the model (e.g. the MoE capacity factor) and the graph
is compiled anew. The old executor's captured programs are dropped first,
so no graph outlives the tensors it was captured against; the new
executor's steps capture once each, on their second call.
"""
from __future__ import annotations

from typing import Callable


class RecompileState:
    """reference: recompile.h:26-41."""

    def __init__(self, trigger: Callable[["RecompileState"], bool],
                 alter: Callable[["RecompileState"], None], ffmodel=None):
        self._trigger = trigger
        self._alter = alter
        self.ffmodel = ffmodel
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self._trigger(self))

    def alter(self, ffmodel=None) -> None:
        self._alter(self)
        self.recompilations += 1


def recompile(ffmodel) -> None:
    """Compile ``ffmodel`` anew after attribute or graph edits, keeping
    every current parameter whose node name, weight name and shape still
    match (the optimizer state starts afresh, as in the JAX package). The
    old executor's programs (the plain and the guarded step, the serving
    programs) are dropped first."""
    old_params = ffmodel.params
    if ffmodel.executor is not None:
        ffmodel.executor.invalidate_jit_cache()
    ffmodel.compile(optimizer=ffmodel.optimizer,
                    loss_type=ffmodel.loss_type,
                    metrics=ffmodel.metrics_obj.measures
                    if ffmodel.metrics_obj else None)
    if old_params:
        for lname, ws in old_params.items():
            if lname not in ffmodel.params:
                continue
            for wname, t in ws.items():
                cur = ffmodel.params[lname].get(wname)
                if cur is not None and cur.shape == t.shape:
                    ffmodel.params[lname][wname] = t
