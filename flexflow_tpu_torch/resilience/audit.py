"""Parallel-correctness audit: refuse plans that compute wrong gradients
(port of ``flexflow_tpu.resilience.audit``).

The worst strategy failure is not a crash but a plan that compiles, runs
and trains on wrong gradients (a bad substitution, a resharding that drops
or double-counts a partial sum). The search's cost model cannot see it;
only execution can. The audit (``--audit-strategy``) runs ONE probe batch
twice over the same graph:

* under the candidate strategy, as the train step runs it
  (``Executor.make_probe_step``: the same compute-dtype cast, aux losses
  and dropout seeds), each rank on its part of the batch;
* under a one-device reference executor on the rank's own device, over
  the whole probe batch: no resharding to get wrong;

and compares the loss and the global gradient L2 norm within
``--audit-tol`` relative error. Any dropped or doubled collective in the
backward moves the global grad norm, and two scalars cost no gather of
both param trees to the host.

Chaos hook: ``ChaosPlan(wrong_reshard=True)`` in ``"scale"`` mode scales
the candidate's reported grad norm by ``wrong_reshard_factor``, so the
reject path is testable without a genuinely wrong plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class AuditError(RuntimeError):
    """The candidate strategy's probe diverged from the one-device
    reference beyond ``--audit-tol``: the plan is presumed wrong."""


@dataclasses.dataclass
class AuditReport:
    passed: bool
    loss_candidate: float
    loss_reference: float
    grad_norm_candidate: float
    grad_norm_reference: float
    loss_rel_err: float
    grad_rel_err: float
    tol: float
    strategy: str = ""

    def detail(self) -> str:
        return (f"loss {self.loss_candidate:.6g} vs reference "
                f"{self.loss_reference:.6g} (rel err "
                f"{self.loss_rel_err:.3g}), grad norm "
                f"{self.grad_norm_candidate:.6g} vs "
                f"{self.grad_norm_reference:.6g} (rel err "
                f"{self.grad_rel_err:.3g}), tol {self.tol:g}")


def describe_plan(ffmodel) -> str:
    """The live plan in ``Strategy.describe()``'s words; the one-device
    path (no strategy) is the JAX package's one-device plan, a data
    parallel mesh of one."""
    if ffmodel.strategy is not None:
        return ffmodel.strategy.describe()
    if ffmodel.pcg is None:
        return "?"
    from ..parallel.strategy import data_parallel_strategy

    return data_parallel_strategy(ffmodel.pcg, 1).describe()


def _reference_executor(ffmodel):
    """A one-device executor over the SAME compiled graph, on the rank's
    own device: no tensor, sequence or expert sharding, so no resharding
    rule to have gotten wrong — the numerical ground truth of the audit."""
    from ..execution.executor import Executor

    ex = ffmodel.executor
    return Executor(ffmodel.pcg, ffmodel.config, ffmodel.final_guid,
                    ex.device, final_out_idx=ex.final_out_idx,
                    loss_type=ffmodel.loss_type, metrics=ffmodel.metrics_obj,
                    optimizer=ffmodel.optimizer, repl_labels=ex.repl_labels)


def _to_device(arrays, device):
    import torch

    return [torch.as_tensor(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def audit_strategy(ffmodel, xs, y, tol: float = 0.05,
                   chaos=None, ref_cache: Optional[dict] = None
                   ) -> AuditReport:
    """Run the probe batch under the model's live strategy and under the
    one-device reference; returns an :class:`AuditReport` (never raises on
    a mere mismatch: the caller decides between refusing and falling
    back).

    ``xs`` / ``y`` are host arrays of one whole batch (labels may be raw;
    they go through the model's label prep). ``tol`` bounds BOTH relative
    errors; a non-finite value on either side fails. ``ref_cache`` (a dict
    the caller owns) keeps the reference's two scalars: the reference does
    not depend on the candidate, so a cascade auditing several candidates
    over one probe runs it once. On a mesh every rank calls it."""
    import torch

    xs = [np.asarray(a) for a in ffmodel._as_input_list(xs)]
    y = ffmodel._prep_label(np.asarray(y))
    ex = ffmodel.executor
    dev = ex.device

    local = ex.local_batch(xs + [y])
    bx = _to_device(local[:-1], dev)
    (by,) = _to_device(local[-1:], dev)
    cargs = (ffmodel.params, bx, by, torch.Generator().manual_seed(0))
    if ex.cache_nodes:
        cargs = cargs + (ex.init_cache(),)
    loss_c, gn_c = (float(v) for v in ex.make_probe_step()(*cargs))
    del cargs, bx, by
    if chaos is not None:
        gn_c *= float(chaos.consume_wrong_reshard())

    if ref_cache is not None and "ref" in ref_cache:
        loss_r, gn_r = ref_cache["ref"]
    else:
        ref = _reference_executor(ffmodel)
        host = ffmodel.get_params_numpy()
        params = {n: {w: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for w, a in ws.items()} for n, ws in host.items()}
        rargs = (params, _to_device(xs, dev), _to_device([y], dev)[0],
                 torch.Generator().manual_seed(0))
        if ref.cache_nodes:
            rargs = rargs + (ref.init_cache(),)
        loss_r, gn_r = (float(v) for v in ref.make_probe_step()(*rargs))
        del ref, params, rargs
        if ref_cache is not None:
            ref_cache["ref"] = (loss_r, gn_r)

    def rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(b), 1e-8)

    loss_err, grad_err = rel(loss_c, loss_r), rel(gn_c, gn_r)
    finite = bool(np.all(np.isfinite([loss_c, gn_c, loss_r, gn_r])))
    passed = finite and loss_err <= tol and grad_err <= tol
    return AuditReport(
        passed=passed, loss_candidate=loss_c, loss_reference=loss_r,
        grad_norm_candidate=gn_c, grad_norm_reference=gn_r,
        loss_rel_err=loss_err, grad_rel_err=grad_err, tol=tol,
        strategy=describe_plan(ffmodel))
