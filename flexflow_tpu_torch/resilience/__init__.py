"""Resilience: fault-tolerant training on one device and the batch
preflight (port of ``flexflow_tpu.resilience``).

* preemption-safe checkpoints: ``execution/checkpoint.py`` (atomic commit,
  async save with backpressure, checksums, retention, exact resume),
  driven from ``FFModel.fit`` by ``--checkpoint-dir`` /
  ``--checkpoint-every`` / ``--resume``;
* the divergence sentinel: ``sentinel.GuardedTrainStep`` (the on-device
  finite check, one bool a step, skip and ``--max-bad-steps`` rollback);
* deterministic fault injection: ``chaos.ChaosPlan`` /
  ``chaos.corrupt_checkpoint``;
* ``session.ResilienceSession`` orchestrates them for one ``fit``;
* elastic restart: ``elastic.elastic_restore`` (re-run the Unity search on
  the live world, host-staged resharding of the restored checkpoint);
* strategy safety: ``preflight`` (``preflight_config`` at compile, the
  strategy and batch checks), ``audit`` (the parallel-correctness probe
  against a one-device reference) and ``fallback.StrategyCascade`` (the
  degrade-through-ranked-candidates cascade before ``fit``'s loop), with
  ``chaos.inject_wrong_reshard`` to test them.
"""
from .audit import AuditError, AuditReport, audit_strategy  # noqa: F401
from .chaos import (ChaosPlan, corrupt_checkpoint,  # noqa: F401
                    inject_wrong_reshard)
from .elastic import elastic_restore  # noqa: F401
from .fallback import (MemoryBudgetError, StrategyCascade,  # noqa: F401
                       StrategyCompileError, StrategySafetyError)
from .preflight import (PreflightError, preflight_config,  # noqa: F401
                        preflight_strategy, validate_batch)
from .sentinel import GuardedTrainStep  # noqa: F401
from .session import ResilienceSession  # noqa: F401
