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
* ``preflight.validate_batch`` checks a batch against the compiled model,
  ``preflight.preflight_strategy`` a strategy against the machine.

Elastic restart, the strategy audit and the fallback cascade come with
the multi-device slices.
"""
from .chaos import ChaosPlan, corrupt_checkpoint  # noqa: F401
from .preflight import (PreflightError, preflight_strategy,  # noqa: F401
                        validate_batch)
from .sentinel import GuardedTrainStep  # noqa: F401
from .session import ResilienceSession  # noqa: F401
