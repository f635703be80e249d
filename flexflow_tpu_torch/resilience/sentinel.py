"""Divergence sentinel: the NaN/Inf-guarded training step (port of
``flexflow_tpu.resilience.sentinel``).

A poisoned step (a bad batch, an overflowed bf16 path, flaky hardware)
must never write NaN into the weights. The guarded step
(``Executor.make_train_step(guard=True)``) checks ``isfinite(loss) &
isfinite(Σ|g|²)`` on the device and masks every optimizer write with it:
a bad step leaves params and optimizer state bitwise unchanged. It has no
host branch, so it runs inside the captured step program.

``GuardedTrainStep`` is the host side: it runs the guarded step, reads the
one bool a step (a pinned ``non_blocking`` copy behind an event, never a
``.item()`` inside the captured body), counts consecutive bad steps and
tells ``fit`` when ``--max-bad-steps`` is reached and a rollback is due.
"""
from __future__ import annotations

from typing import Tuple


class GuardedTrainStep:
    """``guard(params, opt_state, xs, labels, rng[, cache]) -> (outs, ok)``: ``outs``
    is what the unguarded step returns, ``ok`` the host bool of the
    device-side check."""

    def __init__(self, executor, max_bad_steps: int = 3,
                 capture: bool = True):
        self.executor = executor
        self.max_bad_steps = max(int(max_bad_steps), 1)
        self.capture = capture
        self.consecutive_bad = 0
        self.total_bad = 0

    @property
    def fn(self):
        """The executor's guarded step (cached there; dropped with its
        other programs by ``invalidate_jit_cache``)."""
        return self.executor.make_train_step(capture=self.capture,
                                             guard=True)

    def reset(self) -> None:
        self.consecutive_bad = 0

    def __call__(self, params, opt_state, xs, labels, rng, cache=None
                 ) -> Tuple[tuple, bool]:
        """With a cache state (a graph with CacheOps) ``outs`` ends with
        the CacheOps' fresh values, as the plain step's does."""
        from ..execution.graphs import HostTransfer

        extra = (cache,) if cache is not None else ()
        *outs, ok_dev = self.fn(params, opt_state, xs, labels, rng, *extra)
        ok = bool(HostTransfer(ok_dev).wait())  # the one bool a step
        if ok:
            self.consecutive_bad = 0
        else:
            self.consecutive_bad += 1
            self.total_bad += 1
        return tuple(outs), ok

    @property
    def should_rollback(self) -> bool:
        return self.consecutive_bad >= self.max_bad_steps
