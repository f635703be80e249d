"""Serving under failure: deadlines, load shedding, decode-health quarantine
and the graceful drain (port of ``flexflow_tpu.serving.resilience``).

* **deadlines** — ``Request.deadline_ms`` (default from
  ``--request-timeout-ms``), enforced at admission and at every decode
  iteration; an expired request is evicted with outcome
  ``deadline_exceeded`` and its slot recycled.
* **admission control / load shedding** — :class:`AdmissionController`
  keeps an EWMA of the per-token decode cost; queue depth times that cost
  gives an estimated completion time, and :meth:`ServingResilience.admit`
  sheds (a typed :class:`OverloadError` with a ``retry_after_ms`` hint)
  per ``--shed-policy``: ``off`` (the bounded queue is the only wall),
  ``deadline`` (the estimate blows the request's deadline) or ``queue``
  (queue depth at the high-water mark ``max_queue // 2``).
* **decode-health quarantine** — the guarded decode program
  (``Executor.make_decode_step(guard=True)``) also computes a per-slot
  ``isfinite`` verdict on the logits, brought back in the tokens' one
  pinned copy; a poisoned slot is quarantined alone, its request retried
  on a fresh slot per ``--decode-retry-budget`` by re-prefilling prompt +
  committed tokens, and a repeat aborts it with outcome ``decode_fault``.
* **graceful drain** — ``ServingEngine.serve`` installs the flag-only
  SIGTERM/SIGINT handler (``resilience/session.py``); on preemption
  admission stops, in-flight requests finish within ``--drain-grace-s``
  and queued ones are handed back for re-submission.

Device-loss failover (the JAX package's ``DeviceLossError``,
``DecodeStateLostError`` and the auto elastic replan) needs the
multi-device serving plan and comes with ROADMAP A.8: the port's decode
dispatch catches nothing.
"""
from __future__ import annotations

from typing import Callable, Optional

from .scheduler import (ContinuousBatchScheduler, Request,
                        ServingRejection, now_ms)

#: terminal request dispositions — every request that enters the system
#: leaves it under exactly one of these (``quota_exceeded`` is the
#: tenancy layer's, ported later)
OUTCOMES = ("ok", "deadline_exceeded", "shed", "quota_exceeded",
            "decode_fault", "preempted")

SHED_POLICIES = ("off", "deadline", "queue")


class OverloadError(ServingRejection):
    """Admission shed by the load controller (``--shed-policy``): the
    estimated completion time blows the request's deadline, or the queue
    crossed its high-water mark. Carries ``queued`` / ``active`` /
    ``retry_after_ms`` like ``QueueFullError``, so one except clause
    handles both."""


class AdmissionController:
    """EWMA cost model behind load shedding.

    ``observe_step`` feeds each decode iteration's wall time and the number
    of live slots it advanced; the controller keeps an exponentially
    weighted moving average of the per-token decode cost (ms). The
    completion estimate of a new request is

        est_ms = token_cost_ms * (backlog_tokens / n_slots
                                  + max_new_tokens)

    where ``backlog_tokens`` counts the remaining tokens of every in-flight
    slot and every queued request. ``retry_after_ms`` is the backlog half
    of that estimate. The controller lives on the engine, so the cost model
    warms across runs; ``force_token_cost_ms`` pins the cost (tests,
    scripted capacity planning)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self._ewma_token_ms: Optional[float] = None
        self.observed_steps = 0
        self.force_token_cost_ms: Optional[float] = None
        # speculative decoding: the acceptance rate's EWMA (None until a
        # round proposed something). The cost side needs nothing apart: a
        # round reports (wall, tokens committed) through observe_step
        self.spec_acceptance: Optional[float] = None

    def observe_speculation(self, accepted: int, proposed: int) -> None:
        """Feed one verification round's (accepted, proposed) draft counts
        into the acceptance EWMA, with the cost model's alpha."""
        if proposed <= 0:
            return
        rate = accepted / proposed
        if self.spec_acceptance is None:
            self.spec_acceptance = rate
        else:
            self.spec_acceptance += self.alpha * (rate -
                                                  self.spec_acceptance)

    @property
    def token_cost_ms(self) -> float:
        if self.force_token_cost_ms is not None:
            return float(self.force_token_cost_ms)
        return self._ewma_token_ms or 0.0

    def observe_step(self, wall_s: float, tokens: int) -> None:
        cost = wall_s * 1e3 / max(int(tokens), 1)
        if self._ewma_token_ms is None:
            self._ewma_token_ms = cost
        else:
            self._ewma_token_ms += self.alpha * (cost - self._ewma_token_ms)
        self.observed_steps += 1

    def warm_start(self, other: "AdmissionController") -> None:
        """Adopt ``other``'s warm cost model iff this controller is cold
        (never ``force_token_cost_ms``: a pin stays on its controller)."""
        if other is self or other is None:
            return
        if self.observed_steps > 0 or self._ewma_token_ms is not None:
            return
        self._ewma_token_ms = other._ewma_token_ms
        self.observed_steps = other.observed_steps

    @staticmethod
    def _backlog_tokens(sched: ContinuousBatchScheduler) -> int:
        """Remaining tokens ahead of a new request: the queued requests'
        and the in-flight slots' (a saturated slot pool delays a first
        token as a deep queue does)."""
        queued = sum(r.max_new_tokens - len(r.generated)
                     for r in sched.queue)
        inflight = sum(r.max_new_tokens - len(r.generated)
                       for r in sched.slots if r is not None)
        return queued + inflight

    def estimate_completion_ms(self, req: Request,
                               sched: ContinuousBatchScheduler) -> float:
        backlog = self._backlog_tokens(sched)
        return self.token_cost_ms * (backlog / max(sched.n_slots, 1)
                                     + req.max_new_tokens)

    def retry_after_ms(self, sched: ContinuousBatchScheduler) -> float:
        return self.token_cost_ms * (self._backlog_tokens(sched)
                                     / max(sched.n_slots, 1))


class ServingResilience:
    """One serve run's resilience policy and counters: the knobs
    (``--request-timeout-ms`` / ``--shed-policy`` / ``--drain-grace-s`` /
    ``--decode-retry-budget``), the shared :class:`AdmissionController`,
    the clock every deadline decision reads (injectable: one time base for
    submit stamps, sweeps and the drain grace), and the event counters the
    engine merges into ``ServingStats`` and the telemetry's
    ``serving_resilience`` block."""

    def __init__(self, config, chaos=None,
                 controller: Optional[AdmissionController] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.chaos = chaos
        self.request_timeout_ms = float(
            getattr(config, "request_timeout_ms", 0.0) or 0.0)
        self.shed_policy = getattr(config, "shed_policy", "off") or "off"
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, got "
                f"{self.shed_policy!r}")
        self.drain_grace_s = float(getattr(config, "drain_grace_s", 5.0))
        self.decode_retry_budget = int(
            getattr(config, "decode_retry_budget", 1))
        self.controller = controller or AdmissionController()
        self.clock = clock if clock is not None else now_ms
        self.sheds = 0
        self.deadline_misses = 0
        self.quarantines = 0
        self.decode_retries = 0
        self.decode_faults = 0
        self.drains = 0
        self._saw_deadline = False

    @property
    def armed(self) -> bool:
        """Any serving-resilience feature active? A plain serve (False)
        pays nothing: no guarded decode, no per-iteration sweeps. A
        caller-set ``Request.deadline_ms`` arms it with every knob at its
        default."""
        return bool(self.chaos is not None or self.shed_policy != "off"
                    or self.deadlines_armed)

    @property
    def deadlines_armed(self) -> bool:
        return self.request_timeout_ms > 0 or self._saw_deadline

    def stamp_deadline(self, req: Request) -> None:
        """Default a request's deadline from ``--request-timeout-ms``; a
        caller-set ``deadline_ms`` wins."""
        if req.deadline_ms is None and self.request_timeout_ms > 0:
            req.deadline_ms = self.request_timeout_ms
        if req.deadline_ms is not None:
            self._saw_deadline = True

    def _shed(self, sched, req: Request, policy: str, **fields) -> None:
        self.sheds += 1
        req.outcome = "shed"
        if sched.rt.enabled:
            sched.rt.finish(req.rid, float(self.clock()), "shed",
                            policy=policy, **fields)

    def admit(self, sched: ContinuousBatchScheduler, req: Request) -> None:
        """Deadline stamp + shed-policy gate + scheduler submit. Raises
        :class:`OverloadError` (shed) or the scheduler's rejection (the
        hard walls); each is counted here as outcome ``shed``, so a
        rejected request still leaves under exactly one outcome."""
        self.stamp_deadline(req)
        policy = self.shed_policy
        if policy == "queue":
            highwater = max(sched.max_queue // 2, 1)
            if sched.queued >= highwater:
                self._shed(sched, req, "queue", queued=sched.queued,
                           highwater=highwater)
                raise OverloadError(
                    f"request {req.rid} shed (policy 'queue'): queue depth "
                    f"{sched.queued} >= high-water {highwater} "
                    f"(max_queue {sched.max_queue})",
                    queued=sched.queued, active=sched.active,
                    retry_after_ms=self.controller.retry_after_ms(sched))
        elif policy == "deadline" and req.deadline_ms is not None \
                and req.deadline_ms > 0:
            est = self.controller.estimate_completion_ms(req, sched)
            if est > req.deadline_ms:
                self._shed(sched, req, "deadline", est_ms=round(est, 3),
                           deadline_ms=req.deadline_ms)
                raise OverloadError(
                    f"request {req.rid} shed (policy 'deadline'): "
                    f"estimated completion {est:.1f} ms exceeds deadline "
                    f"{req.deadline_ms:.1f} ms",
                    queued=sched.queued, active=sched.active,
                    retry_after_ms=self.controller.retry_after_ms(sched))
        try:
            sched.submit(req)
        except ServingRejection:
            self._shed(sched, req, "hard_wall", queued=sched.queued)
            raise
