"""ResilienceSession: the fault-tolerance orchestrator of one ``fit`` (port
of ``flexflow_tpu.resilience.session``).

One object owns every resilience concern of a training run, so the fit
loop stays readable: the async ``CheckpointManager`` (``--checkpoint-dir``
/ ``--checkpoint-every`` / ``--keep-checkpoints``), the SIGTERM/SIGINT
handlers (they only set a flag; the loop flushes a final checkpoint at the
next step boundary), exact resume (``--resume auto|<path>``: params,
optimizer state, epoch, batch cursor, rng counter), the divergence
sentinel (``--max-bad-steps`` consecutive non-finite steps roll back to
the last committed checkpoint) and the scripted chaos hooks.

On a mesh of several ranks every rank runs a session and every decision
is the same on all of them: the guarded step's verdict is reduced over the
world inside the step (``Executor.make_train_step``), so the bad-step
count and the rollback step agree; the checkpoint rolled back or resumed
to is rank 0's choice, agreed through the model's coordination group
(``parallel/mesh.agree``), never each rank's view of the directory, and
rank 0 alone checksums it; a restore that fails on any rank fails on
all; a preemption seen by one rank (its SIGTERM, or its chaos plan) is
agreed after every step (``any_rank``, one host all-reduce a step, only
while a session runs), so every rank stops after the same step and they
flush one checkpoint together.

Rollback: the first replays from the last good checkpoint unchanged (under
the transient-fault model the replay is clean and the run reconverges to
the uninterrupted one); from the second on, the learning rate is first
multiplied by ``--rollback-lr-factor``; past ``--max-rollbacks`` the run
aborts. Faults land in the tracer as ``fault`` events and recoveries as
``recovery`` spans; the counters stay on the session (``summary()``).
"""
from __future__ import annotations

import signal
import time
from typing import Any, Dict, Optional, Tuple

from ..execution.checkpoint import (CheckpointCorruptError,
                                    CheckpointManager, latest_checkpoint,
                                    list_checkpoints, restore_checkpoint,
                                    restore_train_cursor)
from ..execution.checkpoint import verify_checkpoint
from ..obs.trace import get_tracer
from ..parallel.mesh import agree, any_rank
from .sentinel import GuardedTrainStep


class ResilienceSession:
    def __init__(self, ffmodel, chaos=None, signals_only: bool = False):
        # signals_only: the serving engine takes only the flag-only
        # preemption handlers for its graceful drain — no checkpoint
        # writer, no train-step guard, whatever the config arms for fit
        cfg = ffmodel.config
        self.model = ffmodel
        self.chaos = chaos
        self.tracer = get_tracer()
        self.checkpoint_every = max(int(cfg.checkpoint_every or 0), 0)
        self.manager: Optional[CheckpointManager] = None
        if cfg.checkpoint_dir and not signals_only:
            self.manager = CheckpointManager(ffmodel, cfg.checkpoint_dir,
                                             keep=cfg.keep_checkpoints)
        self.guard: Optional[GuardedTrainStep] = None
        if int(cfg.max_bad_steps or 0) > 0 and not signals_only:
            self.guard = GuardedTrainStep(ffmodel.executor,
                                          cfg.max_bad_steps,
                                          capture=ffmodel._capture_steps)
        self.rollback_lr_factor = float(cfg.rollback_lr_factor or 0.5)
        self.max_rollbacks = max(int(cfg.max_rollbacks or 3), 1)
        self.rollbacks = 0
        self.fault_events = 0
        self.recovery_events = 0
        self.skipped_steps = 0
        self.last_resume_step: Optional[int] = None
        # ``preempted`` is the agreed flag the loop reads; ``signalled``
        # this rank's own (its handler, or its chaos plan)
        self.preempted = False
        self.signalled = False
        self.preempt_signum: Optional[int] = None
        self.group = getattr(ffmodel, "coordination", None)
        self._old_handlers: Dict[int, Any] = {}

    @staticmethod
    def wanted(config, chaos) -> bool:
        """Any resilience feature asked for? (When not, ``fit`` runs its
        plain loop with no per-step cost.)"""
        return bool(config.checkpoint_dir
                    or int(config.max_bad_steps or 0) > 0
                    or (config.resume or "").strip()
                    or chaos is not None)

    @property
    def checkpoints_saved(self) -> int:
        return self.manager.saved if self.manager is not None else 0

    def summary(self) -> Dict[str, Any]:
        """The counters under the names of the JAX package's telemetry
        ``summary()["resilience"]``."""
        res: Dict[str, Any] = {
            "fault_events": self.fault_events,
            "recovery_events": self.recovery_events,
            "skipped_steps": self.skipped_steps,
            "checkpoints_saved": self.checkpoints_saved,
        }
        if self.last_resume_step is not None:
            res["last_resume_step"] = self.last_resume_step
        return res

    # ------------------------------------------------------------ signals --
    def _on_signal(self, signum, frame) -> None:
        # flags only: the handler runs between two bytecodes of the main
        # thread, where the tracer's lock may be held; the fault event is
        # recorded at the next step boundary (note_preemption)
        self.signalled = True
        self.preempt_signum = signum
        if self.group is None:
            self.preempted = True

    def note_preemption(self, step: int) -> None:
        """Record the flagged preemption (from the fit loop, before the
        final flush)."""
        self.fault_events += 1
        self.tracer.event("fault", kind="preemption_signal",
                          signum=self.preempt_signum, step=step)

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old_handlers[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                pass  # not the main thread: preemption flagging unavailable

    def restore_signal_handlers(self) -> None:
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._old_handlers.clear()

    # ------------------------------------------------------------- resume --
    def _chooses(self) -> bool:
        """Is this rank the one whose choices the ranks agree on (rank 0
        of the coordination group, or the only rank)?"""
        if self.group is None:
            return True
        import torch.distributed as dist

        return dist.get_rank(self.group) == 0

    def _restore(self, path: str, verify: bool) -> int:
        """``restore_checkpoint`` on every rank alike: a read that fails
        on any rank raises on all of them (the others would otherwise wait
        in an agreement that rank never joins)."""
        err = None
        try:
            step = restore_checkpoint(self.model, path, verify=verify)
        except (CheckpointCorruptError, OSError) as e:
            err = e
        if any_rank(err is not None, self.group):
            raise err or CheckpointCorruptError(
                f"{path}: the restore failed on another rank")
        return step

    def maybe_resume(self) -> Optional[Tuple[int, int, int]]:
        """Honour ``--resume``: (step, epoch, batch_in_epoch) after the
        model state is restored, or None for a fresh start. ``auto`` with
        no committed checkpoint is a fresh start; an explicit path that is
        missing or uncommitted raises."""
        mode = (self.model.config.resume or "").strip()
        if not mode:
            return None
        if mode == "auto":
            d = self.model.config.checkpoint_dir
            path = agree(latest_checkpoint(d, verify=True)
                         if d and self._chooses() else None, self.group)
            if path is None:
                return None
        else:
            path = mode
        t0 = time.perf_counter()
        # rank 0 has checksummed the latest checkpoint already
        step = self._restore(path, verify=mode != "auto")
        ts = restore_train_cursor(self.model, path)
        self.last_resume_step = step
        self.recovery_events += 1
        self.tracer.complete("recovery", time.perf_counter() - t0,
                             kind="resume", path=path, step=step)
        return step, int(ts.get("epoch", 0)), int(ts.get("batch_in_epoch", 0))

    # -------------------------------------------------------- checkpointing --
    def _train_state(self, step: int, epoch: int, batch_in_epoch: int,
                     steps_per_epoch: int) -> Dict[str, Any]:
        if steps_per_epoch and batch_in_epoch >= steps_per_epoch:
            epoch, batch_in_epoch = epoch + 1, 0  # boundary-normalized
        return {"step": int(step), "epoch": int(epoch),
                "batch_in_epoch": int(batch_in_epoch),
                "rng_counter": int(self.model._rng_counter)}

    def on_step(self, step: int, epoch: int, batch_in_epoch: int,
                steps_per_epoch: int) -> None:
        """Periodic async checkpoint (after the step's update landed), and
        the preemption flag agreed over the ranks."""
        self.preempted = any_rank(self.signalled, self.group)
        if self.manager is None or self.checkpoint_every <= 0:
            return
        if step % self.checkpoint_every == 0:
            self.manager.save_async(
                step, self._train_state(step, epoch, batch_in_epoch,
                                        steps_per_epoch))

    def final_checkpoint(self, step: int, epoch: int, batch_in_epoch: int,
                         steps_per_epoch: int) -> Optional[str]:
        """The preemption flush: drain pending saves, then commit the
        current state synchronously."""
        if self.manager is None:
            return None
        t0 = time.perf_counter()
        path = self.manager.save_sync(
            step, self._train_state(step, epoch, batch_in_epoch,
                                    steps_per_epoch))
        self.tracer.complete("recovery", time.perf_counter() - t0,
                             kind="preemption_flush", step=step,
                             path=path or "")
        return path

    # ------------------------------------------------------------ sentinel --
    def record_fault(self, step: int, kind: str = "nonfinite_step") -> None:
        self.fault_events += 1
        self.skipped_steps += 1
        self.tracer.event("fault", kind=kind, step=step)

    def rollback(self) -> Tuple[int, int, int]:
        """Restore the last committed checksum-clean checkpoint once the
        sentinel's bad-step budget is spent; returns (step, epoch,
        batch_in_epoch) to re-enter the loop at. From the second rollback
        on the learning rate shrinks first."""
        if self.manager is None:
            raise RuntimeError(
                "--max-bad-steps hit with no --checkpoint-dir: divergence "
                "sentinel has no committed checkpoint to roll back to "
                f"(loss/grads non-finite for {self.guard.consecutive_bad} "
                "consecutive steps)")
        self.manager.flush()
        candidates = agree([p for _s, p in reversed(
            list_checkpoints(self.manager.directory))], self.group)
        if not candidates:
            raise RuntimeError(
                "divergence sentinel: no committed checkpoint exists yet "
                "(lower --checkpoint-every or raise --max-bad-steps)")
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"divergence persists after {self.max_rollbacks} rollbacks "
                "(reduced-LR escape hatch included) — aborting the run")
        t0 = time.perf_counter()
        step = path = None
        for cand in candidates:
            # a bit-rotted newest checkpoint falls back to an older one:
            # rank 0 checksums each candidate and its verdict is everyone's
            try:
                if agree(bool(verify_checkpoint(cand))
                         if self._chooses() else None, self.group):
                    raise CheckpointCorruptError(f"{cand}: checksum "
                                                 "mismatch")
                step = self._restore(cand, verify=False)
                path = cand
                break
            except (CheckpointCorruptError, OSError):
                self.fault_events += 1
                self.tracer.event("fault", kind="corrupt_checkpoint",
                                  path=cand)
        if step is None:
            raise RuntimeError(
                "divergence sentinel: every committed checkpoint in "
                f"{self.manager.directory} failed checksum verification")
        ts = restore_train_cursor(self.model, path)
        new_lr = None
        if self.rollbacks > 1:
            # persistent divergence: shrink the LR before replaying (the
            # captured steps bake it in, so they are captured anew)
            opt = self.model.optimizer
            cur = getattr(opt, "lr", None)
            if cur is None:
                cur = getattr(opt, "alpha", 0.0)
            new_lr = float(cur) * self.rollback_lr_factor
            opt.set_learning_rate(new_lr)
            self.model.executor.invalidate_jit_cache()
        if self.guard is not None:
            self.guard.reset()
        self.recovery_events += 1
        self.last_resume_step = step
        self.tracer.complete(
            "recovery", time.perf_counter() - t0, kind="rollback",
            step=step, path=path, rollbacks=self.rollbacks,
            **({"reduced_lr": new_lr} if new_lr is not None else {}))
        return step, int(ts.get("epoch", 0)), int(ts.get("batch_in_epoch", 0))

    # --------------------------------------------------------------- close --
    def merge_telemetry(self, telemetry) -> None:
        """Add this run's counters to ``telemetry``'s resilience block
        (flexflow_tpu/resilience/session.py:244-253); None is a no-op."""
        if telemetry is None:
            return
        telemetry.fault_events += self.fault_events
        telemetry.recovery_events += self.recovery_events
        telemetry.skipped_steps += self.skipped_steps
        if self.manager is not None:
            telemetry.checkpoints_saved += self.manager.saved
        if self.last_resume_step is not None:
            telemetry.last_resume_step = self.last_resume_step

    def close(self, telemetry=None) -> None:
        try:
            if self.manager is not None:
                self.manager.close()
        finally:
            self.restore_signal_handlers()
            self.merge_telemetry(telemetry)
