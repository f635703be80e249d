"""Deterministic fault injection for the training resilience paths (the
training part of ``flexflow_tpu.resilience.chaos``):

* ``ChaosPlan(nan_at_steps={K})`` poisons the batch of step K with NaN, so
  the guarded step sees a genuinely non-finite loss and grads.
* ``ChaosPlan(preempt_at_step=M)`` sends a real ``SIGTERM`` (or
  ``preempt_signal``) to this process right before step M dispatches; the
  handler ``fit`` installs flags it, the step finishes, a final checkpoint
  is flushed and ``fit`` returns.
* ``corrupt_checkpoint(path)`` truncates, bit-flips or un-commits a written
  checkpoint.

Injection is once per step by default, so a run that rolls back and
replays step K replays it clean (the transient-fault model under which
recovery must reconverge to the uninterrupted run). Steps are global
0-based indices: the step count as the step is about to dispatch.

The JAX plan's strategy-safety, serving and fleet injections come with
the slices that port those paths; here each raises, naming itself.
"""
from __future__ import annotations

import os
import signal
from typing import Iterable, List, Optional

from ..execution.checkpoint import COMMIT_MARKER, read_meta

# ChaosPlan arguments of the JAX package whose paths are not ported yet,
# with the value that leaves them off
_LATER_ARGS = {"fail_compiles": 0, "wrong_reshard": False,
               "wrong_reshard_factor": 2.0, "wrong_reshard_mode": "scale",
               "poison_decode_at": None, "storm_queue": None,
               "storm_max_new_tokens": 4, "preempt_serving_at": None,
               "drop_devices_at": None}


class ChaosPlan:
    """Scripted fault schedule for one training run (module doc). With
    ``once=True`` (default) each scripted fault fires a single time even
    if its step is re-executed after a rollback."""

    def __init__(self, nan_at_steps: Iterable[int] = (),
                 preempt_at_step: Optional[int] = None,
                 preempt_signal: int = signal.SIGTERM,
                 once: bool = True, **later):
        for name, value in later.items():
            if name not in _LATER_ARGS:
                raise TypeError(f"ChaosPlan got an unexpected argument "
                                f"{name!r}")
            if value != _LATER_ARGS[name]:
                raise NotImplementedError(
                    f"ChaosPlan({name}=) is ported in a later slice: it "
                    "injects into the strategy-safety, serving or fleet "
                    "paths, which this slice does not run")
        self.nan_at_steps = {int(s) for s in nan_at_steps}
        self.preempt_at_step = (None if preempt_at_step is None
                                else int(preempt_at_step))
        self.preempt_signal = preempt_signal
        self.once = once
        self.injected_nan_steps: List[int] = []
        self.preempted_at: Optional[int] = None
        self._nan_done: set = set()

    def poison_batch(self, step: int, bx):
        """Replace the first floating-point input of step ``step`` with NaN
        (dtype and shape kept, so the captured step replays)."""
        if step not in self.nan_at_steps or \
                (self.once and step in self._nan_done):
            return bx
        bx = list(bx)
        for i, a in enumerate(bx):
            if a.is_floating_point():
                bx[i] = a * float("nan")
                self._nan_done.add(step)
                self.injected_nan_steps.append(step)
                return bx
        raise ValueError(
            "ChaosPlan.nan_at_steps needs a floating-point model input to "
            f"poison; step {step}'s batch has dtypes "
            f"{[str(a.dtype) for a in bx]}")

    def maybe_preempt(self, step: int) -> None:
        """Deliver the scripted signal before step ``step`` dispatches,
        through ``os.kill``, so the real installed handler runs."""
        if self.preempt_at_step is None or self.preempted_at is not None \
                or step != self.preempt_at_step:
            return
        self.preempted_at = step
        os.kill(os.getpid(), self.preempt_signal)


def corrupt_checkpoint(path: str, mode: str = "truncate") -> str:
    """Damage a committed checkpoint deterministically; returns what was
    done. ``truncate`` cuts the largest checksummed payload in half (a
    torn write), ``flip`` flips one byte in its middle (bit rot),
    ``uncommit`` deletes the commit marker (a writer that died before it
    committed)."""
    path = os.path.abspath(path)
    if mode == "uncommit":
        os.remove(os.path.join(path, COMMIT_MARKER))
        return f"removed {COMMIT_MARKER} from {path}"
    sums = read_meta(path).get("checksums", {})
    if not sums:
        raise ValueError(f"{path}: no checksummed payload files")
    # deterministic victim: the largest file, name as tie-break
    rel = max(sorted(sums), key=lambda r: (sums[r][1], r))
    fp = os.path.join(path, rel)
    size = os.path.getsize(fp)
    if mode == "truncate":
        with open(fp, "r+b") as f:
            f.truncate(max(size // 2, 0))
        return f"truncated {rel} from {size} to {max(size // 2, 0)} bytes"
    if mode == "flip":
        with open(fp, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        return f"flipped byte {size // 2} of {rel}"
    raise ValueError(f"unknown corruption mode {mode!r}")
