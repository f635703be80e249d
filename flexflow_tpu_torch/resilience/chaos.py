"""Deterministic fault injection for the training and serving resilience
paths (the training and serving parts of ``flexflow_tpu.resilience.chaos``):

* ``ChaosPlan(nan_at_steps={K})`` poisons the batch of step K with NaN, so
  the guarded step sees a genuinely non-finite loss and grads.
* ``ChaosPlan(preempt_at_step=M)`` sends a real ``SIGTERM`` (or
  ``preempt_signal``) to this process right before step M dispatches; the
  handler ``fit`` installs flags it, the step finishes, a final checkpoint
  is flushed and ``fit`` returns.
* ``corrupt_checkpoint(path)`` truncates, bit-flips or un-commits a written
  checkpoint.
* Serving, keyed on the serve loop's decode-step count (the dispatch count
  in the async loop): ``poison_decode_at {step: slot}`` NaNs one slot's KV
  rows before that decode step, in place, so the guarded decode program
  sees genuinely non-finite logits; ``storm_queue {step: [prompt, ...]}``
  submits a burst through the engine's admission control;
  ``preempt_serving_at`` sends a real SIGTERM before that decode step (the
  graceful drain).

Injection is once per step by default, so a run that rolls back and
replays step K replays it clean (the transient-fault model under which
recovery must reconverge to the uninterrupted run). Steps are global
0-based indices: the step count as the step is about to dispatch.

The JAX plan's strategy-safety injections and its device drop
(``drop_devices_at``, which drives the elastic replan of multi-device
serving, ROADMAP A.8) come with the slices that port those paths; here
each raises, naming itself.
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
               "drop_devices_at": None}


class ChaosPlan:
    """Scripted fault schedule for one training or serving run (module
    doc). With ``once=True`` (default) each scripted fault fires a single
    time even if its step is re-executed after a rollback."""

    def __init__(self, nan_at_steps: Iterable[int] = (),
                 preempt_at_step: Optional[int] = None,
                 preempt_signal: int = signal.SIGTERM,
                 once: bool = True,
                 poison_decode_at: Optional[dict] = None,
                 storm_queue: Optional[dict] = None,
                 storm_max_new_tokens: int = 4,
                 preempt_serving_at: Optional[int] = None, **later):
        for name, value in later.items():
            if name not in _LATER_ARGS:
                raise TypeError(f"ChaosPlan got an unexpected argument "
                                f"{name!r}")
            if value != _LATER_ARGS[name]:
                raise NotImplementedError(
                    f"ChaosPlan({name}=) is ported in a later slice: it "
                    "injects into the strategy-safety path or the "
                    "multi-device serving path (the elastic replan, "
                    "ROADMAP A.8), which this slice does not run")
        self.nan_at_steps = {int(s) for s in nan_at_steps}
        self.preempt_at_step = (None if preempt_at_step is None
                                else int(preempt_at_step))
        self.preempt_signal = preempt_signal
        self.once = once
        self.injected_nan_steps: List[int] = []
        self.preempted_at: Optional[int] = None
        self._nan_done: set = set()
        self.poison_decode_at = {int(k): int(v) for k, v in
                                 (poison_decode_at or {}).items()}
        self.storm_queue = {int(k): list(v) for k, v in
                            (storm_queue or {}).items()}
        self.storm_max_new_tokens = int(storm_max_new_tokens)
        self.preempt_serving_at = (None if preempt_serving_at is None
                                   else int(preempt_serving_at))
        self.poisoned_decode_steps: List[int] = []
        self.storms_injected = 0
        self.serving_preempted_at: Optional[int] = None
        self._decode_poison_done: set = set()
        self._storm_done: set = set()

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

    # -- hooks called by the serving engine ---------------------------------
    def maybe_poison_decode(self, step: int, state, occupied,
                            to_device) -> Optional[int]:
        """NaN one slot's KV rows before decode step ``step`` dispatches
        (:func:`poison_decode_state`); returns the slot, or None when
        nothing is scripted. ``occupied(slot)`` gives the slot's occupied
        pool block ids from the host's bookkeeping and ``to_device(ints)``
        stages them on the device, so the poison costs no sync."""
        slot = self.poison_decode_at.get(step)
        if slot is None or (self.once and step in self._decode_poison_done):
            return None
        self._decode_poison_done.add(step)
        self.poisoned_decode_steps.append(step)
        poison_decode_state(state, slot, occupied(slot), to_device)
        return slot

    def maybe_storm(self, step: int) -> List:
        """The scripted prompt burst to submit through admission control
        before decode step ``step`` (empty when nothing is scheduled)."""
        if step not in self.storm_queue or \
                (self.once and step in self._storm_done):
            return []
        self._storm_done.add(step)
        self.storms_injected += 1
        return list(self.storm_queue[step])

    def maybe_preempt_serving(self, step: int) -> None:
        """Deliver the scripted signal before decode step ``step``, through
        ``os.kill``, so the serve loop's flag-only handler runs and the
        loop drains."""
        if self.preempt_serving_at is None \
                or self.serving_preempted_at is not None \
                or step != self.preempt_serving_at:
            return
        self.serving_preempted_at = step
        os.kill(os.getpid(), self.preempt_signal)


def poison_decode_state(state, slot: int, blocks, to_device) -> None:
    """NaN one slot's KV rows of a serving ``DecodeState`` in place
    (flexflow_tpu/resilience/chaos.py:280-330): ``index_fill_`` on the pool
    tensors the captured decode program reads, enqueued on the stream
    before its replay, so the next step computes with them and nothing is
    captured anew. Floating leaves only: an int8 pool's float scales carry
    the NaN, the cursors stay intact.

    Paged layout: exactly the ``blocks`` the victim occupies (the engine
    passes ``req.kv_blocks[:ceil(cursor / bs)]``), never the GARBAGE block,
    whose rows every co-batched slot's masked reads touch. A slot with no
    occupied block has no pool row to poison. Ring layout: the slot's whole
    ``max_len`` ring. A slot-major entry (the LSTM carry) takes the ring
    rule on either layout: the slot's row."""
    from ..serving.kvcache import GARBAGE_BLOCK, cache_leaves

    blocks = [int(b) for b in blocks if int(b) != GARBAGE_BLOCK]
    slot_idx = block_idx = to_device([slot]).long()
    if state.block_tables is not None:
        block_idx = to_device(blocks).long() if blocks else None
    for entry in state.caches.values():
        leaves = cache_leaves(entry)
        idx = block_idx if any(leaf.ndim == 4 for leaf in leaves) \
            else slot_idx
        if idx is None:
            continue
        for leaf in leaves:
            if leaf.is_floating_point():
                leaf.index_fill_(0, idx, float("nan"))


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
