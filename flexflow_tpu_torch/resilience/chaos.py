"""Deterministic fault injection for the training and serving resilience
paths (the training and serving parts of ``flexflow_tpu.resilience.chaos``):

* ``ChaosPlan(nan_at_steps={K})`` poisons the batch of step K with NaN, so
  the guarded step sees a genuinely non-finite loss and grads.
* ``ChaosPlan(preempt_at_step=M)`` sends a real ``SIGTERM`` (or
  ``preempt_signal``) to this process right before step M dispatches; the
  handler ``fit`` installs flags it, the step finishes, a final checkpoint
  is flushed and ``fit`` returns.

A plan is per process, so on a mesh each rank passes its own and one rank
alone can be poisoned or preempted: the guarded step's verdict and the
preemption flag are agreed over the ranks (``resilience/session.py``), so
every rank skips, rolls back or stops with it.
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

* Strategy safety (``resilience/fallback.py``, ``audit.py``):
  ``fail_compiles=N`` fails the cascade's compile probe for the first N
  candidates (on every rank alike: each rank's plan consumes its own);
  ``wrong_reshard=True`` is a wrong-reshard defect in one of three modes
  (``wrong_reshard_mode``): ``"duplicate"`` inserts a real
  doubled-reduction node (:func:`inject_wrong_reshard`; ShardLint's FF001
  names it with no step run, and under a mesh of several ranks the node
  scales its value by ``wrong_reshard_factor``, so the audit's probe
  diverges from the one-device reference); ``"drop"`` removes a real
  reduction edge (statically FF001; the port's row-parallel linear sums its
  partials itself, so the dropped node changes no value, as XLA re-derives
  the psum in the JAX package); ``"scale"`` (the default) scales the
  candidate's reported grad norm by the factor, with no graph change.

The JAX plan's device drop (``drop_devices_at``, which drives the elastic
replan of multi-device serving, ROADMAP A.8) comes with the slice that
ports that path; here it raises, naming itself.
"""
from __future__ import annotations

import os
import signal
from typing import Iterable, List, Optional

from ..execution.checkpoint import COMMIT_MARKER, read_meta

# ChaosPlan arguments of the JAX package whose paths are not ported yet,
# with the value that leaves them off
_LATER_ARGS = {"drop_devices_at": None}


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
                 preempt_serving_at: Optional[int] = None,
                 fail_compiles: int = 0,
                 wrong_reshard: bool = False,
                 wrong_reshard_factor: float = 2.0,
                 wrong_reshard_mode: str = "scale", **later):
        for name, value in later.items():
            if name not in _LATER_ARGS:
                raise TypeError(f"ChaosPlan got an unexpected argument "
                                f"{name!r}")
            if value != _LATER_ARGS[name]:
                raise NotImplementedError(
                    f"ChaosPlan({name}=) is ported in a later slice: it "
                    "injects into the multi-device serving path (the "
                    "elastic replan, ROADMAP A.8), which this slice does "
                    "not run")
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
        # strategy-safety injections (resilience/fallback.py, audit.py)
        self.fail_compiles = int(fail_compiles)
        self.compile_failures_injected = 0
        self.wrong_reshard = bool(wrong_reshard)
        self.wrong_reshard_factor = float(wrong_reshard_factor)
        if wrong_reshard_mode not in ("scale", "drop", "duplicate"):
            raise ValueError(
                f"wrong_reshard_mode must be scale|drop|duplicate, got "
                f"{wrong_reshard_mode!r}")
        self.wrong_reshard_mode = wrong_reshard_mode
        self.wrong_reshards_injected = 0
        self.injected_defect = ""  # description of the graph-level defect

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

    def maybe_preempt(self, step: int, session=None) -> None:
        """Deliver the scripted signal before step ``step`` dispatches,
        through ``os.kill``, so the real installed handler runs. With
        ``preempt_signal=None`` the fit's ``session`` is flagged as its
        handler would flag it, with no signal: for ranks that are threads
        of one process, where only the main thread has handlers."""
        if self.preempt_at_step is None or self.preempted_at is not None \
                or step != self.preempt_at_step:
            return
        self.preempted_at = step
        if self.preempt_signal is None:
            session._on_signal(None, None)
            return
        os.kill(os.getpid(), self.preempt_signal)

    # -- hooks called by the strategy-safety cascade and the audit ----------
    def strategy_chaos_pending(self) -> bool:
        """Is a strategy-safety injection still pending? (What arms the
        cascade's verification before ``fit``'s loop.)"""
        return (self.compile_failures_injected < self.fail_compiles
                or (self.wrong_reshard
                    and (not self.once
                         or self.wrong_reshards_injected == 0)))

    def consume_compile_failure(self) -> bool:
        """True while scripted compile failures remain: the cascade's
        compile probe treats it as a failed first step. Each call consumes
        one, so candidate N + ``fail_compiles`` compiles clean."""
        if self.compile_failures_injected < self.fail_compiles:
            self.compile_failures_injected += 1
            return True
        return False

    def consume_wrong_reshard(self) -> float:
        """The factor the audit applies to the CANDIDATE's grad norm: the
        plan's ``wrong_reshard_factor`` while a ``"scale"`` injection is
        pending (once by default, so the next candidate audits clean), else
        1.0 (the graph-level modes' defect is a real node)."""
        if self.wrong_reshard and self.wrong_reshard_mode == "scale" and \
                (not self.once or self.wrong_reshards_injected == 0):
            self.wrong_reshards_injected += 1
            return self.wrong_reshard_factor
        return 1.0

    def graph_defect_pending(self) -> bool:
        """A ``drop`` / ``duplicate`` injection not applied yet: the cascade
        applies it to the model's live PCG first."""
        return (self.wrong_reshard
                and self.wrong_reshard_mode in ("drop", "duplicate")
                and (not self.once or self.wrong_reshards_injected == 0))

    def apply_wrong_reshard(self, ffmodel) -> str:
        """Mutate the model's live PCG with the scripted defect
        (:func:`inject_wrong_reshard`). A graph with no reduction edge to
        break (a data-parallel plan) falls back to the ``"scale"`` mode
        with a warning, so the injection never does nothing. Returns what
        was injected ("" after the fallback)."""
        try:
            desc = inject_wrong_reshard(ffmodel.pcg, ffmodel.strategy,
                                        mode=self.wrong_reshard_mode,
                                        factor=self.wrong_reshard_factor)
        except ValueError as e:
            import warnings

            warnings.warn(
                f"ChaosPlan wrong_reshard_mode="
                f"{self.wrong_reshard_mode!r}: no injection site ({e}); "
                "falling back to the legacy grad-norm scale simulation")
            self.wrong_reshard_mode = "scale"
            return ""
        self.wrong_reshards_injected += 1
        self.injected_defect = desc
        # the executor's SPMD plan and remat blocks were built for the
        # graph before the edit
        ex = ffmodel.executor
        ex._plans.clear()
        ex._shard_infos.clear()
        ex._by_name = None
        ex.invalidate_jit_cache()
        return desc

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


def _injected_reduction_op(*args, **kwargs):
    """A real doubled-reduction node (flexflow_tpu/resilience/chaos.py:
    507-532): a ``ReductionOp`` whose forward scales its value by
    ``chaos_factor`` under a mesh of several ranks, as a double-counted
    all-reduce would, and passes it through on one device. So the audit's
    one-device reference computes the true value, while ShardLint's FF001
    names the node statically (a reduction whose input is no partial
    sum)."""
    from ..parallel.parallel_op import ReductionOp

    class _Injected(ReductionOp):
        def forward(self, params, inputs, ctx):
            x = inputs[0]
            mesh = getattr(ctx, "mesh", None)
            n_dev = mesh.numel if mesh is not None else 1
            factor = float(self.attrs.get("chaos_factor", 2.0))
            if n_dev > 1 and factor != 1.0:
                x = x * factor
            return [x]

    return _Injected(*args, **kwargs)


def inject_wrong_reshard(pcg, strategy, mode: str = "duplicate",
                         factor: float = 2.0) -> str:
    """Mutate ``pcg`` IN PLACE with a graph-level wrong-reshard defect
    (flexflow_tpu/resilience/chaos.py:535-628).

    ``mode="duplicate"``: insert an injected reduction node
    (:func:`_injected_reduction_op`) on the output edge of the first
    reduction site — an explicit ``OP_REDUCTION`` node (a searched plan)
    or a partial-sum producer whose ``output_spec`` performs the reduce
    (a spec-based plan). ``mode="drop"``: remove that reduction — splice
    out the ``OP_REDUCTION`` node, or strip the producer's reducing
    ``output_spec``.

    Raises ``ValueError`` when the graph has no reduction site (a pure
    data-parallel plan). Returns a description naming the defect and the
    node, as the analyzer's diagnostic names it."""
    from ..analysis.interp import _partial_axes_produced
    from ..ffconst import OperatorType

    node_strats = strategy.node_strategies if strategy is not None else {}
    site = None  # (node, kind): kind in ("reduction", "producer")
    for node in pcg.compute_nodes():
        if node.op.op_type == OperatorType.OP_REDUCTION and \
                pcg.consumers(node.guid):
            site = (node, "reduction")
            break
    if site is None:
        for node in pcg.compute_nodes():
            ns = node_strats.get(node.guid)
            if _partial_axes_produced(node, ns) and \
                    ns is not None and ns.output_spec is not None and \
                    pcg.consumers(node.guid):
                site = (node, "producer")
                break
    if site is None:
        raise ValueError(
            "no reduction edge to break: the graph has no OP_REDUCTION "
            "node and no partial-sum producer with consumers")
    node, kind = site

    if mode == "drop":
        if kind == "reduction":
            src = node.inputs[0]
            for c in pcg.consumers(node.guid):
                cn = pcg.nodes[c]
                cn.inputs = [src if g == node.guid else (g, i)
                             for g, i in cn.inputs]
            del pcg.nodes[node.guid]
            pcg._order.remove(node.guid)
            node_strats.pop(node.guid, None)
            return (f"dropped reduction node '{node.name}' (consumers "
                    "splice through to its unreduced input)")
        ns = node_strats[node.guid]
        ns.output_spec = None
        return (f"dropped the reducing output constraint of partial-sum "
                f"producer '{node.name}'")

    if mode != "duplicate":
        raise ValueError(f"unknown graph defect mode {mode!r}")
    if kind == "reduction":
        axes = tuple(node.op.attrs.get("axes") or ())
        degree = int(node.op.attrs.get("degree", 2) or 2)
    else:
        axes = tuple(_partial_axes_produced(node,
                                            node_strats.get(node.guid)))
        axis_size = dict(zip(tuple(strategy.axis_names),
                             (int(s) for s in strategy.mesh_shape)))
        degree = int(axis_size.get(axes[0], 2)) if axes else 2
    op = _injected_reduction_op(
        f"chaos_dup_reduction_{node.guid}",
        {"dim": 0, "degree": degree, "axes": axes,
         "chaos_factor": float(factor)},
        node.op.data_type, num_inputs=1)
    consumers = pcg.consumers(node.guid)
    first = pcg.nodes[consumers[0]]
    slot = [s for s, (g, _i) in enumerate(first.inputs)
            if g == node.guid][0]
    new = pcg.insert_node_on_edge(consumers[0], slot, op)
    # insert_node_on_edge rewires one slot: every other slot and consumer
    # reading the reduction goes through the injected node too
    first.inputs = [(new.guid, 0) if g == node.guid else (g, i)
                    for g, i in first.inputs]
    for c in consumers[1:]:
        cn = pcg.nodes[c]
        cn.inputs = [(new.guid, 0) if g == node.guid else (g, i)
                     for g, i in cn.inputs]
    return (f"duplicated the reduction after '{node.name}' as "
            f"'{new.op.name}' (x{factor:g} under a multi-device mesh)")


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
