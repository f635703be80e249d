"""Activation rematerialization: the ``--remat`` levels of the train step
(port of ``flexflow_tpu.execution.remat``).

* ``none``       — autograd keeps every tensor an op saves for backward.
* ``selective``  — the outputs of the contraction ops
  (``REMAT_SAVEABLE_OPS``: dense, conv, batched matmul, attention, the MoE
  dispatch) are kept; the runs of other ops between them (elementwise,
  norms, softmax, reshapes) are recomputed in the backward.
* ``full``       — only the segment boundaries are kept; each segment's
  forward runs again in the backward.

The JAX package picks what to save with a ``jax.checkpoint`` policy over
XLA's dot products. Here the flash kernels are ctypes launches inside a
``torch.autograd.Function``, which ``torch.utils.checkpoint``'s selective
policy (an aten-op dispatch mode) cannot see, so the policy acts on whole
nodes: the executor wraps each run of nodes to recompute in
``torch.utils.checkpoint.checkpoint(use_reentrant=False,
preserve_rng_state=False)`` and runs the nodes to keep outside it
(``Executor._remat_blocks``). ``remat_segments`` is the JAX package's
segmentation, cut at graph bottlenecks, so both packages recompute the same
blocks under ``full``.

A pipeline stage (``parallel/pipeline.PipelineTrainer``) is one segment at
its own level (:func:`resolve_stage_remat`, default ``full``): ``full``
recomputes the stage's whole forward in its backward, the JAX stage's
``jax.checkpoint`` with ``nothing_saveable``; ``selective`` splits the stage
at the ``REMAT_SAVEABLE_OPS`` nodes (``dots_saveable``); ``none`` keeps
every tensor. :func:`level_pieces` is the one rule both consumers cut by.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..ffconst import OperatorType

REMAT_LEVELS = ("none", "selective", "full")

# ops whose outputs ``selective`` keeps (flexflow_tpu/execution/remat.py:
# 43-48): the contractions, whose recompute would repeat the expensive
# work; the elementwise / norm / softmax / gather runs between them are
# the cheap recompute
REMAT_SAVEABLE_OPS = {
    OperatorType.OP_LINEAR, OperatorType.OP_CONV2D,
    OperatorType.OP_BATCHMATMUL, OperatorType.OP_MULTIHEAD_ATTENTION,
    OperatorType.OP_GROUP_BY, OperatorType.OP_AGGREGATE,
    OperatorType.OP_AGG_SPEC, OperatorType.OP_EXPERTS,
}


@dataclasses.dataclass(frozen=True)
class RematPlan:
    """A rematerialization plan for one training step: ``level`` is one of
    ``REMAT_LEVELS``; ``segment_size`` is the target number of compute
    nodes a block (blocks cut at graph bottlenecks)."""

    level: str = "none"
    segment_size: int = 8

    def __post_init__(self):
        if self.level not in REMAT_LEVELS:
            raise ValueError(
                f"remat level {self.level!r} not in {REMAT_LEVELS}")


def remat_segments(pcg, segment_size: int = 8) -> List[List[int]]:
    """Contiguous remat blocks over the PCG's compute nodes, cut at graph
    bottlenecks once a block holds ``segment_size`` nodes (a bottleneck's
    output is the only live tensor at the cut), or forced at 4x
    ``segment_size`` where a graph has none: the JAX package's
    segmentation (flexflow_tpu/execution/remat.py:95-120)."""
    nodes = pcg.compute_nodes()
    if not nodes:
        return []
    bns = set(pcg.bottlenecks())
    size = max(segment_size, 1)
    segs: List[List[int]] = [[]]
    count = 0
    for n in nodes:
        segs[-1].append(n.guid)
        count += 1
        if count >= size and n.guid in bns or count >= 4 * size:
            segs.append([])
            count = 0
    if not segs[-1]:
        segs.pop()
    return segs


def resolve_remat_plan(config, strategy=None) -> RematPlan:
    """The train step's plan: the ``--remat`` flag, then a strategy's
    searched level (``search.unity`` sets ``Strategy.remat``), then none;
    ``--remat-segment-size`` sizes the blocks."""
    level = (getattr(config, "remat", "") or "").strip() \
        or getattr(strategy, "remat", "") or "none"
    return RematPlan(level=level,
                     segment_size=int(getattr(config, "remat_segment_size",
                                              8) or 8))


def level_pieces(pcg, guids: List[int], level: str
                 ) -> List[Tuple[List[int], bool]]:
    """One segment's nodes ``guids`` cut for ``level``: ``[(guids,
    recompute)]`` in order. ``full`` recomputes the whole segment;
    ``selective`` runs each ``REMAT_SAVEABLE_OPS`` node alone, kept, and
    recomputes the runs between them; ``none`` keeps the whole segment."""
    if level in ("full", "none"):
        return [(list(guids), level == "full")]
    pieces: List[Tuple[List[int], bool]] = []
    run: List[int] = []
    for g in guids:
        if pcg.nodes[g].op.op_type in REMAT_SAVEABLE_OPS:
            if run:
                pieces.append((run, True))
                run = []
            pieces.append(([g], False))
        else:
            run.append(g)
    if run:
        pieces.append((run, True))
    return pieces


def resolve_stage_remat(config, strategy) -> str:
    """The pipeline trainer's stage-level remat: the ``--remat`` flag, then
    the strategy's level, then ``full`` (an unsearched pipeline strategy,
    ``remat == ""``, keeps the classic GPipe recompute; only an explicit
    ``none`` turns stage remat off; flexflow_tpu/execution/remat.py:
    135-145)."""
    level = (getattr(config, "remat", "") or "").strip() \
        or getattr(strategy, "remat", "") or "full"
    if level not in REMAT_LEVELS:
        raise ValueError(f"remat level {level!r} not in {REMAT_LEVELS}")
    return level
