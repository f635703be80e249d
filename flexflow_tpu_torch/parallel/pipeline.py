"""Pipeline parallelism over a (pipe, data) grid of ``torch.distributed``
ranks.

Port of ``flexflow_tpu.parallel.pipeline``. The pure half is copied:
``resolve_schedule``, ``describe_schedule``, ``pipeline_schedule`` (the one
source of the (phase, microbatch, chunk) order of a step for ``gpipe``,
``1f1b`` and ``interleaved``), ``pipeline_in_flight``, ``split_stages`` and
``build_stage_specs``.

The JAX ``PipelineTrainer`` is single-controller: each stage chunk lives on
a submesh of a (pipe, data) device array and boundary tensors move with
``jax.device_put``. The port is multi-controller, one process per GPU, so
:class:`PipelineTrainer` runs on a (pp, dp) grid of ranks
(``parallel/mesh.build_pipeline_grid``): rank ``d * dp + j`` is pipe
device ``d``, data index ``j``. Each rank runs its own device's projection
of the global order (which the schedule generator keeps a valid order on
every device) over the chunks ``c`` with ``c % pp == d``:

* a chunk's forward and backward run its sub-PCG through the executor's
  node runner and SPMD plan on the stage's data group (a one-axis
  ``data`` mesh of dp ranks), so ops that mix samples see the whole
  microbatch as they do under XLA; the last chunk's forward is fused with
  its backward and takes the loss on its rows (``Executor._loss_on_rows``);
* boundary tensors travel by point-to-point ``isend`` / ``irecv`` between
  ranks of one data index: activations forward, cotangents backward. NCCL
  matches a pair's messages in issue order on one stream for both
  directions, so each pair's message sequence is derived from the global
  order (by the position of the event that makes each tensor), both sides
  issue exactly that sequence (a receive is posted early when a later
  message must go out first) and assert it as they go (:class:`_Pairs`).
  A feed between two chunks on one rank is handed over in memory; the
  cotangents of an output read by several chunks are summed on the
  producing rank, in descending consumer order (the order every schedule
  runs their backwards in);
* grads accumulate per chunk in ascending microbatch order (asserted), are
  summed over the stage's data group once a step, and the microbatch mean
  updates the params, so every schedule gives bitwise the same update.

Stage remat (``remat=`` none | selective | full, ``execution/remat.py``)
cuts each stage into the executor's remat blocks; ``full`` (the default)
recomputes the stage's forward in its backward. A stage runs in its
params' dtype whatever ``--compute-dtype`` says, as the JAX stages do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ffconst import DataType, LossType, OperatorType, dtype_to_torch
from .pcg import PCG, PCGNode

BoundaryT = Tuple[int, int]  # (guid, out_idx)
# boundary tensors of these types carry a cotangent back
_FLOAT_DTYPES = {DataType.DT_FLOAT, DataType.DT_DOUBLE, DataType.DT_HALF,
                 DataType.DT_BFLOAT16}

# the searched schedule axis; order = the search's sweep order
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "interleaved")


def resolve_schedule(config, strategy) -> Tuple[str, int]:
    """(schedule, virtual_stages) the trainer runs: the ``--schedule`` flag
    wins, then the searched ``strategy.schedule``, then the classic
    ``gpipe``. ``virtual_stages`` (v) is only meaningful for
    ``interleaved`` (``--virtual-stages`` flag > searched value > 2) and is
    pinned to 1 for the single-chunk schedules."""
    sched = (getattr(config, "schedule", "") or "").strip() or \
        (getattr(strategy, "schedule", "") or "") or "gpipe"
    if sched not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"schedule {sched!r} not in {PIPELINE_SCHEDULES}")
    if sched != "interleaved":
        return sched, 1
    v = int(getattr(config, "pipeline_virtual_stages", 0) or 0)
    if v < 2:
        sv = int(getattr(strategy, "virtual_stages", 0) or 0)
        v = sv if sv >= 2 else 2
    return sched, v


def describe_schedule(schedule: str, v: int = 1) -> str:
    """The one display rule for a schedule suffix: '' for gpipe/unset
    (the default needs no annotation), the schedule name otherwise, with
    the interleaved virtual-chunk count appended ('interleaved(v=2)')."""
    if not schedule or schedule == "gpipe":
        return ""
    if schedule == "interleaved" and int(v or 1) > 1:
        return f"{schedule}(v={v})"
    return schedule


def pipeline_schedule(schedule: str, pp: int, n_micro: int, v: int = 1
                      ) -> List[Tuple[str, int, int]]:
    """The (phase, microbatch, chunk) execution order of one training step,
    phase in {"F", "B"}; chunk c executes on pipeline device c % pp.

    The returned sequence is a valid topological order of the microbatch
    dataflow (F(m,c) after F(m,c-1); B(m,c) after F(m,c) and B(m,c+1)),
    and its per-device projection IS the schedule's device-local order.

    ``gpipe`` is the closed-form fill/drain. ``1f1b``/``interleaved`` come
    out of a unit-cost list-scheduling pass with backward-first,
    oldest-microbatch-first device priority (with one chunk per device
    that greedy IS PipeDream-flush 1F1B; with v chunks per device it yields
    the interleaved order). Per chunk, backwards run in ascending
    microbatch order in every schedule — the property that keeps grad
    accumulation bitwise-stable across schedules."""
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"schedule {schedule!r} not in {PIPELINE_SCHEDULES}")
    n_chunks = pp * (v if schedule == "interleaved" else 1)
    if schedule == "gpipe":
        ev = [("F", m, c) for m in range(n_micro) for c in range(n_chunks)]
        ev += [("B", m, c) for m in range(n_micro)
               for c in reversed(range(n_chunks))]
        return ev

    last = n_chunks - 1
    deps: Dict[Tuple[str, int, int], List[Tuple[str, int, int]]] = {}
    for m in range(n_micro):
        for c in range(n_chunks):
            deps[("F", m, c)] = [("F", m, c - 1)] if c else []
            d = [("F", m, c)]
            if c < last:
                d.append(("B", m, c + 1))
            deps[("B", m, c)] = d

    if schedule == "interleaved":
        if n_micro % pp:
            raise ValueError(
                f"interleaved schedule needs n_micro % pp == 0 "
                f"(n_micro={n_micro}, pp={pp}): microbatches advance in "
                "rounds of pp through the virtual chunks — use 1f1b, or "
                "a microbatch count the pipeline depth divides")
        orders = [_interleaved_device_order(pp, d, n_micro, v)
                  for d in range(pp)]
        return _merge_device_orders(orders, deps)

    # 1f1b: unit-cost list scheduling with backward-first priority and the
    # in-flight cap that makes 1F1B 1F1B — device d holds at most pp - d
    # microbatches awaiting backward (the PipeDream-flush warmup depth)
    pending: List[List[Tuple[str, int, int]]] = [[] for _ in range(pp)]
    for t in deps:
        pending[t[2] % pp].append(t)
    done_round: Dict[Tuple[str, int, int], int] = {}
    outstanding = [0] * pp  # forwards issued minus backwards completed
    order: List[Tuple[str, int, int]] = []
    total = len(deps)
    rnd = 0
    while len(order) < total:
        if rnd > 2 * total + n_chunks:  # loop guard, not an assert
            raise RuntimeError(
                f"pipeline schedule generator stalled "
                f"({schedule}, pp={pp}, n_micro={n_micro}, v={v})")
        for dev in range(pp):
            cap = pp - dev
            ready = [t for t in pending[dev]
                     if all(done_round.get(x, rnd) < rnd
                            for x in deps[t])
                     and (t[0] == "B" or outstanding[dev] < cap)]
            if not ready:
                continue
            # backward-first (the 1F1B rule), then oldest microbatch
            t = min(ready, key=lambda tk: (tk[0] != "B", tk[1], tk[2]))
            pending[dev].remove(t)
            done_round[t] = rnd
            outstanding[dev] += 1 if t[0] == "F" else -1
            order.append(t)
        rnd += 1
    return order


def _interleaved_device_order(pp: int, d: int, n_micro: int, v: int
                              ) -> List[Tuple[str, int, int]]:
    """Device d's canonical interleaved-1F1B order (Narayanan et al.,
    SC'21): microbatches advance in rounds of pp through the v virtual
    chunks — forward unit i maps to chunk ((i // pp) % v) of microbatch
    ((i // (pp*v)) * pp + i % pp); backwards mirror with the chunk order
    reversed. Warmup depth (pp - d - 1)*2 + (v - 1)*pp forward units, then
    steady 1F1B alternation, then the cooldown backwards. Chunk c here is
    the GLOBAL chunk id k*pp + d of the device's k-th virtual chunk."""
    N = n_micro * v

    def f_unit(i: int) -> Tuple[str, int, int]:
        k = (i // pp) % v
        m = (i // (pp * v)) * pp + i % pp
        return ("F", m, k * pp + d)

    def b_unit(j: int) -> Tuple[str, int, int]:
        k = v - 1 - (j // pp) % v
        m = (j // (pp * v)) * pp + j % pp
        return ("B", m, k * pp + d)

    warmup = min((pp - d - 1) * 2 + (v - 1) * pp, N)
    seq = [f_unit(i) for i in range(warmup)]
    for j in range(N - warmup):
        seq.append(f_unit(warmup + j))
        seq.append(b_unit(j))
    seq.extend(b_unit(j) for j in range(N - warmup, N))
    return seq


def _merge_device_orders(orders: List[List[Tuple[str, int, int]]],
                         deps: Dict[Tuple[str, int, int],
                                    List[Tuple[str, int, int]]]
                         ) -> List[Tuple[str, int, int]]:
    """Linearize per-device orders into one global sequence that is a
    valid topological order of ``deps`` while preserving every device's
    relative order."""
    order: List[Tuple[str, int, int]] = []
    emitted = set()
    idx = [0] * len(orders)
    total = sum(len(o) for o in orders)
    while len(order) < total:
        progressed = False
        for d, seq in enumerate(orders):
            while idx[d] < len(seq):
                t = seq[idx[d]]
                if any(x not in emitted for x in deps[t]):
                    break
                order.append(t)
                emitted.add(t)
                idx[d] += 1
                progressed = True
        if not progressed:  # loop guard, not an assert
            raise RuntimeError("interleaved device orders deadlocked")
    return order


def pipeline_in_flight(schedule: str, pp: int, n_micro: int, v: int = 1
                       ) -> int:
    """Peak in-flight microbatches per pipeline device under ``schedule``
    (in units of a device's whole share of the model: an interleaved
    device's chunk counts 1/v): ``gpipe`` drains nothing until the flush
    (n_micro); ``1f1b`` caps at the pipeline depth pp; ``interleaved``
    pays an extra ~pp/v of warmup depth for its shorter fill:
    pp*(2v-1)/v, which degenerates to pp at v=1."""
    if schedule == "gpipe":
        return max(n_micro, 1)
    if schedule == "1f1b":
        return max(min(pp, n_micro), 1)
    v = max(v, 1)
    return max(min((pp * (2 * v - 1) + v - 1) // v, n_micro), 1)


def split_stages(pcg: PCG, n_stages: int) -> List[List[int]]:
    """Contiguous flops-balanced partition of compute nodes into stages.

    Cut points snap to graph bottlenecks when one is within a half-stage of
    the balanced position (minimizes cross-stage traffic: a bottleneck's
    output is the only live tensor at that point)."""
    nodes = pcg.compute_nodes()
    assert n_stages >= 1
    if n_stages == 1 or len(nodes) <= n_stages:
        # degenerate: one node per stage (or single stage)
        if n_stages == 1:
            return [[n.guid for n in nodes]]
        return [[n.guid] for n in nodes][:n_stages - 1] + \
            [[n.guid for n in nodes[n_stages - 1:]]]

    from ..ops.base import op_flops

    def node_cost(n: PCGNode) -> float:
        in_shapes = [pcg.nodes[g].out_shapes[i] for g, i in n.inputs]
        return float(max(op_flops(n.op, in_shapes, n.out_shapes), 1))

    costs = [node_cost(n) for n in nodes]
    total = sum(costs)
    bset = set(pcg.bottlenecks())
    pos_of = {n.guid: i for i, n in enumerate(nodes)}
    bot_positions = sorted(pos_of[g] for g in bset if g in pos_of)

    cuts: List[int] = []  # cut AFTER index c
    cum = 0.0
    target = total / n_stages
    half_stage = max(len(nodes) // (2 * n_stages), 1)
    for i, c in enumerate(costs):
        cum += c
        if len(cuts) < n_stages - 1 and cum >= target * (len(cuts) + 1):
            cut = i
            # snap to the nearest bottleneck position within half a stage
            near = [b for b in bot_positions
                    if abs(b - i) <= half_stage and
                    (not cuts or b > cuts[-1]) and b < len(nodes) - 1]
            if near:
                cut = min(near, key=lambda b: abs(b - i))
            if cuts and cut <= cuts[-1]:
                cut = cuts[-1] + 1
            if cut >= len(nodes) - (n_stages - 1 - len(cuts)):
                cut = len(nodes) - (n_stages - 1 - len(cuts)) - 1
            cuts.append(cut)
    while len(cuts) < n_stages - 1:  # pathological cost skew
        nxt = (cuts[-1] + 1) if cuts else 0
        cuts.append(min(nxt, len(nodes) - (n_stages - 1 - len(cuts))))
    out: List[List[int]] = []
    lo = 0
    for c in cuts:
        out.append([n.guid for n in nodes[lo:c + 1]])
        lo = c + 1
    out.append([n.guid for n in nodes[lo:]])
    assert all(out), (cuts, [len(s) for s in out])
    return out


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage: its sub-PCG + boundary wiring."""

    sub_pcg: PCG
    # how to feed the stage, in sub_pcg input-node order:
    #   ("model", input_guid)          — a model input (microbatch slice)
    #   ("stage", src_stage, out_pos)  — output `out_pos` of an earlier stage
    feeds: List[Tuple]
    # which (guid, out_idx) this stage exposes, in order
    outputs: List[BoundaryT]


def build_stage_specs(pcg: PCG, stages: List[List[int]]) -> List[StageSpec]:
    """Each stage's sub-PCG (an ``InputOp`` placeholder for every value it
    reads from outside, in first-use order), its feeds and the boundary
    values it exposes (read by a later stage, or the final output)."""
    from ..ops.noop import InputOp

    stage_of: Dict[int, int] = {}
    for s, guids in enumerate(stages):
        for g in guids:
            stage_of[g] = s
    model_inputs = {n.guid for n in pcg.input_nodes()}
    final = [n for n in pcg.sinks()
             if n.op.op_type != OperatorType.OP_INPUT][-1]

    # boundary tensors: produced in stage s, consumed in stage > s (or final)
    exposed: List[List[BoundaryT]] = [[] for _ in stages]
    exposed_pos: Dict[BoundaryT, Tuple[int, int]] = {}

    def expose(ref: BoundaryT, s: int):
        if ref not in exposed_pos:
            exposed_pos[ref] = (s, len(exposed[s]))
            exposed[s].append(ref)

    for node in pcg.compute_nodes():
        s = stage_of[node.guid]
        for g, i in node.inputs:
            if g in model_inputs:
                continue
            ps = stage_of[g]
            if ps != s:
                expose((g, i), ps)
    expose((final.guid, 0), stage_of[final.guid])

    specs: List[StageSpec] = []
    for s, guids in enumerate(stages):
        sub = PCG()
        feeds: List[Tuple] = []
        gset = set(guids)
        # placeholders for every external reference, in deterministic order
        ext_refs: List[Tuple[int, int]] = []
        seen = set()
        for g in guids:
            for pg, i in pcg.nodes[g].inputs:
                if pg in gset:
                    continue
                if (pg, i) not in seen:
                    seen.add((pg, i))
                    ext_refs.append((pg, i))
        for pg, i in ext_refs:
            src = pcg.nodes[pg]
            op = InputOp(name=f"s{s}_in_{pg}_{i}",
                         attrs={"shape": src.out_shapes[i],
                                "dtype": src.out_dtypes[i]},
                         dtype=src.out_dtypes[i], num_inputs=0)
            node = PCGNode(guid=-(len(sub.nodes) + 1) * 1000 - pg, op=op,
                           inputs=[],
                           out_shapes=[src.out_shapes[i]],
                           out_dtypes=[src.out_dtypes[i]])
            sub.nodes[node.guid] = node
            sub._order.append(node.guid)
            if pg in model_inputs:
                feeds.append(("model", pg))
            else:
                src_stage, out_pos = exposed_pos[(pg, i)]
                feeds.append(("stage", src_stage, out_pos))
        # map (ext pg, i) -> placeholder guid
        ph = {ref: g for ref, g in zip(ext_refs, list(sub._order))}
        for g in guids:
            n = pcg.nodes[g]
            nn = PCGNode(
                guid=g, op=n.op,
                inputs=[(pg, i) if pg in gset else (ph[(pg, i)], 0)
                        for pg, i in n.inputs],
                out_shapes=list(n.out_shapes), out_dtypes=list(n.out_dtypes))
            sub.nodes[g] = nn
            sub._order.append(g)
        specs.append(StageSpec(sub_pcg=sub, feeds=feeds, outputs=exposed[s]))
    return specs


# -------------------------------------------------------------- transport
# a boundary message: ("A", m, src_chunk, out_pos, dst_chunk) carries the
# activation output ``out_pos`` of ``src_chunk`` to ``dst_chunk`` for
# microbatch m; ("C", ...) carries its cotangent back
Msg = Tuple[str, int, int, int, int]


def consumers_of(specs: List[StageSpec]) -> Dict[Tuple[int, int], List[int]]:
    """(chunk, out_pos) -> the chunks that read it, ascending."""
    out: Dict[Tuple[int, int], List[int]] = {}
    for c, spec in enumerate(specs):
        for feed in spec.feeds:
            if feed[0] == "stage":
                out.setdefault((feed[1], feed[2]), []).append(c)
    return out


def pair_messages(order: List[Tuple[str, int, int]],
                  specs: List[StageSpec], chunk_dev: List[int],
                  grad_out: Dict[Tuple[int, int], bool]
                  ) -> Dict[Tuple[int, int], List[Msg]]:
    """Each pair of pipe devices' boundary messages, both directions, in
    the order both of its ranks issue them: by the position in the global
    ``order`` of the event that makes the tensor (an activation at its
    producer's forward, a cotangent at its consumer's backward), then in
    the event's output and consumer order. ``grad_out[(chunk, pos)]``:
    the output carries a cotangent back (it is floating).

    Raises where a message would be read no later than it is made: every
    message is made at an event before the one that reads it, so a rank
    never waits on a tensor whose making waits on it."""
    last = len(specs) - 1
    cons = consumers_of(specs)
    pos_of = {t: i for i, t in enumerate(order)}
    pairs: Dict[Tuple[int, int], List[Msg]] = {}

    def add(msg: Msg, made: int, read: int, a: int, b: int) -> None:
        if read <= made:
            raise RuntimeError(
                f"pipeline message {msg} is read at step position {read}, "
                f"not after it is made ({made})")
        pairs.setdefault((min(a, b), max(a, b)), []).append(msg)

    for phase, m, c in order:
        here = pos_of[(phase, m, c)]
        if phase == "F" and c < last:
            for pos in range(len(specs[c].outputs)):
                for dc in cons.get((c, pos), ()):
                    if chunk_dev[dc] != chunk_dev[c]:
                        add(("A", m, c, pos, dc), here,
                            pos_of[("F", m, dc)], chunk_dev[c],
                            chunk_dev[dc])
        elif phase == "B":
            for feed in specs[c].feeds:
                if feed[0] != "stage":
                    continue
                sc, pos = feed[1], feed[2]
                if chunk_dev[sc] != chunk_dev[c] and grad_out[(sc, pos)]:
                    add(("C", m, sc, pos, c), here, pos_of[("B", m, sc)],
                        chunk_dev[c], chunk_dev[sc])
    return pairs


class _Pairs:
    """This rank's point-to-point traffic of one step: for each peer pipe
    device, the pair's message sequence (:func:`pair_messages`) and a
    cursor. A send or a receive is issued only at its place in the
    sequence: receives that come first are posted early (``irecv`` into a
    buffer of the message's shape, from the stage specs), and a send that
    should have gone out already is a fault, asserted. Sent tensors are
    kept until their send completes."""

    def __init__(self, grid, chunk_dev, seqs, shape_of, device):
        self.grid = grid
        self.chunk_dev = chunk_dev
        self.dev = grid.coord[0]
        self.seqs = seqs          # peer device -> [Msg]
        self.cursor = {p: 0 for p in seqs}
        self.shape_of = shape_of  # (chunk, pos) -> (local shape, dtype)
        self.device = device
        self.posted: Dict[Msg, Tuple[Any, Any]] = {}
        self.sent: Dict[Msg, Tuple[Any, Any]] = {}

    def _ends(self, msg: Msg) -> Tuple[int, int]:
        """(sending, receiving) pipe device of ``msg``."""
        a, b = self.chunk_dev[msg[2]], self.chunk_dev[msg[4]]
        return (a, b) if msg[0] == "A" else (b, a)

    def _issue_upto(self, peer: int, msg: Msg) -> None:
        """Post every receive of the pair's sequence before ``msg``."""
        import torch
        import torch.distributed as dist

        seq = self.seqs[peer]
        k = self.cursor[peer]
        while k < len(seq) and seq[k] != msg:
            early = seq[k]
            src, _dst = self._ends(early)
            if src == self.dev:
                raise AssertionError(
                    f"pipeline pair ({self.dev}, {peer}): message {early} "
                    f"of this rank was not sent before {msg}")
            shape, dtype = self.shape_of[(early[2], early[3])]
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            self.posted[early] = (dist.irecv(
                buf, src=self.grid.peer(peer)), buf)
            k += 1
        if k == len(seq):
            raise AssertionError(
                f"pipeline pair ({self.dev}, {peer}): message {msg} is not "
                "in the pair's sequence")
        self.cursor[peer] = k

    def send(self, msg: Msg, t) -> None:
        import torch.distributed as dist

        src, peer = self._ends(msg)
        assert src == self.dev, msg
        self._issue_upto(peer, msg)
        t = t.detach().contiguous()
        self.sent[msg] = (dist.isend(t, dst=self.grid.peer(peer)), t)
        self.cursor[peer] += 1

    def recv(self, msg: Msg):
        import torch
        import torch.distributed as dist

        peer, dst = self._ends(msg)
        assert dst == self.dev, msg
        if msg not in self.posted:
            self._issue_upto(peer, msg)
            shape, dtype = self.shape_of[(msg[2], msg[3])]
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            self.posted[msg] = (dist.irecv(buf, src=self.grid.peer(peer)),
                                buf)
            self.cursor[peer] += 1
        work, buf = self.posted.pop(msg)
        work.wait()
        return buf

    def release(self, pred) -> None:
        """Wait for the sends ``pred(msg)`` picks and drop their tensors."""
        for msg in [k for k in self.sent if pred(k)]:
            work, _t = self.sent.pop(msg)
            work.wait()

    def finish(self) -> None:
        """End of step: every send completed, every message of every pair
        issued and read."""
        self.release(lambda _msg: True)
        for peer, seq in self.seqs.items():
            if self.cursor[peer] != len(seq) or self.posted:
                raise AssertionError(
                    f"pipeline pair ({self.dev}, {peer}): step ended at "
                    f"message {self.cursor[peer]} of {len(seq)} "
                    f"({len(self.posted)} receives unread)")


# ------------------------------------------------------------------ stages
def _stage_executor_class():
    """The executor of one stage chunk: the sub-PCG's nodes through the
    executor's node runner, with the position-id constants (baked for the
    whole batch, ``serving/kvcache.is_position_constant``) cut to the
    microbatch's rows, as the JAX stages cut them
    (flexflow_tpu/parallel/pipeline.py:538-546)."""
    from ..execution.executor import Executor

    class StageExecutor(Executor):
        mb = None  # the microbatch's rows over the whole data group
        mb_const: frozenset = frozenset()

        def _run_node(self, node, params, inputs, ctx, scoped):
            outs = super()._run_node(node, params, inputs, ctx, scoped)
            if node.guid in self.mb_const and self.mb is not None and \
                    outs[0].shape[0] > self.mb:
                outs = [outs[0][:self.mb]] + list(outs[1:])
            return outs

    return StageExecutor


@dataclasses.dataclass
class _Stage:
    """One chunk this rank runs."""

    chunk: int
    ex: Any                      # its StageExecutor on the data group
    ph_guids: List[int]          # placeholder guids in feed order
    blocks: Any                  # remat blocks of the stage's level
    # (node, weight, shape, torch dtype) of its params
    entries: List[Tuple[str, str, Tuple[int, ...], Any]]


class PipelineTrainer:
    """Pipeline training of an FFModel over a (pipe, data) grid of ranks.

    Usage (every rank of the process group, one process per GPU)::

        ff = FFModel(config); ...build layers...
        trainer = PipelineTrainer(ff, pp=4, dp=2, n_micro=8,
                                  optimizer=AdamOptimizer(ff),
                                  loss_type=LossType...,
                                  schedule="1f1b")
        loss = trainer.train_step(x_batch, y_batch)

    ``devices`` lists the global ranks the grid is laid over (default every
    rank of the default group; the grid takes the first pp*dp); a rank past
    the grid holds no stage and joins each step only to learn its loss.
    The trainer runs on ``ffmodel.device`` (CUDA unless the model was made
    with ``device="cpu"``, the gloo path). ``train_step`` and ``fit`` take
    the whole global batch on every rank; each rank stages its own rows."""

    def __init__(self, ffmodel, pp: int, dp: int = 1,
                 n_micro: Optional[int] = None, optimizer=None,
                 loss_type: LossType =
                 LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                 devices: Optional[Sequence] = None,
                 init_params: bool = True, remat: str = "full",
                 schedule: str = "gpipe", virtual_stages: int = 1):
        from ..execution.optimizers import SGDOptimizer
        from ..execution.remat import REMAT_LEVELS
        from .mesh import build_pipeline_grid

        if remat not in REMAT_LEVELS:
            raise ValueError(f"remat {remat!r} not in {REMAT_LEVELS}")
        if schedule not in PIPELINE_SCHEDULES:
            raise ValueError(
                f"schedule {schedule!r} not in {PIPELINE_SCHEDULES}")
        v = int(virtual_stages or 1)
        if schedule == "interleaved":
            if v < 2:
                raise ValueError(
                    f"interleaved schedule needs virtual_stages >= 2 "
                    f"(got {v}); v=1 IS the 1f1b schedule — use "
                    "schedule='1f1b'")
        elif v != 1:
            raise ValueError(
                f"virtual_stages={v} only applies to the interleaved "
                f"schedule (got schedule={schedule!r})")
        self.remat = remat
        self.schedule = schedule
        self.v = v
        self.loss_type = loss_type
        self.pp, self.dp = pp, dp
        self.n_micro = n_micro or pp
        self.optimizer = optimizer or SGDOptimizer(None)
        self.config = ffmodel.config
        self.device = ffmodel.device

        pcg = ffmodel.pcg if ffmodel.pcg is not None else ffmodel.create_pcg()
        self.pcg = pcg
        self.n_chunks = pp * v
        n_nodes = len(pcg.compute_nodes())
        if self.n_chunks > n_nodes:
            raise ValueError(
                f"schedule {schedule!r} needs pp*v = {pp}*{v} = "
                f"{self.n_chunks} stage chunks but the graph has only "
                f"{n_nodes} compute nodes; lower --virtual-stages (v) "
                "or the pipeline depth")
        self.stages = split_stages(pcg, self.n_chunks)
        self.specs = build_stage_specs(pcg, self.stages)
        self.chunk_dev = [c % pp for c in range(self.n_chunks)]
        self.model_input_order = [n.guid for n in pcg.input_nodes()]
        final = [n for n in pcg.sinks()
                 if n.op.op_type != OperatorType.OP_INPUT][-1]
        self.final_ref = (final.guid, 0)
        self.batch = pcg.input_nodes()[0].out_shapes[0][0]
        for c, spec in enumerate(self.specs):
            for g, i in spec.outputs:
                shape = pcg.nodes[g].out_shapes[i]
                if not shape or shape[0] != self.batch:
                    raise ValueError(
                        f"pipeline stage {c} hands on {pcg.nodes[g].name}"
                        f"[{i}] of shape {shape}, which is not batch-major "
                        f"(batch {self.batch}): a stage cut must pass "
                        "per-sample tensors")
        self._cons = consumers_of(self.specs)
        self._grad_out = {
            (c, pos): pcg.nodes[g].out_dtypes[i] in _FLOAT_DTYPES
            for c, spec in enumerate(self.specs)
            for pos, (g, i) in enumerate(spec.outputs)}

        self.grid = build_pipeline_grid(pp, dp, self.device, devices)
        self._mine = ([c for c in range(self.n_chunks)
                       if self.chunk_dev[c] == self.grid.coord[0]]
                      if self.grid.coord is not None else [])
        # per n_micro (fit re-derives it per batch size): the global order
        # and each pair's message sequence
        self._order_cache: Dict[int, List[Tuple[str, int, int]]] = {}
        self._pair_cache: Dict[int, Dict[Tuple[int, int], List[Msg]]] = {}
        self._build_stages()
        # what the last step did: host-to-device copies, the most (m, chunk)
        # entries this rank held at once awaiting backward
        self.host_copies = 0
        self.peak_live = 0
        if init_params:
            self.params = self._init_params(ffmodel.config.numpy_seed())
            self.opt_states = self._init_states()
        else:  # caller seeds via load_params
            self.params = None
            self.opt_states = None

    # ------------------------------------------------------------- stage fns
    def _build_stages(self) -> None:
        from ..execution.remat import level_pieces
        from ..serving.kvcache import is_position_constant
        from .strategy import Strategy

        StageExecutor = _stage_executor_class()
        strategy = Strategy(mesh_shape=(self.dp,), axis_names=("data",),
                            data_axis="data")
        self._stage: Dict[int, _Stage] = {}
        for c in self._mine:
            spec = self.specs[c]
            sub = spec.sub_pcg
            anchor = self.final_ref if c == self.n_chunks - 1 \
                else spec.outputs[-1]
            ex = StageExecutor(sub, self.config, anchor[0], self.device,
                               final_out_idx=anchor[1],
                               loss_type=self.loss_type,
                               strategy=strategy, mesh=self.grid.data_mesh)
            ex.mb_const = frozenset(
                n.guid for n in sub.compute_nodes()
                if n.op.op_type == OperatorType.OP_CONSTANT
                and is_position_constant(n.op.attrs.get("value")))
            guids = [n.guid for n in sub.compute_nodes()]
            blocks = ex._blocks_of(level_pieces(sub, guids, self.remat),
                                   list(spec.outputs))
            self._stage[c] = _Stage(
                chunk=c, ex=ex,
                ph_guids=[n.guid for n in sub.input_nodes()],
                blocks=blocks, entries=self._chunk_entries(c))

    def _chunk_entries(self, c: int):
        """[(node, weight, shape, torch dtype)] of chunk ``c``'s params,
        known on every rank (the export's buffers)."""
        sub = self.specs[c].sub_pcg
        out = []
        for node in sub.compute_nodes():
            in_shapes = [sub.nodes[g].out_shapes[i] for g, i in node.inputs]
            for w, (shape, dt, _init) in node.op.weight_specs(
                    in_shapes).items():
                out.append((node.name, w, tuple(shape), dtype_to_torch(dt)))
        return out

    # --------------------------------------------------------------- params
    def _init_params(self, seed: int):
        """The one-device weights (``Executor.init_params``' draw: one
        generator seeded with ``seed``, every weight of the model in
        order), each rank keeping its chunks'."""
        import torch

        mine = {self.pcg.nodes[g].name for c in self._mine
                for g in self.stages[c]}
        gen = torch.Generator().manual_seed(int(seed))
        full: Dict[str, Dict[str, Any]] = {}
        for node in self.pcg.compute_nodes():
            in_shapes = [self.pcg.nodes[g].out_shapes[i]
                         for g, i in node.inputs]
            for w, (shape, dt, init) in node.op.weight_specs(
                    in_shapes).items():
                t = init(gen, shape, dtype_to_torch(dt))
                if node.name in mine:
                    full.setdefault(node.name, {})[w] = t
        return self._place(full)

    def _place(self, full) -> List[Optional[Dict[str, Dict[str, Any]]]]:
        """This rank's chunks' params out of a whole pytree, on the
        device (None for another rank's chunk)."""
        import torch

        params: List[Optional[Dict[str, Dict[str, Any]]]] = \
            [None] * self.n_chunks
        for c in self._mine:
            p: Dict[str, Dict[str, Any]] = {}
            for n, w, shape, dt in self._stage[c].entries:
                src = full[n][w]
                t = src.detach() if torch.is_tensor(src) else \
                    torch.from_numpy(np.asarray(src))
                if tuple(t.shape) != shape:
                    raise ValueError(f"{n}.{w}: shape {tuple(t.shape)} != "
                                     f"{shape}")
                p.setdefault(n, {})[w] = t.to(self.device, dt).clone()
            params[c] = p
        return params

    def _init_states(self):
        return [self.optimizer.init_state(p) if p is not None else None
                for p in self.params]

    def load_params(self, full_params: Dict[str, Dict[str, Any]]) -> None:
        """Install a whole ``{layer: {weight: array or tensor}}`` pytree
        (e.g. an ``FFModel``'s params gathered whole): each rank keeps its
        chunks' weights, with fresh optimizer state."""
        self.params = self._place(full_params)
        self.opt_states = self._init_states()

    def export_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Inverse of load_params: the trained params of every chunk as one
        ``{layer: {weight: host array}}`` pytree on every rank. Each chunk
        is broadcast over the default group from its pipe device's first
        data rank, one flat buffer a dtype."""
        import torch
        import torch.distributed as dist

        me = dist.get_rank()
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for c in range(self.n_chunks):
            src = self.grid.rank_of(self.chunk_dev[c], 0)
            entries = self._chunk_entries(c)
            for dt in sorted({e[3] for e in entries}, key=str):
                ents = [e for e in entries if e[3] == dt]
                sizes = [int(np.prod(e[2])) for e in ents]
                if me == src:
                    buf = torch.cat([self.params[c][n][w].reshape(-1)
                                     for n, w, _s, _d in ents])
                else:
                    buf = torch.empty(sum(sizes), dtype=dt,
                                      device=self.device)
                dist.broadcast(buf, src=src)
                host = buf.cpu()
                for (n, w, shape, _d), piece in zip(ents,
                                                    host.split(sizes)):
                    out.setdefault(n, {})[w] = piece.view(shape).numpy()
        return out

    # ---------------------------------------------------------------- train
    def _order(self):
        order = self._order_cache.get(self.n_micro)
        if order is None:
            order = self._order_cache[self.n_micro] = pipeline_schedule(
                self.schedule, self.pp, self.n_micro, self.v)
        return order

    def _pairs(self) -> Dict[Tuple[int, int], List[Msg]]:
        pairs = self._pair_cache.get(self.n_micro)
        if pairs is None:
            pairs = self._pair_cache[self.n_micro] = pair_messages(
                self._order(), self.specs, self.chunk_dev, self._grad_out)
        return pairs

    def _stacked_inputs(self, arrays: List[Any]):
        """One host-to-device copy per (chunk, feed) of this rank, and one
        of the labels on the last chunk's ranks: each array goes up
        microbatch-major ``(n_micro, rows, ...)``, ``rows`` this rank's
        share of a microbatch (its data index's), so a microbatch is an
        index on the device."""
        import torch

        n = int(np.asarray(arrays[0]).shape[0])
        mb = n // self.n_micro
        if mb * self.n_micro != n or mb % self.dp:
            raise ValueError(
                f"pipeline: batch {n} must split into n_micro="
                f"{self.n_micro} microbatches, each divisible by dp="
                f"{self.dp}")
        k, j = mb // self.dp, self.grid.coord[1]
        self._mb = mb

        def up(a):
            a = np.asarray(a)
            a = a.reshape((self.n_micro, mb) + a.shape[1:])[:, j * k:
                                                            (j + 1) * k]
            self.host_copies += 1
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        feed_arrays = dict(zip(self.model_input_order, arrays[:-1]))
        stacked: Dict[Tuple[int, int], Any] = {}
        for c in self._mine:
            for feed in self.specs[c].feeds:
                if feed[0] == "model":
                    stacked[(c, feed[1])] = up(feed_arrays[feed[1]])
        labels = up(arrays[-1]) if self.n_chunks - 1 in self._mine else None
        return stacked, labels

    def _shapes(self):
        """(chunk, out_pos) -> (this rank's local shape, torch dtype) of
        each boundary tensor at the current microbatch."""
        k = self._mb // self.dp
        out = {}
        for c, spec in enumerate(self.specs):
            for pos, (g, i) in enumerate(spec.outputs):
                node = self.pcg.nodes[g]
                out[(c, pos)] = ((k,) + tuple(node.out_shapes[i][1:]),
                                 dtype_to_torch(node.out_dtypes[i]))
        return out

    def _gen(self, rng_seed: int, m: int, c: int):
        """The dropout stream of microbatch m in chunk c: the same whatever
        the schedule (a recompute replays its block's seeds)."""
        import torch

        seed = ((int(rng_seed) * 1000003 + m) * 8191 + c) % (2 ** 63)
        return torch.Generator().manual_seed(seed)

    def _forward(self, st: _Stage, leaves, ins, gen):
        """The stage's outputs and its aux-loss total (or None) at its
        remat level, with autograd recording."""
        import torch

        from ..ops.base import OpContext

        st.ex.mb = self._mb
        ctx = OpContext(training=True, rng=gen, device=self.device,
                        aux_losses=[], mesh=st.ex.mesh)
        with torch.enable_grad():
            outs = st.ex._forward_remat(
                leaves, dict(zip(st.ph_guids, ins)), ctx, st.blocks,
                list(self.specs[st.chunk].outputs))
            aux = None
            for a in ctx.aux_losses:
                aux = a if aux is None else aux + a
        return outs, aux

    def train_step(self, x, y, rng_seed: int = 0) -> float:
        """One pipelined step in ``self.schedule``'s order on this rank's
        chunks: forwards and backwards interleave per
        :func:`pipeline_schedule`, grads accumulate per chunk in ascending
        microbatch order, are summed over the stage's data group, and the
        microbatch-mean update applies. A microbatch's boundary tensors are
        released as its backward completes (:func:`pipeline_in_flight`).
        Returns the step's loss (the microbatch mean), the same on every
        rank."""
        import torch

        from ..obs import get_tracer

        self.host_copies = 0
        self.peak_live = 0
        if self.grid.coord is None:
            return self._step_loss(None)
        xs = x if isinstance(x, (list, tuple)) else [x]
        stacked, labels = self._stacked_inputs(list(xs) + [y])
        S = self.n_chunks
        d = self.grid.coord[0]
        tracer = get_tracer()
        trace = tracer.enabled
        shapes = self._shapes()
        pairs = self._pairs()
        net = _Pairs(self.grid, self.chunk_dev,
                     {(a if b == d else b): seq for (a, b), seq in
                      pairs.items() if d in (a, b)}, shapes, self.device)
        leaves = {c: {n: {w: (t.detach().requires_grad_(True)
                              if t.is_floating_point() else t)
                          for w, t in ws.items()}
                      for n, ws in self.params[c].items()}
                  for c in self._mine}
        saved: Dict[Tuple[int, int], Tuple] = {}  # (m, c) -> ins, outs, aux
        acts: Dict[Msg, Any] = {}   # in-memory activations by message key
        cots: Dict[Msg, Any] = {}   # in-memory cotangents by message key
        grad_acc: Dict[int, List[Any]] = {}
        acc_m = {c: 0 for c in self._mine}
        losses = []

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def gather_ins(m, c):
            ins = []
            for feed in self.specs[c].feeds:
                if feed[0] == "model":
                    ins.append(stacked[(c, feed[1])][m])
                    continue
                msg = ("A", m, feed[1], feed[2], c)
                val = acts.pop(msg) if self.chunk_dev[feed[1]] == d \
                    else net.recv(msg)
                ins.append(val.detach().requires_grad_(
                    self._grad_out[(feed[1], feed[2])]))
            return ins

        for phase, m, c in self._order():
            if self.chunk_dev[c] != d:
                continue
            st = self._stage[c]
            if phase == "F":
                ins = gather_ins(m, c)
                if c == S - 1:  # the last chunk's forward fuses with its
                    saved[(m, c)] = (ins, None, None)  # backward
                else:
                    if trace:
                        with tracer.span("pipeline_fwd", micro=m, stage=c,
                                         device=d, schedule=self.schedule):
                            outs, aux = self._forward(
                                st, leaves[c], ins, self._gen(rng_seed, m, c))
                            sync()
                    else:
                        outs, aux = self._forward(
                            st, leaves[c], ins, self._gen(rng_seed, m, c))
                    saved[(m, c)] = (ins, outs, aux)
                    for pos, out in enumerate(outs):
                        for dc in self._cons.get((c, pos), ()):
                            msg = ("A", m, c, pos, dc)
                            if self.chunk_dev[dc] == d:
                                acts[msg] = out
                            else:
                                net.send(msg, out)
                self.peak_live = max(self.peak_live, len(saved))
                continue

            # ---- backward of (m, c)
            def run_bwd():
                ins, outs, aux = saved.pop((m, c))
                wrt = [t for ws in leaves[c].values() for t in ws.values()
                       if t.requires_grad]
                need = [x for x in ins if x.requires_grad]
                if c == S - 1:
                    outs, aux = self._forward(st, leaves[c], ins,
                                              self._gen(rng_seed, m, c))
                    with torch.enable_grad():
                        raw, split = st.ex._final_rows(outs[0])
                        logits = st.ex._logits_f32(raw)
                        loss, value = st.ex._loss_on_rows(logits, labels[m],
                                                          split)
                        if aux is not None:
                            loss = loss + aux
                            value = value + aux.detach()
                    losses.append(value.detach())
                    roots, grads_out = [loss], [None]
                else:
                    roots, grads_out = [], []
                    for pos, out in enumerate(outs):
                        if not self._grad_out[(c, pos)]:
                            continue
                        total = None
                        # consumers' backwards ran in descending chunk
                        # order in every schedule: sum in that order
                        for dc in reversed(self._cons[(c, pos)]):
                            msg = ("C", m, c, pos, dc)
                            g = cots.pop(msg) if self.chunk_dev[dc] == d \
                                else net.recv(msg)
                            total = g if total is None else total + g
                        if out.requires_grad:
                            roots.append(out)
                            grads_out.append(total)
                    if aux is not None and aux.requires_grad:
                        roots.append(aux)
                        grads_out.append(torch.ones_like(aux))
                roots_ok = [r.requires_grad for r in roots]
                if all(roots_ok) and roots and (wrt or need):
                    got = torch.autograd.grad(roots, wrt + need, grads_out,
                                              allow_unused=True)
                else:
                    got = [None] * (len(wrt) + len(need))
                dparams = [g if g is not None else torch.zeros_like(t)
                           for g, t in zip(got[:len(wrt)], wrt)]
                dins = {id(x): (g if g is not None else torch.zeros_like(x))
                        for x, g in zip(need, got[len(wrt):])}
                return ins, dparams, dins

            if trace:
                with tracer.span("pipeline_bwd", micro=m, stage=c, device=d,
                                 schedule=self.schedule):
                    ins, dparams, dins = run_bwd()
                    sync()
            else:
                ins, dparams, dins = run_bwd()
            # ascending-microbatch accumulation per chunk: the invariant
            # every schedule preserves, keeping the grad sums bitwise-equal
            # across gpipe/1f1b/interleaved
            assert acc_m[c] == m, (self.schedule, c, m, acc_m[c])
            acc_m[c] += 1
            acc = grad_acc.get(c)
            grad_acc[c] = dparams if acc is None else \
                [a + g for a, g in zip(acc, dparams)]
            for x, feed in zip(ins, self.specs[c].feeds):
                if feed[0] != "stage" or \
                        not self._grad_out[(feed[1], feed[2])]:
                    continue
                msg = ("C", m, feed[1], feed[2], c)
                g = dins[id(x)] if id(x) in dins else torch.zeros_like(x)
                if self.chunk_dev[feed[1]] == d:
                    cots[msg] = g
                else:
                    net.send(msg, g)
            # the microbatch's activations this chunk sent are read by now
            net.release(lambda k, m=m, c=c: k[0] == "A" and k[1] == m
                        and k[2] == c)

        net.finish()
        assert not saved and not acts and not cots, \
            (sorted(saved), sorted(acts), sorted(cots))
        # ---- grads summed over the data group; the microbatch-mean update
        inv = 1.0 / self.n_micro
        for c in self._mine:
            st = self._stage[c]
            wrt = [(n, w) for n, ws in leaves[c].items()
                   for w, t in ws.items() if t.requires_grad]
            flat = st.ex._all_reduce_grads(wrt, grad_acc[c])
            grads = {n: {} for n in self.params[c]}
            for (n, w), g in zip(wrt, flat):
                grads[n][w] = g * inv
            self.params[c], self.opt_states[c] = self.optimizer.update(
                self.params[c], grads, self.opt_states[c])
        return self._step_loss(losses)

    def _step_loss(self, losses) -> float:
        """The mean of the microbatch losses, broadcast over the default
        group from the last chunk's first data rank."""
        import torch
        import torch.distributed as dist

        src = self.grid.rank_of(self.chunk_dev[self.n_chunks - 1], 0)
        if losses:
            t = torch.stack(losses).mean().to(torch.float32).reshape(())
        else:
            t = torch.zeros((), dtype=torch.float32, device=self.device)
        dist.broadcast(t, src=src)
        return float(t)

    def fit(self, x, y, epochs: int = 1, batch_size: Optional[int] = None,
            shuffle: bool = False) -> List[float]:
        from ..data.dataloader import batch_iterator

        xs = x if isinstance(x, (list, tuple)) else [x]
        n = xs[0].shape[0]
        bs = batch_size or n
        losses = []
        step = 0
        for ep in range(epochs):
            for arrays in batch_iterator(list(xs) + [y], bs, shuffle=shuffle,
                                         seed=ep):
                losses.append(self.train_step(arrays[:-1], arrays[-1],
                                              rng_seed=step))
                step += 1
        return losses
