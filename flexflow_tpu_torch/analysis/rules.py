"""ShardLint rule registry and the non-lattice rule checkers.

Stable, documented rule IDs (``docs/static_analysis.md`` holds the full
table — ID, what it proves, example diagnostic, fix hint; the
``scripts/check_docs_rules.py`` housekeeping gate keeps the two in sync):

* **FF001** — partial-sum placement: an unreduced ``partial_sum`` reaching
  a consumer that requires a complete value, or a Reduction applied to a
  value that is not partial (a doubled allreduce). Emitted by the
  abstract interpreter (``interp.py``).
* **FF002** — donation-aliasing safety: a buffer the jitted step donates
  (``donate_argnums``) that something still references after the step
  without a device-side copy — the async-checkpoint bug class.
* **FF003** — rng-stream collision: two stochastic op executions that
  statically fold the same (key, counter) stream.
* **FF004** — remat segmentation: remat blocks that fail to partition the
  compute graph, or cut an edge backwards against the topological order.
* **FF005** — serving-state reachability: stateful/position ops folded
  inside a FusedOp, where the serving engine cannot thread decode state —
  the ``serving/engine.py`` runtime refusal, promoted to a pre-serve
  diagnostic.
* **FF006** — shape/divisibility dataflow: every declared PartitionSpec
  axis exists in the mesh and every sharded dim divides its axis size —
  the per-node half of ``resilience.preflight.preflight_strategy``, which
  now routes through this checker (single source of truth).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..ffconst import OperatorType
from .lattice import entry_axes
from .report import Diagnostic


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    title: str
    proves: str       # the property a clean pass establishes
    fix_hint: str     # default remediation shown with each diagnostic


RULES: Dict[str, Rule] = {r.rule_id: r for r in (
    Rule("FF001", "partial-sum placement",
         "every partial_sum produced by a sharded contraction is reduced "
         "exactly once before any consumer needs the complete value",
         "add the missing Reduction parallel op (or output_spec) after "
         "the sharded contraction, or remove the duplicated one"),
    Rule("FF002", "donation-aliasing safety",
         "no buffer donated to the jitted step (donate_argnums) is "
         "referenced after the step without a device-side copy",
         "snapshot the buffer with jnp.copy / checkpoint._device_snapshot "
         "before the step donates it"),
    Rule("FF003", "rng-stream collision",
         "no two stochastic op executions fold the same (key, counter) "
         "prng stream",
         "give every stochastic node a unique guid in the execution "
         "order (a node scheduled twice replays the same dropout mask)"),
    Rule("FF004", "remat segmentation",
         "remat blocks partition the compute graph and respect the "
         "topological order (no edge flows backwards across a cut)",
         "use execution.remat.remat_segments for the segmentation, or "
         "repair the graph order with PCG.retopo()"),
    Rule("FF005", "serving-state reachability",
         "no stateful (attention/LSTM) or position op is folded inside a "
         "FusedOp region, where the serving engine cannot thread decode "
         "state",
         "recompile without --fusion to serve this model"),
    Rule("FF006", "shape/divisibility dataflow",
         "every declared PartitionSpec axis exists in the mesh and every "
         "sharded tensor dim divides its mesh-axis size",
         "use a mesh whose axis sizes divide the sharded dims, or drop "
         "the offending spec entry"),
)}


# ------------------------------------------------------------------- FF002
@dataclasses.dataclass(frozen=True)
class BufferRef:
    """A reference held across the step boundary."""

    holder: str            # who retains it ("CheckpointManager", ...)
    buffer: str            # which step argument ("params", "opt_state", ..)
    device_copy: bool = False  # True when snapshotted (jnp.copy) pre-step


@dataclasses.dataclass(frozen=True)
class DonationSpec:
    """The aliasing contract of one jitted step: which arguments the jit
    donates, and every reference something retains past the dispatch."""

    step: str
    donated: Tuple[str, ...]
    post_step_refs: Tuple[BufferRef, ...] = ()


def check_donation(spec: DonationSpec) -> List[Diagnostic]:
    """FF002: donated buffers are INVALIDATED by the step; any retained
    reference must be a device-side copy or it reads freed memory (the
    async-checkpoint bug class fixed with ``_device_snapshot``)."""
    out: List[Diagnostic] = []
    donated = set(spec.donated)
    for ref in spec.post_step_refs:
        if ref.buffer in donated and not ref.device_copy:
            out.append(Diagnostic(
                rule_id="FF002", node=spec.step,
                message=(f"'{ref.holder}' keeps a reference to donated "
                         f"buffer '{ref.buffer}' past the step dispatch "
                         "without a device-side copy; donate_argnums "
                         "invalidates the buffer the moment the step "
                         "runs"),
                fix_hint=RULES["FF002"].fix_hint))
    return out


def donation_spec_for_training(ffmodel) -> DonationSpec:
    """The live training step's aliasing contract: the jit donates params
    and opt_state (execution/executor.py make_train_step); the known
    retainer (CheckpointManager) DECLARES whether it snapshots
    device-side via ``checkpoint.SNAPSHOT_DEVICE_COPY``, co-located with
    the ``_device_snapshot`` copy code — the analyzer checks the declared
    contract, it does not re-derive it from the implementation."""
    from ..execution.checkpoint import SNAPSHOT_DEVICE_COPY

    refs = []
    cfg = ffmodel.config
    if getattr(cfg, "checkpoint_dir", "") and \
            int(getattr(cfg, "checkpoint_every", 0) or 0) > 0:
        refs.append(BufferRef("CheckpointManager", "params",
                              device_copy=SNAPSHOT_DEVICE_COPY))
        refs.append(BufferRef("CheckpointManager", "opt_state",
                              device_copy=SNAPSHOT_DEVICE_COPY))
    return DonationSpec(step="train_step", donated=("params", "opt_state"),
                        post_step_refs=tuple(refs))


# ------------------------------------------------------------------- FF003
_STOCHASTIC_OPS = {OperatorType.OP_DROPOUT}


def _is_stochastic(op) -> bool:
    if op.op_type in _STOCHASTIC_OPS:
        return True
    if op.op_type in (OperatorType.OP_MULTIHEAD_ATTENTION,
                      OperatorType.OP_SDPA):
        return float(op.attrs.get("dropout", 0.0) or 0.0) > 0.0
    if op.op_type == OperatorType.OP_FUSED:
        return any(_is_stochastic(s) for s in getattr(op, "sub_ops", ()))
    return False


def check_rng_streams(pcg) -> List[Diagnostic]:
    """FF003: the executor derives every stochastic op's stream as
    ``fold_in(step_rng, guid)`` (and ``fold_in(.., sub_index)`` inside a
    FusedOp). A guid scheduled more than once in the execution order
    therefore replays the SAME stream — two dropout applications with an
    identical mask, statically decidable from the order alone."""
    out: List[Diagnostic] = []
    seen: Dict[int, int] = {}
    for guid in pcg._order:
        seen[guid] = seen.get(guid, 0) + 1
    for guid, count in seen.items():
        if count <= 1:
            continue
        node = pcg.nodes.get(guid)
        if node is None or not _is_stochastic(node.op):
            continue
        out.append(Diagnostic(
            rule_id="FF003", node=node.name,
            message=(f"stochastic op is scheduled {count} times in the "
                     f"execution order with the same guid {guid}: every "
                     "execution folds the identical (key, counter) rng "
                     "stream and replays the same mask"),
            fix_hint=RULES["FF003"].fix_hint))
    return out


# ------------------------------------------------------------------- FF004
def check_remat(pcg, level: str, segment_size: int = 8,
                segments: Optional[Sequence[Sequence[int]]] = None,
                kind: str = "remat") -> List[Diagnostic]:
    """FF004: the remat segmentation must partition the compute nodes
    (every node checkpointed exactly once) and respect the topological
    order — an edge flowing backwards across a cut means a block would
    consume a boundary value produced by a LATER block, which the
    checkpointed forward cannot thread (a stateful CacheOp edge cut this
    way is the decode-state bug class).

    ``kind="stage"`` judges a PIPELINE stage-chunk segmentation by the
    same two laws (partition + topological cuts) with stage-cut wording.
    Note the laws are about CUT ORDER in the graph, not device placement:
    the interleaved schedule's round-robin chunk->device assignment
    (chunk c on device c % pp, pp*v chunks) is a legal segmentation — a
    validator that conflated chunk index with device rank would
    misdiagnose every interleaved plan as a backwards stage cut."""
    if kind == "remat" and (not level or level == "none"):
        return []
    what_seg = "remat" if kind == "remat" else "stage-chunk"
    block = "remat block" if kind == "remat" else "stage chunk"
    if segments is None:
        from ..execution.remat import remat_segments

        segments = remat_segments(pcg, segment_size)
    out: List[Diagnostic] = []
    compute = [n.guid for n in pcg.compute_nodes()]
    seg_of: Dict[int, int] = {}
    dupes = set()
    for si, seg in enumerate(segments):
        for g in seg:
            if g in seg_of:
                dupes.add(g)
            seg_of[g] = si
    missing = [g for g in compute if g not in seg_of]
    for what, guids in (("misses", missing), ("duplicates", sorted(dupes))):
        if not guids:
            continue
        names = [pcg.nodes[g].name for g in guids if g in pcg.nodes]
        out.append(Diagnostic(
            rule_id="FF004", node=names[0] if names else "",
            message=(f"{what_seg} segmentation {what} compute node(s) "
                     f"{names}: the blocks do not partition the graph, so "
                     "the checkpointed forward and the simulator's memory "
                     "accounting diverge"),
            fix_hint=RULES["FF004"].fix_hint))
    for n in pcg.compute_nodes():
        if n.guid not in seg_of:
            continue
        for g, _i in n.inputs:
            if g in seg_of and seg_of[g] > seg_of[n.guid]:
                prod = pcg.nodes[g]
                stateful = (" (stateful edge)"
                            if prod.op.op_type == OperatorType.OP_CACHE
                            else "")
                out.append(Diagnostic(
                    rule_id="FF004", node=n.name,
                    message=(f"consumes '{prod.name}' from {block} "
                             f"{seg_of[g]} while living in earlier "
                             f"{block} {seg_of[n.guid]}{stateful}: the "
                             "cut runs against the topological order"),
                    fix_hint=RULES["FF004"].fix_hint))
    return out


# ------------------------------------------------------------------- FF005
def check_serving_graph(pcg) -> List[Diagnostic]:
    """FF005: the per-node serving machinery (prefill/decode state
    threading, position-constant overrides) cannot see inside a FusedOp —
    a fused stateful op would decode without history and a fused position
    constant escapes the override hook. The serving engine refuses such
    graphs at run time (serving/engine.py); this is the same judgement,
    available before any engine (or device) exists."""
    from ..serving.kvcache import is_position_constant

    out: List[Diagnostic] = []
    for node in pcg.compute_nodes():
        if node.op.op_type != OperatorType.OP_FUSED:
            continue
        for sub in getattr(node.op, "sub_ops", ()):
            stateful = sub.op_type in (OperatorType.OP_MULTIHEAD_ATTENTION,
                                       OperatorType.OP_LSTM)
            positional = (sub.op_type == OperatorType.OP_CONSTANT
                          and is_position_constant(sub.attrs.get("value")))
            if stateful or positional:
                out.append(Diagnostic(
                    rule_id="FF005", node=node.name,
                    message=(f"fusion folded the stateful/position op "
                             f"'{sub.name}' into a fused region; the "
                             "serving engine cannot thread decode state "
                             "through it and would generate history-free "
                             "garbage"),
                    fix_hint=RULES["FF005"].fix_hint))
    return out


# ------------------------------------------------------------------- FF006
def check_shapes(pcg, strategy) -> List[Diagnostic]:
    """FF006: the declared-spec shape/divisibility dataflow. This IS the
    per-node half of ``preflight_strategy`` — the preflight re-routes
    through here (single source of truth), so the diagnostic messages
    keep the exact preflight error texts the tests and users know."""
    axes = tuple(strategy.axis_names)
    axis_size = dict(zip(axes, (int(s) for s in strategy.mesh_shape)))
    out: List[Diagnostic] = []

    def check_spec(node_name: str, where: str, spec, shape) -> None:
        for dim, e in enumerate(spec or ()):
            for a in entry_axes(e):
                if a not in axis_size:
                    out.append(Diagnostic(
                        rule_id="FF006", node=node_name,
                        message=(f"{where}: PartitionSpec names mesh axis "
                                 f"{a!r} (dim {dim}) but the strategy's "
                                 f"mesh axes are {axes}"),
                        fix_hint=RULES["FF006"].fix_hint))
                    continue
                sz = axis_size[a]
                if shape is not None and dim < len(shape) and sz > 1 and \
                        shape[dim] % sz:
                    out.append(Diagnostic(
                        rule_id="FF006", node=node_name,
                        message=(f"{where}: dim {dim} has size "
                                 f"{shape[dim]}, not divisible by mesh "
                                 f"axis {a!r} (size {sz}); the plan "
                                 "cannot shard it evenly"),
                        fix_hint=RULES["FF006"].fix_hint))

    for guid, ns in strategy.node_strategies.items():
        node = pcg.nodes.get(guid) if pcg is not None else None
        name = node.name if node is not None else f"node guid {guid}"
        wshapes: Dict[str, Tuple[int, ...]] = {}
        if node is not None and ns.weight_specs:
            try:
                in_shapes = [pcg.nodes[g].out_shapes[i]
                             for g, i in node.inputs]
                wshapes = {w: tuple(s) for w, (s, _d, _i) in
                           node.op.weight_specs(in_shapes).items()}
            except Exception:
                wshapes = {}
        for wname, spec in (ns.weight_specs or {}).items():
            check_spec(name, f"{name}.{wname}", spec, wshapes.get(wname))
        if ns.output_spec:
            oshape = (tuple(node.out_shapes[0])
                      if node is not None and node.out_shapes else None)
            check_spec(name, f"{name} output", ns.output_spec, oshape)
    return out


def check_paged_kv(pcg, *, block_size: int, pool_blocks: int,
                   max_blocks_per_slot: int, max_context: int,
                   kv_layout: str = "replicated",
                   tp: int = 1,
                   prefill_chunk_tokens: int = 0,
                   seq_shards: int = 1,
                   n_devices: int = 1,
                   context_buckets: Sequence[int] = ()) -> List[Diagnostic]:
    """FF006 extension: static shape
    laws of a paged-KV serving configuration — judged with ZERO compile,
    so a misconfigured layout is rejected at engine construction (or
    plan lint), not by an opaque scatter failure ten decode steps in.

    * ``block_size`` must be positive, and the pool must be whole blocks
      with at least one usable block past the reserved garbage block;
    * the pool must hold at least one max-context request — anything
      smaller deadlocks admission by construction — PLUS one live chunk
      when chunked prefill is on (the chunk's copy-on-write spare and
      co-scheduled neighbors otherwise starve);
    * ``--prefill-chunk-tokens`` must be a whole number of KV blocks:
      a chunk boundary inside a block would split one block's rows
      across two chunk programs, breaking the write-before-read law
      shared blocks rely on;
    * the block TABLE must cover the max supported context
      (``max_blocks_per_slot * block_size >= max_context``): a shorter
      table would silently truncate a legal request's KV extent;
    * under a heads-sharded KV layout every attention node's head count
      must divide ``tp`` — the per-chip pool shard otherwise splits a
      head's rows across chips;
    * sequence-parallel decode: ``seq_shards`` must divide
      the block-table width evenly (each shard chip owns a contiguous
      ``max_blocks_per_slot / seq_shards`` run — a ragged split would
      give shards different compiled extents), every searched context
      bucket must fit the table, and on a real mesh ``seq_shards`` must
      divide the device count — composed with a heads-sharded layout,
      ``tp * seq_shards`` must too (the seq axis multiplies the KV
      grid, it does not replace it).
    """
    out: List[Diagnostic] = []
    hint = ("fix the paged-KV knobs (--kv-block-size / --kv-pool-blocks "
            "/ --max-decode-len) so the block table and pool cover the "
            "supported context")
    if block_size < 1:
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=f"paged KV: block_size must be >= 1 (got "
                    f"{block_size})", fix_hint=hint))
        return out
    if pool_blocks < 2:
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=(f"paged KV: pool has {pool_blocks} block(s); needs "
                     ">= 2 (the reserved garbage block + at least one "
                     "usable block)"), fix_hint=hint))
    chunk_blocks = 0
    if prefill_chunk_tokens:
        if prefill_chunk_tokens % block_size:
            out.append(Diagnostic(
                rule_id="FF006", node="",
                message=(f"chunked prefill: --prefill-chunk-tokens "
                         f"({prefill_chunk_tokens}) must be a multiple "
                         f"of --kv-block-size ({block_size}) — a chunk "
                         "boundary inside a block would split one "
                         "block's rows across two chunk programs"),
                fix_hint="pick a chunk size that is a whole number of "
                         "KV blocks"))
        chunk_blocks = -(-int(prefill_chunk_tokens) // int(block_size))
    need = -(-int(max_context) // int(block_size))
    if pool_blocks - 1 < need + chunk_blocks:
        plus = (f" plus one live {prefill_chunk_tokens}-token chunk"
                if chunk_blocks else "")
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=(f"paged KV: pool's {pool_blocks - 1} usable blocks "
                     f"({(pool_blocks - 1) * block_size} tokens) cannot "
                     f"hold one max-context request ({max_context} "
                     f"tokens){plus} — admission would deadlock"),
            fix_hint=hint))
    if max_blocks_per_slot * block_size < max_context:
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=(f"paged KV: block table covers "
                     f"{max_blocks_per_slot * block_size} tokens "
                     f"({max_blocks_per_slot} blocks x {block_size}) "
                     f"< max supported context {max_context}"),
            fix_hint=hint))
    if kv_layout == "sharded" and tp > 1 and pcg is not None:
        for node in pcg.compute_nodes():
            if node.op.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
                continue
            heads = int(node.op.attrs.get("num_heads", 1))
            if heads % tp:
                out.append(Diagnostic(
                    rule_id="FF006", node=node.name,
                    message=(f"paged KV: heads-sharded layout needs "
                             f"num_heads ({heads}) divisible by tp "
                             f"({tp}); a pool block's head axis cannot "
                             "split a head across chips"),
                    fix_hint="use the replicated KV layout or a tp that "
                             "divides num_heads"))
    shard_hint = ("pick --seq-shards so it divides the block-table "
                  "width (--max-decode-len / --kv-block-size) and the "
                  "mesh; size --context-buckets within the table")
    if seq_shards < 1:
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=(f"sequence-parallel decode: seq_shards must be "
                     f">= 1 (got {seq_shards})"), fix_hint=shard_hint))
        return out
    if max_blocks_per_slot % seq_shards:
        out.append(Diagnostic(
            rule_id="FF006", node="",
            message=(f"sequence-parallel decode: --seq-shards "
                     f"({seq_shards}) must divide the block-table width "
                     f"({max_blocks_per_slot} blocks) — each shard chip "
                     "owns one contiguous equal run of a slot's blocks; "
                     "a ragged split would give shards different "
                     "compiled extents"), fix_hint=shard_hint))
    for bucket in context_buckets:
        if bucket > max_blocks_per_slot * block_size:
            out.append(Diagnostic(
                rule_id="FF006", node="",
                message=(f"sequence-parallel decode: context bucket "
                         f"{bucket} exceeds the block table's "
                         f"{max_blocks_per_slot * block_size}-token "
                         f"extent ({max_blocks_per_slot} blocks x "
                         f"{block_size}) — requests routed to it could "
                         "never hold their KV"), fix_hint=shard_hint))
    if seq_shards > 1 and n_devices > 1:
        if n_devices % seq_shards:
            out.append(Diagnostic(
                rule_id="FF006", node="",
                message=(f"sequence-parallel decode: --seq-shards "
                         f"({seq_shards}) must divide the mesh "
                         f"({n_devices} devices) — the seq axis is a "
                         "mesh axis, not a remainder"),
                fix_hint=shard_hint))
        elif kv_layout == "sharded" and n_devices % (tp * seq_shards):
            out.append(Diagnostic(
                rule_id="FF006", node="",
                message=(f"sequence-parallel decode: composed KV grid "
                         f"tp x seq_shards ({tp} x {seq_shards} = "
                         f"{tp * seq_shards}) must divide the mesh "
                         f"({n_devices} devices) — the seq axis "
                         "multiplies the heads-sharded layout, it does "
                         "not replace it"), fix_hint=shard_hint))
    return out
