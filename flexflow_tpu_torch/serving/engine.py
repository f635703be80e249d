"""ServingEngine: continuous-batching inference over a compiled FFModel.

Port of ``flexflow_tpu.serving.engine`` for the paged KV pool
(``kv_cache="paged"``) in the model dtype or int8 (``--kv-dtype``) and the
ring layout (``kv_cache="ring"``, the bitwise reference), the radix prefix
cache with its chunk-prefill step, optional chunked prefill
(``--prefill-chunk-tokens``), the synchronous and the async serve loop
(``--serve-loop``), one sequence shard, greedy or top-k temperature
sampling, and serving under failure (``serving/resilience.py``). Each tick
performs one scheduler action: a one-shot prefill, one prefill chunk, or
one decode step that advances every live slot by a token.

Every device step of an action is a step program
(``execution/graphs.StepProgram``; on CUDA a CUDA graph per shape,
replayed over static buffers), as the JAX package jits them: the prefill
per bucket and the chunk prefill per chunk shape (``Executor``), the
decode step (one graph per engine, replayed every step over the
persistent token buffer, lengths, block tables and pools, which every
action writes in place; ``decode_compiles`` counts its captures), the
sampler per (temperature, top_k), and the engine's slot writes (insert a
prefilled request, arm a chunk-prefilled slot, clear a freed slot, clone a
block on write). Host values reach them through pinned staging buffers
with ``non_blocking`` copies; the decode step's tokens come back through
one pinned copy and an event, in ``_ServeLoop._fetch``, the one place a
decode step blocks. The decode step's attention read is the flash-decode
kernel (``kernels/flash_decode.py``, its int8 branch for int8 pools); the
sampler's top-k goes through the row top-k kernel (``kernels/topk.py``)
where the JAX sampler takes its Pallas kernel.

Serving under failure (the JAX package's ``serve`` and ``_ServeLoop``):
deadlines (``--request-timeout-ms`` or ``Request.deadline_ms``) are swept
at every iteration and at admission; ``--shed-policy`` sheds at admission;
``serve`` installs the flag-only SIGTERM/SIGINT handler and drains on it
(admission stops, in-flight requests get ``--drain-grace-s``, queued ones
come back in ``drained_requests``); and when any of it is armed (or a
``ChaosPlan`` is given) the decode step is the guarded decode program,
whose per-slot finite verdict rides the tokens' one pinned copy back: a
slot whose logits are not finite is quarantined alone and its request
retried on a fresh slot (``--decode-retry-budget``), or aborted as
``decode_fault``. Nothing armed, the loop runs the unguarded program and
pays no per-iteration cost. The decode dispatch catches no exception: a
device error propagates (device-loss failover needs the multi-device
serving plan, ROADMAP A.8).

A run publishes its counters into a ``StepTelemetry`` (``serving``,
``serving_prefix`` and ``serving_resilience`` blocks; ``--telemetry-file``)
at its end; the process tracer (``--trace-file``) gets a ``prefill``,
``prefill_chunk`` or ``decode_step`` span per action and a
``prefix_cow_clone`` event per clone, with the JAX engine's names and
fields; and request tracing (``obs.enable_reqtrace``) notes each chunk
prefill beside the scheduler's notes. All of it is host-side, written only
when enabled, and leaves the programs as they are.

Options outside this slice raise ``NotImplementedError`` naming the flag;
none falls back quietly.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from ..execution.graphs import HostTransfer
from ..ffconst import DataType, OperatorType
from .kvcache import DecodeState
from .scheduler import (ContinuousBatchScheduler, Request, ServingRejection,
                        bucket_for, default_buckets)


def _later_slice(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is ported in a later slice of flexflow_tpu_torch, with "
        "the multi-device serving path and the serving fleet (ROADMAP "
        "A.8); this slice serves one device")


# the per-token latency window: p50/p99 read the most recent walls, so a
# long serve does not grow the list without bound
TOKEN_WALL_WINDOW = 8192


def position_context_bound(executor, max_len: int) -> int:
    """The max supported context: ``max_len`` bounded by the
    position-embedding table wherever one feeds off the baked position
    ids — a position past the table has no embedding row."""
    bound = int(max_len)
    pos_guids = set(executor._position_const_guids())
    for node in executor.pcg.compute_nodes():
        if node.op.op_type == OperatorType.OP_EMBEDDING and any(
                g in pos_guids for g, _ in node.inputs):
            entries = int(node.op.attrs.get("num_entries", 0))
            if entries:
                bound = min(bound, entries)
    return bound


@dataclasses.dataclass
class ServingStats:
    """Host-side counters of one serve() run."""

    requests_served: int = 0
    tokens_generated: int = 0
    prefills: int = 0
    decode_steps: int = 0
    chunked_prefills: int = 0
    prefix_hits: int = 0
    prefix_tokens_reused: int = 0
    prefill_tokens_computed: int = 0
    cache_evictions: int = 0
    queue_depth_hwm: int = 0
    # speculative decoding (serving/speculative.py): verification rounds,
    # drafter tokens proposed and accepted
    spec_rounds: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # analytic KV bytes the decode steps' attention read (each live slot's
    # occupied blocks, at the pool's layout)
    kv_bytes_read: int = 0
    wall_s: float = 0.0
    # per-token latency: decode tokens carry their step wall, first tokens
    # their prefill wall; a window of the last TOKEN_WALL_WINDOW walls
    token_walls_s: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=TOKEN_WALL_WINDOW))
    # the resilience ledger: every request leaves under exactly one
    # outcome (serving.resilience.OUTCOMES); the counters mirror its
    # events. replans stays 0 until the elastic replan is ported
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)
    sheds: int = 0
    deadline_misses: int = 0
    quarantines: int = 0
    decode_retries: int = 0
    decode_faults: int = 0
    drains: int = 0
    replans: int = 0
    drained_returned: int = 0
    # host-overhead accounting: each tick's wall splits into dispatch (tick
    # start -> device call issued), device (the call and the result fetch)
    # and bookkeeping (commits, stats, trie inserts). The async loop's host
    # work done while a dispatched decode step is in flight is overlap: it
    # joins the denominator of host_overhead_fraction, never the numerator.
    # host_syncs counts blocking token fetches (_ServeLoop._fetch): one a
    # committed decode step
    host_dispatch_s: float = 0.0
    host_device_s: float = 0.0
    host_bookkeep_s: float = 0.0
    host_ticks: int = 0
    host_overlap_s: float = 0.0
    host_syncs: int = 0

    def record_token(self, wall_s: float) -> None:
        self.token_walls_s.append(wall_s)

    def count_outcome(self, outcome: str, n: int = 1) -> None:
        if n:
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + int(n)

    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0

    def p50_token_ms(self) -> Optional[float]:
        if not self.token_walls_s:
            return None
        return float(np.percentile(list(self.token_walls_s), 50) * 1e3)

    def p99_token_ms(self) -> Optional[float]:
        if not self.token_walls_s:
            return None
        return float(np.percentile(list(self.token_walls_s), 99) * 1e3)

    def kv_bytes_per_token(self) -> Optional[float]:
        if not self.tokens_generated or not self.kv_bytes_read:
            return None
        return self.kv_bytes_read / self.tokens_generated

    def acceptance_rate(self) -> Optional[float]:
        """Drafter tokens accepted over proposed; None before a proposal."""
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    def prefix_reuse_rate(self) -> Optional[float]:
        """Share of prefill tokens served from the prefix cache; None before
        any prefill ran."""
        total = self.prefix_tokens_reused + self.prefill_tokens_computed
        if not total:
            return None
        return self.prefix_tokens_reused / total

    def batch_occupancy(self, n_slots: int) -> float:
        """Share of decode slot-steps that produced a kept token (1.0 =
        every slot busy every step). First tokens come from a prefill, not
        a decode slot, so they stay out of the numerator."""
        denom = self.decode_steps * n_slots
        return max(self.tokens_generated - self.prefills, 0) / denom \
            if denom else 0.0

    def host_overhead_fraction(self) -> Optional[float]:
        """Share of the ticks' wall spent on host work (dispatch and
        bookkeeping) rather than on the device call and its fetch; None
        before any tick. Overlapped host work counts in the denominator
        only."""
        total = self.host_dispatch_s + self.host_device_s + \
            self.host_bookkeep_s + self.host_overlap_s
        if total <= 0.0:
            return None
        return (self.host_dispatch_s + self.host_bookkeep_s) / total

    def summary(self) -> Dict[str, Any]:
        """The JAX ``ServingStats.summary()`` keys (flexflow_tpu/serving/
        engine.py:203-247) the port has: counters, rounded rates, the
        outcome ledger and the nonzero resilience and prefix counters."""
        out = {k: getattr(self, k) for k in (
            "requests_served", "tokens_generated", "prefills",
            "decode_steps", "queue_depth_hwm")}
        out["wall_s"] = round(self.wall_s, 4)
        out["tokens_per_s"] = round(self.tokens_per_s(), 2)
        p50, p99 = self.p50_token_ms(), self.p99_token_ms()
        if p50 is not None:
            out["p50_token_ms"] = round(p50, 3)
            out["p99_token_ms"] = round(p99, 3)
        if self.outcomes:
            out["outcomes"] = dict(self.outcomes)
        for k in ("sheds", "deadline_misses", "quarantines",
                  "decode_retries", "drains", "replans",
                  "drained_returned", "spec_rounds"):
            if getattr(self, k):
                out[k] = getattr(self, k)
        kvpt = self.kv_bytes_per_token()
        if kvpt is not None:
            out["kv_bytes_per_token"] = round(kvpt, 1)
        acc = self.acceptance_rate()
        if acc is not None:
            out["spec_acceptance"] = round(acc, 4)
        for k in ("prefix_hits", "prefix_tokens_reused",
                  "prefill_tokens_computed", "cache_evictions",
                  "chunked_prefills"):
            if getattr(self, k):
                out[k] = getattr(self, k)
        reuse = self.prefix_reuse_rate()
        if reuse:
            out["prefix_reuse_rate"] = round(reuse, 4)
        hof = self.host_overhead_fraction()
        if hof is not None:
            out["host_overhead_fraction"] = round(hof, 4)
        if self.host_syncs:
            out["host_syncs"] = self.host_syncs
        return out


class _HostStaging:
    """Pinned host buffers for the serving path's host->device copies. Each
    copy is ``non_blocking`` from a pinned buffer, with an event recorded
    behind it; a buffer is written again only once its event says the copy
    ran (``query``, which never blocks: while every buffer of a shape is
    busy, another is made). On the CPU a copy is a plain tensor."""

    def __init__(self, device):
        self.device = device
        self._bufs: Dict[Any, List] = {}

    def to_device(self, arr):
        import torch

        arr = np.ascontiguousarray(arr)
        if self.device.type != "cuda":
            return torch.tensor(arr, device=self.device)
        ring = self._bufs.setdefault((arr.shape, arr.dtype.str), [])
        for buf, event in ring:
            if event.query():
                break
        else:
            buf = torch.empty(arr.shape, dtype=torch.from_numpy(arr).dtype,
                              pin_memory=True)
            event = torch.cuda.Event()
            ring.append((buf, event))
        buf.numpy()[...] = arr
        out = torch.empty(buf.shape, dtype=buf.dtype, device=self.device)
        out.copy_(buf, non_blocking=True)
        event.record()
        return out


def gumbel_scores(logits, tag_counts, seed, temperature: float,
                  top_k: int):
    """The sampled draw's ``(scores, candidate token ids)``, both ``(S,
    C)``: in the JAX sampler's order, one top-k over all rows of the raw
    logits (``top_k`` > 0; through the row top-k kernel where its shape
    gate takes them, else ``torch.topk``; all ``V`` tokens for 0), then
    ``vals / temperature + g``, where each Gumbel ``g = -log(-log(u))``
    comes from (``seed``, the row's (tag, count) in ``tag_counts (S, 2)``
    int32, the candidate's token id) through the flash kernels' counter
    hash (``kernels/flash_attention.counter_hash_u32``): its top 23 bits
    make the uniform ``u`` in (0, 1)."""
    import torch

    from ..kernels.flash_attention import counter_hash_u32
    from ..kernels.topk import topk, topk_kernel_shape

    rows, vocab = logits.shape
    k = int(top_k)
    if k > 0:
        if topk_kernel_shape(logits, k):
            vals, idx = topk(logits, k)
        else:
            vals, idx = torch.topk(logits, min(k, vocab), dim=-1)
    else:
        vals = logits
        idx = torch.arange(vocab, device=logits.device).expand(rows, vocab)
    bits = counter_hash_u32(seed, tag_counts[:, 0:1], tag_counts[:, 1:2],
                            idx)
    u = ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23  # exact, < 1
    return vals.float() / float(temperature) - torch.log(-torch.log(u)), idx


def draw_tokens(logits, tag_counts, seed, temperature: float, top_k: int):
    """The sampler's body: ``logits (S, V)`` fp32 -> tokens ``(S,)`` int32,
    every row in one pass. Greedy (one argmax) when ``temperature <= 0``;
    otherwise a categorical draw over ``softmax(vals / temperature)`` of
    the top-k by the Gumbel-max rule, the argmax of
    :func:`gumbel_scores`. So the same (seed, tag, count) and the same
    logits row give the same token under any co-scheduling, batch or slot.
    The streams differ from the JAX engine's, whose draws come from
    ``jax.random``."""
    import torch

    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    score, idx = gumbel_scores(logits, tag_counts, seed, temperature, top_k)
    choice = torch.argmax(score, dim=-1, keepdim=True)
    return torch.gather(idx, -1, choice)[:, 0].to(torch.int32)


class ServingEngine:
    """Inference engine over a compiled autoregressive FFModel (causal
    self-attention and the LSTM as its sequence-stateful ops, a per-token
    final output ``(batch, seq, vocab)``, and one integer token input).
    An LSTM's carry is its decode state, one slot-major ``(n_slots, 2h)``
    buffer; such a graph serves without the prefix cache and chunked
    prefill."""

    def __init__(self, model, n_slots: Optional[int] = None,
                 max_decode_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 64,
                 eos_id: Optional[int] = None,
                 exact_decode: bool = False,
                 kv_cache: Optional[str] = None,
                 kv_block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None,
                 prefix_cache: Optional[str] = None,
                 prefill_chunk_tokens: Optional[int] = None,
                 prefix_cache_blocks: Optional[int] = None,
                 serve_loop: Optional[str] = None,
                 seq_shards: Optional[int] = None,
                 context_buckets: Optional[Sequence[int]] = None):
        from .kvcache import (KV_DTYPES, SeqShardsError, blocks_per_slot,
                              parse_context_buckets)
        from .resilience import AdmissionController
        from .scheduler import BlockAllocator

        if model.executor is None:
            raise RuntimeError("call model.compile() first")
        if getattr(model, "mesh", None) is not None:
            raise NotImplementedError(
                "ServingEngine: serving a model compiled under a strategy "
                "(a device mesh) is ported in a later slice (ROADMAP A.8, "
                "multi-device serving); compile it without one to serve")
        self.model = model
        self.executor = model.executor
        self.device = model.device
        cfg = model.config
        self.n_slots = int(n_slots or getattr(cfg, "max_inflight", 8))
        self.max_decode_len = int(max_decode_len or
                                  getattr(cfg, "max_decode_len", 128))
        self.requested_max_decode_len = self.max_decode_len
        self.max_queue = max_queue
        self.eos_id = eos_id
        self.exact_decode = bool(exact_decode)
        self.serve_loop = str(serve_loop or
                              getattr(cfg, "serve_loop", "sync") or "sync")
        self.kv_cache = str(kv_cache or getattr(cfg, "kv_cache", "paged"))
        self.kv_dtype = str(kv_dtype or getattr(cfg, "kv_dtype", "native"))
        self.seq_shards = int(seq_shards if seq_shards is not None
                              else getattr(cfg, "seq_shards", 1) or 1)
        buckets_ctx = parse_context_buckets(
            context_buckets if context_buckets is not None
            else getattr(cfg, "context_buckets", "") or "")
        if self.serve_loop not in ("sync", "async"):
            raise ValueError(f"serve_loop must be 'sync' or 'async', got "
                             f"{self.serve_loop!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{self.kv_dtype!r}")
        if self.kv_cache not in ("paged", "ring"):
            raise ValueError(f"kv_cache must be 'paged' or 'ring', got "
                             f"{self.kv_cache!r}")
        if self.kv_cache == "ring" and self.kv_dtype != "native":
            raise ValueError("kv_dtype='int8' requires the paged KV layout "
                             "(kv_cache='paged')")
        if self.seq_shards < 1:
            raise ValueError(
                f"seq_shards must be >= 1, got {self.seq_shards}")
        # the ring's constraints (flexflow_tpu/serving/engine.py:322-379)
        if self.kv_cache == "ring" and self.seq_shards > 1:
            raise SeqShardsError(
                "--seq-shards > 1 requires the paged KV layout "
                "(kv_cache='paged'): the ring layout has no block tables "
                "to partition into per-shard contiguous runs")
        if self.kv_cache == "ring" and buckets_ctx:
            raise ValueError(
                "--context-buckets requires the paged KV layout "
                "(kv_cache='paged'): buckets route requests to "
                "sequence-sharded block-table partitions")
        self.prefill_chunk_tokens = int(
            prefill_chunk_tokens if prefill_chunk_tokens is not None
            else getattr(cfg, "prefill_chunk_tokens", 0) or 0)
        prefix_mode = str(prefix_cache or
                          getattr(cfg, "prefix_cache", "on") or "on")
        if prefix_mode not in ("on", "off"):
            raise ValueError(
                f"prefix_cache must be 'on' or 'off', got {prefix_mode!r}")
        if self.kv_cache == "ring":
            if prefix_cache == "on":
                raise ValueError(
                    "prefix_cache='on' requires the paged KV layout "
                    "(kv_cache='paged'): the ring layout has no shared "
                    "block pool to map a cached prefix into")
            if self.prefill_chunk_tokens:
                raise ValueError(
                    "prefill_chunk_tokens requires the paged KV layout "
                    "(kv_cache='paged'): chunks write into the block "
                    "pool")
            prefix_mode = "off"
        if self.seq_shards != 1:
            raise _later_slice(f"seq_shards={self.seq_shards} "
                               "(--seq-shards)")
        if buckets_ctx:
            raise _later_slice("context_buckets (--context-buckets)")
        if getattr(cfg, "request_journal", ""):
            raise _later_slice("the request journal (--request-journal)")
        self.kv_block_size = int(kv_block_size or
                                 getattr(cfg, "kv_block_size", 16))
        if self.prefill_chunk_tokens % self.kv_block_size:
            raise ValueError(
                f"prefill_chunk_tokens ({self.prefill_chunk_tokens}) must "
                f"be a multiple of kv_block_size ({self.kv_block_size})")
        self._validate_graph()
        if any(n.op.op_type == OperatorType.OP_LSTM
               for n in self.executor.pcg.compute_nodes()):
            # the LSTM carry is a summary, not per-token pool rows: there
            # is no block to share or chunk (flexflow_tpu/serving/
            # engine.py:385-402)
            if self.prefill_chunk_tokens:
                raise ValueError(
                    "prefill_chunk_tokens: chunked prefill supports "
                    "attention-only stateful graphs; this model has "
                    "LSTM recurrence")
            if prefix_cache == "on":
                raise ValueError(
                    "prefix_cache='on': prefix caching supports "
                    "attention-only stateful graphs; this model has "
                    "LSTM recurrence")
            prefix_mode = "off"
        self.max_context = position_context_bound(self.executor,
                                                  self.max_decode_len)
        self.block_allocator = None
        self.kv_pool_blocks = None
        self._prefix = None
        mb = blocks_per_slot(self.max_decode_len, self.kv_block_size)
        self.max_blocks_per_slot = mb
        if self._paged:
            # full capacity (every slot at max_len) + the garbage block +
            # one live chunk's worth of headroom
            chunk_blocks = -(-self.prefill_chunk_tokens //
                             self.kv_block_size)
            kv_pool_blocks = int(kv_pool_blocks if kv_pool_blocks is not None
                                 else getattr(cfg, "kv_pool_blocks", 0))
            self.kv_pool_blocks = kv_pool_blocks or (
                self.n_slots * mb + 1 + chunk_blocks)
            self.block_allocator = BlockAllocator(self.kv_pool_blocks,
                                                  self.kv_block_size)
        if prefix_mode == "on":
            from .prefix import PrefixCache

            self._prefix = PrefixCache(
                self.block_allocator, self.kv_block_size,
                max_blocks=int(prefix_cache_blocks
                               if prefix_cache_blocks is not None
                               else getattr(cfg, "prefix_cache_blocks", 0)
                               or 0))
        self.buckets = tuple(buckets) if buckets else \
            default_buckets(self.max_decode_len)
        self.state: Optional[DecodeState] = None
        self._last_tokens = None  # (n_slots, 1) int32 on the device
        # per guard mode, (decode program, its capture count) when this
        # engine's pools were made: decode_compiles counts from there
        self._decode_captures0: Dict[bool, Any] = {}
        # the state's attention K/V entries (pooled or ringed; the rest,
        # the LSTM carries, are slot-major)
        self._paged_entry_names: set = set()
        self._staging = _HostStaging(self.device)
        # the slot-write programs, over this engine's pools (_slot_program)
        self._slot_programs: Dict[str, Any] = {}
        self.stats = ServingStats()
        # resilience: the admission controller's EWMA cost model lives on
        # the engine, so it warms across serve runs; resilience_clock (ms)
        # overrides the time base of every deadline and drain decision;
        # drained_requests holds the queued requests a drain handed back;
        # _last_guard is the last serve's guard mode (decode_compiles);
        # _pending_resilience carries what admit() ledgered before a serve
        self.admission = AdmissionController()
        self.resilience_clock = None
        self.drained_requests: List[Request] = []
        self._last_guard = False
        self._pending_resilience = None

    # ------------------------------------------------------------ validation
    def _validate_graph(self) -> None:
        pcg = self.executor.pcg
        # FF005 (flexflow_tpu/analysis/rules.py:248-275): the per-node
        # serving machinery (decode state, the position-constant override)
        # cannot see inside a FusedOp; such a graph would decode without
        # history, so it is refused before anything is served
        from .kvcache import is_position_constant

        folded = []
        for node in pcg.compute_nodes():
            if node.op.op_type != OperatorType.OP_FUSED:
                continue
            for sub in node.op.sub_ops:
                if sub.op_type in (OperatorType.OP_MULTIHEAD_ATTENTION,
                                   OperatorType.OP_LSTM) or (
                        sub.op_type == OperatorType.OP_CONSTANT
                        and is_position_constant(sub.attrs.get("value"))):
                    folded.append(f"{node.name} holds '{sub.name}'")
        if folded:
            raise NotImplementedError(
                "FF005 serving-state reachability: fusion folded a "
                "stateful or position op into a fused region ("
                + "; ".join(folded) + "); the serving engine cannot thread "
                "decode state through it. Recompile without --fusion to "
                "serve")
        final = pcg.nodes[self.executor.final_guid]
        out = final.out_shapes[self.executor.final_out_idx]
        if len(out) != 3:
            raise ValueError(
                f"serving needs a per-token final output (batch, seq, "
                f"vocab); {final.name} produces {out}")
        for node in pcg.compute_nodes():
            if node.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
                if not node.op.attrs.get("causal", False):
                    raise ValueError(
                        f"{node.name}: serving requires causal=True "
                        "attention (bidirectional attention cannot be "
                        "decoded incrementally)")
                if len({g for g, _ in node.inputs}) != 1:
                    raise ValueError(
                        f"{node.name}: serving decode supports "
                        "self-attention only (q, k, v from one producer)")

    def _token_input_check(self) -> None:
        ins = self.executor.pcg.input_nodes()
        if len(ins) != 1 or ins[0].op.attrs.get("dtype") not in (
                DataType.DT_INT32, DataType.DT_INT64):
            raise ValueError(
                "generate() needs a single integer token input; this graph "
                f"has {len(ins)} input(s)")

    @property
    def _paged(self) -> bool:
        return self.kv_cache == "paged"

    @property
    def decode_compiles(self) -> Optional[int]:
        """CUDA graphs the decode program of the last serve's guard mode
        captured for this engine's pools (flexflow_tpu/serving/
        engine.py:559-575; guarded and unguarded decode are two programs,
        each with its own count): exactly 1 after warm-up for the whole of
        a generate — prefix hits, chunk prefill, slot reuse, copy-on-write
        and the chaos poison write the captured buffers in place. None on
        the CPU, where nothing is captured, and before the first
        decode."""
        if self.device.type != "cuda" or self.state is None:
            return None
        program = getattr(self._decode_fn(self._last_guard), "program",
                          None)
        if program is None:
            return None
        base_program, base = self._decode_captures0.get(self._last_guard,
                                                        (None, 0))
        return program.captures - (base if program is base_program else 0)

    # ------------------------------------------------------------ device fns
    def _decode_fn(self, guard: bool = False):
        return self.executor.make_decode_step(
            self.max_decode_len, exact=self.exact_decode, guard=guard,
            block_size=self.kv_block_size if self._paged else 0,
            kv_dtype=self.kv_dtype, capture=self.model._capture_steps)

    def _prefill_fn(self, bucket: int):
        return self.executor.make_prefill_step(
            bucket, self.max_decode_len, capture=self.model._capture_steps)

    def _chunk_fn(self, chunk_shape: int):
        return self.executor.make_chunk_prefill_step(
            int(chunk_shape), self.max_decode_len, self.kv_block_size,
            self.kv_dtype, capture=self.model._capture_steps)

    def _ids(self, rows) -> Any:
        """Host ints as an int32 tensor on the device, through pinned
        staging (``non_blocking``)."""
        return self._staging.to_device(np.asarray(rows, np.int32))

    def programs(self) -> List[Any]:
        """Every step program this engine's serving path runs: the
        executor's prefill, chunk, decode and sampler programs and this
        engine's slot writes (``captures`` on each; ``chip_smoke.py``
        checks that a warmed-up generate captures nothing)."""
        progs = [getattr(fn, "program", None)
                 for fn in self.executor._serving_fns.values()]
        return [p for p in progs + list(self._slot_programs.values())
                if p is not None]

    def _ensure_state(self, prefill_cache) -> None:
        """Allocate the KV state lazily from the first prefill's cache
        structure. Paged: one zero ``(kv_pool_blocks, h, block_size, hd)``
        pool per K and V of every attention node (int8: each with its zero
        ``(kv_pool_blocks, h, block_size)`` f32 scale array, the entry
        ``(kq, kscale, vq, vscale)``) and all-garbage block tables. Ring:
        one zero ``(n_slots, h, max_len, hd)`` ring per K and V and no
        tables. Any other entry (the LSTM carry ``(1, 2h)``) gets a zero
        slot-major buffer ``(n_slots, 2h)`` in its own dtype on either
        layout; an int8 pool never quantizes it
        (flexflow_tpu/serving/engine.py:802-850). Zero cursors either
        way."""
        import torch

        from .kvcache import is_kv_entry, paged_pool_entry, ring_entry

        if self.state is not None:
            return
        n = self.n_slots
        with torch.inference_mode():
            caches = {}
            self._paged_entry_names = {name for name, e in
                                       prefill_cache.items()
                                       if is_kv_entry(e)}
            for name, entry in prefill_cache.items():
                if name not in self._paged_entry_names:
                    caches[name] = entry.new_zeros((n,) + entry.shape[1:])
                    continue
                kc, vc = entry
                if not self._paged:
                    caches[name] = tuple(ring_entry(c, n,
                                                    self.max_decode_len)
                                         for c in (kc, vc))
                    continue
                kp, vp = (paged_pool_entry(c, self.kv_pool_blocks,
                                           self.kv_block_size, self.kv_dtype)
                          for c in (kc, vc))
                caches[name] = (*kp, *vp) if self.kv_dtype == "int8" \
                    else (kp, vp)
            self.state = DecodeState(
                caches=caches,
                lengths=torch.zeros((n,), dtype=torch.int32,
                                    device=self.device),
                block_tables=torch.zeros(
                    (n, self.max_blocks_per_slot), dtype=torch.int32,
                    device=self.device) if self._paged else None)
            self._last_tokens = torch.zeros((n, 1), dtype=torch.int32,
                                            device=self.device)
            for guard in (False, True):
                program = getattr(self._decode_fn(guard), "program", None)
                self._decode_captures0[guard] = (
                    program, program.captures if program is not None else 0)

    def _ensure_state_bootstrap(self) -> None:
        """A chunk action needs the pool before any prefill has run: take
        its structure from one smallest-bucket prefill on a dummy token."""
        if self.state is not None:
            return
        b0 = self.buckets[0]
        _lg, _last, cache = self._prefill_fn(b0)(
            self.model.params, [self._ids(np.zeros((1, b0)))],
            self._ids([1]))
        self._ensure_state(cache)

    # ----------------------------------------------------------- slot writes
    # The JAX package jits each of these with the state donated; here each
    # is a small step program over this engine's pools, cursors, tables and
    # token buffer (its arguments, written in place), whose static inputs
    # carry the slot, length, token, table row and block ids
    def _slot_program(self, name: str, body):
        prog = self._slot_programs.get(name)
        if prog is None:
            from ..execution.graphs import step_program

            prog = self._slot_programs[name] = step_program(
                body, self.device, f"slot_{name}",
                self.model._capture_steps)
        return prog

    def _slot_write_body(self, inputs, _seeds, state, last_tokens):
        """``meta`` = [slot, length, table row...] (paged) or [slot,
        length] (ring), ``token (1,)`` and, for an inserted prefill, its
        state leaves per entry: scatter the k/v rows into the row's blocks
        (quantized with their scales into an int8 pool) or insert them
        into the slot's ring with the rest zeroed, copy a carry into the
        slot's row, then set the slot's table row, length cursor and
        pending token."""
        from .kvcache import scatter_prefill_paged, update_slot_entry

        meta, token, *leaves = inputs
        slot, row = meta[0:1].long(), meta[2:]
        bs = self.kv_block_size
        i = 0
        for name, entry in state.caches.items() if leaves else ():
            if name not in self._paged_entry_names:
                entry.index_copy_(0, slot, leaves[i].to(entry.dtype))
                i += 1
                continue
            kc, vc = leaves[i], leaves[i + 1]
            i += 2
            if state.block_tables is None:
                update_slot_entry(entry[0], kc, slot)
                update_slot_entry(entry[1], vc, slot)
            elif self.kv_dtype == "int8":
                kq, ks, vq, vs = entry
                scatter_prefill_paged(kq, kc, row, bs, scales=ks)
                scatter_prefill_paged(vq, vc, row, bs, scales=vs)
            else:
                scatter_prefill_paged(entry[0], kc, row, bs)
                scatter_prefill_paged(entry[1], vc, row, bs)
        if state.block_tables is not None:
            state.block_tables.index_copy_(0, slot, row[None, :])
        state.lengths.index_copy_(0, slot, meta[1:2])
        last_tokens.index_copy_(0, slot, token[:, None])
        return []

    def _write_slot(self, cache, slot: int, length: int, token,
                    table_row: Optional[np.ndarray]) -> None:
        """Insert one prefilled request into the decode batch: scatter its
        k/v rows into its blocks (or its ring), copy its carries into the
        slot's rows, set its table row, length
        cursor and pending first token — in place. ``token`` is the
        sampler's (1,) device tensor, or a host int; ``table_row`` is None
        for the ring."""
        from .kvcache import cache_leaves

        self._arm_slot(slot, length, token, table_row,
                       [t for name in self.state.caches
                        for t in cache_leaves(cache[name])])

    def _set_slot_meta(self, slot: int, length: int, token,
                       table_row: np.ndarray) -> None:
        """Arm a chunk-prefilled slot for decode: the chunks already wrote
        its rows, so only the cursor, table row and first token remain."""
        self._arm_slot(slot, length, token, table_row, [])

    def _arm_slot(self, slot, length, token, table_row, leaves) -> None:
        import torch

        with torch.inference_mode():
            row = () if table_row is None else np.asarray(table_row,
                                                         np.int32)
            meta = self._ids(np.concatenate([[slot, length], row]))
            if not torch.is_tensor(token):
                token = self._ids([token])
            self._slot_program("write", self._slot_write_body)(
                [meta, token.to(torch.int32), *leaves], self.state,
                self._last_tokens)

    @staticmethod
    def _slot_clear_body(inputs, _seeds, state):
        (slot,) = inputs
        state.block_tables.index_fill_(0, slot.long(), 0)
        state.lengths.index_fill_(0, slot.long(), 0)
        return []

    def _clear_slot_tables(self, slot: int) -> None:
        """Reset a freed slot's table row (all GARBAGE) and cursor (0).
        Without it the freed slot's stale row would keep writing its
        discarded tokens into blocks the allocator may already have handed
        to a new request in another slot."""
        import torch

        if self.state is None:
            return
        with torch.inference_mode():
            self._slot_program("clear", self._slot_clear_body)(
                [self._ids([slot])], self.state)

    @staticmethod
    def _cow_body(inputs, _seeds, caches):
        (src_dst,) = inputs
        src, dst = src_dst[0:1].long(), src_dst[1:2].long()
        for entry in caches.values():
            for pool in entry:
                pool.index_copy_(0, dst, pool.index_select(0, src))
        return []

    @staticmethod
    def _scrub_body(inputs, _seeds, caches):
        (blocks,) = inputs
        for entry in caches.values():
            for pool in entry:
                pool.index_fill_(0, blocks.long(), 0)
        return []

    def _scrub_blocks(self, blocks: List[int]) -> None:
        """Zero pool blocks a poison-suspect release returned to the free
        list (``ContinuousBatchScheduler._release_blocks``), in place and in
        stream order after the step that read them: the exact and chunk
        paths weigh every row of a slot's extent (0 x NaN = NaN) and a
        prefill writes only the blocks its prompt covers, so a later
        request handed one of these blocks for its generated tokens would
        otherwise read NaN. The ids are padded to one table row with the
        GARBAGE block (zero is as finite as any garbage), so the program
        has one shape."""
        import torch

        if self.state is None or not self._paged_entry_names:
            return
        ids = np.zeros((self.max_blocks_per_slot,), np.int32)
        ids[:len(blocks)] = blocks
        # the pooled entries only: a block id does not index a carry
        pools = {n: e for n, e in self.state.caches.items()
                 if n in self._paged_entry_names}
        with torch.inference_mode():
            self._slot_program("scrub", self._scrub_body)(
                [self._ids(ids)], pools)

    def _cow_clone(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` in every
        pool (int8 scale arrays included) before the cloner's first
        divergent write."""
        import torch

        if self.state is None:
            return
        with torch.inference_mode():
            self._slot_program("cow", self._cow_body)(
                [self._ids([src, dst])], self.state.caches)

    # -------------------------------------------------------- KV accounting
    def _kv_row_bytes(self) -> int:
        """KV bytes ONE token's row costs across every attention node, at
        the pool's layout (``kvcache.kv_token_bytes``): int8 rows plus
        their two f32 scales, or the stored dtype's bytes — the compute
        dtype where one is set, as the pools hold the rows in it."""
        if getattr(self, "_kv_row_bytes_cache", None) is None:
            from ..ffconst import size_of_datatype
            from .kvcache import kv_token_bytes

            compute = self.executor._compute_dtype()
            total = 0
            for node in self.executor.pcg.compute_nodes():
                if node.op.op_type != OperatorType.OP_MULTIHEAD_ATTENTION:
                    continue
                a = node.op.attrs
                heads = int(a.get("num_heads", 1))
                kd = int(a.get("kdim") or a["embed_dim"] // heads)
                vd = int(a.get("vdim") or a["embed_dim"] // heads)
                el = (compute.itemsize if compute is not None
                      else size_of_datatype(node.op.data_type))
                total += kv_token_bytes(heads, kd, vd, el, self.kv_dtype)
            self._kv_row_bytes_cache = total
        return self._kv_row_bytes_cache

    def _decode_kv_bytes(self, live) -> int:
        """KV bytes one decode step's attention reads: each live slot's
        occupied blocks (the flash-decode kernel's traffic), or for the
        ring every slot's full ``max_len`` (its masked read's extent)."""
        if not self._paged:
            return self.n_slots * self.max_decode_len * self._kv_row_bytes()
        bs = self.kv_block_size
        toks = sum(-(-(req.effective_len + 1) // bs) * bs
                   for _slot, req in live)
        return toks * self._kv_row_bytes()

    def _table_row_for(self, req) -> np.ndarray:
        row = np.zeros((self.max_blocks_per_slot,), np.int32)
        if req.kv_blocks:
            row[:len(req.kv_blocks)] = req.kv_blocks
        return row

    def _attach(self, sched: ContinuousBatchScheduler) -> None:
        """Bind the engine's paged-KV bookkeeping to a scheduler (the ring
        has none) and the max supported context."""
        if self.block_allocator is not None:
            sched.allocator = self.block_allocator
            sched.on_slot_freed = self._clear_slot_tables
            sched.on_suspect_blocks_freed = self._scrub_blocks
            sched.prefix = self._prefix
            sched.chunk_tokens = self.prefill_chunk_tokens
        if self.max_context < sched.max_len:
            sched.max_context = self.max_context

    # -------------------------------------------------------------- sampling
    def _sampler(self, temperature: float, top_k: int):
        """``(logits (S, V) fp32, tag_counts (S, 2) int32, seed (1,) int32)
        -> tokens (S,) int32``, all on the device: :func:`draw_tokens` as
        one step program per (temperature, top_k) — captured per row count
        on CUDA, with the top-k kernel (B7) inside — kept by the executor,
        so every engine of the model replays it. ``tag_counts`` and
        ``seed`` are static inputs; greedy reads neither (pass None). The
        JAX sampler is one jitted program per (temperature, top_k)
        (flexflow_tpu/serving/engine.py ``_sampler``)."""
        import torch

        from ..execution.graphs import step_program

        temp = max(float(temperature), 0.0)
        k = 0 if temp == 0.0 else int(top_k)
        capture = self.model._capture_steps
        key = ("sampler", temp, k, capture)
        fn = self.executor._serving_fns.get(key)
        if fn is not None:
            return fn
        program = step_program(
            lambda inputs, _seeds: [draw_tokens(*inputs, temp, k)]
            if temp > 0.0 else [draw_tokens(inputs[0], None, None, 0.0, 0)],
            self.device, "sampler", capture)

        def sample(logits, tag_counts=None, seed=None):
            with torch.inference_mode():
                inputs = [logits] if temp == 0.0 else \
                    [logits, tag_counts, seed]
                return program(inputs)[0]

        sample.program = program
        self.executor._serving_fns[key] = sample
        return sample

    # ------------------------------------------------------------- main loop
    def _make_resilience(self, chaos):
        from .resilience import ServingResilience

        return ServingResilience(self.model.config, chaos=chaos,
                                 controller=self.admission,
                                 clock=self.resilience_clock)

    def admit(self, sched: ContinuousBatchScheduler, req: Request,
              resilience=None) -> None:
        """Resilient admission: deadline stamp, shed-policy gate and the
        scheduler's submit. Raises ``OverloadError`` (shed) or the
        scheduler's rejection — all ``ServingRejection``. Without a
        ``resilience``, its events accumulate on a pending policy object
        the next ``serve`` consumes, so a shed or a deadline stamped before
        the serve is not lost."""
        self._attach(sched)
        res = resilience
        if res is None:
            if self._pending_resilience is None:
                self._pending_resilience = self._make_resilience(None)
            res = self._pending_resilience
        res.admit(sched, req)

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, eos_id: Optional[int] = None,
                 seed: int = 0, chaos=None,
                 deadline_ms: Optional[float] = None) -> List[List[int]]:
        """Generate continuations for ``prompts`` (token-id sequences)
        through the continuous-batching loop; returns the generated token
        lists in submission order. ``deadline_ms`` gives each request a
        relative completion budget (default ``--request-timeout-ms``);
        ``chaos`` a ``ChaosPlan`` of serving faults. A request shed at
        admission, evicted or drained returns its partial (possibly empty)
        continuation, with ``Request.outcome`` saying why: read
        ``self.stats.outcomes`` and ``self.drained_requests``."""
        self._token_input_check()
        res = self._make_resilience(chaos)
        sched = ContinuousBatchScheduler(
            n_slots=self.n_slots, max_queue=max(len(prompts),
                                                self.max_queue),
            buckets=self.buckets, max_len=self.max_decode_len,
            clock=res.clock)
        sched.shed_policy = res.shed_policy
        self._attach(sched)
        reqs = []
        for i, p in enumerate(prompts):
            r = Request(prompt=np.asarray(p, dtype=np.int32),
                        max_new_tokens=max_new_tokens,
                        eos_id=self.eos_id if eos_id is None else eos_id,
                        rng_tag=i, deadline_ms=deadline_ms)
            try:
                res.admit(sched, r)
            except ServingRejection:
                pass  # r.outcome == "shed"; the ledger counts it at finish
            reqs.append(r)
        self.serve(sched, temperature=temperature, top_k=top_k, seed=seed,
                   chaos=chaos, resilience=res)
        return [list(r.generated) for r in reqs]

    def _merge_telemetry(self, sched, stats: ServingStats) -> None:
        """Publish the run into a StepTelemetry when a sink wants one
        (flexflow_tpu/serving/engine.py:1263-1305): the ``serving`` block
        (requests, tokens, queue high-water mark, tokens/s, p50/p99 ms a
        token, host overhead share), the ``serving_resilience`` block (the
        outcome ledger and its counters) and the ``serving_prefix`` block.
        The JAX run's ``kv_hbm_per_chip_bytes`` stays empty until the port
        has sequence shards."""
        tracer = self.model._obs_tracer()
        tel = self.model._make_telemetry(tracer, batch_size=self.n_slots,
                                         phase="serving")
        self.model._telemetry = tel or self.model._telemetry
        if tel is None:
            return
        for w in stats.token_walls_s:
            tel.record_step(w)
        tel.requests_served = stats.requests_served
        tel.tokens_generated = stats.tokens_generated
        tel.queue_depth_hwm = stats.queue_depth_hwm
        tel.serving_p50_token_ms = stats.p50_token_ms()
        tel.serving_p99_token_ms = stats.p99_token_ms()
        tel.serving_tokens_per_s = round(stats.tokens_per_s(), 2)
        tel.serving_host_overhead_fraction = stats.host_overhead_fraction()
        tel.serving_outcomes = dict(stats.outcomes)
        tel.serving_sheds = stats.sheds
        tel.serving_deadline_misses = stats.deadline_misses
        tel.serving_quarantines = stats.quarantines
        tel.serving_drains = stats.drains
        tel.serving_replans = stats.replans
        tel.serving_prefix_hits = stats.prefix_hits
        tel.serving_prefix_tokens_reused = stats.prefix_tokens_reused
        tel.serving_prefill_tokens_computed = stats.prefill_tokens_computed
        tel.serving_cache_evictions = stats.cache_evictions
        tel.serving_chunked_prefills = stats.chunked_prefills
        tel.finalize()
        if self.model.config.telemetry_file:
            tel.write(self.model.config.telemetry_file)

    def start_serve(self, sched: ContinuousBatchScheduler,
                    temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0, chaos=None,
                    resilience=None) -> "_ServeLoop":
        """Begin a serve run without driving it: the loop whose ``tick()``
        advances one scheduler action. ``serve`` is ``start_serve``, then
        ``tick()`` until it returns False, then ``finish()``. Under
        ``--serve-loop async`` the loop is the one-deep
        :class:`_AsyncServeLoop`: a decode step's result may be in flight
        between ticks (``settle()`` lands it; ``finish()`` settles
        first)."""
        cls = _AsyncServeLoop if self.serve_loop == "async" else _ServeLoop
        return cls(self, sched, temperature=temperature, top_k=top_k,
                   seed=seed, chaos=chaos, resilience=resilience)

    def serve(self, sched: ContinuousBatchScheduler,
              temperature: float = 0.0, top_k: int = 0,
              seed: int = 0, chaos=None, resilience=None) -> ServingStats:
        """Drive the scheduler until its queue and slots drain. The loop
        installs the flag-only SIGTERM/SIGINT handler (``resilience/
        session.py``, ``signals_only``) for the run and restores the old
        one after: a preemption signal becomes a graceful drain."""
        from ..resilience.session import ResilienceSession

        loop = self.start_serve(sched, temperature=temperature,
                                top_k=top_k, seed=seed, chaos=chaos,
                                resilience=resilience)
        session = ResilienceSession(self.model, signals_only=True)
        session.install_signal_handlers()
        try:
            while True:
                if session.preempted:
                    loop.request_drain(session=session)
                if not loop.tick():
                    break
        finally:
            session.close()
        return loop.finish()

    # ------------------------------------------------------ resilience hooks
    def _sweep_deadlines(self, sched, res, tracer) -> None:
        """Deadline enforcement at the iteration boundary: expired queued
        requests are dropped before they cost a prefill, expired in-flight
        ones evicted and their slots recycled (outcome
        ``deadline_exceeded`` either way)."""
        now = res.clock()
        for req in [r for r in sched.queue if r.expired(now)]:
            res.deadline_misses += 1
            sched.drop_queued(req, "deadline_exceeded")
            if tracer.enabled:
                tracer.event("deadline_exceeded", rid=req.rid, queued=True)
        for slot, req in enumerate(list(sched.slots)):
            if req is not None and req.expired(now):
                res.deadline_misses += 1
                sched.evict(slot, "deadline_exceeded")
                if tracer.enabled:
                    tracer.event("deadline_exceeded", rid=req.rid,
                                 slot=slot, tokens=len(req.generated))

    def _quarantine(self, sched, res, slot: int, req, tracer) -> None:
        """The guarded decode said this slot's logits are not finite:
        quarantine the slot and retry the request on a fresh one while its
        retry budget lasts (re-prefilling prompt + committed tokens, so the
        stream goes on where it stopped); once it is spent, abort the
        request with outcome ``decode_fault``."""
        res.quarantines += 1
        retryable = req.retries_used < res.decode_retry_budget
        if retryable:
            try:
                bucket_for(req.effective_len, sched.buckets)
            except ValueError:
                retryable = False  # the committed stream outgrew the buckets
        if retryable:
            req.retries_used += 1
            res.decode_retries += 1
            sched.quarantine(slot)
            if tracer.enabled:
                tracer.event("decode_quarantine", rid=req.rid, slot=slot,
                             retry=req.retries_used,
                             tokens=len(req.generated))
        else:
            res.decode_faults += 1
            sched.evict(slot, "decode_fault")
            if tracer.enabled:
                tracer.event("decode_fault", rid=req.rid, slot=slot,
                             retries_used=req.retries_used)

    def _dispatch_decode(self, params, guard: bool):
        """Enqueue one decode step: ``(logits, ok-or-None)``, ``ok`` the
        guarded program's (n_slots,) int32 verdict. Nothing is caught: a
        device error propagates."""
        outs = self._decode_fn(guard)(params, [self._last_tokens],
                                      self.state)
        return outs[0], (outs[2] if guard else None)


class _ServeLoop:
    """One serve() run, advanced one scheduler action per ``tick()``: the
    synchronous loop, which dispatches a decode step, blocks on its tokens
    (``_fetch``) and commits them before the next tick. ``finish()``
    closes the ledger exactly once."""

    def __init__(self, engine: ServingEngine,
                 sched: ContinuousBatchScheduler, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, chaos=None,
                 resilience=None):
        eng = self.engine = engine
        self.sched = sched
        self.tracer = eng.model._obs_tracer()
        self.params = eng.model.params
        self.greedy = temperature <= 0.0
        self.sampler = eng._sampler(temperature, top_k)
        # the seed's low 32 bits, on the device once for the run
        self.seed = None if self.greedy else eng._ids(
            np.asarray([int(seed) & 0xFFFFFFFF], np.uint32).view(np.int32))
        self.stats = eng.stats = ServingStats()
        pending = eng._pending_resilience
        res = self.res = resilience or pending or \
            eng._make_resilience(chaos)
        eng._pending_resilience = None
        if pending is not None and res is not pending:
            # sheds and deadline stamps admit() ledgered before this serve
            res.sheds += pending.sheds
            res._saw_deadline = res._saw_deadline or pending._saw_deadline
        if chaos is not None:
            res.chaos = chaos
        self.chaos = res.chaos
        if res.controller is not eng.admission:
            res.controller.warm_start(eng.admission)
        sched.shed_policy = res.shed_policy
        eng._attach(sched)
        # one time base: submits were stamped by the scheduler's clock
        res.clock = sched.clock
        # requests submitted straight to the scheduler never passed
        # res.admit: stamp the default deadline and arm the sweeps for a
        # caller-set one
        for r in list(sched.queue) + [s for s in sched.slots
                                      if s is not None]:
            res.stamp_deadline(r)
        self.res_active = res.armed
        self.guard = bool(self.res_active)
        eng._last_guard = self.guard
        eng.drained_requests = []
        self.storm_seq = 0
        self.draining = False
        self.drain_deadline_ms = None
        self.finished = False
        self._chunk_walls: Dict[int, float] = {}
        self._prefix_hits0 = sched.prefix_hits
        self._prefix_reused0 = sched.prefix_tokens_reused
        self._evictions0 = eng._prefix.evictions \
            if eng._prefix is not None else 0
        self.t0 = time.perf_counter()

    # ---------------------------------------------------------------- drain
    def request_drain(self, session=None) -> None:
        """The graceful drain (a SIGTERM under ``serve``): admission stops,
        in-flight requests get the grace window, queued ones are handed
        back at ``finish()``. Idempotent."""
        if self.draining:
            return
        sched, res = self.sched, self.res
        self.draining = True
        sched.draining = True
        res.drains += 1
        if session is not None:
            session.note_preemption(self.stats.decode_steps)
        self.drain_deadline_ms = res.clock() + res.drain_grace_s * 1e3
        if self.tracer.enabled:
            self.tracer.event("serving_drain",
                              step=self.stats.decode_steps,
                              queued=sched.queued, active=sched.active,
                              grace_s=res.drain_grace_s)

    # -------------------------------------------------- pending transfers
    def settle(self) -> None:
        """Land any in-flight decode result and commit it: the async
        loop's drain point. The sync loop never has one."""
        self._settle_pending()

    def _settle_pending(self) -> None:
        return None

    def _fetch(self, transfer: HostTransfer):
        """THE blocking host transfer of a decode step's result (both loops
        land every decode result through it), counted in
        ``stats.host_syncs``: one a committed decode step. The guarded
        program's verdict rides the same copy as the tokens (row 1 of the
        packed buffer, :meth:`_transfer`). Returns ``(tokens (n_slots,),
        ok (n_slots,) bool or None)``."""
        self.stats.host_syncs += 1
        out = transfer.wait()
        if self.guard:
            return out[0], out[1].astype(bool)
        return out, None

    @staticmethod
    def _transfer(toks, ok) -> HostTransfer:
        """The decode step's one device-to-host copy: the tokens, packed
        with the guarded program's verdict into one (2, n_slots) int32
        buffer when there is one."""
        import torch

        return HostTransfer(toks if ok is None else torch.stack((toks, ok)))

    def _acct_tick(self, t_tick: float, t_dev: float, dev_s: float) -> None:
        """Split this tick's wall into dispatch (tick entry -> device call
        issued), device (the call and its fetch) and bookkeeping (device
        return -> now)."""
        st = self.stats
        st.host_dispatch_s += max(t_dev - t_tick, 0.0)
        st.host_device_s += dev_s
        st.host_bookkeep_s += max(time.perf_counter() - t_dev - dev_s, 0.0)
        st.host_ticks += 1

    # ------------------------------------------------------------ sampling
    def _tag_counts(self, rows):
        """The sampler's (tag, count) int32 rows on the device, from
        ``rows`` [(tag, count), ...]; None for greedy, which reads
        none."""
        if self.greedy:
            return None
        return self.engine._ids(np.asarray(rows, np.int32).reshape(-1, 2))

    @staticmethod
    def _tag(req) -> int:
        return req.rng_tag if req.rng_tag is not None else req.rid

    def _sample_first(self, last, req):
        """A completed prefill's first token: the sampler on its last row
        at (tag, tokens emitted). Returns (the (1,) device token, its host
        value); reading it blocks, as in the JAX loop."""
        toks = self.sampler(
            last, self._tag_counts([(self._tag(req), len(req.generated))]),
            self.seed)
        return toks, int(HostTransfer(toks).wait()[0])

    def _sample(self, live, logits, pending=None):
        """Sample every slot's next token on the device and feed it back as
        the next step's input: ``_last_tokens`` is written from the DEVICE
        tokens, never a host copy, which is what lets the async loop
        dispatch step k+1 before step k's tokens land. Rows draw at (tag,
        tokens emitted); with ``pending`` (the async loop's in-flight
        step) a slot whose previous token is still uncommitted draws at
        count + 1, the count it will have when that token lands (a
        pending token that is discarded discards this draw too)."""
        eng, sched = self.engine, self.sched
        rows = [(0, 0)] * eng.n_slots
        for s, r in live:
            rows[s] = (self._tag(r), len(r.generated))
        if pending is not None:
            for (s, r), e in zip(pending.live, pending.epochs):
                if sched.slots[s] is r and sched.slot_epoch[s] == e:
                    rows[s] = (rows[s][0], rows[s][1] + 1)
        toks = self.sampler(logits, self._tag_counts(rows), self.seed)
        eng._last_tokens.copy_(toks[:, None])
        return toks

    def _cache_prompt(self, req, tokens, eff: int) -> None:
        """Eagerly cache the prompt's FULL blocks at prefill completion so
        same-batch shared-prefix admissions already hit."""
        eng = self.engine
        if eng._prefix is not None and req.kv_blocks:
            full = eff // eng.kv_block_size
            if full:
                eng._prefix.insert(tokens[:full * eng.kv_block_size],
                                   req.kv_blocks[:full])

    # ----------------------------------------------------------------- tick
    def tick(self) -> bool:
        """Perform ONE scheduler action; False when there is nothing to do
        (queue and slots empty, or the drain grace just ran out and
        evicted the stragglers)."""
        import torch

        t_tick = time.perf_counter()
        sched, res = self.sched, self.res
        with torch.inference_mode():
            if self.draining and sched.active and \
                    res.clock() > self.drain_deadline_ms:
                # grace spent: stragglers are evicted as preempted, after
                # any in-flight tokens land (async)
                self._settle_pending()
                for slot, r in enumerate(list(sched.slots)):
                    if r is not None:
                        sched.evict(slot, "preempted")
                return False
            if self.res_active and res.deadlines_armed:
                self.engine._sweep_deadlines(sched, res, self.tracer)
            action = sched.next_action()
            if action is None:
                return self._idle()
            if action[0] == "prefill":
                return self._tick_prefill(t_tick, *action[1:])
            if action[0] == "prefill_chunk":
                return self._tick_chunk(t_tick, *action[1:])
            return self._tick_decode(t_tick, action[1])

    def _idle(self) -> bool:
        """No scheduler action is available. The async loop may still hold
        an in-flight result whose arrival is the remaining work; the sync
        loop is done."""
        return False

    def _expired_in_slot(self, req, slot: int) -> bool:
        """A request that expired while queued but was admitted into a slot
        in the same iteration is evicted before it costs a prefill."""
        res = self.res
        if self.res_active and req.expired(res.clock()):
            res.deadline_misses += 1
            self.sched.evict(slot, "deadline_exceeded")
            return True
        return False

    def _tick_prefill(self, t_tick: float, req, slot: int,
                      bucket: int) -> bool:
        eng, sched, stats = self.engine, self.sched, self.stats
        if self._expired_in_slot(req, slot):
            return True
        t_p = time.perf_counter()
        eff = req.effective_len
        cur = req.current_prompt()
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :eff] = cur
        _logits, last, cache = eng._prefill_fn(bucket)(
            self.params, [eng._ids(ids)], eng._ids([eff]))
        eng._ensure_state(cache)
        toks, tok = self._sample_first(last, req)
        wall = time.perf_counter() - t_p
        stats.prefills += 1
        stats.prefill_tokens_computed += eff
        stats.record_token(wall)
        stats.tokens_generated += 1
        if self.tracer.enabled:
            self.tracer.complete("prefill", wall, rid=req.rid, bucket=bucket,
                                 slot=slot, prompt_len=eff)
        if not sched.commit_token(slot, tok):
            eng._write_slot(cache, slot, eff, toks,
                            eng._table_row_for(req) if eng._paged else None)
            req.prefill_pos = req.prefill_target
            self._cache_prompt(req, cur, eff)
        self._acct_tick(t_tick, t_p, wall)
        return True

    def _tick_chunk(self, t_tick: float, req, slot: int, start: int, n: int,
                    shape: int) -> bool:
        eng, sched, stats = self.engine, self.sched, self.stats
        if self._expired_in_slot(req, slot):
            self._chunk_walls.pop(req.rid, None)
            return True
        t_p = time.perf_counter()
        eng._ensure_state_bootstrap()
        if req.pending_cow is not None:
            src, dst = req.pending_cow
            eng._cow_clone(src, dst)
            sched.release_cow(req)
            if self.tracer.enabled:
                self.tracer.event("prefix_cow_clone", rid=req.rid,
                                  slot=slot, src=src, dst=dst)
        cur = req.current_prompt()
        ids = np.zeros((1, shape), np.int32)
        ids[0, :n] = cur[start:start + n]
        row = eng._table_row_for(req)
        meta = eng._ids(np.concatenate([[start, n], row]))
        last, eng.state = eng._chunk_fn(shape)(
            self.params, [eng._ids(ids)], eng.state, meta[2:], meta[0:1],
            meta[1:2])
        stats.prefill_tokens_computed += n
        stats.chunked_prefills += 1
        done = sched.chunk_done(slot, n)
        wall = time.perf_counter() - t_p
        if self.tracer.enabled:
            self.tracer.complete("prefill_chunk", wall, rid=req.rid,
                                 slot=slot, start=start, tokens=n,
                                 hit=req.prefix_hit_tokens, done=done)
        if sched.rt.enabled:
            sched.rt.note(req.rid, "chunk", float(sched.clock()),
                          start=start, tokens=n)
        self._chunk_walls[req.rid] = self._chunk_walls.get(req.rid, 0.0) + \
            wall
        if not done:
            self._acct_tick(t_tick, t_p, wall)
            return True
        eff = req.prefill_target
        toks, tok = self._sample_first(last, req)
        stats.prefills += 1
        stats.record_token(self._chunk_walls.pop(req.rid, wall))
        stats.tokens_generated += 1
        self._cache_prompt(req, cur, eff)
        if not sched.commit_token(slot, tok):
            eng._set_slot_meta(slot, eff, toks, row)
        self._acct_tick(t_tick, t_p, wall)
        return True

    # --------------------------------------------------------------- decode
    # shared by the sync loop and the async one, so the two differ only in
    # WHEN the commit happens, never in what it does
    def _pending_slots(self) -> set:
        """Slots whose previous decode token is still in flight (the async
        loop's pending step, at the epoch it was dispatched against)."""
        return set()

    def _occupied_blocks(self, slot: int) -> List[int]:
        """The pool blocks ``slot``'s request occupies on the device, from
        the host's bookkeeping (no sync): its table row's first
        ceil(cursor / block_size) entries, the cursor being the tokens
        whose rows are written — prompt + committed tokens - 1, + 1 while
        a step is in flight for it. Empty for a free or prefilling slot
        (its device cursor is 0) and for the ring, which is poisoned
        whole."""
        eng = self.engine
        req = self.sched.slots[slot]
        if req is None or req.prefilling or not eng._paged:
            return []
        cursor = req.effective_len - 1 + (slot in self._pending_slots())
        return req.kv_blocks[:-(-cursor // eng.kv_block_size)]

    def _chaos_hooks(self, k: int) -> None:
        """Scripted chaos at decode-step boundary ``k`` (the dispatch count
        in the async loop, which equals the sync loop's decode-step count
        at injection time): the preemption signal, the queue storm through
        admission control, and the in-place KV poison."""
        eng, sched, res = self.engine, self.sched, self.res
        chaos = self.chaos
        if chaos is None:
            return
        chaos.maybe_preempt_serving(k)
        for p in chaos.maybe_storm(k):
            r = Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=chaos.storm_max_new_tokens,
                        eos_id=eng.eos_id,
                        rng_tag=1_000_000 + self.storm_seq)
            self.storm_seq += 1
            try:
                res.admit(sched, r)
            except ServingRejection:
                pass  # counted by the policy; outcome shed
        if eng.state is not None:
            poisoned = chaos.maybe_poison_decode(
                k, eng.state, self._occupied_blocks, eng._ids)
            if poisoned is not None and self.tracer.enabled:
                self.tracer.event("decode_poison", step=k, slot=poisoned)

    def _commit_arrival(self, live, epochs, toks_host, ok_host,
                        wall: float) -> None:
        """THE commit point of one landed decode step: token commits (EOS
        and length recycling inside ``commit_token``), the guard's verdict
        (a poisoned slot's token is not committed; the slot is quarantined
        alone) and the stats. The sync loop runs it right after its fetch;
        the async loop at arrival, one step behind dispatch, where
        ``epochs`` discards the entries of slots recycled while the result
        was in flight."""
        eng, sched, stats, res = self.engine, self.sched, self.stats, \
            self.res
        stats.decode_steps += 1
        stats.kv_bytes_read += eng._decode_kv_bytes(live)
        if self.res_active:
            res.controller.observe_step(wall, len(live))
        for i, (slot, req) in enumerate(live):
            if epochs is not None and (
                    sched.slots[slot] is not req
                    or sched.slot_epoch[slot] != epochs[i]):
                continue  # the one-deep pipeline's extra draw
            if ok_host is not None and not bool(ok_host[slot]):
                eng._quarantine(sched, res, slot, req, self.tracer)
                continue
            stats.tokens_generated += 1
            stats.record_token(wall)
            sched.commit_token(slot, int(toks_host[slot]))
        if self.tracer.enabled:
            self.tracer.complete("decode_step", wall,
                                 step=stats.decode_steps,
                                 live_slots=len(live))

    def _tick_decode(self, t_tick: float, live) -> bool:
        """One decode step for every live slot, synchronously: chaos hooks,
        dispatch, sample on the device, block on the result's transfer,
        commit."""
        self._chaos_hooks(self.stats.decode_steps)
        t_d = time.perf_counter()
        logits, ok = self.engine._dispatch_decode(self.params, self.guard)
        toks = self._sample(live, logits)
        toks_host, ok_host = self._fetch(self._transfer(toks, ok))
        wall = time.perf_counter() - t_d
        self._commit_arrival(live, None, toks_host, ok_host, wall)
        self._acct_tick(t_tick, t_d, wall)
        return True

    # --------------------------------------------------------------- finish
    def finish(self) -> ServingStats:
        """Close the run exactly once: the drain handoff (queued requests
        into ``engine.drained_requests``, their request timelines closed as
        preempted), the outcome ledger (every request that entered leaves
        under exactly one outcome), the stats, and the telemetry (and the
        trace file) when a sink wants them."""
        eng, stats, sched, res = self.engine, self.stats, self.sched, \
            self.res
        if self.finished:
            return stats
        self.finished = True
        if self.draining:
            eng.drained_requests = sched.pop_queued()
            if sched.rt.enabled:
                for r in eng.drained_requests:
                    sched.rt.finish(r.rid, float(sched.clock()),
                                    "preempted", reason="drain",
                                    new_tokens=len(r.generated))
            if self.tracer.enabled:
                self.tracer.event("serving_drain_done",
                                  returned=len(eng.drained_requests),
                                  finished=len(sched.finished))
        stats.wall_s = time.perf_counter() - self.t0
        stats.requests_served = sum(1 for r in sched.finished
                                    if (r.outcome or "ok") == "ok")
        stats.queue_depth_hwm = sched.queue_depth_hwm
        for r in sched.finished:
            stats.count_outcome(r.outcome or "ok")
        stats.count_outcome("shed", res.sheds)
        stats.count_outcome("preempted", len(eng.drained_requests))
        stats.sheds = res.sheds
        stats.deadline_misses = res.deadline_misses
        stats.quarantines = res.quarantines
        stats.decode_retries = res.decode_retries
        stats.decode_faults = res.decode_faults
        stats.drains = res.drains
        stats.drained_returned = len(eng.drained_requests)
        stats.prefix_hits = sched.prefix_hits - self._prefix_hits0
        stats.prefix_tokens_reused = \
            sched.prefix_tokens_reused - self._prefix_reused0
        if eng._prefix is not None:
            stats.cache_evictions = eng._prefix.evictions - self._evictions0
        eng._merge_telemetry(sched, stats)
        if self.tracer.enabled and eng.model.config.trace_file:
            self.tracer.write(eng.model.config.trace_file)
        return stats


@dataclasses.dataclass
class _PendingStep:
    """One in-flight decode step of the async loop: its result's transfer
    (tokens, and the guard's verdict packed with them), the live slots it
    was dispatched for and their epochs at dispatch (a slot recycled while
    the result was in flight discards its entry), and the dispatch
    time."""

    transfer: HostTransfer
    live: List
    epochs: List[int]
    t_d: float


class _AsyncServeLoop(_ServeLoop):
    """The one-deep serve loop behind ``--serve-loop async``: decode step
    k+1 is dispatched while step k's result is still on its way to the
    host, and step k's commits (token commits, EOS and length recycling,
    quarantine verdicts) run at its arrival, one step behind dispatch,
    while step k+1 runs on the card. The only blocking host wait a
    committed step costs is its ``_fetch`` (``stats.host_syncs``).

    Why the pipeline is safe (the JAX loop's argument, in torch terms):

    * the decode input token is read from the DEVICE tokens
      (``_last_tokens`` written by ``_sample`` on the stream), so
      dispatching k+1 never needs k's host copy;
    * every write to the pools, block tables, cursors and token buffer —
      the decode graph, the sampler, the prefill and chunk programs, the
      slot writes, clears, clones and scrubs, the chaos poison — is
      enqueued on one stream in host dispatch order, so the device sees
      them in the order the sync loop would run them;
    * the per-row streams key on (tag, tokens emitted), with an
      uncommitted in-flight token counted (+1), so sampled streams equal
      the sync loop's whatever the commit lag;
    * the extra in-flight step of a finishing slot writes its one row at
      the slot's cursor, at or past the end of its prompt, so only past
      the full blocks the prefix trie cached; it is enqueued before the
      ``_clear_slot_tables`` its settle enqueues, and every block handed
      to a new request is written by that request's prefill, chunk or
      clone, enqueued after it, before any read;
    * slot epochs (``ContinuousBatchScheduler.slot_epoch``) discard the
      in-flight results of recycled slots, a quarantined one included
      (``quarantine`` bumps the epoch, so the extra draw made against the
      poisoned slot is dropped).

    Chaos keys on the dispatch count (``dispatch_no``), which equals the
    sync loop's decode-step count at injection time. ``finish()``, an idle
    tick and the drain-grace eviction settle the pending step first."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._pending: Optional[_PendingStep] = None
        self.dispatch_no = 0

    def _pending_slots(self) -> set:
        p, sched = self._pending, self.sched
        if p is None:
            return set()
        return {s for (s, r), e in zip(p.live, p.epochs)
                if sched.slots[s] is r and sched.slot_epoch[s] == e}

    def _settle_step(self, p: _PendingStep) -> float:
        """Block until ``p``'s result lands, then commit it. Returns the
        seconds spent blocked (device wait, not host work)."""
        t_s = time.perf_counter()
        toks_host, ok_host = self._fetch(p.transfer)
        blocked = time.perf_counter() - t_s
        self.stats.host_device_s += blocked
        self._commit_arrival(p.live, p.epochs, toks_host, ok_host,
                             time.perf_counter() - p.t_d)
        return blocked

    def _settle_pending(self) -> None:
        """Land and commit the in-flight step; with nothing to overlap,
        its host work is bookkeeping."""
        p, self._pending = self._pending, None
        if p is None:
            return
        t0 = time.perf_counter()
        blocked = self._settle_step(p)
        self.stats.host_bookkeep_s += max(
            time.perf_counter() - t0 - blocked, 0.0)

    def _idle(self) -> bool:
        if self._pending is None:
            return False
        # the in-flight step is the remaining work: its arrival commits
        # tokens, frees slots, may requeue a quarantined stream
        self._settle_pending()
        return True

    def _tick_decode(self, t_tick: float, live) -> bool:
        """Dispatch step k+1 first, then land and commit step k while k+1
        runs. Host time before the dispatch is overlap when a step was
        already in flight (the card was busy), dispatch otherwise."""
        stats = self.stats
        pipelined = self._pending is not None
        self._chaos_hooks(self.dispatch_no)
        t_d = time.perf_counter()
        logits, ok = self.engine._dispatch_decode(self.params, self.guard)
        issued = time.perf_counter()
        if pipelined:
            stats.host_overlap_s += max(issued - t_tick, 0.0)
        else:
            stats.host_dispatch_s += max(issued - t_tick, 0.0)
        toks = self._sample(live, logits, pending=self._pending)
        prev, self._pending = self._pending, _PendingStep(
            transfer=self._transfer(toks, ok), live=list(live),
            epochs=[self.sched.slot_epoch[s] for s, _ in live], t_d=t_d)
        self.dispatch_no += 1
        blocked = self._settle_step(prev) if prev is not None else 0.0
        stats.host_overlap_s += max(
            time.perf_counter() - issued - blocked, 0.0)
        stats.host_ticks += 1
        return True

    def finish(self) -> ServingStats:
        import torch

        with torch.inference_mode():
            self._settle_pending()
        return super().finish()
