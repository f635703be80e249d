"""Continuous (iteration-level) batching scheduler for the serving engine.

Port of ``flexflow_tpu.serving.scheduler`` (Orca-style scheduling over a
fixed pool of decode slots, length-bucketed prefill, a refcounted paged-KV
block allocator, a bounded admission queue, prefix-aware admission with
copy-on-write, and chunked prefill). Pure host bookkeeping — the schedule
is a deterministic function of the submission sequence, as in the JAX
package, so both packages admit, chunk and decode in the same order.

The resilience layer (``serving/resilience.py``) drives the slot pool
through ``evict``, ``drop_queued``, ``quarantine`` and ``pop_queued``:
every request leaves under exactly one outcome (``ok``,
``deadline_exceeded``, ``shed``, ``decode_fault``, ``preempted``), the
slot epochs are bumped wherever a slot is freed (so the async serve loop
can tell a recycled slot from the one it dispatched against), and
``draining`` stops admission during a graceful drain. Request tracing
(``obs/reqtrace.py``) notes each request's submit, admission, tokens,
quarantine and finish on the scheduler's clock, every note behind the
tracer's ``enabled`` test. Hedged-request cancellation and rid reservation
come with the serving fleet and its journal (ROADMAP A.8).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

from ..obs.reqtrace import get_reqtrace

_req_counter = itertools.count(1)


def now_ms() -> float:
    """The scheduler's default time base (ms, monotonic), as in
    flexflow_tpu/serving/scheduler.py:43."""
    return time.monotonic() * 1e3


def remove_by_identity(queue, req: "Request") -> bool:
    """Remove ``req`` from a queue by identity, returning whether it was
    there (a Request holds arrays, so ``==`` cannot compare two)."""
    for i, q in enumerate(queue):
        if q is req:
            del queue[i]
            return True
    return False


class ServingRejection(RuntimeError):
    """Common base of every admission refusal: ``queued`` / ``active``
    snapshot the scheduler at refusal, ``retry_after_ms`` is the admission
    controller's drain-time hint (0.0 without a cost estimate)."""

    def __init__(self, message: str, queued: int = 0, active: int = 0,
                 retry_after_ms: float = 0.0):
        super().__init__(message)
        self.queued = int(queued)
        self.active = int(active)
        self.retry_after_ms = float(retry_after_ms)


class QueueFullError(ServingRejection):
    """Admission refused: the bounded submit queue is at capacity."""


class ContextOverflowError(ServingRejection):
    """Admission refused: prompt + max new tokens exceeds the model's max
    supported context (the position-embedding table)."""


class BlockAccountingError(RuntimeError):
    """A paged-KV block operation violated the allocator's refcount laws
    (double free, sharing a free block, touching the garbage block)."""


class BlockAllocator:
    """Host-side refcounted FIFO free-list allocator over the paged KV pool.

    Block 0 (the garbage block) is reserved, so ``n_blocks - 1`` blocks are
    allocatable. Allocation is whole-request at admission; a block may be
    mapped by several tables at once (the prefix trie plus every request
    reusing that prefix) and returns to the free list at refcount 0."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2 or block_size < 1:
            raise ValueError("paged pool needs >= 1 usable block plus the "
                             "garbage block, and block_size >= 1")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.free_blocks: Deque[int] = deque(range(1, self.n_blocks))
        self.refcounts: List[int] = [0] * self.n_blocks

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def in_use(self) -> int:
        return self.n_usable - len(self.free_blocks)

    def blocks_needed(self, tokens: int) -> int:
        return -(-max(int(tokens), 1) // self.block_size)

    def refcount(self, block: int) -> int:
        return self.refcounts[int(block)]

    def _check(self, block: int) -> int:
        b = int(block)
        if b <= 0 or b >= self.n_blocks:
            raise BlockAccountingError(
                f"block {b} is outside the pool (usable ids 1.."
                f"{self.n_blocks - 1}; 0 is the reserved garbage block)")
        return b

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids at refcount 1 each, or None when the pool cannot
        satisfy the request right now."""
        if n > len(self.free_blocks):
            return None
        out = []
        for _ in range(int(n)):
            b = self.free_blocks.popleft()
            if self.refcounts[b] != 0:
                raise BlockAccountingError(
                    f"free list corrupt: block {b} popped with refcount "
                    f"{self.refcounts[b]} (double-listed)")
            self.refcounts[b] = 1
            out.append(b)
        return out

    def share(self, blocks: List[int]) -> None:
        """Add one reference to each (live) block."""
        for b in blocks:
            b = self._check(b)
            if self.refcounts[b] == 0:
                raise BlockAccountingError(
                    f"cannot share block {b}: it is free (refcount 0)")
            self.refcounts[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per block; a block returns to the free list
        when its last reference is gone. Freeing a free block raises."""
        for b in blocks:
            b = self._check(b)
            if self.refcounts[b] == 0:
                raise BlockAccountingError(
                    f"double free of block {b}: refcount is already 0")
            self.refcounts[b] -= 1
            if self.refcounts[b] == 0:
                self.free_blocks.append(b)

    def leaked(self) -> List[int]:
        """Blocks still referenced."""
        return [b for b in range(1, self.n_blocks) if self.refcounts[b]]

    def reset(self) -> None:
        """Forget every allocation (the pool is rebuilt from zeros)."""
        self.free_blocks = deque(range(1, self.n_blocks))
        self.refcounts = [0] * self.n_blocks


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int token array;
    ``generated`` fills as steps commit tokens."""

    prompt: np.ndarray
    max_new_tokens: int
    rid: int = dataclasses.field(default_factory=lambda: next(_req_counter))
    eos_id: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # "eos" | "length"
    # resilience: the relative completion budget from submission (None: no
    # deadline; the engine defaults it from --request-timeout-ms), the
    # submit, first-token and terminal stamps on the scheduler's clock
    # (ms), the terminal disposition (one of serving.resilience.OUTCOMES)
    # and the decode-fault re-prefills spent against --decode-retry-budget
    deadline_ms: Optional[float] = None
    submit_ms: float = 0.0
    first_token_ms: float = 0.0
    finish_ms: float = 0.0
    outcome: Optional[str] = None
    retries_used: int = 0
    # sampling-stream tag (submission order), so the same (prompts, seed)
    # reproduces the same draws run after run
    rng_tag: Optional[int] = None
    # paged KV: pool block ids this request holds while it occupies a slot
    kv_blocks: List[int] = dataclasses.field(default_factory=list)
    # prefix cache + chunked prefill: tokens mapped from the trie at
    # admission, tokens of the prompt whose KV is in the pool so far, the
    # prompt length this admission must prefill, the chunk program's
    # width, and the (src, dst) copy-on-write clone still owed
    prefix_hit_tokens: int = 0
    prefill_pos: int = 0
    prefill_target: int = 0
    chunk_shape: int = 0
    pending_cow: Optional[Tuple[int, int]] = None

    @property
    def prefilling(self) -> bool:
        """True while this request's prompt KV is not fully in the pool —
        the decode batch excludes it."""
        return self.prefill_target > 0 and \
            self.prefill_pos < self.prefill_target

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def effective_len(self) -> int:
        return self.prompt_len + len(self.generated)

    def current_prompt(self) -> np.ndarray:
        """Tokens the next prefill feeds: the prompt, plus the committed
        tokens for a quarantine retry."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def expired(self, now_ms: float) -> bool:
        return (self.deadline_ms is not None and self.deadline_ms > 0
                and now_ms - self.submit_ms > self.deadline_ms)


def default_buckets(max_prompt_len: int, min_bucket: int = 16
                    ) -> Tuple[int, ...]:
    """Geometric prefill buckets: powers of two from ``min_bucket``, capped
    by ``max_prompt_len`` as the last bucket."""
    buckets = []
    b = min(max(int(min_bucket), 1), max_prompt_len)
    while b < max_prompt_len:
        buckets.append(b)
        b *= 2
    buckets.append(min(b, max_prompt_len))
    return tuple(buckets)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(
        f"prompt length {length} exceeds the largest prefill bucket "
        f"{buckets[-1]} (raise --max-decode-len / the engine's buckets)")


class ContinuousBatchScheduler:
    """Slot allocator + admission queue for iteration-level batching.

    ``next_action()`` returns ("prefill", request, slot, bucket_len),
    ("prefill_chunk", request, slot, start, n_tokens, chunk_shape) or
    ("decode", [(slot, request), ...]), or None when idle."""

    def __init__(self, n_slots: int, max_queue: int = 64,
                 buckets: Optional[Sequence[int]] = None,
                 max_len: int = 128, clock=None):
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.max_len = max_len
        self.buckets = tuple(buckets) if buckets else \
            default_buckets(max_len)
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self._free: Deque[int] = deque(range(n_slots))
        self.finished: List[Request] = []
        self.queue_depth_hwm = 0
        # attached by the paged engine before it drives the loop.
        # on_slot_freed fires on every slot-freeing path (the engine resets
        # the slot's table row and cursor); on_suspect_blocks_freed gets
        # the blocks a poison-suspect release returned to the free list
        # (the engine zeroes them: a later request may read their rows)
        self.allocator: Optional[BlockAllocator] = None
        self.max_context: Optional[int] = None
        self.on_slot_freed = None
        self.on_suspect_blocks_freed = None
        self.prefix = None
        self.chunk_tokens = 0
        self._chunk_turn = False
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        # slot incarnation counters, bumped on every slot-freeing path: a
        # result the async serve loop dispatched against epoch e of a slot
        # is discarded if the slot was recycled while it was in flight
        self.slot_epoch: List[int] = [0] * n_slots
        # resilience: ``clock`` (ms, injectable) stamps submits, so the
        # deadline math shares one time base with the engine's sweeps; the
        # shed policy in effect is recorded so the queue wall can name it;
        # ``draining`` stops admission during a graceful drain
        self.clock = clock if clock is not None else now_ms
        self.shed_policy = "off"
        self.draining = False
        self.quarantined = 0
        self.evicted = 0
        # request tracing: the process request tracer as of construction;
        # each lifecycle edge below notes it behind ``rt.enabled`` (one
        # attribute load and test when tracing is off), stamped by
        # ``clock``
        self.rt = get_reqtrace()

    @property
    def queued(self) -> int:
        return len(self.queue)

    @property
    def active(self) -> int:
        return self.n_slots - len(self._free)

    def submit(self, req: Request) -> None:
        """FIFO admission with bounded-queue backpressure."""
        if len(self.queue) >= self.max_queue:
            raise QueueFullError(
                f"serving queue full ({self.max_queue} waiting, shed "
                f"policy '{self.shed_policy}'); retry later or raise "
                "--max-inflight/max_queue",
                queued=len(self.queue), active=self.active)
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new_tokens {req.max_new_tokens} exceeds the decode "
                f"capacity {self.max_len} (--max-decode-len)")
        if self.max_context is not None and \
                req.prompt_len + req.max_new_tokens > self.max_context:
            raise ContextOverflowError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new_tokens {req.max_new_tokens} exceeds the max "
                f"supported context {self.max_context} (position "
                "embedding table limit; build the model with a longer "
                "seq_len or lower max_new_tokens)",
                queued=len(self.queue), active=self.active)
        if self.allocator is not None:
            need = self.allocator.blocks_needed(
                req.prompt_len + req.max_new_tokens)
            if need > self.allocator.n_usable:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV blocks but the "
                    f"pool has {self.allocator.n_usable} (raise "
                    "--kv-pool-blocks or --kv-block-size)")
        # effective_len: a quarantine retry re-prefills its committed
        # tokens too, so a narrower scheduler refuses it here, before
        # next_action claims a slot
        bucket_for(req.effective_len, self.buckets)
        req.submit_ms = float(self.clock())
        self.queue.append(req)
        self.queue_depth_hwm = max(self.queue_depth_hwm, len(self.queue))
        if self.rt.enabled:
            self.rt.note(req.rid, "submit", req.submit_ms,
                         prompt_len=req.prompt_len,
                         max_new=req.max_new_tokens,
                         deadline_ms=req.deadline_ms)

    def _admit_head(self):
        """Admit the head-of-queue request into a free slot with
        prefix-aware block accounting. Returns the ("prefill", ...) action,
        "chunked" when the request entered the chunk-prefill path, or None
        when the pool cannot hold it yet.

        The trie walk maps the longest cached prefix (>= one full block)
        into the slot's table with zero prefill compute; a hit whose
        boundary falls inside a shared block schedules a copy-on-write
        clone of that block before the first divergent write."""
        req = self.queue[0]
        eff = req.effective_len
        match_blocks: List[int] = []
        match_t = 0
        if self.allocator is not None:
            alc = self.allocator
            if self.prefix is not None:
                # never match the full prompt: the last token's forward
                # produces the next-token logits, so >= 1 token prefills
                match_blocks, match_t = self.prefix.match(
                    req.current_prompt(), cap=eff - 1)
            need_total = alc.blocks_needed(
                req.prompt_len + req.max_new_tokens)
            partial = match_t % alc.block_size != 0
            fresh_needed = need_total - len(match_blocks) + (1 if partial
                                                            else 0)
            if match_blocks:
                alc.share(match_blocks)  # pin before any eviction runs
            fresh = alc.alloc(fresh_needed)
            if fresh is None and self.prefix is not None:
                if self.prefix.evict(fresh_needed - len(alc.free_blocks)):
                    fresh = alc.alloc(fresh_needed)
            if fresh is None:
                if match_blocks:
                    alc.free(match_blocks)
                return None
            if partial:
                req.pending_cow = (match_blocks[-1], fresh[0])
                req.kv_blocks = match_blocks[:-1] + [fresh[0]] + fresh[1:]
            else:
                req.pending_cow = None
                req.kv_blocks = match_blocks + fresh
        req.prefix_hit_tokens = match_t
        req.prefill_pos = match_t
        req.prefill_target = eff
        req.chunk_shape = 0
        self.queue.popleft()
        slot = self._free.popleft()
        self.slots[slot] = req
        if self.rt.enabled:
            self.rt.note(req.rid, "admit", float(self.clock()), slot=slot,
                         hit=match_t, cow=req.pending_cow is not None)
        if match_t:
            self.prefix_hits += 1
            self.prefix_tokens_reused += match_t
        suffix = eff - match_t
        if match_t > 0 or (self.chunk_tokens and
                           suffix > self.chunk_tokens):
            # chunk path: chunk_tokens-wide steps when chunking is on, one
            # bucket-shaped chunk otherwise; width floor 2, as in the JAX
            # package, so both packages run the same chunk shapes
            req.chunk_shape = max(
                2, self.chunk_tokens or bucket_for(suffix, self.buckets))
            self._chunk_turn = True
            return "chunked"
        req.prefill_pos = 0  # the engine marks completion after the write
        return ("prefill", req, slot, bucket_for(eff, self.buckets))

    def next_action(self):
        """Prefill takes priority so freed capacity never idles while work
        queues; chunks of an in-progress chunked prefill alternate with
        decode steps over the decodable slots. While ``draining`` nothing
        is admitted: in-flight requests finish, the queue stays for the
        engine to hand back."""
        while self.queue and self._free and not self.draining:
            act = self._admit_head()
            if act is None:
                break  # pool pressure: decode on, recycling frees blocks
            if act != "chunked":
                return act
        chunking = [(i, r) for i, r in enumerate(self.slots)
                    if r is not None and r.prefilling]
        live = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and not r.prefilling]
        if chunking and (self._chunk_turn or not live):
            slot, req = chunking[0]
            self._chunk_turn = False
            n = min(req.chunk_shape, req.prefill_target - req.prefill_pos)
            return ("prefill_chunk", req, slot, req.prefill_pos, n,
                    req.chunk_shape)
        if live:
            self._chunk_turn = True
            return ("decode", live)
        return None

    def chunk_done(self, slot: int, n_tokens: int) -> bool:
        """Record one completed chunk; True when the whole prompt is in."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"chunk for empty slot {slot}")
        req.prefill_pos += int(n_tokens)
        return req.prefill_pos >= req.prefill_target

    def release_cow(self, req: Request) -> None:
        """The engine's COW clone landed: drop the admission-held share on
        the source block."""
        if req.pending_cow is not None and self.allocator is not None:
            self.allocator.free([req.pending_cow[0]])
        req.pending_cow = None

    def commit_token(self, slot: int, token: int) -> bool:
        """Record one generated token; True when the request finished (EOS
        or length) and the slot was recycled."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"token for empty slot {slot}")
        req.generated.append(int(token))
        # the first-token stamp (TTFT = first_token_ms - submit_ms) lands
        # here, the one commit point every first token passes; a retry
        # keeps its original stamp
        if not req.first_token_ms:
            req.first_token_ms = float(self.clock())
        if self.rt.enabled:
            self.rt.note(req.rid, "token", float(self.clock()),
                         occ=self.n_slots - len(self._free))
        if req.eos_id is not None and int(token) == int(req.eos_id):
            return self._finish(slot, "eos")
        if len(req.generated) >= req.max_new_tokens:
            return self._finish(slot, "length")
        return False

    def _release_blocks(self, req: Request, adopt: bool = True) -> None:
        """The one choke point returning a request's pool blocks; a fully
        prefilled request's prompt blocks are adopted into the prefix trie
        first, so its cached KV outlives it. ``adopt=False`` on the
        quarantine and decode-fault paths: poison-suspect KV never enters
        the trie, and blocks the trie cached from it are purged. The blocks
        such a release returns to the free list go to
        ``on_suspect_blocks_freed``: the exact and chunk reads multiply
        every row of a slot's extent by its probability (0 x NaN = NaN),
        and a later request may be handed these blocks for rows its
        prefill does not write."""
        if self.allocator is not None:
            if req.pending_cow is not None:
                self.allocator.free([req.pending_cow[0]])
                req.pending_cow = None
            if req.kv_blocks:
                if (adopt and self.prefix is not None
                        and req.prefill_target > 0
                        and req.prefill_pos >= req.prefill_target):
                    self.prefix.insert(
                        req.current_prompt()[:req.prefill_pos],
                        req.kv_blocks)
                elif not adopt and self.prefix is not None:
                    self.prefix.invalidate(req.kv_blocks)
                self.allocator.free(req.kv_blocks)
                if not adopt and self.on_suspect_blocks_freed is not None:
                    freed = [b for b in req.kv_blocks
                             if self.allocator.refcount(b) == 0]
                    if freed:
                        self.on_suspect_blocks_freed(freed)
        req.kv_blocks = []

    def _finish(self, slot: int, reason: str, outcome: str = "ok") -> bool:
        req = self.slots[slot]
        req.done = True
        req.finish_reason = reason
        req.outcome = outcome
        req.finish_ms = float(self.clock())
        if self.rt.enabled:
            self.rt.finish(req.rid, req.finish_ms, outcome, reason=reason,
                           new_tokens=len(req.generated))
        self._release_blocks(req, adopt=outcome != "decode_fault")
        self.finished.append(req)
        self.slots[slot] = None
        self._free.append(slot)
        self.slot_epoch[slot] += 1
        if self.on_slot_freed is not None:
            self.on_slot_freed(slot)
        return True

    # ---------------------------------------------------------- resilience
    def evict(self, slot: int, outcome: str) -> Request:
        """Terminate the request in ``slot`` with a failure ``outcome``
        (deadline_exceeded | decode_fault | preempted) and recycle the
        slot; the request lands in ``finished``, never silently dropped."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"evict of empty slot {slot}")
        self.evicted += 1
        self._finish(slot, outcome, outcome=outcome)
        return req

    def drop_queued(self, req: Request, outcome: str) -> None:
        """Remove a still-queued request (it never held a slot) with a
        terminal ``outcome``: the admission half of deadline
        enforcement."""
        if not remove_by_identity(self.queue, req):
            raise ValueError(f"request rid={req.rid} is not queued")
        req.done = True
        req.finish_reason = outcome
        req.outcome = outcome
        req.finish_ms = float(self.clock())
        if self.rt.enabled:
            self.rt.finish(req.rid, req.finish_ms, outcome, reason=outcome,
                           new_tokens=len(req.generated))
        self._release_blocks(req)  # a queued request holds none
        self.finished.append(req)

    def quarantine(self, slot: int) -> Request:
        """Pull a decode-poisoned request out of ``slot`` for a retry: the
        slot goes to the BACK of the free pool (the retry prefers another
        slot when one is free), the request to the FRONT of the queue with
        its committed tokens (``current_prompt`` re-prefills them). Its
        blocks are released without adoption."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"quarantine of empty slot {slot}")
        self._release_blocks(req, adopt=False)
        self.slots[slot] = None
        self._free.append(slot)
        self.slot_epoch[slot] += 1
        self.quarantined += 1
        if self.rt.enabled:
            self.rt.note(req.rid, "quarantine", float(self.clock()),
                         slot=slot)
        self.queue.appendleft(req)
        if self.on_slot_freed is not None:
            self.on_slot_freed(slot)
        return req

    def remove_finished(self, req: Request) -> bool:
        """Strike a request from ``finished`` (by identity); True when an
        entry was removed."""
        return remove_by_identity(self.finished, req)

    def pop_queued(self) -> List[Request]:
        """Drain handoff: every still-queued request (outcome
        ``preempted``) for re-submission elsewhere — they never started,
        so their state is clean."""
        out = list(self.queue)
        self.queue.clear()
        for r in out:
            r.outcome = "preempted"
        return out
