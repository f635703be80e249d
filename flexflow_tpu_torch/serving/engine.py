"""ServingEngine: continuous-batching inference over a compiled FFModel.

Port of ``flexflow_tpu.serving.engine`` for the paged KV pool
(``kv_cache="paged"``) in the model dtype or int8 (``--kv-dtype``), the
radix prefix cache with its chunk-prefill step, optional chunked prefill
(``--prefill-chunk-tokens``), the synchronous serve loop, one sequence
shard, and greedy or top-k temperature sampling. Each tick performs one
scheduler action: a one-shot prefill, one prefill chunk, or one decode step
that advances every live slot by a token. The decode step is the
executor's captured program (``Executor.make_decode_step``; on CUDA one
CUDA graph per engine, replayed every step over the persistent token
buffer, lengths, block tables and pools, which every action writes in
place; ``decode_compiles`` counts its captures). Its attention read
is the flash-decode kernel (``kernels/flash_decode.py``, its int8 branch
for int8 pools); the sampler's top-k goes through the row top-k kernel
(``kernels/topk.py``) where the JAX sampler takes its Pallas kernel.

Options outside this slice raise ``NotImplementedError`` naming the flag;
none falls back quietly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..ffconst import DataType, OperatorType
from .kvcache import DecodeState
from .scheduler import ContinuousBatchScheduler, Request, default_buckets


def _later_slice(flag: str) -> NotImplementedError:
    return NotImplementedError(
        f"{flag} is ported in a later slice of flexflow_tpu_torch; this "
        "slice serves the paged-KV sync loop")


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
    queue_depth_hwm: int = 0
    # analytic KV bytes the decode steps' attention read (each live slot's
    # occupied blocks, at the pool's layout)
    kv_bytes_read: int = 0
    wall_s: float = 0.0
    # per-token latency: decode tokens carry their step wall, first tokens
    # their prefill wall
    token_walls_s: List[float] = dataclasses.field(default_factory=list)

    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0

    def p50_token_ms(self) -> Optional[float]:
        if not self.token_walls_s:
            return None
        return float(np.percentile(self.token_walls_s, 50) * 1e3)

    def p99_token_ms(self) -> Optional[float]:
        if not self.token_walls_s:
            return None
        return float(np.percentile(self.token_walls_s, 99) * 1e3)

    def kv_bytes_per_token(self) -> Optional[float]:
        if not self.tokens_generated or not self.kv_bytes_read:
            return None
        return self.kv_bytes_read / self.tokens_generated

    def summary(self) -> Dict[str, Any]:
        out = {k: getattr(self, k) for k in (
            "requests_served", "tokens_generated", "prefills",
            "decode_steps", "chunked_prefills", "prefix_hits",
            "prefix_tokens_reused", "prefill_tokens_computed",
            "queue_depth_hwm")}
        out["wall_s"] = self.wall_s
        out["tokens_per_s"] = self.tokens_per_s()
        out["p50_token_ms"] = self.p50_token_ms()
        out["p99_token_ms"] = self.p99_token_ms()
        kvpt = self.kv_bytes_per_token()
        if kvpt is not None:
            out["kv_bytes_per_token"] = round(kvpt, 1)
        return out


class ServingEngine:
    """Inference engine over a compiled autoregressive FFModel (causal
    self-attention as the only sequence-stateful op, a per-token final
    output ``(batch, seq, vocab)``, and one integer token input)."""

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
        from .kvcache import KV_DTYPES, blocks_per_slot, parse_context_buckets
        from .scheduler import BlockAllocator

        if model.executor is None:
            raise RuntimeError("call model.compile() first")
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
        if self.serve_loop != "sync":
            raise _later_slice(f"serve_loop={self.serve_loop!r} "
                               "(--serve-loop)")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got "
                             f"{self.kv_dtype!r}")
        if self.kv_cache not in ("paged", "ring"):
            raise ValueError(f"kv_cache must be 'paged' or 'ring', got "
                             f"{self.kv_cache!r}")
        if self.kv_cache == "ring" and self.kv_dtype != "native":
            raise ValueError("kv_dtype='int8' requires the paged KV layout "
                             "(kv_cache='paged')")
        if self.kv_cache != "paged":
            raise _later_slice(f"kv_cache={self.kv_cache!r} (--kv-cache)")
        if self.seq_shards != 1:
            raise _later_slice(f"seq_shards={self.seq_shards} "
                               "(--seq-shards)")
        if buckets_ctx:
            raise _later_slice("context_buckets (--context-buckets)")
        if getattr(cfg, "request_journal", ""):
            raise _later_slice("the request journal (--request-journal)")
        if getattr(cfg, "request_timeout_ms", 0) or \
                getattr(cfg, "shed_policy", "off") != "off":
            raise _later_slice("serving resilience (--request-timeout-ms, "
                               "--shed-policy)")
        # their defaults are live settings of the JAX loop (the SIGTERM
        # drain and the decode guard), so only a value given on the
        # command line is refused
        for flag in ("--drain-grace-s", "--decode-retry-budget"):
            if flag in getattr(cfg, "flags_given", ()):
                raise _later_slice(f"{flag} (serving resilience)")
        self.kv_block_size = int(kv_block_size or
                                 getattr(cfg, "kv_block_size", 16))
        self.prefill_chunk_tokens = int(
            prefill_chunk_tokens if prefill_chunk_tokens is not None
            else getattr(cfg, "prefill_chunk_tokens", 0) or 0)
        if self.prefill_chunk_tokens % self.kv_block_size:
            raise ValueError(
                f"prefill_chunk_tokens ({self.prefill_chunk_tokens}) must "
                f"be a multiple of kv_block_size ({self.kv_block_size})")
        prefix_mode = str(prefix_cache or
                          getattr(cfg, "prefix_cache", "on") or "on")
        if prefix_mode not in ("on", "off"):
            raise ValueError(
                f"prefix_cache must be 'on' or 'off', got {prefix_mode!r}")
        self._validate_graph()
        self.max_context = position_context_bound(self.executor,
                                                  self.max_decode_len)
        mb = blocks_per_slot(self.max_decode_len, self.kv_block_size)
        self.max_blocks_per_slot = mb
        # full capacity (every slot at max_len) + the garbage block + one
        # live chunk's worth of headroom
        chunk_blocks = -(-self.prefill_chunk_tokens // self.kv_block_size)
        kv_pool_blocks = int(kv_pool_blocks if kv_pool_blocks is not None
                             else getattr(cfg, "kv_pool_blocks", 0))
        self.kv_pool_blocks = kv_pool_blocks or (
            self.n_slots * mb + 1 + chunk_blocks)
        self.block_allocator = BlockAllocator(self.kv_pool_blocks,
                                              self.kv_block_size)
        self._prefix = None
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
        # (decode program, its capture count) when this engine's pools
        # were made: decode_compiles counts from there
        self._decode_captures0: Any = (None, 0)
        self._paged_entry_names: set = set()
        self.stats = ServingStats()

    # ------------------------------------------------------------ validation
    def _validate_graph(self) -> None:
        pcg = self.executor.pcg
        for node in pcg.compute_nodes():
            if node.op.op_type == OperatorType.OP_LSTM:
                raise NotImplementedError(
                    f"{node.name}: LSTM serving, ported in a later slice "
                    "of flexflow_tpu_torch (the recurrent carry as decode "
                    "state); this slice serves causal-attention graphs")
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
    def decode_compiles(self) -> Optional[int]:
        """CUDA graphs the decode program captured for this engine's pools
        (flexflow_tpu/serving/engine.py:559-575): exactly 1 after warm-up
        for the whole of a generate — prefix hits, chunk prefill, slot
        reuse and copy-on-write write the captured buffers in place. None
        on the CPU, where nothing is captured, and before the first
        decode."""
        if self.device.type != "cuda" or self.state is None:
            return None
        program = getattr(self._decode_fn(), "program", None)
        if program is None:
            return None
        base_program, base = self._decode_captures0
        return program.captures - (base if program is base_program else 0)

    # ------------------------------------------------------------ device fns
    def _decode_fn(self):
        return self.executor.make_decode_step(
            self.max_decode_len, exact=self.exact_decode,
            block_size=self.kv_block_size, kv_dtype=self.kv_dtype,
            capture=self.model._capture_steps)

    def _prefill_fn(self, bucket: int):
        return self.executor.make_prefill_step(bucket, self.max_decode_len)

    def _chunk_fn(self, chunk_shape: int):
        return self.executor.make_chunk_prefill_step(
            int(chunk_shape), self.max_decode_len, self.kv_block_size,
            self.kv_dtype)

    def _ids(self, rows) -> Any:
        import torch

        return torch.as_tensor(np.asarray(rows, np.int32)).to(self.device)

    def _ensure_state(self, prefill_cache) -> None:
        """Allocate the pools lazily from the first prefill's cache
        structure: one zero ``(kv_pool_blocks, h, block_size, hd)`` pool
        per K and V of every attention node (int8: each with its zero
        ``(kv_pool_blocks, h, block_size)`` f32 scale array, the entry
        ``(kq, kscale, vq, vscale)``), all-garbage block tables and zero
        cursors."""
        import torch

        from .kvcache import paged_pool_entry

        if self.state is not None:
            return
        with torch.inference_mode():
            caches = {}
            self._paged_entry_names = set(prefill_cache)
            for name, (kc, vc) in prefill_cache.items():
                kp, vp = (paged_pool_entry(c, self.kv_pool_blocks,
                                           self.kv_block_size, self.kv_dtype)
                          for c in (kc, vc))
                caches[name] = (*kp, *vp) if self.kv_dtype == "int8" \
                    else (kp, vp)
            n = self.n_slots
            self.state = DecodeState(
                caches=caches,
                lengths=torch.zeros((n,), dtype=torch.int32,
                                    device=self.device),
                block_tables=torch.zeros(
                    (n, self.max_blocks_per_slot), dtype=torch.int32,
                    device=self.device))
            self._last_tokens = torch.zeros((n, 1), dtype=torch.int32,
                                            device=self.device)
            program = getattr(self._decode_fn(), "program", None)
            self._decode_captures0 = (
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

    def _write_slot(self, cache, slot: int, length: int, token: int,
                    table_row: np.ndarray) -> None:
        """Insert one prefilled request into the decode batch: scatter its
        k/v rows into its blocks (quantized, with their scales, into an
        int8 pool), set its table row, length cursor and pending first
        token — in place."""
        import torch

        from .kvcache import scatter_prefill_paged

        bs = self.kv_block_size
        with torch.inference_mode():
            row = self._ids(table_row)
            for name in self._paged_entry_names:
                entry = self.state.caches[name]
                kc, vc = cache[name]
                if self.kv_dtype == "int8":
                    kq, ks, vq, vs = entry
                    scatter_prefill_paged(kq, kc, row, bs, scales=ks)
                    scatter_prefill_paged(vq, vc, row, bs, scales=vs)
                else:
                    scatter_prefill_paged(entry[0], kc, row, bs)
                    scatter_prefill_paged(entry[1], vc, row, bs)
            self.state.block_tables[slot] = row
            self.state.lengths[slot] = int(length)
            self._last_tokens[slot, 0] = int(token)

    def _set_slot_meta(self, slot: int, length: int, token: int,
                       table_row: np.ndarray) -> None:
        """Arm a chunk-prefilled slot for decode: the chunks already wrote
        its rows, so only the cursor, table row and first token remain."""
        import torch

        with torch.inference_mode():
            self.state.block_tables[slot] = self._ids(table_row)
            self.state.lengths[slot] = int(length)
            self._last_tokens[slot, 0] = int(token)

    def _clear_slot_tables(self, slot: int) -> None:
        """Reset a freed slot's table row (all GARBAGE) and cursor (0).
        Without it the freed slot's stale row would keep writing its
        discarded tokens into blocks the allocator may already have handed
        to a new request in another slot."""
        import torch

        if self.state is None:
            return
        with torch.inference_mode():
            self.state.block_tables[slot] = 0
            self.state.lengths[slot] = 0

    def _cow_clone(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate pool block ``src`` into ``dst`` in every
        pool (int8 scale arrays included) before the cloner's first
        divergent write."""
        import torch

        if self.state is None:
            return
        with torch.inference_mode():
            for name in self._paged_entry_names:
                for pool in self.state.caches[name]:
                    pool[dst] = pool[src]

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
        occupied blocks (the flash-decode kernel's traffic)."""
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
        sched.allocator = self.block_allocator
        sched.on_slot_freed = self._clear_slot_tables
        sched.prefix = self._prefix
        sched.chunk_tokens = self.prefill_chunk_tokens
        if self.max_context < sched.max_len:
            sched.max_context = self.max_context

    # -------------------------------------------------------------- sampling
    def _sampler(self, temperature: float, top_k: int):
        """``(logits (S, V) fp32, tag_counts (S, 2) host ints, seed) ->
        tokens (S,) int32`` on the device. Greedy when temperature <= 0.
        Otherwise a categorical draw at ``temperature`` over the top-k of
        the raw logits (all of them for ``top_k`` 0), each row drawn from
        its own ``torch.Generator`` seeded from (seed, submission tag,
        tokens emitted) — deterministic under any co-scheduling. As the JAX
        sampler: one top-k over all rows, taken before the division by the
        temperature, through the row top-k kernel (``kernels/topk.py``;
        its plain version on CPU tensors) where the JAX sampler takes its
        Pallas kernel (1 <= k <= 8, vocab a multiple of 128), else
        ``torch.topk``. The streams differ from the JAX engine's
        ``jax.random`` ones."""
        import torch

        from ..kernels.topk import topk, topk_kernel_shape

        if temperature <= 0.0:
            def greedy(logits, tag_counts, seed):
                return torch.argmax(logits, dim=-1).to(torch.int32)
            return greedy
        temp = float(temperature)
        k = int(top_k)

        def sample(logits, tag_counts, seed):
            vals, idx = logits, None
            if k > 0:
                if topk_kernel_shape(logits, k):
                    vals, idx = topk(logits, k)
                else:
                    vals, idx = torch.topk(logits, min(k, logits.shape[-1]),
                                           dim=-1)
            probs = torch.softmax(vals / temp, dim=-1)
            out = torch.empty((logits.shape[0],), dtype=torch.int32,
                              device=logits.device)
            for i in range(logits.shape[0]):
                tag, count = (int(x) for x in tag_counts[i])
                gen = torch.Generator(device=logits.device).manual_seed(
                    (int(seed) * 1_000_003 + tag) * 1_000_003 + count)
                choice = torch.multinomial(probs[i], 1, generator=gen)
                out[i] = (idx[i][choice] if idx is not None else choice)[0]
            return out
        return sample

    # ------------------------------------------------------------- main loop
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, eos_id: Optional[int] = None,
                 seed: int = 0, chaos=None,
                 deadline_ms: Optional[float] = None) -> List[List[int]]:
        """Generate continuations for ``prompts`` (token-id sequences)
        through the continuous-batching loop; returns the generated token
        lists in submission order."""
        if chaos is not None:
            raise _later_slice("chaos injection (generate(chaos=...))")
        if deadline_ms is not None:
            raise _later_slice("request deadlines (deadline_ms)")
        self._token_input_check()
        sched = ContinuousBatchScheduler(
            n_slots=self.n_slots, max_queue=max(len(prompts),
                                                self.max_queue),
            buckets=self.buckets, max_len=self.max_decode_len)
        self._attach(sched)
        reqs = []
        for i, p in enumerate(prompts):
            r = Request(prompt=np.asarray(p, dtype=np.int32),
                        max_new_tokens=max_new_tokens,
                        eos_id=self.eos_id if eos_id is None else eos_id,
                        rng_tag=i)
            sched.submit(r)
            reqs.append(r)
        self.serve(sched, temperature=temperature, top_k=top_k, seed=seed)
        return [list(r.generated) for r in reqs]

    def serve(self, sched: ContinuousBatchScheduler,
              temperature: float = 0.0, top_k: int = 0,
              seed: int = 0) -> ServingStats:
        """Drive the scheduler until its queue and slots drain."""
        import torch

        loop = _ServeLoop(self, sched, temperature=temperature,
                          top_k=top_k, seed=seed)
        with torch.inference_mode():
            while loop.tick():
                pass
        return loop.finish()


class _ServeLoop:
    """One serve() run, advanced one scheduler action per ``tick()``."""

    def __init__(self, engine: ServingEngine,
                 sched: ContinuousBatchScheduler, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        self.engine = engine
        self.sched = sched
        engine._attach(sched)
        self.params = engine.model.params
        self.sampler = engine._sampler(temperature, top_k)
        self.seed = int(seed)
        self.stats = engine.stats = ServingStats()
        self._chunk_walls: Dict[int, float] = {}
        self._prefix_hits0 = sched.prefix_hits
        self._prefix_reused0 = sched.prefix_tokens_reused
        self.t0 = time.perf_counter()

    def _sample_one(self, last, req) -> int:
        tag = req.rng_tag if req.rng_tag is not None else req.rid
        return int(self.sampler(last, [[tag, len(req.generated)]],
                                self.seed)[0])

    def _cache_prompt(self, req, tokens, eff: int) -> None:
        """Eagerly cache the prompt's FULL blocks at prefill completion so
        same-batch shared-prefix admissions already hit."""
        eng = self.engine
        if eng._prefix is not None and req.kv_blocks:
            full = eff // eng.kv_block_size
            if full:
                eng._prefix.insert(tokens[:full * eng.kv_block_size],
                                   req.kv_blocks[:full])

    def tick(self) -> bool:
        """Perform ONE scheduler action; False when there is nothing to
        do."""
        eng, sched, stats = self.engine, self.sched, self.stats
        action = sched.next_action()
        if action is None:
            return False
        if action[0] == "prefill":
            _, req, slot, bucket = action
            t_p = time.perf_counter()
            eff = req.effective_len
            cur = req.current_prompt()
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :eff] = cur
            _logits, last, cache = eng._prefill_fn(bucket)(
                self.params, [eng._ids(ids)], eng._ids([eff]))
            eng._ensure_state(cache)
            tok = self._sample_one(last, req)
            wall = time.perf_counter() - t_p
            stats.prefills += 1
            stats.prefill_tokens_computed += eff
            stats.token_walls_s.append(wall)
            stats.tokens_generated += 1
            if not sched.commit_token(slot, tok):
                eng._write_slot(cache, slot, eff, tok,
                                eng._table_row_for(req))
                req.prefill_pos = req.prefill_target
                self._cache_prompt(req, cur, eff)
            return True
        if action[0] == "prefill_chunk":
            _, req, slot, start, n, shape = action
            t_p = time.perf_counter()
            eng._ensure_state_bootstrap()
            if req.pending_cow is not None:
                src, dst = req.pending_cow
                eng._cow_clone(src, dst)
                sched.release_cow(req)
            cur = req.current_prompt()
            ids = np.zeros((1, shape), np.int32)
            ids[0, :n] = cur[start:start + n]
            row = eng._table_row_for(req)
            last, eng.state = eng._chunk_fn(shape)(
                self.params, [eng._ids(ids)], eng.state, eng._ids(row),
                start, n)
            stats.prefill_tokens_computed += n
            stats.chunked_prefills += 1
            done = sched.chunk_done(slot, n)
            wall = time.perf_counter() - t_p
            self._chunk_walls[req.rid] = \
                self._chunk_walls.get(req.rid, 0.0) + wall
            if not done:
                return True
            eff = req.prefill_target
            tok = self._sample_one(last, req)
            stats.prefills += 1
            stats.token_walls_s.append(self._chunk_walls.pop(req.rid, wall))
            stats.tokens_generated += 1
            self._cache_prompt(req, cur, eff)
            if not sched.commit_token(slot, tok):
                eng._set_slot_meta(slot, eff, tok, row)
            return True
        return self._tick_decode(action[1])

    def _tick_decode(self, live) -> bool:
        """One decode step for every live slot: dispatch, sample on the
        device, one blocking host transfer of the tokens, commit."""
        eng, sched, stats = self.engine, self.sched, self.stats
        t_d = time.perf_counter()
        logits, eng.state = eng._decode_fn()(
            self.params, [eng._last_tokens], eng.state)
        tag_counts = [[0, 0]] * eng.n_slots
        for s, r in live:
            tag_counts[s] = [r.rng_tag if r.rng_tag is not None else r.rid,
                             len(r.generated)]
        toks = self.sampler(logits, tag_counts, self.seed)
        eng._last_tokens.copy_(toks[:, None])
        toks_host = toks.cpu().numpy()
        wall = time.perf_counter() - t_d
        stats.decode_steps += 1
        stats.kv_bytes_read += eng._decode_kv_bytes(live)
        for slot, req in live:
            stats.tokens_generated += 1
            stats.token_walls_s.append(wall)
            sched.commit_token(slot, int(toks_host[slot]))
        return True

    def finish(self) -> ServingStats:
        stats, sched = self.stats, self.sched
        stats.wall_s = time.perf_counter() - self.t0
        stats.requests_served = len(sched.finished)
        stats.queue_depth_hwm = sched.queue_depth_hwm
        stats.prefix_hits = sched.prefix_hits - self._prefix_hits0
        stats.prefix_tokens_reused = \
            sched.prefix_tokens_reused - self._prefix_reused0
        return stats
