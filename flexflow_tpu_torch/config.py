"""Runtime configuration and CLI flag parsing.

A copy of ``flexflow_tpu.config.FFConfig`` for the PyTorch port: the same
fields, the same flag names and the same parse-time validation, so one
command line drives either package (reference: include/flexflow/config.h:93-162
and ``FFConfig::parse_args``, src/runtime/model.cc:~3530-3700). Flags of
features this port does not run yet are still parsed; the entry points that
would act on them raise ``NotImplementedError`` instead of ignoring them.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional, Sequence

from .ffconst import CompMode, DataType


@dataclasses.dataclass
class FFIterationConfig:
    """Per-iteration knobs (reference: config.h:164-169)."""

    seq_length: int = -1

    def reset(self) -> None:
        self.seq_length = -1


@dataclasses.dataclass
class FFConfig:
    """All runtime configuration (reference: config.h:93-162).

    Device terminology: ``workers_per_node`` counts accelerator chips per host
    (the reference's GPUs-per-node); on TPU a "worker" is one chip.
    """

    # training loop
    epochs: int = 1
    batch_size: int = 64
    print_freq: int = 10
    dataset_path: str = ""

    # devices / topology
    num_nodes: int = 1
    workers_per_node: int = 0  # 0 = use all visible devices
    cpus_per_node: int = 1
    device_memory_mb: int = 0  # analog of -ll:fsize; 0 = query from device

    # auto-parallelization search (Unity)
    search_budget: int = -1
    search_alpha: float = 1.05
    search_overlap_backward_update: bool = False
    computation_mode: CompMode = CompMode.COMP_MODE_TRAINING
    only_data_parallel: bool = False
    enable_sample_parallel: bool = True
    enable_parameter_parallel: bool = False
    enable_attribute_parallel: bool = False
    # TPU-native extension: sequence/context parallelism (ring attention) in
    # the search space; no reference analog (SURVEY §5 long-context). Off
    # by default in the port, unlike the JAX package: the port's attention
    # refuses a sequence-parallel plan until ring / Ulysses attention is
    # ported (ROADMAP A.7), so a search that may pick one would turn an
    # unstrategized compile that trains into one that raises
    enable_sequence_parallel: bool = False
    # TPU-native extension: GPipe (pp, dp) grids as search candidates;
    # the reference reserves OP_PIPELINE but ships no schedule
    enable_pipeline_parallel: bool = True
    enable_inplace_optimizations: bool = True
    search_num_nodes: int = -1
    search_num_workers: int = -1
    base_optimize_threshold: int = 10
    enable_control_replication: bool = True
    python_data_loader_type: int = 2

    # fusion & memory search
    perform_fusion: bool = False
    perform_memory_search: bool = False
    # activation rematerialization (--remat): "" lets the Unity memory
    # search choose the level; "none"/"selective"/"full" force one —
    # Executor remat blocks and PipelineTrainer stages alike
    # (execution/remat.py, docs/remat.md)
    remat: str = ""
    # target compute nodes per remat block (blocks cut at graph
    # bottlenecks; ~one transformer layer at the default)
    remat_segment_size: int = 8
    # pipeline schedule (--schedule, ISSUE 10; docs/pipeline.md): "" lets
    # the Unity search sweep the schedule axis; "gpipe"/"1f1b"/
    # "interleaved" force one — the same flag-beats-searched precedence
    # as --remat (parallel.pipeline.resolve_schedule)
    schedule: str = ""
    # virtual stage chunks per pipeline device for the interleaved
    # schedule (Megatron interleaved-1F1B's v); 0 = default (2 when
    # interleaved is chosen)
    pipeline_virtual_stages: int = 0
    # SPMD collective-compute overlap (--collective-overlap, ISSUE 10):
    # "on" splits the step's gradient synchronization into per-remat-block
    # psums issued as each block's backward completes (bitwise-identical
    # loss/grads to the synchronous path — executor._blockwise_value_and_
    # grad); "off" keeps the synchronous all-reduces at step end
    collective_overlap: str = "off"

    # multi-pod topology + hierarchical search (docs/multipod.md;
    # ISSUE 15). --pods N splits the machine into N DCN-connected pods
    # (each one ICI domain; 0 = keep the detected/parsed topology);
    # --dcn-gbps overrides the per-pod DCN bandwidth in GB/s
    num_pods: int = 0
    dcn_gbps: float = 0.0
    # two-level DCN x ICI strategy search: "auto" (default — on for
    # multi-pod machines at >= 64 chips), "on" (force the decomposition),
    # "off" (always the flat factorization sweep)
    search_hierarchical: str = "auto"

    # machine model for the simulator
    machine_model_version: int = 0
    machine_model_file: str = ""
    simulator_work_space_size: int = 2 * 1024 * 1024 * 1024
    simulator_segment_size: int = 16777216
    simulator_max_num_segments: int = 1

    # strategy import/export (reference: config.h:143-148)
    import_strategy_file: str = ""
    export_strategy_file: str = ""
    export_strategy_task_graph_file: str = ""
    export_strategy_computation_graph_file: str = ""
    include_costs_dot_graph: bool = False
    substitution_json_path: Optional[str] = None

    # observability
    profiling: bool = False
    # Legion Prof analog (-lg:prof / -lg:prof_logfile): when set, fit() runs
    # under jax.profiler.trace writing an XLA/TensorBoard trace here
    profiler_trace_dir: str = ""
    # obs subsystem (flexflow_tpu/obs): Chrome trace-event JSON of host-side
    # phases (compile / step / epoch / eval / search), Perfetto-loadable
    trace_file: str = ""
    # per-run training telemetry JSON (step walls, loss history, compile vs
    # steady split, samples/sec, estimated MFU, XLA peak memory)
    telemetry_file: str = ""
    # Unity/MCMC per-iteration JSONL log (candidate cost, accept/reject,
    # temperature, best-so-far) — mirrors the strategy-export workflow
    search_log_file: str = ""
    perform_auto_mapping: bool = False
    # numerical-safety checks — the TPU analog of the reference's reliance on
    # Legion region coherence for race freedom (SURVEY §5: XLA purity plays
    # that role; this adds jax_debug_nans on top)
    debug_nans: bool = False

    # fault tolerance (flexflow_tpu/resilience, docs/fault_tolerance.md).
    # The reference inherits resilience from Legion's task runtime; here it
    # is a first-class subsystem: preemption-safe async checkpoints,
    # divergence sentinels with rollback, elastic degraded-mesh restart.
    checkpoint_dir: str = ""     # atomic committed checkpoints land here
    checkpoint_every: int = 0    # steps between async checkpoints; 0 = off
    keep_checkpoints: int = 3    # retention: newest N committed kept
    # divergence sentinel: after this many CONSECUTIVE non-finite steps
    # (NaN/Inf loss or grad) auto-restore the last committed checkpoint;
    # 0 disables guarding (no per-step scalar transfer)
    max_bad_steps: int = 0
    # "auto" resumes from the newest committed checkpoint in
    # checkpoint_dir; a path resumes from exactly that checkpoint
    resume: str = ""
    # reduced-LR escape hatch: LR multiplier applied when divergence
    # persists past the first rollback; hard stop after max_rollbacks
    rollback_lr_factor: float = 0.5
    max_rollbacks: int = 3

    # strategy safety (flexflow_tpu/resilience/fallback.py + audit.py,
    # docs/strategy_safety.md). "on" lets a failed strategy degrade through
    # the search's ranked candidates -> dp+full-remat; "off" turns any
    # verification failure into an immediate error. The verification pass
    # only runs when it has something to check (audit / memory budget /
    # chaos injection), so plain fits pay nothing.
    strategy_fallback: str = "on"
    # parallel-correctness audit: one probe batch under the live strategy
    # vs a single-device reference; loss and grad-norm must agree within
    # audit_tol relative error
    audit_strategy: bool = False
    audit_tol: float = 0.05
    # compile-time OOM gate: XLA's compiled peak for the train step must
    # fit this many MiB (0 = disabled; the -ll:fsize analog for the
    # fallback cascade rather than the search)
    memory_budget_mb: int = 0
    # ShardLint static analysis (flexflow_tpu/analysis,
    # docs/static_analysis.md; ISSUE 7). "on" (default): stage 0 of the
    # fallback cascade, candidate pruning in the Unity search, and the
    # pre-serve FF005 check. "strict": additionally analyze EVERY compiled
    # strategy (explicit/imported/searched) and refuse on errors. "off":
    # dynamic checks only (the pre-ISSUE 7 behavior).
    static_analysis: str = "on"

    # closed-loop calibration (flexflow_tpu/obs/drift.py +
    # search/calibration.py, docs/calibration.md; ISSUE 8).
    # --profile-ops PATH arms the ProfiledStep pass: fit() times every
    # distinct op shape on device, streams OpRecords to PATH (JSONL) and
    # feeds the drift sentinel (sim-vs-measured per op-cost cache key)
    profile_ops: str = ""
    # drift band half-width: a key whose rolling measured/predicted ratio
    # leaves [1/(1+tol), 1+tol] raises calibration_drift events and counts
    # in the telemetry "calibration" block
    drift_tolerance: float = 0.25
    # opt-in closed loop: out-of-band drift triggers
    # Simulator.calibrate_from_profile (per-key repair, exact delta-cost
    # cache invalidation), table persistence, and a top-K re-rank
    auto_recalibrate: bool = False
    # replay a --profile-ops JSONL into the search simulator's calibration
    # before searching (and into the fit sentinel's sim)
    calibrate_from_trace: str = ""
    # persistent calibration store: one JSON table per (chip generation,
    # compute dtype), merged across runs so a fleet shares measurements
    calibration_dir: str = ""

    # serving engine (flexflow_tpu/serving, docs/serving.md; ISSUE 6).
    # The reference's only inference artifact is an incomplete Triton
    # prototype — these knobs drive the JAX serving path instead.
    serve: bool = False          # run the examples' serve mode after compile
    # decode-state ring-buffer capacity per slot: prompt + generated tokens
    # must fit; also the largest prefill bucket
    max_decode_len: int = 128
    # continuous-batching decode slots (the in-flight request ceiling);
    # also the serving search's total-slot budget
    max_inflight: int = 8
    # serving-objective SLO: simulated p99 per-token latency bound (ms) for
    # search_all(objective="serving"); 0 = throughput-only
    slo_p99_ms: float = 0.0
    # paged KV cache (flexflow_tpu/serving/kvcache.py, docs/serving.md
    # "Paged KV cache" + docs/decode_perf.md; ISSUE 12).
    # KV-cache layout: "paged" (block pool + per-slot block tables —
    # slot recycling is pointer bookkeeping, decode attention reads
    # O(true_length) through the flash-decode kernel) or "ring" (the
    # legacy per-slot max_len buffers)
    kv_cache: str = "paged"
    # tokens per KV block of the paged layout
    kv_block_size: int = 16
    # paged pool size in blocks (incl. the reserved garbage block);
    # 0 = auto (every slot can hold max_decode_len). Setting it smaller
    # decouples pool occupancy from max_decode_len: admission then waits
    # on free BLOCKS, not just free slots
    kv_pool_blocks: int = 0
    # KV storage dtype: "native" (model dtype; also lets the serving
    # search sweep the int8 axis) or "int8" (pin symmetric per-(token,
    # head) int8 with f32 scales — ~1/el the decode KV bandwidth, judged
    # against a pinned tolerance band instead of the bitwise contract)
    kv_dtype: str = "native"
    # prefix cache + chunked prefill (flexflow_tpu/serving/prefix.py,
    # docs/serving.md "Prefix cache & chunked prefill"; ISSUE 14).
    # Radix-tree prefix reuse over the paged pool: requests sharing a
    # cached prompt prefix (>= one full KV block) map its blocks into
    # their block table with zero prefill compute and prefill only the
    # suffix. "on" (default; paged, attention-only graphs) or "off".
    # The hit path is bitwise the cold path, so enabling it changes no
    # emitted token.
    prefix_cache: str = "on"
    # chunked prefill: prompts/suffixes longer than this many tokens
    # prefill in fixed chunks co-scheduled with decode iterations, so a
    # long prompt stops head-of-line-blocking the continuous batch.
    # Must be a whole number of KV blocks (FF006); 0 = off (one-shot
    # prefill, the legacy behavior).
    prefill_chunk_tokens: int = 0
    # steady-state cap (in pool blocks) on what the prefix trie may
    # retain; 0 = unbounded (LRU eviction still runs under pool
    # pressure either way)
    prefix_cache_blocks: int = 0
    # serving resilience (flexflow_tpu/serving/resilience.py,
    # docs/serving.md "Serving under failure"; ISSUE 9).
    # Per-request completion deadline (ms from submission) defaulted onto
    # every request without an explicit Request.deadline_ms; expired
    # requests are evicted (outcome deadline_exceeded). 0 = no deadline.
    request_timeout_ms: float = 0.0
    # load shedding at admission: "off" (bounded queue only), "deadline"
    # (shed when the EWMA completion estimate blows the request deadline),
    # "queue" (shed at the max_queue//2 high-water mark). Shed requests get
    # a typed OverloadError with a retry_after_ms hint.
    shed_policy: str = "off"
    # graceful SIGTERM drain: in-flight requests may finish for this many
    # seconds before stragglers are evicted as preempted; queued requests
    # are handed back for re-submission either way
    drain_grace_s: float = 5.0
    # decode-health sentinel: retries per request after a quarantined
    # (non-finite) decode slot before the request aborts as decode_fault
    decode_retry_budget: int = 1
    # serve-loop runtime (ISSUE 17, docs/serving.md "Async runtime"):
    # "sync" (reference: block on step k's tokens before dispatching
    # k+1) or "async" (double-buffered: dispatch k+1 while k's transfer
    # is in flight, commit at arrival — bitwise the sync streams under
    # exact decode, at a lower host_overhead_fraction)
    serve_loop: str = "sync"
    # sequence-parallel decode (flexflow_tpu/kernels/seqpar_decode.py,
    # docs/decode_perf.md "Sequence-parallel decode"; ISSUE 18): number
    # of contiguous block-table shards a slot's KV extent is scored
    # across per decode step — the capacity axis for contexts whose
    # paged KV exceeds one chip's HBM. 1 = unsharded (the reference
    # path); requires the paged layout; refused by speculative decoding
    # (SeqShardsError)
    seq_shards: int = 1
    # context-length buckets the serving search prices seq_shards for
    # ("1024,4096,16384" — strictly ascending token counts; admission
    # routes each request to the smallest covering bucket). Empty = no
    # bucketing (one shard width for everything)
    context_buckets: str = ""
    # serving fleet (flexflow_tpu/serving/fleet.py, docs/fleet.md;
    # ISSUE 11). Replica count of the multi-replica router: N independent
    # fault domains behind load-aware dispatch with health-checked
    # failover; 0 = single-engine serving (no fleet layer)
    fleet_replicas: int = 0
    # hedged retries: launch a bounded hedge on a second replica once a
    # request's wait exceeds this percent of its EWMA-predicted service
    # time (first new committed token wins, loser cancelled); 0 = off
    hedge_after_pctl: float = 0.0
    # active health probes: probe-decode every live replica every N fleet
    # ticks (half-open circuit probes run on their own backoff schedule
    # regardless); 0 disables the periodic probe
    health_probe_every: int = 16
    # circuit breaker: consecutive per-replica failures (decode
    # quarantines, dispatch timeouts, failed probes) before the
    # replica's circuit opens and it stops receiving dispatches
    circuit_open_after: int = 3
    # multi-tenant SLO tiers (flexflow_tpu/serving/tenancy.py,
    # docs/multitenant.md; ISSUE 19): override/extend the built-in
    # interactive|standard|batch registry with comma-separated
    # NAME:WEIGHT[:DEADLINE_MS[:QUOTA_TOKENS_PER_S]] entries; empty =
    # the built-in tiers
    tenant_tiers: str = ""
    # backlog-forecast autoscaler on the serving fleet: "on" grows the
    # replica pool when the backlog-EWMA forecast blows the tightest
    # tier SLO and shrinks through migrate-and-drain; "off" (default)
    # keeps the pool fixed
    autoscale: str = "off"
    # autoscaler pool bounds (only meaningful with --autoscale on):
    # 0 = default to the initial fleet size / twice it
    min_replicas: int = 0
    max_replicas: int = 0
    # crash-durable serving (flexflow_tpu/serving/journal.py,
    # docs/durability.md; ISSUE 20). Directory for the fleet door's
    # write-ahead request journal: submits/progress/outcomes survive a
    # process crash and ServingFleet.recover() replays the unfinished
    # backlog. Empty (default) = journal off, allocation-free hot path
    request_journal: str = ""
    # group-commit window in ms: buffered journal records are
    # flushed+fsynced at most once per window (0 = every record is its
    # own fsync — maximum durability, maximum overhead)
    journal_sync_ms: float = 0.0
    # journal a progress record once a stream accumulates this many
    # committed tokens (0 = submits/outcomes only; recovery restarts
    # unfinished streams from token zero)
    journal_commit_every: int = 0

    # TPU-native knobs (no reference analog)
    mesh_shape: Optional[Sequence[int]] = None  # e.g. (8,) or (4, 2)
    mesh_axis_names: Sequence[str] = ("data", "model")
    allow_mixed_precision: bool = True  # bf16 compute where safe
    # compute (activation/matmul) dtype for the jitted step; DT_NONE = follow
    # tensor dtypes. Master weights, loss, and normalization stay float32 —
    # the standard TPU mixed-precision recipe (bf16 on the MXU).
    compute_dtype: DataType = DataType.DT_NONE
    seed: int = 42

    iteration_config: FFIterationConfig = dataclasses.field(
        default_factory=FFIterationConfig
    )

    def __post_init__(self) -> None:
        # under pytest the process argv belongs to the test runner, whose
        # flags collide with ours (pytest's ``-p no:cacheprovider`` would be
        # read as ``--print-freq``); argv[0] basename alone misses
        # ``python -m pytest`` (argv[0] is .../pytest/__main__.py). Only
        # argv[0] is consulted — env markers (PYTEST_CURRENT_TEST) inherit
        # into subprocesses a test launches, and those are real production
        # processes whose flags must parse; same for ``"pytest" in
        # sys.modules``, true in anything that imports pytest transitively
        a0 = sys.argv[0]
        under_pytest = ("pytest" in os.path.basename(a0)
                        or a0.replace(os.sep, "/").endswith(
                            ("pytest/__main__.py", "py.test")))
        argv = sys.argv[1:] if not under_pytest else []
        self.parse_args(argv)
        if self.workers_per_node == 0:
            import torch

            self.workers_per_node = max(
                1, torch.cuda.device_count() // self.num_nodes)

    # -- reference-compatible flag parsing (model.cc:~3530-3700) ---------------
    def parse_args(self, argv: List[str]) -> None:
        seen = set()  # our recognized flags present in THIS argv, for the
        # cross-flag validation below (order-independent, and programmatic
        # attribute assignment stays unvalidated-by-parse on purpose)
        i = 0
        while i < len(argv):
            a = argv[i]
            if a.startswith("-"):
                seen.add(a)

            def _next() -> str:
                nonlocal i
                i += 1
                if i >= len(argv):
                    raise ValueError(f"flag {a} expects a value")
                return argv[i]

            if a in ("-e", "--epochs"):
                self.epochs = int(_next())
            elif a in ("-b", "--batch-size"):
                self.batch_size = int(_next())
            elif a in ("-p", "--print-freq"):
                self.print_freq = int(_next())
            elif a in ("-d", "--dataset"):
                self.dataset_path = _next()
            elif a == "--budget" or a == "--search-budget":
                self.search_budget = int(_next())
            elif a == "--alpha" or a == "--search-alpha":
                self.search_alpha = float(_next())
            elif a == "--only-data-parallel":
                self.only_data_parallel = True
            elif a == "--enable-parameter-parallel":
                self.enable_parameter_parallel = True
            elif a == "--enable-attribute-parallel":
                self.enable_attribute_parallel = True
            elif a == "--disable-sequence-parallel":
                self.enable_sequence_parallel = False
            elif a == "--disable-pipeline-parallel":
                self.enable_pipeline_parallel = False
            elif a == "--fusion":
                self.perform_fusion = True
            elif a == "--memory-search":
                self.perform_memory_search = True
            elif a == "--remat":
                v = _next()
                if v not in ("none", "selective", "full"):
                    raise ValueError(
                        f"--remat expects none|selective|full, got {v!r}")
                self.remat = v
            elif a == "--remat-segment-size":
                self.remat_segment_size = int(_next())
            elif a == "--schedule":
                v = _next()
                if v not in ("gpipe", "1f1b", "interleaved"):
                    raise ValueError(
                        f"--schedule expects gpipe|1f1b|interleaved, "
                        f"got {v!r}")
                self.schedule = v
            elif a == "--virtual-stages":
                self.pipeline_virtual_stages = int(_next())
            elif a == "--collective-overlap":
                v = _next()
                if v not in ("on", "off"):
                    raise ValueError(
                        f"--collective-overlap expects on|off, got {v!r}")
                self.collective_overlap = v
            elif a == "--overlap":
                self.search_overlap_backward_update = True
            elif a == "--import" or a == "--import-strategy":
                self.import_strategy_file = _next()
            elif a == "--export" or a == "--export-strategy":
                self.export_strategy_file = _next()
            elif a == "--pods":
                self.num_pods = int(_next())
            elif a == "--dcn-gbps":
                self.dcn_gbps = float(_next())
            elif a == "--hierarchical-search":
                v = _next()
                if v not in ("auto", "on", "off"):
                    raise ValueError(
                        f"--hierarchical-search expects auto|on|off, "
                        f"got {v!r}")
                self.search_hierarchical = v
            elif a == "--machine-model-version":
                self.machine_model_version = int(_next())
            elif a == "--machine-model-file":
                self.machine_model_file = _next()
            elif a == "--simulator-workspace-size":
                self.simulator_work_space_size = int(_next())
            elif a == "--substitution-json":
                self.substitution_json_path = _next()
            elif a == "--search-num-nodes":
                self.search_num_nodes = int(_next())
            elif a == "--search-num-workers":
                self.search_num_workers = int(_next())
            elif a == "--base-optimize-threshold":
                self.base_optimize_threshold = int(_next())
            elif a == "--compute-dtype":
                from .ffconst import str_to_dtype

                self.compute_dtype = str_to_dtype(_next())
            elif a == "--enable-propagation":
                pass  # legacy MCMC propagation; accepted for compatibility
            elif a == "--disable-control-replication":
                self.enable_control_replication = False
            elif a == "--nodes":
                self.num_nodes = int(_next())
            elif a == "--profiling":
                self.profiling = True
            elif a == "--debug-nans":
                self.debug_nans = True
            elif a == "--checkpoint-dir":
                self.checkpoint_dir = _next()
            elif a == "--checkpoint-every":
                self.checkpoint_every = int(_next())
            elif a == "--keep-checkpoints":
                self.keep_checkpoints = int(_next())
            elif a == "--max-bad-steps":
                self.max_bad_steps = int(_next())
            elif a == "--resume":
                self.resume = _next()
            elif a == "--strategy-fallback":
                v = _next()
                if v not in ("on", "off"):
                    raise ValueError(
                        f"--strategy-fallback expects on|off, got {v!r}")
                self.strategy_fallback = v
            elif a == "--audit-strategy":
                self.audit_strategy = True
            elif a == "--audit-tol":
                self.audit_tol = float(_next())
            elif a == "--memory-budget-mb":
                self.memory_budget_mb = int(_next())
            elif a == "--static-analysis":
                v = _next()
                if v not in ("on", "off", "strict"):
                    raise ValueError(
                        f"--static-analysis expects on|off|strict, got "
                        f"{v!r}")
                self.static_analysis = v
            elif a == "--profile-ops":
                self.profile_ops = _next()
            elif a == "--drift-tolerance":
                self.drift_tolerance = float(_next())
            elif a == "--auto-recalibrate":
                self.auto_recalibrate = True
            elif a == "--calibrate-from-trace":
                self.calibrate_from_trace = _next()
            elif a == "--calibration-dir":
                self.calibration_dir = _next()
            elif a == "--serve":
                self.serve = True
            elif a == "--max-decode-len":
                self.max_decode_len = int(_next())
            elif a == "--max-inflight":
                self.max_inflight = int(_next())
            elif a == "--slo-p99-ms":
                self.slo_p99_ms = float(_next())
            elif a == "--kv-cache":
                v = _next()
                if v not in ("paged", "ring"):
                    raise ValueError(
                        f"--kv-cache expects paged|ring, got {v!r}")
                self.kv_cache = v
            elif a == "--kv-block-size":
                self.kv_block_size = int(_next())
            elif a == "--kv-pool-blocks":
                self.kv_pool_blocks = int(_next())
            elif a == "--kv-dtype":
                v = _next()
                if v not in ("native", "int8"):
                    raise ValueError(
                        f"--kv-dtype expects native|int8, got {v!r}")
                self.kv_dtype = v
            elif a == "--prefix-cache":
                v = _next()
                if v not in ("on", "off"):
                    raise ValueError(
                        f"--prefix-cache expects on|off, got {v!r}")
                self.prefix_cache = v
            elif a == "--prefill-chunk-tokens":
                self.prefill_chunk_tokens = int(_next())
            elif a == "--prefix-cache-blocks":
                self.prefix_cache_blocks = int(_next())
            elif a == "--request-timeout-ms":
                self.request_timeout_ms = float(_next())
            elif a == "--shed-policy":
                v = _next()
                if v not in ("off", "deadline", "queue"):
                    raise ValueError(
                        f"--shed-policy expects off|deadline|queue, got "
                        f"{v!r}")
                self.shed_policy = v
            elif a == "--drain-grace-s":
                self.drain_grace_s = float(_next())
            elif a == "--decode-retry-budget":
                self.decode_retry_budget = int(_next())
            elif a == "--serve-loop":
                v = _next()
                if v not in ("sync", "async"):
                    raise ValueError(
                        f"--serve-loop expects sync|async, got {v!r}")
                self.serve_loop = v
            elif a == "--seq-shards":
                self.seq_shards = int(_next())
                if self.seq_shards < 1:
                    raise ValueError(
                        f"--seq-shards expects an integer >= 1, got "
                        f"{self.seq_shards}")
            elif a == "--context-buckets":
                from .serving.kvcache import parse_context_buckets

                v = _next()
                parse_context_buckets(v)  # fail fast at parse time
                self.context_buckets = v
            elif a == "--fleet-replicas":
                self.fleet_replicas = int(_next())
            elif a == "--hedge-after-pctl":
                self.hedge_after_pctl = float(_next())
            elif a == "--health-probe-every":
                self.health_probe_every = int(_next())
            elif a == "--circuit-open-after":
                self.circuit_open_after = int(_next())
            elif a == "--tenant-tiers":
                from .serving.tenancy import parse_tenant_tiers

                v = _next()
                parse_tenant_tiers(v)  # fail fast at parse time
                self.tenant_tiers = v
            elif a == "--autoscale":
                v = _next()
                if v not in ("on", "off"):
                    raise ValueError(
                        f"--autoscale expects on|off, got {v!r}")
                self.autoscale = v
            elif a == "--min-replicas":
                self.min_replicas = int(_next())
            elif a == "--max-replicas":
                self.max_replicas = int(_next())
            elif a == "--request-journal":
                self.request_journal = _next()
            elif a == "--journal-sync-ms":
                v = float(_next())
                if v < 0:
                    raise ValueError(
                        f"--journal-sync-ms must be >= 0, got {v:g}")
                self.journal_sync_ms = v
            elif a == "--journal-commit-every":
                v = int(_next())
                if v < 0:
                    raise ValueError(
                        f"--journal-commit-every must be >= 0, got {v}")
                self.journal_commit_every = v
            elif a == "--rollback-lr-factor":
                self.rollback_lr_factor = float(_next())
            elif a == "--max-rollbacks":
                self.max_rollbacks = int(_next())
            elif a == "--taskgraph":
                self.export_strategy_task_graph_file = _next()
            elif a == "--include-costs-dot-graph":
                self.include_costs_dot_graph = True
            elif a == "--compgraph":
                self.export_strategy_computation_graph_file = _next()
            elif a == "-ll:gpu" or a == "-ll:tpu":
                self.workers_per_node = int(_next())
            elif a == "-ll:cpu":
                self.cpus_per_node = int(_next())
            elif a == "-ll:fsize":
                self.device_memory_mb = int(_next())
            elif a in ("-ll:zsize", "-ll:util", "-ll:py", "-lg:prof"):
                _next()  # accepted and ignored
            elif a in ("--profiler-trace", "-lg:prof_logfile"):
                # Legion Prof analog: dump a jax.profiler (XLA/TensorBoard)
                # trace of the training loop to this directory
                self.profiler_trace_dir = _next()
            elif a == "--trace-file":
                self.trace_file = _next()
            elif a == "--telemetry-file":
                self.telemetry_file = _next()
            elif a in ("--search-log", "--search-log-file"):
                self.search_log_file = _next()
            elif a == "--seed":
                self.seed = int(_next())
            elif a == "--mesh-shape":
                self.mesh_shape = tuple(int(x) for x in _next().split("x"))
            # unrecognized flags are ignored, matching the reference's behavior
            i += 1
        self._validate_flag_combos(seen)

    def _validate_flag_combos(self, seen: set) -> None:
        """Fail fast at parse time on flag combinations that would
        otherwise die mid-run with a far worse error (ISSUE 5 satellite).
        Only flags present in the parsed argv are judged — programmatic
        attribute assignment is validated later by
        ``resilience.preflight.preflight_config`` at compile."""
        if "--audit-tol" in seen and not self.audit_strategy:
            raise ValueError(
                "--audit-tol is only meaningful with --audit-strategy; add "
                "--audit-strategy or drop --audit-tol")
        if "--audit-tol" in seen and self.audit_tol <= 0:
            raise ValueError(
                f"--audit-tol must be > 0 (got {self.audit_tol}): it is "
                "the relative loss/grad-norm error budget of the audit")
        if "--keep-checkpoints" in seen and self.keep_checkpoints < 1:
            raise ValueError(
                f"--keep-checkpoints must keep at least 1 committed "
                f"checkpoint (got {self.keep_checkpoints}); retention 0 "
                "would delete the checkpoint --resume and rollback need")
        if "--memory-budget-mb" in seen and self.memory_budget_mb < 0:
            raise ValueError(
                f"--memory-budget-mb must be >= 0 (got "
                f"{self.memory_budget_mb}); 0 disables the check")
        if "--max-decode-len" in seen and self.max_decode_len < 1:
            raise ValueError(
                f"--max-decode-len must be >= 1 (got "
                f"{self.max_decode_len}): it is the decode ring-buffer "
                "capacity every prompt + generation must fit")
        if "--max-inflight" in seen and self.max_inflight < 1:
            raise ValueError(
                f"--max-inflight must be >= 1 (got {self.max_inflight}): "
                "the serving engine needs at least one decode slot")
        if "--slo-p99-ms" in seen and self.slo_p99_ms < 0:
            raise ValueError(
                f"--slo-p99-ms must be >= 0 (got {self.slo_p99_ms}); "
                "0 disables the latency bound")
        if "--kv-block-size" in seen and self.kv_block_size < 1:
            raise ValueError(
                f"--kv-block-size must be >= 1 (got "
                f"{self.kv_block_size}): it is the token granularity of "
                "the paged KV pool")
        if "--kv-pool-blocks" in seen and self.kv_pool_blocks < 0:
            raise ValueError(
                f"--kv-pool-blocks must be >= 0 (got "
                f"{self.kv_pool_blocks}); 0 sizes the pool automatically "
                "(every slot can hold max_decode_len)")
        if "--kv-pool-blocks" in seen and self.kv_cache == "ring":
            raise ValueError(
                "--kv-pool-blocks is only meaningful with --kv-cache "
                "paged; drop it or switch the layout")
        if "--kv-dtype" in seen and self.kv_dtype != "native" and \
                self.kv_cache == "ring":
            raise ValueError(
                "--kv-dtype int8 requires --kv-cache paged (the ring "
                "layout stores the model dtype only)")
        if "--prefix-cache" in seen and self.prefix_cache == "on" and \
                self.kv_cache == "ring":
            raise ValueError(
                "--prefix-cache on requires --kv-cache paged (the ring "
                "layout has no shared block pool to map a cached prefix "
                "into)")
        if "--prefill-chunk-tokens" in seen:
            if self.prefill_chunk_tokens < 0:
                raise ValueError(
                    f"--prefill-chunk-tokens must be >= 0 (got "
                    f"{self.prefill_chunk_tokens}); 0 disables chunked "
                    "prefill (one-shot prompts)")
            if self.prefill_chunk_tokens and self.kv_cache == "ring":
                raise ValueError(
                    "--prefill-chunk-tokens requires --kv-cache paged "
                    "(chunks write into the block pool)")
            if self.prefill_chunk_tokens % max(self.kv_block_size, 1):
                raise ValueError(
                    f"--prefill-chunk-tokens ({self.prefill_chunk_tokens}"
                    f") must be a multiple of --kv-block-size "
                    f"({self.kv_block_size}) — a chunk boundary inside a "
                    "KV block would split one block's rows across two "
                    "chunk programs (FF006)")
        if "--prefix-cache-blocks" in seen:
            if self.prefix_cache_blocks < 0:
                raise ValueError(
                    f"--prefix-cache-blocks must be >= 0 (got "
                    f"{self.prefix_cache_blocks}); 0 leaves trie "
                    "retention unbounded (pressure eviction still runs)")
            if self.prefix_cache_blocks and self.prefix_cache == "off":
                raise ValueError(
                    "--prefix-cache-blocks is only meaningful with "
                    "--prefix-cache on; drop it or enable the cache")
        if "--request-timeout-ms" in seen and self.request_timeout_ms < 0:
            raise ValueError(
                f"--request-timeout-ms must be >= 0 (got "
                f"{self.request_timeout_ms}); 0 disables per-request "
                "deadlines")
        if "--drain-grace-s" in seen and self.drain_grace_s < 0:
            raise ValueError(
                f"--drain-grace-s must be >= 0 (got {self.drain_grace_s}): "
                "it bounds how long in-flight requests may finish after "
                "SIGTERM (0 = evict immediately)")
        if "--decode-retry-budget" in seen and self.decode_retry_budget < 0:
            raise ValueError(
                f"--decode-retry-budget must be >= 0 (got "
                f"{self.decode_retry_budget}); 0 aborts a poisoned "
                "request on its first quarantined decode")
        if "--seq-shards" in seen and self.seq_shards > 1 and \
                self.kv_cache == "ring":
            raise ValueError(
                "--seq-shards > 1 requires --kv-cache paged (the ring "
                "layout has no block tables to partition into per-shard "
                "contiguous runs)")
        if "--context-buckets" in seen and self.context_buckets and \
                self.kv_cache == "ring":
            raise ValueError(
                "--context-buckets requires --kv-cache paged (buckets "
                "route requests to sequence-sharded block-table "
                "partitions)")
        if "--fleet-replicas" in seen and self.fleet_replicas < 0:
            raise ValueError(
                f"--fleet-replicas must be >= 0 (got "
                f"{self.fleet_replicas}); 0 serves through a single "
                "engine with no fleet layer")
        if "--hedge-after-pctl" in seen and self.hedge_after_pctl < 0:
            raise ValueError(
                f"--hedge-after-pctl must be >= 0 (got "
                f"{self.hedge_after_pctl}): it is the percent of the "
                "EWMA-predicted service time a request may wait before "
                "it is hedged on a second replica (0 disables hedging)")
        if "--health-probe-every" in seen and self.health_probe_every < 0:
            raise ValueError(
                f"--health-probe-every must be >= 0 (got "
                f"{self.health_probe_every}); 0 disables the periodic "
                "probe (half-open circuit probes still run)")
        if "--circuit-open-after" in seen and self.circuit_open_after < 1:
            raise ValueError(
                f"--circuit-open-after must be >= 1 (got "
                f"{self.circuit_open_after}): the circuit opens after "
                "this many consecutive per-replica failures")
        if "--min-replicas" in seen and self.min_replicas < 1:
            raise ValueError(
                f"--min-replicas must be >= 1 (got "
                f"{self.min_replicas}): the autoscaler never shrinks "
                "below this pool size")
        if "--max-replicas" in seen and self.max_replicas < 1:
            raise ValueError(
                f"--max-replicas must be >= 1 (got "
                f"{self.max_replicas}): the autoscaler never grows "
                "past this pool size")
        if ("--min-replicas" in seen or "--max-replicas" in seen) \
                and self.autoscale != "on":
            raise ValueError(
                "--min-replicas/--max-replicas bound the autoscaler's "
                "pool and are only meaningful with --autoscale on")
        if "--min-replicas" in seen and "--max-replicas" in seen \
                and self.max_replicas < self.min_replicas:
            raise ValueError(
                f"--max-replicas ({self.max_replicas}) must be >= "
                f"--min-replicas ({self.min_replicas})")
        if "--request-journal" in seen and not self.request_journal:
            raise ValueError(
                "--request-journal needs a directory path: it is where "
                "the fleet door's write-ahead request journal lives "
                "(docs/durability.md)")
        if ("--journal-sync-ms" in seen or
                "--journal-commit-every" in seen) \
                and not self.request_journal:
            raise ValueError(
                "--journal-sync-ms/--journal-commit-every tune the "
                "write-ahead request journal and are only meaningful "
                "with --request-journal DIR")
        if "--virtual-stages" in seen:
            if self.pipeline_virtual_stages < 2:
                raise ValueError(
                    f"--virtual-stages must be >= 2 (got "
                    f"{self.pipeline_virtual_stages}): v=1 IS the 1f1b "
                    "schedule — drop the flag and use --schedule 1f1b")
            if self.schedule != "interleaved":
                raise ValueError(
                    "--virtual-stages only applies to the interleaved "
                    "schedule; add --schedule interleaved or drop "
                    "--virtual-stages")
        if "--pods" in seen and self.num_pods < 1:
            raise ValueError(
                f"--pods must be >= 1 (got {self.num_pods}): it is the "
                "number of DCN-connected ICI domains the machine is "
                "split into (1 = single pod)")
        if "--dcn-gbps" in seen and self.dcn_gbps <= 0:
            raise ValueError(
                f"--dcn-gbps must be > 0 (got {self.dcn_gbps}): it is "
                "the per-pod cross-DCN bandwidth in GB/s the cost model "
                "prices cross-pod collectives with")
        if "--dcn-gbps" in seen and self.num_pods < 2 and \
                not self.machine_model_file:
            raise ValueError(
                "--dcn-gbps needs a multi-pod topology to apply to: add "
                "--pods N with N >= 2 (or a --machine-model-file with "
                "num_pods)")
        if "--drift-tolerance" in seen and self.drift_tolerance <= 0:
            raise ValueError(
                f"--drift-tolerance must be > 0 (got "
                f"{self.drift_tolerance}): it is the half-width of the "
                "sim-vs-measured band [1/(1+tol), 1+tol] the drift "
                "sentinel alerts on")
        if "--drift-tolerance" in seen and not (self.profile_ops or
                                                self.auto_recalibrate):
            raise ValueError(
                "--drift-tolerance is only meaningful with --profile-ops "
                "(the drift sentinel judges profiled passes); add "
                "--profile-ops PATH or drop --drift-tolerance")
        if "--auto-recalibrate" in seen and not self.profile_ops:
            raise ValueError(
                "--auto-recalibrate needs --profile-ops PATH: the closed "
                "loop repairs calibration from the profiled pass's "
                "measurements")
        if "--calibrate-from-trace" in seen and \
                not os.path.isfile(self.calibrate_from_trace):
            raise ValueError(
                f"--calibrate-from-trace {self.calibrate_from_trace!r}: "
                "no such profile file (produce one with --profile-ops)")
        if "--resume" in seen:
            if self.resume == "auto" and not self.checkpoint_dir:
                raise ValueError(
                    "--resume auto needs --checkpoint-dir to know where "
                    "committed checkpoints live; pass --checkpoint-dir DIR "
                    "or give --resume an explicit step_N checkpoint path")
            if self.resume != "auto" and not os.path.isdir(self.resume):
                raise ValueError(
                    f"--resume {self.resume!r}: no such checkpoint "
                    "directory; pass 'auto' (with --checkpoint-dir) or an "
                    "existing step_N path")

    # -- derived properties -----------------------------------------------------
    def get_current_time(self) -> float:
        """Microsecond wall clock (reference: flexflow_cffi.py:559, the
        Realm timer the examples use for ELAPSED TIME prints)."""
        import time

        return time.perf_counter() * 1e6

    @property
    def total_workers(self) -> int:
        return self.num_nodes * self.workers_per_node

    def numpy_seed(self) -> int:
        return self.seed
