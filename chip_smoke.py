#!/usr/bin/env python3
"""Smoke test of flexflow_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a host with a CUDA GPU and nvcc. It
drives the PyTorch port only (it imports neither jax nor flexflow_tpu).
On CUDA the port's train step and its serving steps (prefill per
bucket, chunk prefill per chunk shape, decode, the sampler per
(temperature, top_k), the slot writes) are captured programs
(``execution/graphs.py``): a shape's first step runs eagerly, its second
is captured as a CUDA graph, later ones replay it, and each replay adds
the captured launches to the kernels' launch counts. Every training and
serving phase below runs them so; their warm-ups take the eager step and
the capture (a serving engine is warmed by two generates of prompts of
the timed prompts' shapes and other tokens, ``warm_serving``, so the
timed generate only replays):

1. build — compiles every CUDA kernel of the port from ``csrc/`` (one
   nvcc per source, all started together) and prints the build seconds
   and, per source, the compiler's register and spill counts (and any
   warning that it serialized wgmma instructions); then a SASS census
   (``cuobjdump -sass``) of each instance of the Hopper flash-attention
   forward, fused and two-pass backward (B1, B2, B3, B4 in bf16 and fp16
   at d 64 and 128: their wgmma ``HGMMA``, TMA load ``UTMALDG`` and, in the
   fused backward, bulk reduce-add ``UBLKRED`` instructions) and of the
   fp32 forward, fused and two-pass backward (B1, B2, B3 and B4 at d 64
   and 128: their ``cp.async`` copies ``LDGSTS`` and 128-bit shared loads
   ``LDS.128``; B2 also its dQ reduce-adds ``REDG``), failing if one is
   missing, beside its registers, spill bytes and dynamic shared memory
   (24 instances); and
   the registers and spill bytes of the flash-decode instances the kernel
   phase times;
2. kernels — holds flash decode (B5), top-k (B7) and softmax (B6) against
   their plain-PyTorch versions on the card, and times kernel, plain
   version and one PyTorch library call computing the same function:
   flash decode (B5) at the shapes GPT-2 small's decode gives it (8 slots,
   12 heads, head_dim 64, block_size 16, 32 blocks per slot, random
   tables, key counts 1..512) in fp32 and bf16, with native pools and with
   int8 pools and their scales, and at the Transformer decoder's (the same
   with 16 heads) in fp32 (library: ``F.scaled_dot_product_attention``
   over the gathered, masked — for int8 dequantized, untimed — keys),
   timed as CUDA-graph replays cycling over 12 layers' inputs, so each
   launch finds its pool cold in L2 as in a decode step and Python's
   launch cost is left out (it is printed beside); the row top-k (B7) at
   the sampler's shape (8, 50304) fp32, k = 8 and 1, with injected ties
   and a row with fewer than k finite entries, values and indices equal to
   the plain sweeps' and a CUDA-graph replay equal to an eager call
   (library: ``torch.topk``), with its chunks a row and its registers and
   spills; the row softmax forward and
   backward (B6) at GPT-2 small's logits (4096, 50304) in fp32 and bf16
   (library: ``torch.softmax`` and its backward);
3. end to end — per compute dtype (fp32, bf16): GPT-2 small at full width
   (hidden 768, 12 heads, 12 layers, vocab 50257; random weights from a
   seed) serves 8 prompts of 32..200 tokens, three sharing a 64-token
   prefix (prefix-cache hits take the chunk-prefill path), 32 greedy new
   tokens each, through ``FFModel.generate``. Launch counts are reset
   just before and read just after; every decode step must launch the
   flash-decode kernel once per layer. A teacher-forced prefill + decode
   run is then held against a whole-sequence plain forward. With
   ``--profile`` the same generate runs once more under ``torch.profiler``
   and the card's busy share and kernels by time are printed;
4. int8 KV and top-k sampling — per compute dtype: GPT-2 small at vocab
   50304 (nanoGPT's padding, the width at which the sampler's top-k takes
   its kernel) serves the same prompts with ``--kv-dtype int8``: greedy,
   temperature 0.8 with top_k 8 and with top_k 1, and once with native KV,
   each on a fresh engine with the launch counts reset before and read
   after. Asserted: 12 int8 flash-decode launches per decode step, one
   top-k launch per sampler call (prefills plus decode steps; the
   sampler is a captured program with B7 inside), the top_k 1 streams
   equal to the greedy ones, and teacher-forced int8 decode logits
   inside a stated band of native KV's with the greedy argmax agreeing on
   at least 0.9 of the steps; then the captured sampler on the card
   against the same sampler on CPU tensors over those logits (top_k 8
   and 1, temperature 0.8, the same (seed, tag, count)): tokens equal
   outside ``SAMPLER_TIE_MARGIN``. It prints tokens/s, p50/p99 ms per token and
   ``kv_bytes_per_token`` of int8 beside native; ``--profile`` profiles
   the greedy int8 run;
5. flash attention — holds the forward (B1), fused backward (B2) and
   two-pass backward (B3 dK/dV, B4 dQ) kernels against their plain
   versions at BERT-Large's attention (b8 h16 s512 d64) and GPT-2 small's
   (b8 h12 s512 d64, causal) in fp32 and bf16, at GPT-2 small's widths at
   seq 16384 (b1, causal: the shape where the JAX package's rule takes the
   two-pass backward) in fp32 and bf16, and once with dropout 0.1 (the
   grads against their largest element and, per 64-row tile, against the
   tile's; at seq 16384 it prints what planted faults read on both
   checks); times each kernel launch alone, SDPA's forward, SDPA's backward
   (``torch.autograd.grad`` of a retained forward) and SDPA's forward plus
   backward as CUDA-graph replays (inputs warm in L2, as a training step
   finds them), and each plain version eagerly, and prints each against
   its bound; a ``pair B3+B4`` line for each timed shape holds the
   two-pass kernels' sum against SDPA's backward in the same call; then
   the host time to encode one TMA descriptor (the 16-bit forward encodes 3 a
   launch, the fused backward 5, dK/dV and dQ 4 each) beside a launch's
   time from Python;
6. training — through ``FFModel.fit``, with random weights and data from a
   seed: the BERT-Large proxy (``bench.py``'s flagship: hidden 1024, 16
   heads, 24 layers, seq 512, batch 8, bf16 compute, Adam 1e-4, sparse
   categorical cross-entropy), 2 warm-up then 6 timed steps; GPT-2 small
   with a softmax head on token labels (fp32, batch 8, seq 512), 1 + 3
   steps; GPT-2 small's widths at seq 16384 (batch 1), 2 steps in fp32
   and 2 after 1 warm-up in bf16 (its step launches the 16-bit B1, B3 and
   B4 12 times each);
   GPT-2 small at vocab 50304 with the head's softmax opted into the
   row-softmax kernel (``ff.softmax(logits, use_pallas=True)``; fp32,
   batch 8, seq 512), 1 + 3 steps. Launch counts are reset before each
   timed fit and read after: each step must launch the forward kernel once
   per layer, the backward the JAX package's rule picks (fused at seq 512,
   two-pass at 16384) once per layer, and, with the opt-in, the softmax
   forward and backward once each. At the initial weights, one step's
   loss and grads with attention through the kernels are held against
   the same step through the einsum core, and with the softmax kernel
   against the same step through ``torch.softmax``. It prints p50 step
   ms, samples/s and MFU against 989 TF/s; ``--profile`` adds one
   BERT-Large step, one GPT-2 small fp32 step at seq 512 and one fp32 and
   one bf16 step at seq 16384 under ``torch.profiler`` (busy share,
   flash/GEMM/other split, flash time by kernel, kernels by time in
   ``profile_train_bert_bf16.txt``, ``profile_train_gpt2_fp32.txt``,
   ``profile_train_long_fp32.txt`` and ``profile_train_long_bf16.txt`` of
   the output directory);
7. graph — the eager step bodies against the captured programs in this
   call: the BERT-Large proxy (bf16) and GPT-2 small (fp32, seq 512) train
   2 + 6 and 2 + 4 steps each way from the same weights, optimizer state,
   batches and generator seeds (p50 step ms, the busy time and idle share
   of one more step under the profiler and of one replay by CUDA events,
   host kernel- and graph-launch calls, peak memory; losses and params
   after the run within ``GRAPH_TOL``, flash launches a step equal);
   GPT-2 small (fp32) serves the e2e prompts with native and with int8
   KV in three modes on fresh warmed engines — eager bodies, captured
   programs under the sync loop, captured under ``--serve-loop async``
   (greedy streams token-identical, flash-decode launches a step equal,
   ``decode_compiles == 1`` and no program capturing in the timed and
   profiled generates, ``host_syncs`` equal to the decode steps (async:
   at most), ``host_overlap_s > 0`` async, at most 10 kernel launch
   calls a scheduler action captured, teacher-forced logits within
   ``E2E_ATOL``; tokens/s, p50/p99 per-token ms, peak memory, the host
   split, and the idle share and launch calls of a generate of the same
   shapes under the profiler, beside the 3910 / 32 of the decode step
   captured alone); and a BERT-like
   model (BERT-Large's widths, 2 layers,
   attention dropout 0.1) holds one captured step against one eager step
   from the same generator and fails if a second replay's loss equals the
   first's (the mask did not move);
8. zoo — the vision and recommendation models at their published widths
   (no Pallas kernel lies on their path: convolutions, pooling and batch
   norm are cuDNN's, as they are ``lax`` calls in the JAX package). Per
   architecture (AlexNet at 224, ResNet-50, InceptionV3 at 299, ResNeXt-50
   32x4d, DLRM with eight 200000 x 64 tables) one fp32 step on the card
   against the port's CPU path from the same weights and batch (batch 2;
   DLRM 64), with cuDNN's process default ``allow_tf32`` left on: the
   loss, each conv, dense, norm and batched-matmul node alone, and the
   whole step's grads where no ReLU output lies on opposite sides of 0
   (``ZOO_CPU_TOL``; the same readings with the conv op's IEEE guard
   lifted are printed and must fail the node check). Then each timed run
   (those five in fp32 and ResNet-50 in bf16, batch 64, Adam 1e-3, random
   weights from the seed): 2 warm-up steps (eager, capture) and 3 replays
   through ``fit``, once eager and once captured — losses, p50 step ms,
   samples/s, MFU against the compute dtype's peak (67 TF/s fp32, 989
   bf16), idle share by the profiler and by CUDA events around one
   replay, host launch calls, peak memory — and, as gate (b), the same
   steps eager and freshly captured with cuDNN's deterministic algorithms
   (``GRAPH_TOL``). ``--profile`` adds one captured step of each
   under the profiler, its kernels split into conv, batch norm, Adam,
   copies, GEMMs, pooling and the rest (``profile zoo <model> <dtype>``
   lines; tables in ``chiprun_out/profile_zoo_*.txt``).

9. seq — the LSTM and MoE models and the Transformer family at their
   published widths, fp32, random weights from the seed (no kernel of
   their own: the JAX package computes the LSTM, the MoE dispatch and the
   experts outside any Pallas body). Per model, gate (a) as in the zoo
   phase: one step on the card against the port's CPU path from the same
   weights and batch — the OSDI'22 Transformer proxy (transformer.cc: 12
   layers, hidden 1024, 16 heads, seq 512) and NMT at ``rnn.h``'s widths
   (vocab 32000, embed and hidden 1024, 2 layers, 40 tokens) at batch 2,
   the MoE MLP of ``moe.cc`` (784 inputs, 8 experts, top 2, expert hidden
   64) at batch 64 built with ``moe`` and with ``moe_experts`` (the proxy
   here with its layer norms on, so that its activations and grads keep
   their scale through the 12 layers): the loss,
   each dense, attention, LSTM and experts node alone, the whole step's
   grads where no ReLU output changes sides, and for the MoE MLPs the
   dispatch (dest, keep) as integers (``GATE_MARGIN``); then each at its
   published batch (the proxy 8, NMT 64, the MoE MLPs 64; Adam), 2
   warm-up steps and 3 replays once eager and once captured, through
   ``fit`` (NMT, whose labels are flattened tokens, through
   ``make_train_step``): p50 step ms, samples/s (NMT target tokens/s),
   MFU against 67 TF/s from the graph's op FLOPs, idle share by CUDA
   events around one replay, host launch calls, peak memory, the
   captured-vs-eager difference within ``GRAPH_TOL``; the proxy's step
   must launch the fp32 flash forward (B1) and fused backward (B2) 12
   times each. Last, the proxy's causal decoder
   (``build_transformer_decoder``, vocab 256, layer norms on) serves the
   e2e prompts in the same three modes: streams token-identical, 12
   flash-decode (B5) launches a decode step, ``decode_compiles == 1``,
   teacher-forced logits of order 1 against the whole-sequence forward
   within ``E2E_ATOL``; tokens/s and p50/p99 ms a token. ``--profile`` adds one profiled step
   of each timed run (``profile seq <model> fp32`` lines: flash, Adam,
   GEMM, MoE dispatch, elementwise — in NMT chiefly the LSTM's gates).

10. resilient train — the BERT-Large proxy (bf16, Adam 1e-4, float
   input, ``default_rng`` data: 2 epochs of 6 batches) through the
   fault-tolerant ``fit``, one model whose state every run resets in
   place: (a) the guarded captured step against the plain one on a clean
   batch (``GRAPH_TOL``); (b) on a poisoned batch ``ok`` is false and
   params, m, v and the step count are bitwise unchanged; (c) a run
   preempted by SIGTERM before step 7 (``--checkpoint-every 4``) stops at
   step 8 with a committed ``step_8``, and ``--resume auto`` finishes it;
   (d) a NaN batch at step 10 with ``--max-bad-steps 1`` rolls back to
   ``step_8`` (counters fault 1, recovery 1, skipped 1, last resume 8; the
   learning rate unchanged) — both final params within the band of the
   widest pair of ``SPREAD_RUNS`` uninterrupted runs of this call
   (``BAND_FACTOR``, ``BAND_FLOOR``); each save's GB, seconds, GB/s and
   blocked seconds; (e) no capture across (c) and (d), exactly one after
   a ``set_learning_rate``; (f) a save -> restore roundtrip bitwise and in
   place; (g) ``--remat none|selective|full``: p50 step ms, one eager
   step's peak allocated and reserved memory, flash launches a step (24 /
   24 B1 / B2 under none and selective, 48 / 24 under full), peak full <
   none and selective <= none, loss and grads within the band of none's,
   also with attention dropout 0.1 on a 2-layer copy; (h) three manual
   steps (``set_batch``, ``forward``, ``zero_gradients``, ``backward``,
   ``update``) against three ``fit`` steps, in the band of
   ``SPREAD_RUNS`` such fits; (i) the plain and the guarded fit's p50 step
   and idle share. Checkpoints go to a temporary directory (``--keep-
   checkpoints 2``; under ``$TMPDIR`` or, with more room, the checkout;
   about 11 GB at most), removed at the end.

11. obs — observability, fusion and the cache op's recompile: (a) the
   BERT-Large proxy (bf16, Adam) through ``fit`` with ``--telemetry-file``
   and ``--trace-file``: a fit's marginal step (12 replays less 6) without
   and with telemetry (each step then waits for its loss), the telemetry's
   ``steady_step_s``, samples/s, ``estimated_mfu`` against the card's peak
   (``obs.detect_peak_flops``), ``model_flops_per_step`` (the JAX count:
   ``train_flops_per_step`` plus three times the output elements of the
   ops without a cost hook) and ``device_memory``; the Chrome trace's
   ``compile``, ``train_step`` and ``epoch`` events; then three steps of a
   fresh capture under ``--profiler-trace-dir``: every node named by a
   ``record_function`` range, 24 B1 and 24 B2 kernels in each replay;
   (b) before that, the same proxy compiled with ``--fusion``: 48 regions
   (the JAX pass's count, ``tests/test_torch_fusion.py``), 24 + 24 flash
   launches a step as unfused, the first loss bitwise the unfused
   model's from the seed's weights, the params after 4 steps within
   ``GRAPH_TOL`` (bf16 B2's dQ sums are unordered), both p50s; (c) GPT-2
   small (fp32, vocab 50304) serves the e2e prompts with int8 KV and top-k
   8 under ``--serve-loop async``, captured, untraced and then with
   ``obs.enable_reqtrace()`` and ``--telemetry-file``, each on a fresh
   warmed engine: streams equal, one ``ok`` record a request with its
   tokens, the telemetry's tokens equal ``ServingStats``', no capture and
   at most ``MAX_LAUNCH_CALLS_PER_ACTION`` kernel launch calls a
   scheduler action, 12 B5 (int8) a decode step and one B7 a sampler
   call, tokens/s and ``host_bookkeep_s`` each way; (d)
   ``tests/test_cache_op.py``'s MoE model with the cache op and a
   ``RecompileState``: the trigger fires once, the cache scores lie in
   [0, 1], the old program is dropped and the new one captures once, not
   again in a later fit; then a recompile's compile, eager and capture
   seconds. Its files go to a temporary directory removed at the end.

12. chaos — serving under failure on GPT-2 small (fp32, 768 / 12 heads /
   12 layers; vocab 50257 greedy, 50304 with int8 KV and top-k 8), the e2e
   prompt lengths without a shared prefix, 8 slots, 512 positions: first
   B5 (native and int8) on a NaN slot and B7 on NaN and inf rows against
   their plain versions (healthy rows equal, the NaN slot NaN, in-range
   indices); (a) per (native | int8) x (sync | async), on a fresh warmed
   engine, an unpoisoned guarded run, a ``ChaosPlan`` poisoning slot 1
   before decode step 4 and one poisoning it again at step 8: one
   quarantine and retry (then a ``decode_fault``), the neighbours'
   streams and every common decode step's logits rows bitwise the clean
   run's, the native retried stream identical outside a top-2 tie of
   ``CHAOS_TIE_MARGIN`` (and under ``exact_decode`` identical), no capture
   after warm-up, ``host_syncs`` = decode steps, 12 B5 a step and one B7 a
   sampler call; (b) the guarded against the unguarded program on one
   engine: streams bitwise equal, B5 12 a step each way,
   ``decode_compiles`` 1 each, tokens/s and p50 / p99 ms a token in turns
   (unguarded, guarded, guarded, unguarded), launch calls kernel / graph
   of a profiled generate; (c) scripted-clock deadlines twice alike, a
   real-clock ``--request-timeout-ms`` run (counts), ``--shed-policy
   queue`` under a storm (the same counts twice), a real SIGTERM drain
   (in-flight finish, queued handed back and completed on resubmission,
   the handler restored); (d) the ring layout: teacher-forced logits
   bitwise paged-exact's, within ``RING_ATOL`` of paged B5's, greedy
   streams equal, ``kv_bytes_per_token`` ring / paged the analytic ratio,
   tokens/s each way.

13. serving13 — the rest of one-GPU serving: (a) speculative decoding on
   GPT-2 small (fp32, vocab 50257) with a drafter GPT-2 of the same
   vocabulary (hidden 256, 4 heads, 2 layers, its own seed), eight
   prompts of 16-64 tokens, 32 tokens, gamma 4, context 128: the
   speculative streams of the random and of the perfect drafter (the
   target itself) equal the exact-decode and the B5 baseline's outside
   positions whose top-2 logit gap is under ``SPEC_TIE`` (the count
   excluded and the smallest gap printed), the perfect drafter rejects
   only at such ties and commits more tokens than it runs rounds, no
   prefill program captures after warm-up, 12 B5 a step in the B5
   baseline; rounds, proposed, accepted, acceptance, tokens/s and p50 ms
   a token beside the baselines'; (b) an LSTM language model at
   ``NMTConfig()``'s widths (vocab 32000, embed 1024, two LSTMs of 1024,
   a dense head; fp32, 8 slots, 128 positions, prompts of 8-40 tokens, 32
   tokens): the prefix cache refused by name and chunked prefill
   (``ValueError``), teacher-forced decode logits within ``LSTM_ATOL`` of
   the card's whole-sequence forward with the greedy argmax equal outside
   ties, streams equal on paged / ring, sync / async and to the port's
   CPU path from the same weights (outside ties), ``decode_compiles`` 1
   and no capture after warm-up, tokens/s and p50 ms a token each way;
   (c) a traced GPT-2 small serve (``--trace-file``, the prefix cache on,
   64-token chunks, a ninth prompt sharing the first's 72 tokens): the
   ``prefill`` / ``prefill_chunk`` / ``decode_step`` spans number the
   one-shot prefills, chunks and decode steps of ``ServingStats``, with
   the JAX engine's fields, the ``prefix_cow_clone`` events counted, the
   streams the untraced run's, traced / untraced tokens/s. B5 is held
   against its plain version on each B5 engine's own pools after its run.

14. mesh — strategies on a device mesh (the section's comment): NCCL of
   one rank, tp = 2 x dp = 2 as threads, four gloo ranks on the CPU.

15. pipeline — pipeline parallelism (the section's comment): the
   BERT-Large proxy at full width in fp32 as four ranks in threads on
   the one card (a harness group that adds point-to-point as copies), pp
   4 x dp 1 under gpipe, 1f1b and interleaved (v 2) and pp 2 x dp 2
   under 1f1b, within the band of one-device runs, B1 and B2 counted per
   rank; four gloo ranks on the CPU, the tiny BERT at pp 2 x dp 2, the
   three schedules bitwise equal. B1 and B2 are held against their
   plain versions at the microbatch shape and timed there
   (``flash_fwd_pipeline``, ``flash_bwd_fused_pipeline``).

16. mesh16 — checkpoints and FSDP on a mesh (the section's comment).

17. search — the Unity search and its cost model on the card (the
   section's comment): (a) the machine model's efficiencies measured
   (a GEMM in bf16 and fp32, an elementwise pass, the port's Adam update)
   and ``GPUMachineModel.detect`` reading the card; (b) the BERT-Large
   proxy's ``profile_operators`` (8 heaviest op shapes, CUDA events around
   a captured graph of each op) against the analytic ``op_cost``, the
   attention op's ``"grad"`` measurement, and the simulated step against
   phase 6's measured captured p50, B1 / B2 counted inside the
   measurements (``flash_fwd_measure``, ``flash_bwd_fused_measure``);
   (c) ``--search-num-workers 4 --export-strategy`` on the one card: the
   winner, the search's wall and candidates, its simulated step beside
   the best plan on dp 4, hybrid 2 x 2 and tp 4; (d) the same search at
   BERT-Large's widths cut to 2 layers in fp32 without pipeline
   candidates (the threaded harness has no point-to-point; phase 15 holds
   the pipeline schedules), its export imported onto
   four threaded ranks on the card: one step's loss and grads against one
   device (``SEARCH_THREADED_TOL``), B1 / B2 counted per rank
   (``flash_fwd_search``, ``flash_bwd_fused_search``) and held against
   their plain versions at the rank's shape.

It prints the run's wall seconds, one ``{"kernels": [...]}`` line (the
entries of the instances the census covers also carry their SASS counts,
registers, spills and shared memory; the flash-decode entries their
registers and spills; the two-pass entries SDPA's backward as
``pair_library_ms``; the backward entries their tile error; the
proxy's B1 and B2 as ``flash_fwd_transformer`` and
``flash_bwd_fused_transformer``, timed at the fp32 BERT shape, which is
theirs; the decoder's B5 as ``flash_decode_decoder``; B1 and B2 under
``--remat full`` as ``flash_fwd_remat`` and ``flash_bwd_fused_remat``;
phase 11's as ``flash_fwd_obs``, ``flash_bwd_fused_obs``,
``flash_decode_int8_obs`` and ``topk_obs``; phase 12's as
``flash_decode_guarded``, ``flash_decode_int8_guarded`` and
``topk_guarded``; phase 13's as ``flash_decode_spec`` and
``flash_decode_spans``), the card's
name and power limit (nvidia-smi), and as its last line ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero; without CUDA, or without the package, it
exits 1 and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 (non-tensor
# core) rate. The kernel does its arithmetic in fp32 for every pool dtype.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel phase shapes: GPT-2 small decode at 8 slots, max_decode_len 512
SLOTS, HEADS, HEAD_DIM, BLOCK, MAX_BLOCKS = 8, 12, 64, 16, 32
# tolerance of the kernel against its plain version: fp32 differs only in
# summation order; bf16 outputs round to 8 mantissa bits (ulp 2**-7 at 1)
KERNEL_ATOL = {"fp32": 2e-5, "bf16": 2e-2}
# decode logits against a whole-sequence plain forward of the same
# tokens: fp32 paths differ in summation order only; in bf16 the two paths
# round activations at different points (decode writes K/V rows one token
# at a time, the plain core reads them from one GEMM), judged in a band
E2E_ATOL = {"fp32": 1e-4, "bf16": 5e-2}
E2E_MAX_DECODE_LEN = 512
E2E_NEW_TOKENS = 32
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, device, graph: bool = False,
            stream=None) -> float:
    """Mean milliseconds per call of ``fn(i)`` (i = 0..iters-1) after two
    warm-up calls: CUDA events around ``iters`` back-to-back calls on the
    card. With ``graph`` the calls are captured once into a CUDA graph and
    the replay is timed, so the figure is device time without Python's
    per-call launch cost (which exceeds a short kernel's run time).
    ``stream``: warm up and capture on this stream (an autograd backward
    runs on the stream its forward ran on, so a captured backward needs
    its forward on the capture stream)."""
    import contextlib

    import torch

    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        fn(0)
        fn(1)
    if device.type != "cuda":
        t = time.perf_counter()
        for i in range(iters):
            fn(i)
        return (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            run()
        run = g.replay
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------- build phase
def build_phase() -> dict:
    """Builds every kernel and returns the SASS census of the Hopper
    flash-attention instances (:func:`sass_census`)."""
    from flexflow_tpu_torch.kernels import build_all

    t = time.perf_counter()
    reports = build_all()
    secs = time.perf_counter() - t
    log(f"build: {len(reports)} kernel(s) compiled for sm_90a in "
        f"{secs:.2f} s")
    import re

    for name, rep in reports.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             rep)]
        log(f"  {name}: {len(regs)} kernel instantiations, registers "
            f"{min(regs, default=0)}..{max(regs, default=0)} a thread, "
            f"{sum(1 for s in spills if s)} spilling (at most "
            f"{max(spills, default=0)} bytes)")
        for line in rep.splitlines():
            if "wgmma" in line and "serialized" in line:
                log(f"  {name}: ptxas: {line.strip()[:300]}")
    return sass_census()


# SASS instructions each flash-attention instance built for Hopper must
# hold (an entry with a dot also needs that modifier, e.g. LDS.128): the
# 16-bit forward, fused and two-pass backward wgmma (HGMMA) and TMA tile
# loads (UTMALDG), the fused backward also the bulk reduce-add of its dQ
# partials (UBLKRED); the fp32 forward, fused and two-pass backward their
# cp.async ring (LDGSTS) and 128-bit shared loads (LDS.128), the fused one
# also the vector reduce-adds of its dQ partials (REDG)
SASS_NEEDS = {"flash_fwd_sm90": ("HGMMA", "UTMALDG"),
              "flash_bwd_fused_sm90": ("HGMMA", "UTMALDG", "UBLKRED"),
              "flash_bwd_dkv_sm90": ("HGMMA", "UTMALDG"),
              "flash_bwd_dq_sm90": ("HGMMA", "UTMALDG"),
              "flash_bwd_dkv_f32": ("LDGSTS", "LDS.128"),
              "flash_bwd_dq_f32": ("LDGSTS", "LDS.128"),
              "flash_fwd_f32": ("LDGSTS", "LDS.128"),
              "flash_bwd_fused_f32": ("LDGSTS", "LDS.128", "REDG")}
# instances the census must find: B1, B2, B3 and B4 x bf16/fp16/fp32 x d
# 64/128
SASS_INSTANCES = 24


def sass_count(ops, need: str) -> int:
    """Instructions of ``ops`` (full opcodes, e.g. ``LDS.U.128``) with the
    opcode and every modifier of ``need``."""
    stem, *mods = need.split(".")
    return sum(1 for op in ops
               if op.split(".")[0] == stem
               and all(m in op.split(".")[1:] for m in mods))


def cuobjdump_path() -> str:
    import os
    import shutil

    from flexflow_tpu_torch.kernels.build import nvcc_path

    beside = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    found = shutil.which("cuobjdump") or (beside if os.path.exists(beside)
                                          else None)
    if found is None:
        try:
            import triton
        except ImportError:
            fail("no cuobjdump (neither beside nvcc nor in triton)")
        found = os.path.join(os.path.dirname(triton.__file__), "backends",
                             "nvidia", "bin", "cuobjdump")
    return found


def sass_census() -> dict:
    """Counts, in ``cuobjdump -sass`` of the built flash-attention library,
    the instructions of :data:`SASS_NEEDS` in every instance of the kernels
    it names, beside its registers and spill bytes (from the compiler's
    report kept beside the library) and its dynamic shared memory. Fails if
    an instance lacks an instruction its design needs. Returns {(kernel,
    dtype, head_dim): entry}."""
    import re

    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import flash_attention as fa

    lib = build.library_path("flash_attention")
    sass = subprocess.run([cuobjdump_path(), "-sass", lib],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed: {sass.stderr.strip()[:400]}")
    props = ptxas_props("flash_attention")
    pat = re.compile(r"(flash_fwd_sm90|flash_bwd_fused_sm90"
                     r"|flash_bwd_dkv_sm90|flash_bwd_dq_sm90)I"
                     r"(13__nv_bfloat16|6__half)Li(64|128)E"
                     r"|(flash_bwd_dkv_f32|flash_bwd_dq_f32|flash_fwd_f32"
                     r"|flash_bwd_fused_f32)"
                     r"ILi(64|128)E")
    census = {}
    for chunk in re.split(r"\n\s*Function : ", sass.stdout)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        m = pat.search(name)
        if not m:
            continue
        if m.group(1):
            kernel, d = m.group(1), int(m.group(3))
            dtype = "bf16" if "bfloat16" in m.group(2) else "fp16"
        else:
            kernel, d, dtype = m.group(4), int(m.group(5)), "fp32"
        # every instruction, at any offset (a kernel can pass 64 KB)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9_]*(?:\.[A-Za-z0-9_]+)*)", chunk)
        counts = {op: sass_count(ops, op) for op in SASS_NEEDS[kernel]}
        entry = dict(sass=counts, **props.get(name, {}),
                     smem_bytes=fa.smem_bytes(kernel, d))
        short = kernel.replace("_sm90", "").replace("_f32", "")
        census[(short, dtype, d)] = entry
        log(f"  sass {kernel}<{dtype}, d{d}>: "
            + ", ".join(f"{op} {n}" for op, n in counts.items())
            + f"; registers {entry.get('registers')}, spill bytes "
            f"{entry.get('spill_bytes')}, dynamic shared memory "
            f"{entry['smem_bytes']} bytes")
        missing = [op for op, n in counts.items() if n == 0]
        if missing:
            fail(f"{kernel}<{dtype}, d{d}> has no {missing} in its SASS")
    if len(census) != SASS_INSTANCES:
        fail(f"found {len(census)} flash-attention instances in the "
             f"library's SASS, want {SASS_INSTANCES} (B1, B2, B3 and B4 x "
             "bf16/fp16/fp32 x d 64/128)")
    return census


def ptxas_props(name: str) -> dict:
    """{mangled kernel name: {"registers", "spill_bytes"}} from the
    compiler's report kept beside kernel ``name``'s library."""
    import re

    from flexflow_tpu_torch.kernels import build

    with open(build.library_path(name) + ".log") as f:
        report = f.read()
    props, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            props[current] = {}
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            props[current]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            props[current]["registers"] = int(m.group(1))
    return props


def decode_props() -> dict:
    """Registers and spill bytes of the flash-decode instances the kernel
    phase times (head width class 64, 16-byte loads), by JSON entry name;
    fails if one is missing from the compiler's report."""
    import re

    pat = re.compile(r"flash_decode_kernelI(f|13__nv_bfloat16)(f|S1_|a)"
                     r"Li64ELb1E")
    names = {("f", "f"): "flash_decode",
             ("13__nv_bfloat16", "S1_"): "flash_decode_bf16",
             ("f", "a"): "flash_decode_int8",
             ("13__nv_bfloat16", "a"): "flash_decode_int8_bf16"}
    out = {}
    for kernel, p in ptxas_props("flash_decode").items():
        m = pat.search(kernel)
        if m and (m.group(1), m.group(2)) in names:
            out[names[(m.group(1), m.group(2))]] = p
    if set(out) != set(names.values()):
        fail(f"flash_decode instances missing from the compiler's report: "
             f"{sorted(set(names.values()) - set(out))}")
    for name, p in sorted(out.items()):
        log(f"  ptxas {name}: registers {p.get('registers')}, spill bytes "
            f"{p.get('spill_bytes')}")
    return out


# ------------------------------------------------------------ kernel phase
def decode_inputs(dtype, device, layers: int, seed: int = SEED,
                  heads: int = HEADS):
    """Decode shapes of 8 slots, d64, 16-token blocks, 32 blocks a slot
    (GPT-2 small's 12 heads, or the Transformer decoder's 16): one random
    (q, kpool, vpool) per layer, shared shuffled block tables and key
    counts 1..512 (the ends always present). Timing cycles through the
    layers, as a decode step does, so a launch finds its pool outside the
    L2 cache (``layers`` pools of 25 MB in fp32 exceed its 50 MB)."""
    import torch

    rng = np.random.default_rng(seed)
    n_blocks = SLOTS * MAX_BLOCKS + 1
    tables = rng.permutation(np.arange(1, n_blocks)).reshape(SLOTS,
                                                             MAX_BLOCKS)
    n_keys = rng.integers(1, BLOCK * MAX_BLOCKS + 1, SLOTS)
    n_keys[0], n_keys[-1] = 1, BLOCK * MAX_BLOCKS
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    per_layer = [(randn(SLOTS, heads, HEAD_DIM),
                  randn(n_blocks, heads, BLOCK, HEAD_DIM),
                  randn(n_blocks, heads, BLOCK, HEAD_DIM))
                 for _ in range(layers)]
    i = [torch.tensor(a, dtype=torch.int32, device=device)
         for a in (tables, n_keys)]
    return per_layer, i[0], i[1]


def flash_decode_bound(n_keys, el: int, int8: bool = False,
                       heads: int = HEADS):
    """(bound_ms, bound_by): the bytes this call must move — the used K/V
    rows (int8: 1 byte an element plus two f32 scales per key and head), q,
    the output, tables and counts, each once — over HBM bandwidth, against
    its fp32 flops (score and PV: 4 * dim per key and head) over the fp32
    peak."""
    keys = int(np.sum(n_keys))
    kv = keys * heads * (2 * HEAD_DIM + 8 if int8 else 2 * HEAD_DIM * el)
    io = 2 * SLOTS * heads * HEAD_DIM * el + SLOTS * (MAX_BLOCKS + 1) * 4
    t_bytes = (kv + io) / HBM_BYTES_PER_S
    t_ops = keys * heads * 4 * HEAD_DIM / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(device, card: str, dtypes=("fp32", "bf16"),
                 iters: int = 240, layers: int = 12, int8: bool = False,
                 heads: int = HEADS):
    """Flash decode against its plain version and timed, at ``heads``
    heads (:func:`decode_inputs`). ``int8``: the kernel's int8 branch, the
    fp32 pools of the native case quantized per (token, head) and q in the
    compute dtype; the library call then reads keys gathered and
    dequantized to q's dtype beforehand (not timed)."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.serving.kvcache import (dequantize_kv,
                                                    gather_paged_kv,
                                                    gather_paged_scales,
                                                    quantize_kv)

    label = ("flash_decode_int8" if int8 else "flash_decode") + (
        f" {heads} heads" if heads != HEADS else "")
    out = {}
    for name in dtypes:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[name]
        per_layer, tables, n_keys = decode_inputs(
            torch.float32 if int8 else dtype, device, layers, heads=heads)
        if int8:
            # (q, kq, vq, {kscale, vscale})
            per_layer = [(q.to(dtype), kq, vq, dict(kscale=ks, vscale=vs))
                         for q, (kq, ks), (vq, vs) in (
                             (q, quantize_kv(k), quantize_kv(v))
                             for q, k, v in per_layer)]
        else:
            per_layer = [(q, k, v, {}) for q, k, v in per_layer]

        def call(fn, i):
            q, k, v, scales = per_layer[i % layers]
            return fn(q, k, v, tables, n_keys, **scales)

        wants = [call(fd.flash_decode_plain, i) for i in range(layers)]
        err = max((call(fd.flash_decode, i).float() - want.float())
                  .abs().max().item() for i, want in enumerate(wants))
        if not err <= KERNEL_ATOL[name]:
            fail(f"{label} {name}: max |kernel - plain| = {err} > "
                 f"{KERNEL_ATOL[name]}")

        def gather(pool, scales):
            if scales is None:
                return gather_paged_kv(pool, tables)
            return dequantize_kv(gather_paged_kv(pool, tables),
                                 gather_paged_scales(scales, tables), dtype)

        # yardstick: one library call on the keys gathered and masked
        gathered = [(q[:, :, None, :], gather(k, sc.get("kscale")),
                     gather(v, sc.get("vscale")))
                    for q, k, v, sc in per_layer]
        kpos = torch.arange(gathered[0][1].shape[2], device=device)
        mask = (kpos[None, :] < n_keys[:, None])[:, None, None, :]
        q4, kc, vc = gathered[0]
        lib = F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)
        lib_err = (lib[:, :, 0].float() - wants[0].float()).abs().max().item()

        def kernel(i):
            return call(fd.flash_decode, i)

        def plain(i):
            return call(fd.flash_decode_plain, i)

        def library(i):
            q4, kc, vc = gathered[i % layers]
            return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)

        cuda = device.type == "cuda"
        ms = time_ms(kernel, iters, device, graph=cuda)
        eager_ms = time_ms(kernel, iters, device)
        plain_ms = time_ms(plain, max(iters // 20, 1), device)
        library_ms = time_ms(library, iters, device, graph=cuda)
        bound_ms, bound_by = flash_decode_bound(
            n_keys.cpu().numpy(), per_layer[0][0].element_size(), int8,
            heads)
        log(f"kernel {label} {name}: max_abs_err {err:.3g} "
            f"(sdpa vs plain {lib_err:.3g}), {ms * 1e3:.2f} us "
            f"({eager_ms * 1e3:.2f} us a call launched from Python), "
            f"plain {plain_ms * 1e3:.2f} us, sdpa over gathered keys "
            f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}) [{card}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
    return out


# ------------------------------------------- top-k (B7) and softmax (B6)
# nanoGPT's padded GPT-2 vocabulary (50257 rounded up, 393 x 128): the
# width at which the sampler's top-k and the opt-in softmax take kernels
VOCAB_PADDED = 50304
TOPK_KS = (8, 1)
# softmax kernel phase: GPT-2 small's logits at batch 8, seq 512
SOFTMAX_ROWS = 8 * 512
# kernel against plain: fp32 differs in summation order only (values <= 1);
# 16-bit outputs are rounded once on both sides, and an fp32 value one ulp
# apart may round to the neighbouring bf16 value, which is at most 2**-8
# below 1. The backward is judged relative to its largest element.
SOFTMAX_TOL = {"fp32": 2e-6, "bf16": 2.0 ** -8}
# int8 KV against native KV, teacher-forced decode logits of the same
# weights (GPT-2 small, seed 0, 4 requests x 31 steps): measured 9.3e-4 in
# fp32 and 1.15e-2 in bf16 on an H100, banded at about 10x and 4x that
# (the JAX package pins 0.25 on its tiny GPT-2, tests/test_decode_paged.py);
# the greedy argmax agreement is the JAX package's law
INT8_BAND = {"fp32": 1e-2, "bf16": 5e-2}
INT8_ARGMAX_AGREEMENT = 0.9


def topk_inputs(device, n: int, seed: int = SEED):
    """``n`` (8, 50304) fp32 sampler logits: random, with a maximum
    repeated in row 0, ties across the k-th place in row 1, and row 2 with
    two finite entries (the rest -inf)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for _ in range(n):
        x = torch.randn((SLOTS, VOCAB_PADDED), generator=gen, device=device)
        x[0, [3, 70, VOCAB_PADDED - 1]] = 9.0
        x[1, [5, 6, 200]] = 7.5
        x[1, [1, 2]] = 8.0
        x[2] = float("-inf")
        x[2, [VOCAB_PADDED // 2, 1]] = torch.tensor([0.5, -3.0],
                                                    device=device)
        out.append(x)
    return out


def topk_props() -> dict:
    """Registers and spill bytes of the top-k instances the kernel phase
    times (fp32, 16-byte loads), by k; fails if one is missing from the
    compiler's report."""
    import re

    out = {}
    for kernel, p in ptxas_props("topk").items():
        m = re.search(r"topk_kernelIfLi(\d)ELb1E", kernel)
        if m and int(m.group(1)) in TOPK_KS:
            out[int(m.group(1))] = p
    if set(out) != set(TOPK_KS):
        fail(f"topk instances missing from the compiler's report: "
             f"{sorted(set(TOPK_KS) - set(out))}")
    for k, p in sorted(out.items()):
        log(f"  ptxas topk k={k} fp32: registers {p.get('registers')}, "
            f"spill bytes {p.get('spill_bytes')}")
    return out


def topk_kernel_phase(device, card: str, iters: int = 240, n: int = 12):
    """B7 at the sampler's decode shape, k = 8 and k = 1: values and
    indices must EQUAL the plain sweeps', and a CUDA-graph replay the
    eager call's. Timed as graph replays cycling over ``n`` inputs (19 MB,
    warm in L2, as logits fresh from the LM head are); the library call is
    ``torch.topk``."""
    import torch

    from flexflow_tpu_torch.kernels import topk as tk

    xs = topk_inputs(device, n)
    out = {}
    for k in TOPK_KS:
        for x in xs:
            vals, idx = tk.topk(x, k)
            want_v, want_i = tk.topk_plain(x, k)
            if not (torch.equal(idx, want_i) and torch.equal(vals, want_v)):
                fail(f"topk k={k}: kernel and plain sweeps differ")
        # a replay of the split launch (scratch from the wrapper, tickets
        # left zero) equals the eager call bitwise
        vals, idx = tk.topk(xs[0], k)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            g_vals, g_idx = tk.topk(xs[0], k)
        g.replay()
        if not (torch.equal(g_vals, vals) and torch.equal(g_idx, idx)):
            fail(f"topk k={k}: a graph replay differs from the eager call")
        chunk, chunks, _kp = tk.chunking(SLOTS, VOCAB_PADDED, k, 0)
        lib_v, _ = torch.topk(xs[0], k, dim=-1)
        lib_same = bool(torch.equal(lib_v, tk.topk_plain(xs[0], k)[0]))
        ms = time_ms(lambda i: tk.topk(xs[i % n], k), iters, device,
                     graph=True)
        plain_ms = time_ms(lambda i: tk.topk_plain(xs[i % n], k),
                           max(iters // 20, 1), device)
        lib_ms = time_ms(lambda i: torch.topk(xs[i % n], k, dim=-1), iters,
                         device, graph=True)
        nbytes = xs[0].numel() * 4 + SLOTS * k * 8
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = xs[0].numel() / FP32_FLOPS  # one compare an element
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"kernel topk k={k} ({SLOTS}, {VOCAB_PADDED}) fp32: values and "
            f"indices equal the plain sweeps' (torch.topk values equal: "
            f"{lib_same}), graph replay equal, {chunks} chunks of {chunk} a "
            f"row, {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
            f"torch.topk {lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us"
            f" ({bound_by}) [{card}]")
        out[k] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by,
                      library_ms=lib_ms, chunks=chunks)
    for k, p in topk_props().items():
        out[k].update(p)
    return out


def softmax_kernel_phase(device, card: str, iters: int = 8):
    """B6 forward and backward at GPT-2 small's logits (4096 rows of
    50304) in fp32 and bf16 against their plain versions, timed as graph
    replays (each call streams 0.8 GB or more, far past L2); the library
    calls are ``torch.softmax`` and ``torch._softmax_backward_data`` (what
    its autograd backward runs)."""
    import torch

    from flexflow_tpu_torch.kernels import softmax as sm

    out = {}
    for name in ("fp32", "bf16"):
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[name]
        gen = torch.Generator(device=device).manual_seed(SEED)
        shape = (SOFTMAX_ROWS, VOCAB_PADDED)
        x = (torch.randn(shape, generator=gen, device=device) * 4.0).to(dtype)
        g = torch.randn(shape, generator=gen, device=device).to(dtype)
        p = sm._forward(x)
        dx = sm._backward(p, g)
        tol = SOFTMAX_TOL[name]
        errs = {"softmax_fwd": abs_err(p, sm.softmax_plain(x))}
        want_dx = sm.softmax_bwd_plain(p, g)
        errs["softmax_bwd"] = abs_err(dx, want_dx)
        rel_bwd = errs["softmax_bwd"] / want_dx.float().abs().max().item()
        del want_dx
        if not (errs["softmax_fwd"] <= tol and rel_bwd <= tol):
            fail(f"softmax {name}: kernel vs plain forward {errs['softmax_fwd']}"
                 f", backward (relative) {rel_bwd} > {tol}")
        el = x.element_size()
        calls = {
            "softmax_fwd": (lambda i: sm._forward(x),
                            lambda i: sm.softmax_plain(x),
                            lambda i: torch.softmax(x, dim=-1), 2, 5),
            "softmax_bwd": (lambda i: sm._backward(p, g),
                            lambda i: sm.softmax_bwd_plain(p, g),
                            lambda i: torch._softmax_backward_data(
                                g, p, -1, dtype), 3, 4),
        }
        # (kernel, plain, library, tensors moved, fp32 operations an
        # element: max, subtract, exp, add, divide; multiply, add,
        # subtract, multiply)
        for kname, (kern, plain, lib, tensors, ops) in calls.items():
            ms = time_ms(kern, iters, device, graph=True)
            torch.cuda.empty_cache()
            plain_ms = time_ms(plain, 2, device)
            lib_ms = time_ms(lib, iters, device, graph=True)
            torch.cuda.empty_cache()
            t_bytes = tensors * x.numel() * el / HBM_BYTES_PER_S
            t_ops = ops * x.numel() / FP32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            log(f"kernel {kname} {name} {shape}: max_abs_err "
                f"{errs[kname]:.3g}{f' (rel {rel_bwd:.3g})' if kname == 'softmax_bwd' else ''}"
                f", {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, library "
                f"{lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us "
                f"({bound_by}; {bound_ms / ms:.3f} of it) [{card}]")
            out[(kname, name)] = dict(max_abs_err=errs[kname], ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, library_ms=lib_ms)
        del x, g, p, dx
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------- end-to-end phase
def build_model(cfg, compute: str, device, max_decode_len: int,
                seed: int = SEED):
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.gpt2 import build_gpt2

    config = FFConfig()
    config.batch_size = cfg.batch_size
    config.seed = seed
    config.max_decode_len = max_decode_len
    config.max_inflight = 8
    if compute == "bf16":
        config.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(config, device=device)
    build_gpt2(ff, cfg)
    ff.compile()
    return ff


def make_prompts(vocab: int, lengths, shared_len: int, n_shared: int,
                 seed: int = SEED + 1):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).tolist()
    prompts = []
    for i, n in enumerate(lengths):
        if i < n_shared:
            prompts.append(shared + rng.integers(0, vocab,
                                                 n - shared_len).tolist())
        else:
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


# seeds of the warm-up prompt sets (``warm_serving``) and of the profiled
# run's (``graph_serve``): the timed prompts' shapes, other tokens
WARM_SEEDS = (SEED + 101, SEED + 102)
PROFILE_PROMPT_SEED = SEED + 103


def warm_serving(ff, lengths, shared_len: int, n_shared: int,
                 new_tokens: int, max_len: int, **sampling) -> None:
    """Warm the model's serving engine (made here if there is none) for a
    run of ``make_prompts`` at these lengths: two generates of prompt sets
    of the same shapes and other tokens (so no prefix of the timed prompts
    is cached), which run every program the timed run will (each prefill
    bucket, chunk shape, sampler row count and slot write) twice: its
    eager first call, then its capture. A timed generate after it only
    replays."""
    import torch

    vocab = ff.pcg.nodes[ff.executor.final_guid].out_shapes[
        ff.executor.final_out_idx][-1]
    for seed in WARM_SEEDS:
        ff.generate(make_prompts(vocab, lengths, shared_len, n_shared, seed),
                    max_new_tokens=new_tokens, max_decode_len=max_len,
                    **sampling)
    torch.cuda.synchronize()


def serving_captures(eng) -> int:
    """Graphs captured so far by every program of ``eng``'s serving path."""
    return sum(p.captures for p in eng.programs())


def teacher_forced(ff, tokens, prompt_len: int, steps: int, max_len: int,
                   block: int, kv_dtype: str = "native",
                   capture: bool = True):
    """Teacher-forced serving steps: prefill ``tokens[:prompt_len]`` into a
    paged pool of ``kv_dtype`` ("native" or "int8"), then ``steps`` decode
    steps fed the true next token, through the captured decode program (or,
    ``capture=False``, its eager body). Returns the serving logits, the
    prefill's last row then one row per decode step. Launch counts include
    these decodes."""
    import torch

    from flexflow_tpu_torch.serving.kvcache import (DecodeState,
                                                    blocks_per_slot,
                                                    paged_pool_entry,
                                                    scatter_prefill_paged)
    from flexflow_tpu_torch.serving.scheduler import (bucket_for,
                                                      default_buckets)

    ex, dev = ff.executor, ff.device
    bucket = bucket_for(prompt_len, default_buckets(max_len))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt_len] = tokens[:prompt_len]
    _lg, last, cache = ex.make_prefill_step(bucket, max_len)(
        ff.params, [torch.tensor(ids, device=dev)],
        torch.tensor([prompt_len], dtype=torch.int32, device=dev))
    mb = blocks_per_slot(max_len, block)
    table = torch.arange(1, mb + 1, dtype=torch.int32, device=dev)
    caches = {}
    for name, leaves in cache.items():
        entry = []
        for leaf in leaves:
            pool = paged_pool_entry(leaf, mb + 1, block, kv_dtype)
            if kv_dtype == "int8":
                entry += scatter_prefill_paged(pool[0], leaf, table, block,
                                               scales=pool[1])
            else:
                entry.append(scatter_prefill_paged(pool, leaf, table, block))
        caches[name] = tuple(entry)
    state = DecodeState(caches=caches,
                        lengths=torch.tensor([prompt_len], dtype=torch.int32,
                                             device=dev),
                        block_tables=table[None, :].clone())
    decode = ex.make_decode_step(max_len, block_size=block,
                                 kv_dtype=kv_dtype, capture=capture)
    rows = [last[0]]
    for s in range(steps):
        tok = torch.tensor([[tokens[prompt_len + s]]], dtype=torch.int32,
                           device=dev)
        logits, state = decode(ff.params, [tok], state)
        rows.append(logits[0])
    return torch.stack(rows)


def decode_vs_forward(ff, tokens, prompt_len: int, steps: int,
                      max_len: int, block: int):
    """Teacher-forced serving steps (:func:`teacher_forced`, native KV)
    against the whole-sequence plain forward. Returns (max |serving -
    forward| over the prefill's last row and every decode row, the serving
    logits)."""
    import torch

    ex, dev = ff.executor, ff.device
    serving = teacher_forced(ff, tokens, prompt_len, steps, max_len, block)
    full = ex.forward(ff.params, [torch.tensor(
        [tokens[:prompt_len + steps]], dtype=torch.int32, device=dev)])[0]
    want = full[prompt_len - 1:prompt_len + steps]
    if not bool(torch.isfinite(serving).all()):
        fail("non-finite serving logits")
    return (serving - want).abs().max().item(), serving


def profile_generate(ff, compute: str, prompts, new_tokens: int,
                     max_len: int, wall_s: float, prompt_set: dict) -> None:
    """``--profile``: the timed generate once more, on a fresh engine
    warmed up as the timed one (``warm_serving`` on ``prompt_set``, so the
    same work) under ``torch.profiler``. Prints
    the card's busy time (the sum of kernel times) against the unprofiled
    run's wall and writes the kernels by total time to
    ``chiprun_out/profile_<compute>.txt``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ff._serving_engine = None
    warm_serving(ff, **prompt_set)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ff.generate(prompts, max_new_tokens=new_tokens,
                    max_decode_len=max_len)
        torch.cuda.synchronize()
    stats = ff._serving_engine.stats
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        log(f"profile {compute}: the profiler saw no kernel time; device "
            "busy share not measured")
        return
    launches = sum(e.count for e in kernels)
    steps = max(stats.decode_steps, 1)
    log(f"profile {compute}: kernels busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled run's {wall_s * 1e3:.3f} ms wall (idle share "
        f"{1 - busy_us / 1e3 / (wall_s * 1e3):.4f}; profiled wall "
        f"{stats.wall_s * 1e3:.3f} ms), {launches} kernel launches "
        f"({launches / steps:.1f} per decode step incl. prefills)")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", f"profile_{compute}.txt")
    with open(path, "w") as f:
        f.write("kernel\tcount\ttotal_us\tshare\n")
        for e in kernels:
            f.write(f"{e.key}\t{e.count}\t{e.self_device_time_total:.1f}\t"
                    f"{e.self_device_time_total / busy_us:.4f}\n")
    for e in kernels[:8]:
        log(f"profile {compute}:   {e.self_device_time_total / 1e3:9.3f} ms"
            f" {e.count:6d}x {e.key[:90]}")
    log(f"profile {compute}: full table in {path}")


def e2e_phase(device, card: str, cfg, compute: str, lengths,
              shared_len: int, n_shared: int, new_tokens: int, max_len: int,
              profile: bool = False):
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd

    t = time.perf_counter()
    ff = build_model(cfg, compute, device, max_len)
    log(f"e2e {compute}: GPT-2 hidden {cfg.hidden} heads {cfg.num_heads} "
        f"layers {cfg.num_layers} vocab {cfg.vocab_size} built in "
        f"{time.perf_counter() - t:.1f} s")
    prompts = make_prompts(cfg.vocab_size, lengths, shared_len, n_shared)
    # warm-up (cuBLAS handles, the kernel library, allocator pools, every
    # serving program's eager first call and capture)
    prompt_set = dict(lengths=lengths, shared_len=shared_len,
                      n_shared=n_shared, new_tokens=new_tokens,
                      max_len=max_len)
    warm_serving(ff, **prompt_set)

    fd.reset_launch_count()
    outs = ff.generate(prompts, max_new_tokens=new_tokens,
                       max_decode_len=max_len)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = fd.launch_count()
    stats = ff._serving_engine.stats

    for i, o in enumerate(outs):
        if len(o) != new_tokens or not all(0 <= t < cfg.vocab_size
                                           for t in o):
            fail(f"e2e {compute}: request {i} produced {o}")
    if stats.decode_steps < 1 or stats.chunked_prefills < 1 \
            or stats.prefix_hits < 1:
        fail(f"e2e {compute}: the run must decode, hit the prefix cache "
             f"and chunk-prefill: {stats.summary()}")
    per_step = cfg.num_layers
    want_launches = per_step * stats.decode_steps
    if device.type == "cuda" and launches < want_launches:
        fail(f"e2e {compute}: {launches} flash_decode launches over "
             f"{stats.decode_steps} decode steps (need >= {per_step} per "
             "step)")
    p50 = stats.p50_token_ms()
    log(f"e2e {compute}: {stats.tokens_generated} tokens from "
        f"{len(prompts)} requests in {stats.wall_s:.3f} s = "
        f"{stats.tokens_per_s():.1f} tokens/s, p50 per-token "
        f"{p50:.3f} ms, p99 {stats.p99_token_ms():.3f} ms, "
        f"{stats.decode_steps} decode steps, {stats.prefills} prefills "
        f"({stats.chunked_prefills} chunks, {stats.prefix_hits} prefix "
        f"hits), flash_decode launches {launches} "
        f"(= {launches / max(stats.decode_steps, 1):.1f} per step) "
        f"[{card}]")
    if profile:
        profile_generate(ff, compute, prompts, new_tokens, max_len,
                         stats.wall_s, prompt_set)

    # teacher-forced check on request 0's prompt and greedy continuation
    seq = prompts[0] + outs[0]
    plen = len(prompts[0])
    err, _ = decode_vs_forward(ff, seq, plen, min(8, len(outs[0]) - 1),
                               max_len, ff.config.kv_block_size)
    if not err <= E2E_ATOL[compute]:
        fail(f"e2e {compute}: serving logits differ from the plain "
             f"forward by {err} > {E2E_ATOL[compute]}")
    log(f"e2e {compute}: prefill + decode logits vs whole-sequence plain "
        f"forward max |diff| {err:.3g} (atol {E2E_ATOL[compute]})")
    return dict(launches=launches, decode_steps=stats.decode_steps,
                tokens_per_s=stats.tokens_per_s(), p50_token_ms=p50,
                logit_err=err)


def int8_serving_phase(device, card: str, compute: str, lengths,
                       shared_len: int, n_shared: int, new_tokens: int,
                       max_len: int, forced: int = 4, profile: bool = False):
    """GPT-2 small at vocab 50304 served through ``FFModel.generate`` with
    the KV pool in int8 (``--kv-dtype int8``), against the same weights
    with native KV: (a) greedy, (b) temperature 0.8 with top_k 8, (c)
    temperature 0.8 with top_k 1, and the native greedy run. Each run gets
    a fresh engine (an empty prefix cache, so every run admits and chunks
    the prompts alike) warmed up on a short prompt (its decode step
    captured), with the launch counts reset just before the run and read
    just after. Then ``forced`` requests are decoded teacher-forced
    on their greedy int8 streams with both pools. ``--profile`` profiles
    the greedy int8 run once more."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.kernels import topk as tk
    from flexflow_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(vocab_size=VOCAB_PADDED)
    t = time.perf_counter()
    ff = build_model(cfg, compute, device, max_len)
    log(f"int8 {compute}: GPT-2 hidden {cfg.hidden} heads {cfg.num_heads} "
        f"layers {cfg.num_layers} vocab {cfg.vocab_size} built in "
        f"{time.perf_counter() - t:.1f} s")
    prompts = make_prompts(cfg.vocab_size, lengths, shared_len, n_shared)
    layers = cfg.num_layers
    prompt_set = dict(lengths=lengths, shared_len=shared_len,
                      n_shared=n_shared, new_tokens=new_tokens,
                      max_len=max_len)

    def run(kv_dtype: str, prompts, **sampling):
        ff.config.kv_dtype = kv_dtype
        ff._serving_engine = None
        # the fresh engine's warm-up: every program's eager first call and
        # capture, so the run samples in the captured sampler
        warm_serving(ff, **prompt_set, **sampling)
        fd.reset_launch_count()
        tk.reset_launch_count()
        outs = ff.generate(prompts, max_new_tokens=new_tokens,
                           max_decode_len=max_len, **sampling)
        torch.cuda.synchronize()
        counts = {n: fd.launch_count(n) for n in fd.KERNELS}
        counts["topk"] = tk.launch_count()
        stats = ff._serving_engine.stats
        for i, o in enumerate(outs):
            if len(o) != new_tokens or not all(0 <= x < cfg.vocab_size
                                               for x in o):
                fail(f"int8 {compute} {kv_dtype} {sampling}: request {i} "
                     f"produced {o}")
        return outs, stats, counts

    runs = {
        "native": run("native", prompts),
        "greedy": run("int8", prompts),
        "top8": run("int8", prompts, temperature=0.8, top_k=8, seed=SEED),
        "top1": run("int8", prompts, temperature=0.8, top_k=1, seed=SEED),
    }
    for key, (_outs, stats, counts) in runs.items():
        steps = stats.decode_steps
        want = {"flash_decode": layers * steps if key == "native" else 0,
                "flash_decode_int8": 0 if key == "native" else layers * steps,
                "topk": (stats.prefills + steps) if key.startswith("top")
                else 0}
        if counts != want:
            fail(f"int8 {compute} {key}: launches {counts}, want {want} "
                 f"({steps} decode steps, {stats.prefills} prefills)")
        if steps < 1 or stats.chunked_prefills < 1 or stats.prefix_hits < 1:
            fail(f"int8 {compute} {key}: the run must decode, hit the prefix"
                 f" cache and chunk-prefill: {stats.summary()}")
        log(f"int8 {compute} {key}: {stats.tokens_generated} tokens in "
            f"{stats.wall_s:.3f} s = {stats.tokens_per_s():.1f} tokens/s, "
            f"p50 per-token {stats.p50_token_ms():.3f} ms, p99 "
            f"{stats.p99_token_ms():.3f} ms, {steps} decode steps, "
            f"{stats.prefills} prefills ({stats.chunked_prefills} chunks, "
            f"{stats.prefix_hits} prefix hits), kv_bytes_per_token "
            f"{stats.kv_bytes_per_token():.1f}, launches {counts} [{card}]")
    if profile:
        ff.config.kv_dtype = "int8"
        profile_generate(ff, f"int8_{compute}", prompts, new_tokens, max_len,
                         runs["greedy"][1].wall_s, prompt_set)
    greedy = runs["greedy"][0]
    if runs["top1"][0] != greedy:
        fail(f"int8 {compute}: top_k 1 streams differ from the greedy ones")
    same = np.mean([a == b for o8, on in zip(greedy, runs["native"][0])
                    for a, b in zip(o8, on)])
    log(f"int8 {compute}: top_k 1 streams equal the greedy streams; greedy "
        f"tokens equal to native KV's: {same:.4f}; kv_bytes_per_token int8 "
        f"{runs['greedy'][1].kv_bytes_per_token():.1f} vs native "
        f"{runs['native'][1].kv_bytes_per_token():.1f}")

    # teacher-forced int8 decode logits against native KV's on the same
    # tokens (the prefill row reads no cache and is left out)
    errs, agree, rows = [], [], []
    for r in range(forced):
        seq = prompts[r] + greedy[r]
        plen = len(prompts[r])
        got, want = (teacher_forced(ff, seq, plen, new_tokens - 1, max_len,
                                    ff.config.kv_block_size, kv)[1:]
                     for kv in ("int8", "native"))
        if not bool(torch.isfinite(got).all()):
            fail(f"int8 {compute}: non-finite decode logits")
        rows.append(got.float())
        errs.append((got.float() - want.float()).abs().max().item())
        agree += (got.argmax(-1) == want.argmax(-1)).tolist()
    err, agreement = max(errs), float(np.mean(agree))
    band = INT8_BAND[compute]
    log(f"int8 {compute}: teacher-forced decode logits vs native KV over "
        f"{len(agree)} steps: max |diff| {err:.4g} (band {band}), greedy "
        f"argmax agreement {agreement:.4f} (need >= {INT8_ARGMAX_AGREEMENT})"
        f" [{card}]")
    if not (err <= band and agreement >= INT8_ARGMAX_AGREEMENT):
        fail(f"int8 {compute}: int8 logits outside the band of native KV's")
    sampler = sampler_card_vs_cpu(ff, torch.cat(rows), f"int8 {compute}",
                                  card)
    res = {k: dict(counts=v[2], decode_steps=v[1].decode_steps,
                   tokens_per_s=v[1].tokens_per_s(),
                   p50_token_ms=v[1].p50_token_ms(),
                   p99_token_ms=v[1].p99_token_ms(),
                   kv_bytes_per_token=v[1].kv_bytes_per_token())
           for k, v in runs.items()}
    res["logit_err"], res["agreement"] = err, agreement
    res["sampler"] = sampler
    del ff
    torch.cuda.empty_cache()
    return res


# the sampler on the card against the same sampler on CPU tensors: a row
# whose two best Gumbel scores are closer than this may flip on a last-ulp
# difference of log between the devices (scores are of order 10, where an
# fp32 ulp is 1e-6)
SAMPLER_TIE_MARGIN = 1e-4
SAMPLER_TEMPERATURE = 0.8


def sampler_card_vs_cpu(ff, logits, label: str, card: str) -> dict:
    """The captured sampler (the decode step's 8-row program of
    temperature 0.8, top_k 8 and 1, B7 inside) on ``logits`` rows 8 at a
    time on the card, against ``draw_tokens`` on the same rows as CPU
    tensors, with the same (tag, count) rows and seed. Fails unless the
    tokens are equal in every row whose two best Gumbel scores (on the
    CPU) are more than ``SAMPLER_TIE_MARGIN`` apart; prints the rows
    inside the margin."""
    import torch

    from flexflow_tpu_torch.serving.engine import draw_tokens, gumbel_scores

    eng, dev = ff._serving_engine, ff.device
    out = {}
    for k in TOPK_KS:
        sample = eng._sampler(SAMPLER_TEMPERATURE, k)
        total, inside = 0, []
        for b in range(0, logits.shape[0] - SLOTS + 1, SLOTS):
            x = logits[b:b + SLOTS].contiguous()
            tc = torch.tensor([(b + r, 3 * r + k) for r in range(SLOTS)],
                              dtype=torch.int32)
            seed = torch.tensor([SEED + k], dtype=torch.int32)
            on_card = sample(x, tc.to(dev), seed.to(dev)).cpu()
            xc = x.cpu()
            on_cpu = draw_tokens(xc, tc, seed, SAMPLER_TEMPERATURE, k)
            score, _ = gumbel_scores(xc, tc, seed, SAMPLER_TEMPERATURE, k)
            top2 = torch.topk(score, min(2, score.shape[1]), dim=-1).values
            for r in range(SLOTS):
                gap = float(top2[r, 0] - top2[r, 1]) if k > 1 \
                    else float("inf")
                total += 1
                if gap <= SAMPLER_TIE_MARGIN:
                    inside.append((b + r, gap, int(on_cpu[r]),
                                   int(on_card[r])))
                elif int(on_cpu[r]) != int(on_card[r]):
                    fail(f"{label} sampler top_k {k}: row {b + r} draws "
                         f"{int(on_card[r])} on the card and "
                         f"{int(on_cpu[r])} on the CPU (score gap {gap})")
        log(f"{label} sampler top_k {k} card vs cpu: {total} rows at "
            f"temperature {SAMPLER_TEMPERATURE}, tokens equal outside the "
            f"tie margin {SAMPLER_TIE_MARGIN}; {len(inside)} rows inside "
            f"it {inside} [{card}]")
        out[k] = dict(rows=total, inside_margin=len(inside))
    return out


# ------------------------------------------- flash attention (B1-B4) phase
BF16_FLOPS = 989e12
# kernel-phase shapes: BERT-Large's attention (non-causal) and GPT-2
# small's (causal) at batch 8, seq 512; and GPT-2 small's at seq 16384,
# batch 1, where the JAX package's residency rule takes the two-pass
# backward (B3 + B4) as the long-context training paths (fp32 and bf16)
# do
FA_SHAPES = {
    "bert": dict(b=8, h=16, sq=512, sk=512, d=64, causal=False),
    # a tensor-parallel rank's share of the BERT shape at tp = 2 (phase 14)
    "bert_tp2": dict(b=8, h=8, sq=512, sk=512, d=64, causal=False),
    # a pipeline microbatch of the BERT shape: batch 8 in 4 (phase 15)
    "bert_micro": dict(b=2, h=16, sq=512, sk=512, d=64, causal=False),
    "gpt2": dict(b=8, h=12, sq=512, sk=512, d=64, causal=True),
    "long": dict(b=1, h=12, sq=16384, sk=16384, d=64, causal=True),
}
# kernel against plain: O absolute (fp32 summation order; bf16 one output
# rounding), grads relative to their largest element (bf16: P and dS are
# rounded to bf16 before each product on both sides, and a probability one
# fp32 ulp apart can round to neighbouring bf16 values)
FA_TOL = {"fp32": (2e-5, 1e-4), "bf16": (2e-2, 2e-2)}
# the backward's grads are held tile by tile as well: each 64-row tile's
# largest error over that tile's own largest element. Under the causal band
# at seq 16384 a late key's dV (or a late query's dQ) is 3-6x smaller than
# the global limit above, so a kernel that skipped late key blocks or q
# tiles would pass it. The limits sit 2.7x or more above the sound
# kernels' readings and far below a planted fault's (a tile zeroed reads
# 1; each run at seq 16384 prints both, PERF.md records them)
TILE_ROWS = 64
TILE_TOL = {"fp32": 1e-4, "bf16": 2e-2}
FA_KERNELS = {  # name -> (pallas kernel body replaced, flop factor)
    "flash_fwd": ("flexflow_tpu/kernels/flash_attention.py:168", 4),
    "flash_bwd_fused": ("flexflow_tpu/kernels/flash_attention.py:332", 10),
    "flash_bwd_dkv": ("flexflow_tpu/kernels/flash_attention.py:432", 8),
    "flash_bwd_dq": ("flexflow_tpu/kernels/flash_attention.py:496", 6),
}
FA_SOURCE = "flexflow_tpu_torch/kernels/csrc/flash_attention.cu"
LONG_SEQ = FA_SHAPES["long"]["sq"]


def band_pairs(sq: int, sk: int, causal: bool) -> int:
    """(q, k) pairs a query attends: all, or those inside the causal band
    k <= q + (sk - sq)."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(q + off + 1, sk) for q in range(sq))


def fa_bound(kernel: str, shape: dict, el: int):
    """(bound_ms, bound_by) for one launch: the larger of the bytes it must
    move over HBM bandwidth — q, k, v, O and lse for the forward; q, k, v,
    O, dO, lse read and dq, dk, dv written for the fused backward; q, k, v,
    dO, lse, delta read and dk, dv (B3) or dq (B4) written — and its
    matmul flops (4, 10, 8, 6 x d per attended (q, k) pair) over the peak
    for the input dtype (989 TF/s bf16 tensor cores, 67 TF/s fp32)."""
    b, h, sq, sk, d = (shape[k] for k in ("b", "h", "sq", "sk", "d"))
    bh = b * h
    tq, tk, row = bh * sq * d * el, bh * sk * d * el, bh * sq * 4
    nbytes = {"flash_fwd": 2 * tq + 2 * tk + row,
              "flash_bwd_fused": 4 * tq + 4 * tk + row,
              "flash_bwd_dkv": 2 * tq + 4 * tk + 2 * row,
              "flash_bwd_dq": 3 * tq + 2 * tk + 2 * row}[kernel]
    flops = FA_KERNELS[kernel][1] * bh * band_pairs(
        sq, sk, shape["causal"]) * d
    peak = BF16_FLOPS if el == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fa_inputs(shape: dict, dtype, device, seed: int = SEED):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, sq, sk, d = (shape[k] for k in ("b", "h", "sq", "sk", "d"))
    return [torch.randn(s, generator=gen, device=device).to(dtype)
            for s in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d),
                      (b, h, sq, d))]


def rel_err(got, want) -> float:
    scale = max(1.0, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def abs_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def tile_rel_err(got, want, rows: int = TILE_ROWS) -> float:
    """The largest, over (batch, head, tile of ``rows`` rows), of the
    tile's max |got - want| over its own max |want|."""
    import torch.nn.functional as F

    g, w = (t.float().reshape(-1, t.shape[-2], t.shape[-1])
            for t in (got, want))
    pad = -g.shape[1] % rows
    g, w = (F.pad(t, (0, 0, 0, pad)).reshape(t.shape[0], -1,
                                             rows * t.shape[-1])
            for t in (g, w))
    err, scale = (g - w).abs().amax(-1), w.abs().amax(-1)
    # a tile whose reference is all zero counts as wrong if any error
    return (err / scale.clamp_min(1e-30)).max().item()


def planted_faults(want) -> dict:
    """``want`` with rows along the sequence zeroed: what a dK/dV kernel
    that stopped short of the late key blocks (or skipped one), or a dQ
    kernel that did so with q tiles, would write."""
    n = want.shape[-2]
    late = (n - n // 3) // TILE_ROWS * TILE_ROWS
    one = 3 * n // 4 // TILE_ROWS * TILE_ROWS
    out = {}
    for what, start, rows in (("last third", late, n - late),
                              ("one at 3/4", one, TILE_ROWS)):
        bad = want.clone()
        bad.narrow(-2, start, rows).zero_()
        out[what] = bad
    return out


def fa_case(device, card: str, shape_name: str, dname: str,
            dropout: float = 0.0, timed: bool = True):
    """Hold B1-B4 against their plain versions at one shape and dtype and
    (``timed``) time each kernel launch, its plain version, and the
    library yardsticks. Returns {kernel: numbers}."""
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_attention as fa

    shape = FA_SHAPES[shape_name]
    causal = shape["causal"]
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dname]
    seed = 0x5EED if dropout else 0
    # the plain versions' summation blocks: 128 as the attention router
    # picks at seq 512, 512 at long context (fewer Python tile steps)
    blk = 512 if shape["sq"] > 4096 else 128
    q, k, v, do = fa_inputs(shape, dtype, device)
    out_tol, grad_tol = FA_TOL[dname]
    want_o, want_lse = fa.flash_forward_plain(q, k, v, causal, blk, blk,
                                              dropout, seed)
    got_o, got_lse = fa._flash_forward(q, k, v, causal, blk, blk, dropout,
                                       seed)
    errs = {"flash_fwd": (abs_err(got_o, want_o), abs_err(got_o, want_o),
                          out_tol)}
    tiles = {}
    if abs_err(got_lse, want_lse) > 1e-4:
        fail(f"flash_fwd {shape_name} {dname}: lse differs by "
             f"{abs_err(got_lse, want_lse)}")
    for fused in (True, False):
        got = fa._flash_backward(q, k, v, want_o, want_lse, do, causal, blk,
                                 blk, dropout, seed, fused=fused)
        want = fa.flash_backward_plain(q, k, v, want_o, want_lse, do, causal,
                                       blk, blk, dropout, seed, fused=fused)
        pairs = [(g, w) for g, w in zip(got, want)]
        for name, sel in ((("flash_bwd_fused", pairs),) if fused else
                          (("flash_bwd_dq", pairs[:1]),
                           ("flash_bwd_dkv", pairs[1:]))):
            errs[name] = (max(abs_err(g, w) for g, w in sel),
                          max(rel_err(g, w) for g, w in sel), grad_tol)
            tiles[name] = max(tile_rel_err(g, w) for g, w in sel)
        if not fused and shape_name == "long":
            # the check's reach: the readings of planted faults, the
            # global one beside the tile one
            for name, sel in (("flash_bwd_dq", want[:1]),
                              ("flash_bwd_dkv", want[1:])):
                bads = [planted_faults(w) for w in sel]
                unit = "q tiles" if name == "flash_bwd_dq" else "key blocks"
                for what in bads[0]:
                    glob = max(rel_err(b[what], w) for b, w in zip(bads, sel))
                    tile = max(tile_rel_err(b[what], w)
                               for b, w in zip(bads, sel))
                    log(f"planted fault {name} {shape_name} {dname} ({unit}: "
                        f"{what} zeroed): global {glob:.3g} (limit "
                        f"{grad_tol}), tile {tile:.3g} (limit {TILE_TOL[dname]}); the "
                        f"kernel's: global {errs[name][1]:.3g}, tile "
                        f"{tiles[name]:.3g} [{card}]")
                    if not tile > TILE_TOL[dname]:
                        fail(f"the tile check misses a planted fault in "
                             f"{name} {shape_name} {dname}: {tile} <= "
                             f"{TILE_TOL[dname]}")
    torch.cuda.synchronize()
    for name, (ae, re, tol) in errs.items():
        err = ae if name == "flash_fwd" else re
        if not err <= tol:
            fail(f"{name} {shape_name} {dname} dropout {dropout}: kernel vs "
                 f"plain error {err} > {tol}")
    for name, err in tiles.items():
        if not err <= TILE_TOL[dname]:
            fail(f"{name} {shape_name} {dname} dropout {dropout}: kernel vs "
                 f"plain error {err} of a {TILE_ROWS}-row tile's largest "
                 f"element > {TILE_TOL[dname]}")
    if not timed:
        log(f"kernel flash attention {shape_name} {dname} dropout "
            f"{dropout}: B1-B4 agree with their plain versions (max rel "
            f"err {max(e[1] for e in errs.values()):.3g}, tile "
            f"{max(tiles.values()):.3g}) [{card}]")
        return {}

    # -- timing: each launch alone into preallocated buffers and the
    # library calls, as CUDA graph replays; the plain versions eagerly
    qs, dor, delta2 = fa._bwd_inputs(q, want_o, do, fused=False)
    out, lse = torch.empty_like(q), torch.empty_like(want_lse)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=device)
    args = (causal, dropout, seed)
    launches = {
        "flash_fwd": lambda i: fa._launch_fwd(qs, k, v, out, lse, *args),
        "flash_bwd_fused": lambda i: fa._launch_bwd_kv(
            qs, k, v, want_o, dor, want_lse, None, dk, dv, dq_acc, *args),
        "flash_bwd_dkv": lambda i: fa._launch_bwd_kv(
            qs, k, v, want_o, dor, want_lse, delta2, dk, dv, None, *args),
        "flash_bwd_dq": lambda i: fa._launch_bwd_q(
            qs, k, v, dor, want_lse, delta2, dq, *args),
    }
    pargs = (qs, k, v, dor, want_lse, delta2, causal, blk, blk, dropout,
             seed)
    plains = {
        "flash_fwd": lambda i: fa.flash_forward_plain(q, k, v, causal, blk,
                                                      blk, dropout, seed),
        "flash_bwd_fused": lambda i: fa.flash_backward_plain(
            q, k, v, want_o, want_lse, do, causal, blk, blk, dropout, seed,
            fused=True),
        "flash_bwd_dkv": lambda i: fa.flash_bwd_kv_plain(*pargs),
        "flash_bwd_dq": lambda i: fa.flash_bwd_q_plain(*pargs),
    }
    # yardsticks: SDPA forward, and SDPA's backward alone (autograd.grad
    # of a retained forward graph), which computes what B2 computes; the
    # forward runs on the side stream the backward is captured on
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    torch.cuda.current_stream(device).wait_stream(side)
    library = {
        "flash_fwd": lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal),
        "flash_bwd_fused": lambda i: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True),
    }
    flops_long = shape["sq"] > 4096
    iters, plain_iters = (3, 1) if flops_long else (20, 2)
    res = {}
    for name in FA_KERNELS:
        ms = time_ms(launches[name], iters, device, graph=True)
        eager_ms = time_ms(launches[name], iters, device)
        plain_ms = time_ms(plains[name], plain_iters, device)
        lib_ms = (time_ms(library[name], iters, device, graph=True,
                          stream=side) if name in library else None)
        bound_ms, bound_by = fa_bound(name, shape, q.element_size())
        ae, re, _tol = errs[name]
        res[name] = dict(max_abs_err=ae, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, eager_ms=eager_ms)
        tile_txt = ""
        if name in tiles:
            res[name]["max_tile_rel_err"] = tiles[name]
            tile_txt = f", tile {tiles[name]:.3g}"
        lib_txt = f"{lib_ms * 1e3:.1f} us" if lib_ms is not None else "none"
        log(f"kernel {name} {shape_name} {dname} (b{shape['b']} "
            f"h{shape['h']} s{shape['sq']} d{shape['d']}"
            f"{' causal' if causal else ''}): max_abs_err {ae:.3g} (rel "
            f"{re:.3g}{tile_txt}), {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, "
            f"sdpa {lib_txt}, bound {bound_ms * 1e3:.2f} us ({bound_by}; "
            f"{bound_ms / ms:.3f} of it) [{card}]")
    # the two-pass pair against SDPA's backward, which computes the same
    # dq, dk, dv in one call
    pair = res["flash_bwd_dkv"]["ms"] + res["flash_bwd_dq"]["ms"]
    sdpa_bwd = res["flash_bwd_fused"]["library_ms"]
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        res[name]["pair_library_ms"] = sdpa_bwd
    bound = sum(res[n]["bound_ms"] for n in ("flash_bwd_dkv",
                                              "flash_bwd_dq"))
    log(f"pair B3+B4 {shape_name} {dname}: {pair * 1e3:.1f} us against "
        f"sdpa backward {sdpa_bwd * 1e3:.1f} us ({pair / sdpa_bwd:.3f}x)"
        f"; bound {bound * 1e3:.2f} us ({bound / pair:.3f} of it) "
        f"[{card}]")
    fwdbwd = time_ms(lambda i: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, is_causal=causal), leaves,
        do), iters, device, graph=True, stream=side)
    log(f"library sdpa forward+backward {shape_name} {dname}: "
        f"{fwdbwd * 1e3:.1f} us; flash kernels B1+B2 "
        f"{(res['flash_fwd']['ms'] + res['flash_bwd_fused']['ms']) * 1e3:.1f}"
        f" us [{card}]")
    return res


def fa_kernel_phase(device, card: str):
    out = {}
    for shape_name, dname in (("bert", "bf16"), ("bert", "fp32"),
                              ("gpt2", "fp32"), ("gpt2", "bf16"),
                              ("long", "fp32"), ("long", "bf16")):
        for name, r in fa_case(device, card, shape_name, dname).items():
            out[(name, shape_name, dname)] = r
    fa_case(device, card, "bert", "bf16", dropout=0.1, timed=False)
    # host cost of the TMA descriptors the 16-bit kernels encode on every
    # launch (B1 3, B2 5, B3 and B4 4 each), beside the time a launch from
    # Python takes
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    us = fa.tensor_map_us(fa_inputs(FA_SHAPES["bert"], torch.bfloat16,
                                    device)[0])
    eager = {n: out[(n, "bert", "bf16")]["eager_ms"] * 1e3 for n in FA_KERNELS}
    log(f"host: one TMA descriptor encodes in {us:.3f} us: {3 * us:.3f} us "
        f"a 16-bit forward launch, {5 * us:.3f} us a fused backward launch, "
        f"{4 * us:.3f} us a dK/dV or dQ launch (a launch from Python: "
        f"forward {eager['flash_fwd']:.1f} us, fused backward "
        f"{eager['flash_bwd_fused']:.1f} us, dK/dV "
        f"{eager['flash_bwd_dkv']:.1f} us, dQ {eager['flash_bwd_dq']:.1f} "
        f"us) [{card}]")
    for r in out.values():
        r.pop("eager_ms")
    return out


# ------------------------------------------------------------ training phase
def train_model(kind: str, compute: str, device, seq: int = 512,
                batch: int = 8, softmax_kernel: bool = False,
                fusion: bool = False, strategy_fn=None,
                num_layers: int = 0, per_op: bool = False):
    """A model the port trains, as a user builds it: the BERT-Large proxy
    (``bench.py``'s flagship config) or GPT-2 small with a softmax head and
    token-level labels; Adam, sparse categorical cross-entropy; random
    weights from the seed. ``softmax_kernel``: GPT-2 small at vocab 50304
    with the head's softmax opted into the row-softmax kernel
    (``ff.softmax(logits, use_pallas=True)``). ``--profiling`` records
    each step's wall; ``fusion`` compiles with ``--fusion``;
    ``strategy_fn`` compiles for a device mesh (phase 14); ``num_layers``
    cuts BERT's depth (its widths stay); ``per_op`` leaves the per-op
    block of ``--profiling`` (``profile_operators``) to the caller."""
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType, MetricsType)
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    config = FFConfig()
    config.batch_size, config.seed = batch, SEED
    config.profiling, config.print_freq = True, 1
    config.perform_fusion = fusion
    if compute == "bf16":
        config.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(config, device=device)
    metrics = []
    if kind == "bert":
        cfg = BertConfig.large()
        if num_layers:
            cfg.num_layers = num_layers
        build_bert(ff, cfg)
        metrics = [MetricsType.METRICS_ACCURACY]
    else:
        cfg = GPT2Config(batch_size=batch, seq_len=seq)
        if softmax_kernel:
            cfg.vocab_size = VOCAB_PADDED
        _ids, logits = build_gpt2(ff, cfg)
        ff.softmax(logits, use_pallas=softmax_kernel)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=metrics, strategy_fn=strategy_fn)
    # --profiling here records each step's wall; its per-op block is
    # phase 17's, run here with no op, so a phase's launch counts stay its
    # steps' alone
    if not per_op:
        ff.profile_operators(0)
    return ff, cfg


def train_data(kind: str, cfg, n: int):
    rng = np.random.default_rng(SEED)
    if kind == "bert":
        x = rng.standard_normal((n, cfg.seq_len, cfg.hidden),
                                dtype=np.float32)
        y = rng.integers(0, cfg.num_classes, (n, 1)).astype(np.int32)
    else:
        x = rng.integers(0, cfg.vocab_size, (n, cfg.seq_len)).astype(
            np.int32)
        y = rng.integers(0, cfg.vocab_size, (n, cfg.seq_len)).astype(
            np.int32)
    return x, y


def set_flash(ff, on: bool) -> None:
    from flexflow_tpu_torch import OperatorType

    for node in ff.pcg.compute_nodes():
        if node.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION:
            node.op.attrs["use_flash"] = "auto" if on else False


def set_softmax_kernel(ff, on: bool) -> None:
    from flexflow_tpu_torch import OperatorType

    for node in ff.pcg.compute_nodes():
        if node.op.op_type == OperatorType.OP_SOFTMAX:
            node.op.attrs["use_pallas"] = on


def grad_check(ff, x, y, route, counter, want: dict):
    """One step's loss and grads with the kernels under test against the
    same step with ``route(ff, False)``: attention through the einsum core
    (``set_flash``) or the head's softmax through ``torch.softmax``
    (``set_softmax_kernel``). The kernel step must launch ``want``
    ({kernel: count} of the ``counter`` module). Returns (|loss diff|,
    relative grad-norm error, max per-tensor relative norm error)."""
    import torch

    ex, dev = ff.executor, ff.device
    xs = [torch.from_numpy(x).to(dev)]
    lab = torch.from_numpy(ff._prep_label(y)).to(dev)
    counter.reset_launch_count()
    lk, _, gk = ex.loss_and_grads(ff.params, xs, lab)
    torch.cuda.synchronize()
    got = {n: counter.launch_count(n) for n in want}
    if got != want:
        fail(f"grad check: launches {got}, want {want}")
    route(ff, False)
    try:
        lc, _, gc = ex.loss_and_grads(ff.params, xs, lab)
    finally:
        route(ff, True)
    num = den = 0.0
    worst = 0.0
    for n, ws in gc.items():
        for w, g in ws.items():
            d = (gk[n][w] - g).float().norm().item()
            gn = g.float().norm().item()
            num += d * d
            den += gn * gn
            worst = max(worst, d / max(gn, 1e-30))
    return abs(lk.item() - lc.item()), (num / max(den, 1e-30)) ** 0.5, worst


# kernels vs einsum core over one whole step: fp32 differs in summation
# order only; in bf16 the flash path rounds the unnormalised probabilities
# and the core the normalised ones, before the PV product, in every layer
TRAIN_TOL = {"fp32": (1e-4, 1e-4), "bf16": (2e-2, 5e-2)}
# the softmax kernel vs torch.softmax over one whole fp32 step: both
# compute in fp32 and differ in summation order only
SOFTMAX_STEP_TOL = (1e-5, 1e-4)


def train_phase(device, card: str, kind: str, compute: str, steps: int,
                warmup: int, profile: bool = False, seq: int = 512,
                batch: int = 8, check_grads: bool = True,
                softmax_kernel: bool = False):
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.kernels import softmax as sm
    from flexflow_tpu_torch.models.bert import bert_train_flops_per_step
    from flexflow_tpu_torch.models.gpt2 import gpt2_train_flops_per_step

    label = (f"{kind}{'' if seq == 512 else f'-seq{seq}'}"
             f"{'-softmax-kernel' if softmax_kernel else ''} {compute}")
    t = time.perf_counter()
    ff, cfg = train_model(kind, compute, device, seq=seq, batch=batch,
                          softmax_kernel=softmax_kernel)
    layers = cfg.num_layers
    x, y = train_data(kind, cfg, batch * (warmup + steps))
    log(f"train {label}: hidden {cfg.hidden} heads {cfg.num_heads} layers "
        f"{layers} seq {cfg.seq_len} batch {batch}"
        f"{f' vocab {cfg.vocab_size}' if kind == 'gpt2' else ''} built in "
        f"{time.perf_counter() - t:.1f} s")
    if check_grads:
        # at the initial weights, before the softmax head saturates
        if softmax_kernel:
            what = "the softmax kernel vs torch.softmax"
            check = (set_softmax_kernel, sm,
                     {"softmax_fwd": 1, "softmax_bwd": 1})
            ltol, gtol = SOFTMAX_STEP_TOL
        else:
            what = "the flash kernels vs the einsum core"
            check = (set_flash, fa, {"flash_fwd": layers})
            ltol, gtol = TRAIN_TOL[compute]
        dl, grel, worst = grad_check(ff, x[:batch], y[:batch], *check)
        log(f"train {label}: one step with {what}: |loss diff| {dl:.3g} "
            f"(tol {ltol}), grad relative norm error {grel:.3g} (tol "
            f"{gtol}), worst tensor {worst:.3g} [{card}]")
        if not (dl <= ltol and grel <= gtol):
            fail(f"train {label}: {what} disagree")
        # the reference step's tensors leave the allocator's cache in
        # another shape than the kernel steps want
        torch.cuda.empty_cache()
    if warmup:
        ff.fit(x[:batch * warmup], y[:batch * warmup], epochs=1)
        torch.cuda.synchronize()
    fa.reset_launch_count()
    sm.reset_launch_count()
    perf = ff.fit(x[batch * warmup:], y[batch * warmup:], epochs=1)
    torch.cuda.synchronize()
    counts = {n: fa.launch_count(n) for n in fa.KERNELS}
    counts.update((n, sm.launch_count(n)) for n in sm.KERNELS)
    losses = ff.fit_history.loss
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train {label}: losses {losses}")
    if perf.train_all != batch * steps:
        fail(f"train {label}: PerfMetrics counted {perf.train_all} samples")
    two_pass = not fa.use_fused_backward(cfg.seq_len,
                                         cfg.hidden // cfg.num_heads)
    want = {"flash_fwd": layers * steps,
            "flash_bwd_fused": 0 if two_pass else layers * steps,
            "flash_bwd_dkv": layers * steps if two_pass else 0,
            "flash_bwd_dq": layers * steps if two_pass else 0,
            "softmax_fwd": steps if softmax_kernel else 0,
            "softmax_bwd": steps if softmax_kernel else 0}
    if counts != want:
        fail(f"train {label}: kernel launches {counts}, want {want} "
             f"({layers} layers x {steps} steps)")
    p50 = float(np.median(ff.fit_history.step_s))
    flops = (bert_train_flops_per_step(cfg) if kind == "bert"
             else gpt2_train_flops_per_step(cfg))
    log(f"train {label}: {steps} steps after {warmup} warm-up, losses "
        f"{[round(v, 4) for v in losses]}, p50 step {p50 * 1e3:.1f} ms, "
        f"{batch / p50:.2f} samples/s, {flops / p50 / 1e12:.1f} TFLOP/s "
        f"= MFU {flops / p50 / BF16_FLOPS:.4f} of 989 TF/s; kernel launches "
        f"per step {({n: c // steps for n, c in counts.items() if c})} "
        f"[{card}]")
    res = dict(counts=counts, p50_ms=p50 * 1e3, losses=losses)
    if profile:
        profile_train(ff, x[:batch], y[:batch],
                      f"long {compute}" if seq == LONG_SEQ else label, p50)
    del ff
    torch.cuda.empty_cache()
    return res


def profile_train(ff, x, y, label: str, step_s: float) -> None:
    """``--profile``: one more training step under ``torch.profiler``. Prints
    the card's busy time (the sum of kernel times) against the unprofiled
    p50 step and writes the kernels by total time to
    ``chiprun_out/profile_train_<label>.txt``."""
    import os
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ff.fit(x, y, epochs=1)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        log(f"profile train {label}: the profiler saw no kernel time; "
            "device busy share not measured")
        return
    flash = sum(e.self_device_time_total for e in kernels
                if "flash_" in e.key)
    gemm = sum(e.self_device_time_total for e in kernels
               if any(w in e.key.lower()
                      for w in ("gemm", "cutlass", "nvjet", "xmma")))
    log(f"profile train {label}: kernels busy {busy_us / 1e3:.3f} ms of the "
        f"unprofiled p50 step's {step_s * 1e3:.3f} ms (idle share "
        f"{1 - busy_us / 1e3 / (step_s * 1e3):.4f}); flash attention "
        f"{flash / 1e3:.3f} ms ({flash / busy_us:.3f}), GEMMs "
        f"{gemm / 1e3:.3f} ms ({gemm / busy_us:.3f}), other "
        f"{(busy_us - flash - gemm) / 1e3:.3f} ms; "
        f"{sum(e.count for e in kernels)} kernel launches")
    by_kernel = {}
    for e in kernels:
        m = re.search(r"flash_\w+", e.key)
        if m:
            by_kernel[m.group(0)] = (by_kernel.get(m.group(0), 0.0)
                                     + e.self_device_time_total)
    log(f"profile train {label}: flash attention by kernel: "
        + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in by_kernel.items()))
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out",
                        f"profile_train_{label.replace(' ', '_')}.txt")
    with open(path, "w") as f:
        f.write("kernel\tcount\ttotal_us\tshare\n")
        for e in kernels:
            f.write(f"{e.key}\t{e.count}\t{e.self_device_time_total:.1f}\t"
                    f"{e.self_device_time_total / busy_us:.4f}\n")
    for e in kernels[:10]:
        log(f"profile train {label}:   {e.self_device_time_total / 1e3:9.3f}"
            f" ms {e.count:6d}x {e.key[:90]}")
    log(f"profile train {label}: full table in {path}")


# ------------------------------------------------ captured vs eager steps
# captured vs eager after the same steps from the same weights, batches
# and generator seeds. fp32: the same kernels on the same inputs, except
# that the fused backward (B2) adds dQ by reduce-adds in no fixed order, so
# the two differ by that ordering only; bf16: the band of a bf16 step
GRAPH_TOL = {"fp32": (1e-6, 1e-5), "bf16": TRAIN_TOL["bf16"]}


def state_tensors(ff) -> list:
    """Every param and optimizer-state tensor of ``ff``, in order."""
    from flexflow_tpu_torch.execution.graphs import _tensors_of

    return _tensors_of([ff.params, ff.opt_state])


def profiled(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy ms (the
    sum of its kernel, copy and memset times), of which ``nccl_ms`` in
    NCCL kernels (a receive's kernel spins until its peer sends), the
    device operations it ran, and the host's kernel launch calls (``cudaLaunchKernel`` and the
    like) and graph launch calls (``cudaGraphLaunch``). Read from the raw
    trace events: building the profiler's event tree for a whole generate
    (tens of thousands of launches) takes longer than the run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_ns = ops = kernel_calls = graph_calls = nccl_ns = 0
    nccl = set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy_ns += e.duration_ns()
            ops += 1
            if "nccl" in e.name().lower():
                nccl.add(e.name())
                nccl_ns += e.duration_ns()
        else:
            name = e.name()
            kernel_calls += "LaunchKernel" in name
            graph_calls += "GraphLaunch" in name
    return dict(busy_ms=busy_ns / 1e6, device_ops=ops,
                kernel_launch_calls=kernel_calls,
                graph_launch_calls=graph_calls, nccl_kernels=sorted(nccl),
                nccl_ms=nccl_ns / 1e6)


def replay_ms(program, iters: int = 3) -> float:
    """Device ms of one replay of ``program``'s graph, CUDA events around
    ``iters`` back-to-back replays: the step's device time without the
    host, read even where the profiler would not see inside a graph."""
    import torch

    (entry,) = [e for e in program._entries.values() if e.graph is not None]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        entry.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fit_steps(ff, xs, y, batch: int):
    """``run_steps`` of :func:`eager_and_captured` for a model trained
    through ``fit``: one epoch over ``xs`` (a list of input arrays) and
    ``y`` with the eager step body or the captured program, the generator
    seeds from the start. Returns (losses, step walls in s, one more step
    on the first batch)."""
    def run(mode: str):
        ff._rng_counter = 0
        ff._capture_steps = mode == "captured"
        ff.fit(xs, y, epochs=1)
        return (list(ff.fit_history.loss), list(ff.fit_history.step_s),
                lambda: ff.fit([a[:batch] for a in xs], y[:batch], epochs=1))
    return run


def train_step_steps(ff, batches):
    """``run_steps`` of :func:`eager_and_captured` for a model trained
    through ``Executor.make_train_step`` (NMT's flattened token labels):
    one step a (device inputs, device labels) pair of ``batches``, each
    ended by a device sync and timed, through the eager body or the
    captured program."""
    import torch

    def run(mode: str):
        step = ff.executor.make_train_step(capture=mode == "captured")
        walls, losses = [], []
        for xs, lab in batches:
            t = time.perf_counter()
            _p, _s, loss, _m = step(ff.params, ff.opt_state, xs, lab, None)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            losses.append(float(loss))
        xs0, lab0 = batches[0]
        return losses, walls, lambda: step(ff.params, ff.opt_state, xs0,
                                           lab0, None)
    return run


def eager_and_captured(ff, run_steps, steps: int, warmup: int, label: str,
                       measure: bool = True) -> dict:
    """The same ``warmup + steps`` training steps of ``ff``, first with
    the eager step body, then with the captured program, from the same
    weights and optimizer state: ``run_steps(mode)`` (:func:`fit_steps`,
    :func:`train_step_steps`) runs them and returns (losses, step walls,
    one more step). Per mode: p50 step ms over the ``steps`` after
    warm-up, the losses, the params after the run, the flash launches a
    step, peak memory and, with ``measure``, one more step under the
    profiler (busy ms, device ops, host launch calls); the captured mode
    also one replay by CUDA events. Fails unless the captured program
    captured once, every loss is finite and both modes launch the same
    kernels a step."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    snap = [t.clone() for t in state_tensors(ff)]
    res = {}
    for mode in ("eager", "captured"):
        for t, v in zip(state_tensors(ff), snap):
            t.copy_(v)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()
        losses, walls, again = run_steps(mode)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        totals = {n: c for n in fa.KERNELS if (c := fa.launch_count(n))}
        counts = {n: c // (warmup + steps) for n, c in totals.items()}
        if len(losses) != warmup + steps or not all(np.isfinite(losses)):
            fail(f"{label} {mode}: losses {losses}")
        p50 = float(np.median(walls[warmup:])) * 1e3
        after = [t.clone() for ws in ff.params.values()
                 for t in ws.values()]
        res[mode] = dict(p50_ms=p50, peak_gb=peak / 2 ** 30, counts=counts,
                         totals=totals, losses=losses, params=after)
        if measure:
            res[mode].update(profiled(again))
        if mode == "captured":
            program = ff.executor.make_train_step().program
            if program.captures != 1:
                fail(f"{label}: {program.captures} captures, want 1")
            if measure:
                res[mode]["replay_ms"] = replay_ms(program)
    e, c = res["eager"], res["captured"]
    if c["counts"] != e["counts"]:
        fail(f"{label}: kernel launches a step {c['counts']} captured vs "
             f"{e['counts']} eager")
    res["loss_rel_diff"] = max(abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(c["losses"], e["losses"]))
    res["param_rel_diff"] = rel_norm(c["params"], e["params"])
    for r in (e, c):
        del r["params"]
    return res


def mode_line(r: dict, steps: int, warmup: int) -> str:
    """One mode's figures of :func:`eager_and_captured`."""
    return (f"p50 step {r['p50_ms']:.3f} ms over {steps} steps after "
            f"{warmup}; one step under the profiler: busy "
            f"{r['busy_ms']:.3f} ms (idle share "
            f"{1 - r['busy_ms'] / r['p50_ms']:.4f} of the p50), "
            f"{r['device_ops']} device ops, host launch calls "
            f"{r['kernel_launch_calls']} kernel / {r['graph_launch_calls']} "
            f"graph; peak memory {r['peak_gb']:.3f} GiB"
            + (f"; one replay {r['replay_ms']:.3f} ms by CUDA events (idle "
               f"share {1 - r['replay_ms'] / r['p50_ms']:.4f})"
               if 'replay_ms' in r else ""))


def graph_train(device, card: str, kind: str, compute: str, steps: int,
                warmup: int = 2) -> dict:
    """:func:`eager_and_captured` on the BERT-Large proxy or GPT-2 small
    (``train_model``); prints both modes and the loss and param
    differences after the run, and fails outside ``GRAPH_TOL`` or if the
    kernels' launches a step differ."""
    import torch

    label = f"graph train {kind} {compute}"
    ff, cfg = train_model(kind, compute, device)
    batch = cfg.batch_size
    x, y = train_data(kind, cfg, batch * (warmup + steps))
    res = eager_and_captured(ff, fit_steps(ff, [x], y, batch), steps, warmup,
                             label)
    e, c = res["eager"], res["captured"]
    for mode in ("eager", "captured"):
        log(f"{label} {mode}: {mode_line(res[mode], steps, warmup)}; flash "
            f"launches a step {res[mode]['counts']} [{card}]")
    dloss, dparams = res["loss_rel_diff"], res["param_rel_diff"]
    ltol, ptol = GRAPH_TOL[compute]
    log(f"{label}: after {warmup + steps} steps, captured vs eager: max "
        f"relative loss difference {dloss:.3g} (tol {ltol}), param relative "
        f"norm difference {dparams:.3g} (tol {ptol}); p50 "
        f"{e['p50_ms']:.3f} -> {c['p50_ms']:.3f} ms "
        f"({e['p50_ms'] / c['p50_ms']:.2f}x) [{card}]")
    if not (dloss <= ltol and dparams <= ptol):
        fail(f"{label}: captured and eager steps disagree")
    del ff
    torch.cuda.empty_cache()
    return res


def rel_norm(got, want) -> float:
    num = sum(float((a - b).float().norm()) ** 2 for a, b in zip(got, want))
    den = sum(float(b.float().norm()) ** 2 for b in want)
    return (num / max(den, 1e-30)) ** 0.5


# graph_serve's modes: (name, captured programs, serve loop)
SERVE_MODES = (("eager", False, "sync"), ("captured", True, "sync"),
               ("async", True, "async"))
# GPT-2 small's timed generate with only the decode step captured (eager
# prefills, chunks, sampler and slot writes; PERF.md section 5): host
# kernel and graph launch calls
DECODE_ONLY_LAUNCH_CALLS = (3910, 32)
# kernel launch calls a scheduler action the captured modes may make
MAX_LAUNCH_CALLS_PER_ACTION = 10


def graph_serve(device, card: str, cfg, kv_dtype: str, lengths,
                shared_len: int, n_shared: int, new_tokens: int,
                max_len: int, model=None, label: str = "") -> dict:
    """GPT-2 small (fp32) serves the e2e prompts greedily with
    ``kv_dtype`` KV in three modes (``SERVE_MODES``): the eager step
    bodies, the captured programs under the sync loop, and the captured
    programs under ``--serve-loop async``, each on a fresh engine warmed
    up by :func:`warm_serving`. Per mode the timed generate, then the
    same generate on prompts of the same shapes under the profiler.
    Asserted: token-identical streams, the same flash-decode launches a
    decode step (one a layer), ``decode_compiles == 1`` and no capture in
    any program across the timed and the profiled generate for the
    captured modes, one token fetch a committed decode step
    (``host_syncs``; at most one async), host work overlapped in the async
    loop (``host_overlap_s > 0``), at most
    ``MAX_LAUNCH_CALLS_PER_ACTION`` kernel launch calls a scheduler action
    captured, and teacher-forced decode logits within ``E2E_ATOL`` (B5
    merges in a fixed order: 0 expected). Prints tokens/s, p50/p99
    per-token ms, peak memory, the host split, and the idle share and host
    launch calls of the profiled generate beside
    ``DECODE_ONLY_LAUNCH_CALLS``. ``model`` serves
    a model built by the caller (fp32) instead of GPT-2 small. The result
    also holds request 0's prompt and stream (``stream0``)."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd

    label = label or f"graph serve {kv_dtype}"
    ff = model if model is not None else build_model(cfg, "fp32", device,
                                                     max_len)
    ff.config.kv_dtype = kv_dtype
    vocab = ff.pcg.nodes[ff.executor.final_guid].out_shapes[
        ff.executor.final_out_idx][-1]
    shapes = dict(lengths=lengths, shared_len=shared_len, n_shared=n_shared,
                  new_tokens=new_tokens, max_len=max_len)
    prompts = make_prompts(vocab, lengths, shared_len, n_shared)
    profile_prompts = make_prompts(vocab, lengths, shared_len, n_shared,
                                   PROFILE_PROMPT_SEED)
    name = "flash_decode_int8" if kv_dtype == "int8" else "flash_decode"
    res = {}

    def generate(ps):
        t = time.perf_counter()
        outs = ff.generate(ps, max_new_tokens=new_tokens,
                           max_decode_len=max_len)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t

    for mode, capture, loop in SERVE_MODES:
        ff._capture_steps = capture
        ff.config.serve_loop = loop
        ff._serving_engine = None
        warm_serving(ff, **shapes)
        eng = ff._serving_engine
        before = serving_captures(eng)
        fd.reset_launch_count()
        torch.cuda.reset_peak_memory_stats()
        outs, _wall = generate(prompts)
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        stats = eng.stats
        launches = fd.launch_count(name)
        per_step = launches / max(stats.decode_steps, 1)
        compiles = eng.decode_compiles
        walls = {}
        prof = profiled(lambda: walls.setdefault(
            "s", generate(profile_prompts)[1]))
        pstats = eng.stats
        captured = serving_captures(eng) - before
        per_action = prof["kernel_launch_calls"] / max(pstats.host_ticks, 1)
        res[mode] = dict(outs=outs, launches=launches,
                         tokens_per_s=stats.tokens_per_s(),
                         p50_token_ms=stats.p50_token_ms(),
                         p99_token_ms=stats.p99_token_ms(),
                         wall_s=stats.wall_s, decode_steps=stats.decode_steps,
                         launches_per_step=per_step, decode_compiles=compiles,
                         captures_in_runs=captured,
                         host_syncs=stats.host_syncs,
                         host_dispatch_s=stats.host_dispatch_s,
                         host_device_s=stats.host_device_s,
                         host_bookkeep_s=stats.host_bookkeep_s,
                         host_overlap_s=stats.host_overlap_s,
                         host_ticks=stats.host_ticks,
                         host_overhead_fraction=
                         stats.host_overhead_fraction(),
                         launch_calls_per_action=per_action,
                         peak_gb=peak / 2 ** 30,
                         reserved_gb=reserved / 2 ** 30,
                         idle_share=1 - prof["busy_ms"] / (stats.wall_s * 1e3),
                         **prof)
        log(f"{label} {mode}: {stats.tokens_generated} tokens in "
            f"{stats.wall_s:.3f} s = {stats.tokens_per_s():.1f} tokens/s, "
            f"p50 per-token {stats.p50_token_ms():.3f} ms, p99 "
            f"{stats.p99_token_ms():.3f} ms, {stats.decode_steps} decode "
            f"steps ({stats.prefills} prefills, {stats.prefix_hits} prefix "
            f"hits, {stats.chunked_prefills} chunks), {name} launches a "
            f"step {per_step:.1f}, decode_compiles {compiles}, captures in "
            f"the timed and profiled runs {captured}, peak memory "
            f"{peak / 2 ** 30:.3f} GiB allocated, {reserved / 2 ** 30:.3f} "
            f"GiB reserved; host split: dispatch "
            f"{stats.host_dispatch_s * 1e3:.3f} ms, device "
            f"{stats.host_device_s * 1e3:.3f} ms, bookkeeping "
            f"{stats.host_bookkeep_s * 1e3:.3f} ms, overlap "
            f"{stats.host_overlap_s * 1e3:.3f} ms over {stats.host_ticks} "
            f"ticks (host_overhead_fraction "
            f"{stats.host_overhead_fraction():.4f}), host_syncs "
            f"{stats.host_syncs}; the same generate on other prompts of "
            f"these shapes under the profiler: busy {prof['busy_ms']:.3f} "
            f"ms (idle share {res[mode]['idle_share']:.4f} of the "
            f"unprofiled wall; profiled wall {walls['s'] * 1e3:.3f} ms), "
            f"{prof['device_ops']} device ops, host launch calls "
            f"{prof['kernel_launch_calls']} kernel / "
            f"{prof['graph_launch_calls']} graph ({per_action:.2f} kernel "
            f"launch calls a scheduler action over {pstats.host_ticks}; "
            f"with only the decode step captured: "
            f"{DECODE_ONLY_LAUNCH_CALLS[0]} / {DECODE_ONLY_LAUNCH_CALLS[1]}) "
            f"[{card}]")
    ff.config.serve_loop = "sync"
    e = res["eager"]
    for mode, capture, loop in SERVE_MODES:
        r = res[mode]
        if r["outs"] != e["outs"]:
            fail(f"{label}: {mode} greedy streams differ from eager ones")
        if r["launches_per_step"] != cfg.num_layers:
            fail(f"{label}: {name} launches a step {r['launches_per_step']}"
                 f" in mode {mode}, want {cfg.num_layers}")
        if loop == "sync" and r["host_syncs"] != r["decode_steps"]:
            fail(f"{label} {mode}: host_syncs {r['host_syncs']} != "
                 f"decode_steps {r['decode_steps']}")
        if loop == "async" and not (r["host_syncs"] <= r["decode_steps"]
                                    and r["host_overlap_s"] > 0.0):
            fail(f"{label} {mode}: host_syncs {r['host_syncs']} over "
                 f"{r['decode_steps']} decode steps, host_overlap_s "
                 f"{r['host_overlap_s']}")
        if not capture:
            continue
        if r["decode_compiles"] != 1:
            fail(f"{label} {mode}: decode_compiles {r['decode_compiles']}, "
                 "want 1")
        if r["captures_in_runs"]:
            fail(f"{label} {mode}: the programs captured "
                 f"{r['captures_in_runs']} graphs in warmed-up runs")
        if r["launch_calls_per_action"] > MAX_LAUNCH_CALLS_PER_ACTION:
            fail(f"{label} {mode}: {r['launch_calls_per_action']:.2f} kernel "
                 f"launch calls a scheduler action (at most "
                 f"{MAX_LAUNCH_CALLS_PER_ACTION})")
    c = res["captured"]
    seq = prompts[0] + e["outs"][0]
    plen = len(prompts[0])
    logits = [teacher_forced(ff, seq, plen, 8, max_len,
                             ff.config.kv_block_size, kv_dtype, capture=cap)
              for cap in (False, True)]
    err = (logits[1] - logits[0]).abs().max().item()
    log(f"{label}: greedy streams token-identical in the three modes, "
        f"teacher-forced decode logits captured vs eager max |diff| "
        f"{err:.3g} (atol {E2E_ATOL['fp32']}); tokens/s "
        f"{e['tokens_per_s']:.1f} -> {c['tokens_per_s']:.1f} -> "
        f"{res['async']['tokens_per_s']:.1f}, p50 per-token "
        f"{e['p50_token_ms']:.3f} -> {c['p50_token_ms']:.3f} -> "
        f"{res['async']['p50_token_ms']:.3f} ms, idle share "
        f"{e['idle_share']:.4f} -> {c['idle_share']:.4f} -> "
        f"{res['async']['idle_share']:.4f} (eager -> captured -> async) "
        f"[{card}]")
    if not err <= E2E_ATOL["fp32"]:
        fail(f"{label}: captured decode logits differ from eager by {err}")
    for r in res.values():
        del r["outs"]
    del ff
    torch.cuda.empty_cache()
    return dict(res, logit_err=err, stream0=(seq, plen))


def graph_dropout(device, card: str) -> dict:
    """A BERT-like model (BERT-Large's widths, 2 layers, fp32, attention
    dropout 0.1, SGD) trains one captured step and one eager step from the
    same weights and generator state: loss and grads (the SGD update over
    its rate) within ``TRAIN_TOL``; a second captured replay from the same
    weights with the next generator must give another loss (a new mask)."""
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel, LossType, SGDOptimizer
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    label = "graph dropout"
    config = FFConfig()
    config.batch_size, config.seed = 8, SEED
    ff = FFModel(config, device=device)
    cfg = BertConfig(num_layers=2, dropout=0.1)
    build_bert(ff, cfg)
    lr = 1e-3
    ff.compile(optimizer=SGDOptimizer(ff, lr=lr),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = train_data("bert", cfg, cfg.batch_size)
    xs = [torch.from_numpy(x).to(device)]
    lab = torch.from_numpy(ff._prep_label(y)).to(device)
    ex = ff.executor
    step, eager = ex.make_train_step(), ex.make_train_step(capture=False)
    params = [t for ws in ff.params.values() for t in ws.values()]
    snap = [t.clone() for t in params]

    def run(fn, k):
        for t, v in zip(params, snap):
            t.copy_(v)
        _p, _s, loss, _m = fn(ff.params, ff.opt_state, xs, lab,
                              torch.Generator().manual_seed(k))
        torch.cuda.synchronize()
        return float(loss), [(v - t) / lr for t, v in zip(params, snap)]

    run(step, 0)  # the shape's eager first call
    loss1, grads1 = run(step, 1)  # captured, replayed once
    loss_e, grads_e = run(eager, 1)
    loss2, _ = run(step, 2)  # a replay with the next generator
    if step.program.captures != 1:
        fail(f"{label}: {step.program.captures} captures, want 1")
    ltol, gtol = TRAIN_TOL["fp32"]
    dl, dg = abs(loss1 - loss_e), rel_norm(grads1, grads_e)
    log(f"{label}: BERT-Large widths, 2 layers, dropout 0.1, fp32: captured "
        f"step vs eager step from the same generator: |loss diff| {dl:.3g} "
        f"(tol {ltol}), grad relative norm difference {dg:.3g} (tol {gtol}); "
        f"losses {loss1!r} (replay 1) and {loss2!r} (replay 2, next "
        f"generator) [{card}]")
    if not (dl <= ltol and dg <= gtol):
        fail(f"{label}: the captured dropout step disagrees with the eager "
             "one")
    if loss2 == loss1:
        fail(f"{label}: a second replay gave the same loss bitwise: the "
             "dropout mask did not change")
    del ff
    torch.cuda.empty_cache()
    return dict(loss_diff=dl, grad_rel_diff=dg)


def graph_phase(device, card: str, cfg, prompt_set: dict) -> dict:
    """Eager step bodies against the captured programs, in this call:
    BERT-Large bf16 and GPT-2 small fp32 training at seq 512, GPT-2 small
    serving with native and int8 KV, and one dropout step."""
    return {
        "bert": graph_train(device, card, "bert", "bf16", steps=6),
        "gpt2": graph_train(device, card, "gpt2", "fp32", steps=4),
        "serve_native": graph_serve(device, card, cfg, "native",
                                    **prompt_set),
        "serve_int8": graph_serve(device, card, cfg, "int8", **prompt_set),
        "dropout": graph_dropout(device, card),
    }


# ----------------------------------------------------------------- zoo phase
# the vision and recommendation models at their published widths: (kind,
# compute dtype) of each timed run, in order
ZOO_RUNS = (("alexnet", "fp32"), ("resnet50", "fp32"), ("resnet50", "bf16"),
            ("inception_v3", "fp32"), ("resnext50", "fp32"), ("dlrm", "fp32"))
ZOO_BATCH = 64
# DLRM as the JAX bench's on-chip leg builds it (bench.py:1355-1391)
DLRM_TABLES, DLRM_ROWS = 8, 200000
# gate (a), card against CPU in fp32 from the same weights and batch (the
# two sides differ in summation order only; a TF32 convolution, 10-bit
# mantissa, moves a conv's output and grads by 2e-4..1e-3): the loss of
# one step within 1e-4 relative; every conv, dense, batch-norm and batched
# matmul node alone, without its fused activation, fed the CPU forward's
# own input activations and a seeded cotangent on both sides, its output
# and grads within 1e-4 relative norm;
# and every grad of the whole step within 1e-4 relative norm where no ReLU
# output lies on opposite sides of 0 on the two sides. Where one does (a
# pre-activation within fp32 rounding of the kink), that element's grad
# moves whole and the whole-step grads of a deep ReLU network differ by
# 1e-3..2e-2 between any two correct fp32 implementations (the port's CPU
# path against itself in float64 reads the same: ResNet-50 at batch 2, 57
# such elements, 1.77e-2), so the per-node check holds the numerics there
ZOO_CPU_TOL = 1e-4
ZOO_CPU_BATCH = {"dlrm": ZOO_BATCH}
ZOO_OP_TYPES = ("OP_CONV2D", "OP_LINEAR", "OP_BATCHNORM", "OP_BATCHMATMUL")


def zoo_model(kind: str, compute: str, device, batch: int):
    """A zoo model as a user builds it, at its published widths: AlexNet
    (ImageNet, 224, examples/cpp/AlexNet/alexnet.cc), ResNet-50 (224),
    InceptionV3 (299), ResNeXt-50 32x4d (224), each with 1000 classes and
    sparse categorical cross-entropy, or DLRM (eight 200000 x 64 tables,
    dense dim 16, bottom MLP 512-256-64, top 512-256-1, MSE avg-reduce);
    Adam 1e-3 (the JAX bench's legs); random weights from the seed.
    ``--profiling`` records each step's wall."""
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models import (build_alexnet, build_dlrm,
                                           build_inception_v3,
                                           build_resnet50, build_resnext50)

    config = FFConfig()
    config.batch_size, config.seed = batch, SEED
    config.profiling, config.print_freq = True, 10 ** 6
    if compute == "bf16":
        config.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(config, device=device)
    loss = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY
    if kind == "dlrm":
        build_dlrm(ff, batch_size=batch,
                   embedding_sizes=(DLRM_ROWS,) * DLRM_TABLES,
                   embedding_dim=64)
        loss = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
    else:
        build = {"alexnet": build_alexnet, "resnet50": build_resnet50,
                 "inception_v3": build_inception_v3,
                 "resnext50": build_resnext50}[kind]
        build(ff, batch_size=batch)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-3), loss_type=loss)
    ff.profile_operators(0)  # the per-op block is phase 17's
    return ff


def zoo_data(ff, n: int, seed: int = SEED):
    """``n`` samples for ``ff``'s inputs from the seed: images from a
    normal and labels over 1000 classes; DLRM's ids uniform over the
    tables (int64), its dense features normal and its targets uniform in
    [0, 1), as the JAX bench's leg draws them."""
    rng = np.random.default_rng(seed)
    xs = []
    for t in ff._input_tensors:
        shape = (n,) + tuple(t.dims[1:])
        if t.name.startswith("sparse_"):
            xs.append(rng.integers(0, DLRM_ROWS, size=shape).astype(
                np.int64))
        else:
            xs.append(rng.normal(size=shape).astype(np.float32))
    from flexflow_tpu_torch import LossType

    if ff.loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        y = rng.random(size=(n, 1)).astype(np.float32)
    else:
        y = rng.integers(0, 1000, size=(n, 1)).astype(np.int32)
    return xs, y


def shift_free_biases(ff) -> set:
    """(node, "bias") of every convolution whose output feeds batch norms
    only, with no activation between: the norm removes any per-channel
    shift, so the exact gradient of such a bias is zero and each side's
    is rounding noise, which no relative check can hold."""
    from flexflow_tpu_torch import ActiMode, OperatorType

    users = {}
    for node in ff.pcg.compute_nodes():
        for g, _ in node.inputs:
            users.setdefault(g, []).append(node.op.op_type)
    return {(node.name, "bias") for node in ff.pcg.compute_nodes()
            if node.op.op_type == OperatorType.OP_CONV2D
            and node.op.attrs.get("use_bias", True)
            and node.op.attrs.get("activation", ActiMode.AC_MODE_NONE)
            == ActiMode.AC_MODE_NONE
            and users.get(node.guid)
            and all(u == OperatorType.OP_BATCHNORM for u in users[node.guid])}


def grad_errors(got: dict, want: dict, skip: set):
    """(worst per-tensor relative norm error and its tensor, over every
    grad but ``skip``; the relative norm error of all grads together)."""
    worst, where, num, den = 0.0, None, 0.0, 0.0
    for n, ws in want.items():
        for w, g in ws.items():
            d = float((got[n][w].double() - g.double()).norm())
            gn = float(g.double().norm())
            num, den = num + d * d, den + gn * gn
            if (n, w) not in skip and d / max(gn, 1e-30) > worst:
                worst, where = d / max(gn, 1e-30), f"{n}.{w}"
    return worst, where, (num / max(den, 1e-30)) ** 0.5


def op_outputs(model, xs) -> dict:
    """Every node's outputs of ``model``'s inference forward on ``xs``, by
    node name, on the CPU."""
    import torch

    from flexflow_tpu_torch.ops.base import OpContext

    ex = model.executor
    with torch.no_grad():
        vals = ex.forward_outputs(model.params, ex._bind_inputs(xs),
                                  OpContext(device=model.device))
    return {model.pcg.nodes[g].name: [v.cpu() for v in vs]
            for g, vs in vals.items()}


def relu_side_flips(a: dict, b: dict) -> tuple:
    """(elements that are 0 in one of the two ``op_outputs`` and not in the
    other, elements compared)."""
    flips = total = 0
    for name, outs in a.items():
        for u, v in zip(outs, b[name]):
            if u.is_floating_point():
                flips += int(((u == 0) != (v == 0)).sum())
                total += u.numel()
    return flips, total


def op_errors(ff, cpu, vals: dict, types=ZOO_OP_TYPES) -> tuple:
    """Every node of ``types`` (``ZOO_OP_TYPES``) of ``cpu`` alone on the
    CPU and its
    counterpart in ``ff`` on the card, both fed the CPU forward's input
    activations ``vals`` and the node's weights, then a seeded cotangent:
    (worst relative norm error of an output, an input grad or a weight
    grad, where, nodes checked). The node runs without its fused
    activation (a ReLU's kink would move a grad element whole, as in the
    whole step); the activation is the same elementwise call on both
    sides."""
    import torch

    from flexflow_tpu_torch import ActiMode
    from flexflow_tpu_torch.ops.base import OpContext

    def bare(op):
        return type(op)(op.name, dict(op.attrs, relu=False,
                                      activation=ActiMode.AC_MODE_NONE),
                        op.data_type, op.num_inputs)

    def run(op, params, ins, cot, device):
        params = {w: t.detach().to(device).requires_grad_(True)
                  for w, t in params.items()}
        # a copy each: one tensor may feed several inputs (attention's
        # q, k and v), and each input takes its own grad
        ins = [t.detach().to(device, copy=True).requires_grad_(
            t.is_floating_point()) for t in ins]
        out = op.forward(params, ins, OpContext(training=True,
                                                device=device))[0]
        leaves = list(params.values()) + [t for t in ins
                                          if t.requires_grad]
        grads = torch.autograd.grad(out, leaves, cot.to(device))
        return [out] + list(grads), list(params) + [
            f"in{i}" for i, t in enumerate(ins) if t.requires_grad]

    card_nodes = {n.name: n for n in ff.pcg.compute_nodes()}
    worst, where, checked = 0.0, None, 0
    gen = torch.Generator().manual_seed(SEED)
    for node in cpu.pcg.compute_nodes():
        if node.op.op_type.name not in types:
            continue
        ins = [vals[cpu.pcg.nodes[g].name][i] for g, i in node.inputs]
        shape = node.out_shapes[0]
        cot = torch.randn(tuple(shape), generator=gen)
        want, names = run(bare(node.op), cpu.params.get(node.name, {}), ins,
                          cot, torch.device("cpu"))
        got, _ = run(bare(card_nodes[node.name].op),
                     ff.params.get(node.name, {}), ins, cot, ff.device)
        for name, a, b in zip(["out"] + names, got, want):
            b = b.detach().double()
            e = float((a.detach().cpu().double() - b).norm()) / max(
                float(b.norm()), 1e-30)
            if e > worst:
                worst, where = e, f"{node.name}.{name}"
        checked += 1
    return worst, where, checked


def zoo_card_vs_cpu(device, card: str, kind: str) -> dict:
    """Gate (a) (``ZOO_CPU_TOL``): one fp32 training step of the
    full-width model (batch 2; DLRM at its batch of 64) on the card and
    through the port's CPU path from the same weights and batch: the loss;
    every conv, dense, batch-norm and batched-matmul node alone; and the
    whole step's grads (``shift_free_biases`` held only in the norm of all
    grads together), gated where no ReLU output lies on opposite sides of
    0. The
    process keeps cuDNN's default ``allow_tf32`` (True): the conv op
    itself must run IEEE fp32. The same readings with the op's guard
    lifted (TF32 convolutions) are printed beside them."""
    import contextlib

    import torch

    from flexflow_tpu_torch.ops import conv as conv_op

    batch = ZOO_CPU_BATCH.get(kind, 2)
    label = f"zoo {kind} card vs cpu"
    ff = zoo_model(kind, "fp32", device, batch)
    cpu = zoo_model(kind, "fp32", torch.device("cpu"), batch)
    cpu.set_params_numpy(ff.get_params_numpy())
    xs, y = zoo_data(ff, batch, seed=SEED + 1)
    lab = ff._prep_label(y)
    xs_dev = [torch.from_numpy(a).to(device) for a in xs]
    xs_cpu = [torch.from_numpy(a) for a in xs]
    skip = shift_free_biases(ff)

    def card_readings():
        loss, _, g = ff.executor.loss_and_grads(
            ff.params, xs_dev, torch.from_numpy(lab).to(device))
        g = {n: {w: t.cpu() for w, t in ws.items()} for n, ws in g.items()}
        dl = abs(float(loss) - float(lc)) / max(abs(float(lc)), 1e-30)
        return (dl,) + grad_errors(g, gc, skip) + op_errors(ff, cpu, vals)

    t = time.perf_counter()
    lc, _, gc = cpu.executor.loss_and_grads(cpu.params, xs_cpu,
                                            torch.from_numpy(lab))
    vals = op_outputs(cpu, xs_cpu)
    cpu_s = time.perf_counter() - t
    flips, total = relu_side_flips(op_outputs(ff, xs_dev), vals)
    dl, worst, where, glob, op_worst, op_where, n_ops = card_readings()
    planted = None
    if any(n.op.op_type.name == "OP_CONV2D" for n in ff.pcg.compute_nodes()):
        saved = conv_op.ieee_fp32_convolutions
        conv_op.ieee_fp32_convolutions = contextlib.nullcontext
        try:
            planted = card_readings()
        finally:
            conv_op.ieee_fp32_convolutions = saved
    tol = ZOO_CPU_TOL
    log(f"{label}: batch {batch}, fp32, cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}: loss relative difference "
        f"{dl:.3g} (tol {tol}); {n_ops} conv/dense/norm/bmm nodes alone: "
        f"worst relative norm error {op_worst:.3g} ({op_where}; tol {tol}); "
        f"whole step: ReLU outputs on opposite sides of 0 {flips} of "
        f"{total}, worst grad relative norm error {worst:.3g} ({where}; tol "
        f"{tol} {'applied' if flips == 0 else 'not applied: kinks'}), all "
        f"grads {glob:.3g}, {len(skip)} shift-free conv biases in the total "
        f"only; CPU step and forward {cpu_s:.1f} s"
        + (f"; with TF32 convolutions: loss {planted[0]:.3g}, nodes alone "
           f"{planted[4]:.3g} ({planted[5]}), whole step worst "
           f"{planted[1]:.3g} ({planted[2]}), all grads {planted[3]:.3g}"
           if planted else "") + f" [{card}]")
    if not (dl <= tol and op_worst <= tol and (flips or worst <= tol)):
        fail(f"{label}: the card's fp32 step disagrees with the CPU's")
    if planted is not None and planted[4] <= tol:
        fail(f"{label}: the node check does not tell TF32 convolutions "
             "from IEEE fp32 ones")
    del ff, cpu
    torch.cuda.empty_cache()
    return dict(loss_rel_diff=dl, op_worst=op_worst, worst_grad=worst,
                all_grads=glob, relu_flips=flips, tf32=planted)


# kernel classes of a zoo step's profile, first match wins: cuDNN's
# convolution kernels (implicit-GEMM fprop, dgrad, wgrad and their
# helpers), batch norm, Adam's foreach passes, copies (the HWIO -> OIHW
# kernel permute, its grad's way back, the bf16 casts), GEMMs (dense
# layers), pooling, then the rest (bias adds, ReLUs, the loss)
ZOO_KERNEL_CLASSES = (
    ("conv", ("conv", "xmma", "implicit", "wgrad", "dgrad", "fprop",
              "cudnn", "winograd", "fft")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("adam", ("foreach", "multi_tensor")),
    ("copies", ("copy", "permute", "transpose")),
    ("gemm", ("gemm", "cutlass", "nvjet")),
    ("pool", ("pool",)),
)


def profile_zoo(ff, xs, y, label: str, step_s: float) -> None:
    """``--profile``: one more captured step of a zoo model under
    ``torch.profiler`` (:func:`profile_classes`, ``ZOO_KERNEL_CLASSES``)."""
    profile_classes(lambda: ff.fit(xs, y, epochs=1), label, step_s,
                    ZOO_KERNEL_CLASSES)


def profile_classes(run, label: str, step_s: float, classes) -> None:
    """One call of ``run`` (a captured step) under ``torch.profiler``:
    busy time against the unprofiled p50 step, the busy time by
    ``classes`` (first match wins, the rest "other"), the ten kernels
    that take the most, and the whole table in
    ``chiprun_out/profile_<label>.txt``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels)
    if busy <= 0:
        log(f"profile {label}: the profiler saw no kernel time; not "
            "measured")
        return
    split = {}
    for e in kernels:
        key = e.key.lower()
        cls = next((c for c, words in classes
                    if any(w in key for w in words)), "other")
        split[cls] = split.get(cls, 0.0) + e.self_device_time_total
    log(f"profile {label}: kernels busy {busy / 1e3:.3f} ms of the "
        f"unprofiled p50 step's {step_s * 1e3:.3f} ms; "
        + ", ".join(f"{c} {us / 1e3:.3f} ms ({us / busy:.3f})"
                    for c, us in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; {sum(e.count for e in kernels)} kernel launches")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out",
                        f"profile_{label.replace(' ', '_')}.txt")
    with open(path, "w") as f:
        f.write("kernel\tcount\ttotal_us\tshare\n")
        for e in kernels:
            f.write(f"{e.key}\t{e.count}\t{e.self_device_time_total:.1f}\t"
                    f"{e.self_device_time_total / busy:.4f}\n")
    for e in kernels[:10]:
        log(f"profile {label}:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:5d}x {e.key[:100]}")


def zoo_train(device, card: str, kind: str, compute: str, steps: int = 3,
              warmup: int = 2, profile: bool = False) -> dict:
    """A zoo model at batch 64 through ``fit``: ``warmup`` steps (the
    shape's eager first step and its capture) then ``steps`` replays, once
    with the eager body and once captured (:func:`eager_and_captured`).
    Prints p50 step ms, samples/s and MFU against the compute dtype's
    peak for both, their idle shares, peak memory and host launch calls,
    and their difference after the run. Then gate (b): the same steps
    eager and freshly captured with cuDNN's deterministic algorithms,
    within ``GRAPH_TOL``. Fails unless every loss of both pairs is
    finite."""
    import torch

    from flexflow_tpu_torch.models import train_flops_per_step

    label = f"zoo train {kind} {compute}"
    t = time.perf_counter()
    ff = zoo_model(kind, compute, device, ZOO_BATCH)
    xs, y = zoo_data(ff, ZOO_BATCH * (warmup + steps))
    n_params = sum(t.numel() for ws in ff.params.values()
                   for t in ws.values())
    log(f"{label}: {len(ff._layers)} layers, {n_params} params, inputs "
        f"{[tuple(t.dims) for t in ff._input_tensors]}, built in "
        f"{time.perf_counter() - t:.1f} s")
    res = eager_and_captured(ff, fit_steps(ff, xs, y, ZOO_BATCH), steps,
                             warmup, label)
    flops = train_flops_per_step(ff)
    peak = BF16_FLOPS if compute == "bf16" else FP32_FLOPS
    for mode in ("eager", "captured"):
        r = res[mode]
        s = r["p50_ms"] / 1e3
        log(f"{label} {mode}: losses {[round(v, 4) for v in r['losses']]}, "
            f"{ZOO_BATCH / s:.2f} samples/s, {flops / s / 1e12:.2f} TFLOP/s "
            f"= MFU {flops / s / peak:.4f} of {peak / 1e12:.0f} TF/s; "
            f"{mode_line(r, steps, warmup)} [{card}]")
    e, c = res["eager"], res["captured"]
    log(f"{label}: after {warmup + steps} steps with cuDNN's default "
        f"algorithms, captured vs eager: max relative loss difference "
        f"{res['loss_rel_diff']:.3g}, param relative norm difference "
        f"{res['param_rel_diff']:.3g} (not bitwise repeatable, not gated); "
        f"p50 {e['p50_ms']:.3f} -> {c['p50_ms']:.3f} ms "
        f"({e['p50_ms'] / c['p50_ms']:.2f}x); {flops / 1e9:.1f} GFLOP a "
        f"step [{card}]")
    if profile:
        profile_zoo(ff, [a[:ZOO_BATCH] for a in xs], y[:ZOO_BATCH],
                    f"zoo {kind} {compute}", c["p50_ms"] / 1e3)
    # gate (b), captured against eager after the same steps (the graph
    # phase's method): cuDNN's default backward algorithms are not
    # bitwise repeatable on the card (two eager steps from one state give
    # other conv grads), and over a few Adam steps at 1e-3 the difference
    # grows to 1e-2 of the params, past any band of one step. So a fresh
    # capture and the eager body run the same steps again with cuDNN's
    # deterministic algorithms, held to the graph phase's GRAPH_TOL
    ff.executor.invalidate_jit_cache()
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gate = eager_and_captured(ff, fit_steps(ff, xs, y, ZOO_BATCH),
                                  steps, warmup, label, measure=False)
    finally:
        torch.backends.cudnn.deterministic = was
    ltol, ptol = GRAPH_TOL[compute]
    log(f"{label}: after {warmup + steps} steps with cuDNN deterministic, "
        f"captured vs eager: max relative loss difference "
        f"{gate['loss_rel_diff']:.3g} (tol {ltol}), param relative norm "
        f"difference {gate['param_rel_diff']:.3g} (tol {ptol}); p50 "
        f"{gate['eager']['p50_ms']:.3f} -> {gate['captured']['p50_ms']:.3f} "
        f"ms [{card}]")
    if not (gate["loss_rel_diff"] <= ltol and gate["param_rel_diff"] <= ptol):
        fail(f"{label}: captured and eager steps disagree")
    del ff
    torch.cuda.empty_cache()
    return dict(res, flops=flops, gate=gate)


def zoo_phase(device, card: str, profile: bool = False) -> dict:
    """Gate (a) once per architecture, then every timed run of
    ``ZOO_RUNS`` (ResNet-50 in bf16 shares the fp32 architecture's
    gate); ``--profile`` profiles one more captured step of each."""
    gates = {kind: zoo_card_vs_cpu(device, card, kind)
             for kind in dict.fromkeys(k for k, _ in ZOO_RUNS)}
    runs = {(kind, compute): zoo_train(device, card, kind, compute,
                                       profile=profile)
            for kind, compute in ZOO_RUNS}
    return dict(gates=gates, runs=runs)


# ----------------------------------------------------------------- seq phase
# the recurrent and MoE models and the Transformer family at their
# published widths (phase 9). The MoE MLP of moe.cc: batch 64, MNIST's 784
# inputs, 8 experts, top 2, expert hidden 64, capacity factor 2.0, the
# load-balance weight 0.04
SEQ_MOE = dict(batch_size=64, in_dim=784, num_classes=10, num_exp=8,
               num_select=2, expert_hidden=64, alpha=2.0, lambda_bal=0.04)
SEQ_RUNS = ("transformer", "nmt", "moe", "moe_experts")
# the decoder's logits must reach this for E2E_ATOL to see its attention
DECODER_MIN_LOGIT = 0.1
# the decoder's decode attention: 16 heads of d64 (the kernel phase's
# GPT-2 shape has 12)
DECODER_HEADS = 16
# gate (a): the card against the CPU, fp32, one step from the same weights
# and batch (batch 2; the MoE MLP at its batch of 64): the loss within
# 1e-4 relative, every dense, attention, LSTM and experts node alone within
# 1e-4 relative norm (``op_errors``), and the whole step's grads within
# 1e-4 where no ReLU output changes sides (``relu_side_flips``). The proxy
# runs it with its layer norms on (``SEQ_CPU_LAYERNORM``): without them
# its activations shrink about 25x a layer at the seed's weights (the
# port's CPU path reads 8.6e-3 after layer 0 and 2.2e-18 after layer 11),
# so its loss sits at ln 2, its query and key grads past layer 0 are zero
# or below fp32's normal range and the check would see little of
# attention; the timed run keeps the reference's proxy, without them
SEQ_CPU_BATCH = {"moe": 64, "moe_experts": 64}
SEQ_CPU_LAYERNORM = ("transformer",)
SEQ_OP_TYPES = ("OP_LINEAR", "OP_MULTIHEAD_ATTENTION", "OP_LSTM",
                "OP_EXPERTS")
# a router row whose top-3 gate probabilities lie within this of each
# other may order its top 2 otherwise on the two sides (rounding alone);
# the MoE dispatch (dest, keep) is compared as integers on every token
# before the first such row that differs
GATE_MARGIN = 1e-6
# kernel classes of a phase-9 step's profile, first match wins: the flash
# kernels (B1, B2), Adam's foreach passes, GEMMs, the MoE dispatch
# (cumsum, index_add, gathers), elementwise passes (in NMT chiefly the
# LSTM's gate arithmetic: sigmoid, tanh, mul, add), then the rest
SEQ_KERNEL_CLASSES = (
    ("flash", ("flash",)),
    ("adam", ("foreach", "multi_tensor")),
    ("gemm", ("gemm", "cutlass", "nvjet", "cublas")),
    ("moe dispatch", ("index", "scan", "cumsum", "gather", "scatter")),
    ("elementwise", ("elementwise", "sigmoid", "tanh", "mul", "add")),
)


def seq_model(kind: str, device, batch: int = 0, layernorm: bool = False):
    """A phase-9 model as a user builds it, fp32, random weights from the
    seed: the OSDI'22 Transformer proxy (``TransformerConfig()``: batch 8,
    seq 512, hidden 1024, 16 heads, 12 layers, no layer norm; Adam 1e-4),
    NMT at ``rnn.h``'s widths (``NMTConfig()``: batch 64, vocab 32000 /
    32000, embed and hidden 1024, 2 layers, source and target 40; Adam
    1e-3), or the MoE MLP of ``moe.cc`` (``SEQ_MOE``; Adam 1e-3) built
    with ``moe`` (``build_moe_mlp``) or with ``moe_experts`` in its place.
    ``batch`` overrides the batch; ``layernorm`` turns the proxy's layer
    norms on. Returns (model, its config)."""
    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models import (NMTConfig, TransformerConfig,
                                           build_moe_mlp, build_nmt,
                                           build_transformer)

    if kind == "transformer":
        cfg, alpha = TransformerConfig(use_layernorm=layernorm), 1e-4
    elif kind == "nmt":
        cfg, alpha = NMTConfig(), 1e-3
    else:
        cfg, alpha = types.SimpleNamespace(**SEQ_MOE), 1e-3
    cfg.batch_size = batch or cfg.batch_size
    config = FFConfig()
    config.batch_size, config.seed = cfg.batch_size, SEED
    config.profiling, config.print_freq = True, 10 ** 6
    ff = FFModel(config, device=device)
    if kind == "transformer":
        build_transformer(ff, cfg)
    elif kind == "nmt":
        build_nmt(ff, cfg)
    elif kind == "moe":
        build_moe_mlp(ff, **vars(cfg))
    else:
        x = ff.create_tensor((cfg.batch_size, cfg.in_dim), name="moe_input")
        t = ff.dense(x, 64, ActiMode.AC_MODE_RELU)
        t = ff.moe_experts(t, cfg.num_exp, cfg.num_select, cfg.expert_hidden,
                           alpha=cfg.alpha, lambda_bal=cfg.lambda_bal)
        ff.softmax(ff.dense(t, cfg.num_classes))
    ff.compile(optimizer=AdamOptimizer(ff, alpha=alpha),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    ff.profile_operators(0)  # the per-op block is phase 17's
    return ff, cfg


def seq_data(kind: str, cfg, n: int, seed: int = SEED):
    """``n`` samples from the seed: the proxy's inputs normal with labels
    over its 2 classes; NMT's source and target tokens uniform over the
    vocabularies and its labels flattened (n * tgt_len,); the MoE MLP's
    inputs normal with labels over 10 classes. Returns (xs, y)."""
    rng = np.random.default_rng(seed)
    if kind == "transformer":
        x = rng.standard_normal((n, cfg.seq_len, cfg.hidden),
                                dtype=np.float32)
        return [x], rng.integers(0, 2, (n, 1)).astype(np.int32)
    if kind == "nmt":
        src = rng.integers(0, cfg.src_vocab, (n, cfg.src_len)).astype(
            np.int32)
        tgt = rng.integers(0, cfg.tgt_vocab, (n, cfg.tgt_len)).astype(
            np.int32)
        y = rng.integers(0, cfg.tgt_vocab, (n * cfg.tgt_len,)).astype(
            np.int32)
        return [src, tgt], y
    x = rng.standard_normal((n, cfg.in_dim)).astype(np.float32)
    return [x], rng.integers(0, cfg.num_classes, (n, 1)).astype(np.int32)


def moe_dispatch_check(ff, card_vals: dict, cpu_vals: dict) -> dict:
    """The router's choices and the dispatch on the card against the CPU
    forward's: the rows whose top-3 gate probabilities lie within
    ``GATE_MARGIN`` (where rounding may reorder the top 2), the rows whose
    assignment differs (fails unless each is such a row), and (dest, keep)
    of every token before the first differing row, computed on the card
    from the card's assignment and on the CPU from the CPU's, equal as
    integers."""
    import torch

    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.ops.moe_ops import dispatch_indices

    nodes = {n.op.op_type: n for n in ff.pcg.compute_nodes()}
    topk, group = nodes[OperatorType.OP_TOPK], nodes[OperatorType.OP_GROUP_BY]
    gate = ff.pcg.nodes[topk.inputs[0][0]].name
    probs = cpu_vals[gate][0]
    k = topk.op.attrs["k"]
    top = probs.topk(k + 1, dim=-1).values
    margin = (top[:, :-1] - top[:, 1:]).min(dim=-1).values
    near = margin <= GATE_MARGIN
    a_card, a_cpu = card_vals[topk.name][1], cpu_vals[topk.name][1]
    differ = (a_card != a_cpu).any(dim=-1)
    if bool((differ & ~near).any()):
        fail(f"moe dispatch: the router's choice differs at rows "
             f"{torch.nonzero(differ & ~near).flatten().tolist()} whose "
             f"gate margin exceeds {GATE_MARGIN}")
    rows = int(torch.nonzero(differ)[0]) if bool(differ.any()) \
        else a_cpu.shape[0]
    n = group.op.attrs["n"]
    cap = group.out_shapes[0][-2]
    dc, kc = dispatch_indices(a_cpu[:rows].reshape(-1), n, cap)
    dg, kg = dispatch_indices(a_card[:rows].reshape(-1).to(ff.device), n,
                              cap)
    if not (torch.equal(dg.cpu(), dc) and torch.equal(kg.cpu(), kc)):
        fail("moe dispatch: (dest, keep) on the card differ from the CPU's")
    return dict(near_rows=int(near.sum()), differ_rows=int(differ.sum()),
                tokens=int(dc.numel()), dropped=int((~kc).sum()),
                capacity=cap)


def seq_card_vs_cpu(device, card: str, kind: str) -> dict:
    """Gate (a) for a phase-9 model (``SEQ_CPU_BATCH``,
    ``SEQ_CPU_LAYERNORM``, ``SEQ_OP_TYPES``; the zoo's ``ZOO_CPU_TOL``):
    one fp32 training step on the card and through the port's CPU path
    from the same weights and batch. The MoE MLPs add
    :func:`moe_dispatch_check`."""
    import torch

    batch = SEQ_CPU_BATCH.get(kind, 2)
    ln = kind in SEQ_CPU_LAYERNORM
    label = f"seq {kind} card vs cpu"
    ff, _ = seq_model(kind, device, batch, ln)
    cpu, cfg = seq_model(kind, torch.device("cpu"), batch, ln)
    cpu.set_params_numpy(ff.get_params_numpy())
    xs, y = seq_data(kind, cfg, batch, seed=SEED + 1)
    lab = ff._prep_label(y)
    xs_dev = [torch.from_numpy(a).to(device) for a in xs]
    xs_cpu = [torch.from_numpy(a) for a in xs]
    t = time.perf_counter()
    lc, _, gc = cpu.executor.loss_and_grads(cpu.params, xs_cpu,
                                            torch.from_numpy(lab))
    vals = op_outputs(cpu, xs_cpu)
    cpu_s = time.perf_counter() - t
    loss, _, g = ff.executor.loss_and_grads(
        ff.params, xs_dev, torch.from_numpy(lab).to(device))
    g = {n: {w: v.cpu() for w, v in ws.items()} for n, ws in g.items()}
    dl = abs(float(loss) - float(lc)) / max(abs(float(lc)), 1e-30)
    worst, where, glob = grad_errors(g, gc, set())
    card_vals = op_outputs(ff, xs_dev)
    flips, total = relu_side_flips(card_vals, vals)
    op_worst, op_where, n_ops = op_errors(ff, cpu, vals, SEQ_OP_TYPES)
    disp = (moe_dispatch_check(ff, card_vals, vals)
            if kind.startswith("moe") else None)
    tol = ZOO_CPU_TOL
    log(f"{label}: batch {batch}, fp32{', layer norm' if ln else ''}: loss "
        f"{float(lc):.6g}, relative difference {dl:.3g} (tol {tol}); "
        f"{n_ops} dense/attention/LSTM/experts nodes alone: "
        f"worst relative norm error {op_worst:.3g} ({op_where}; tol {tol}); "
        f"whole step: ReLU outputs on opposite sides of 0 {flips} of "
        f"{total}, worst grad relative norm error {worst:.3g} ({where}; tol "
        f"{tol} {'applied' if flips == 0 else 'not applied: kinks'}), all "
        f"grads {glob:.3g}"
        + (f"; dispatch: {disp['tokens']} tokens (capacity "
           f"{disp['capacity']}, {disp['dropped']} dropped) equal as "
           f"integers, {disp['near_rows']} router rows within a gate "
           f"margin of {GATE_MARGIN}, {disp['differ_rows']} rows routed "
           "otherwise" if disp else "")
        + f"; CPU step and forward {cpu_s:.1f} s [{card}]")
    if not (dl <= tol and op_worst <= tol and (flips or worst <= tol)):
        fail(f"{label}: the card's fp32 step disagrees with the CPU's")
    del ff, cpu
    torch.cuda.empty_cache()
    return dict(loss_rel_diff=dl, op_worst=op_worst, worst_grad=worst,
                all_grads=glob, relu_flips=flips, dispatch=disp)


def seq_train(device, card: str, kind: str, steps: int = 3, warmup: int = 2,
              profile: bool = False) -> dict:
    """A phase-9 model at its published widths (:func:`seq_model`):
    ``warmup`` steps (the eager first step and the capture) then
    ``steps`` replays, once with the eager body and once captured, through
    ``fit`` (NMT through ``make_train_step``). Prints p50 step ms,
    samples/s (NMT: target tokens/s), MFU against 67 TF/s from the graph's
    op FLOPs, idle share by CUDA events around one replay, host launch
    calls and peak memory each way, and the captured-vs-eager difference
    after the run, held to ``GRAPH_TOL``. The proxy's step must launch
    the fp32 flash forward and the fused backward once per layer."""
    import torch

    from flexflow_tpu_torch.models import train_flops_per_step

    label = f"seq train {kind} fp32"
    t = time.perf_counter()
    ff, cfg = seq_model(kind, device)
    batch = ff.config.batch_size
    xs, y = seq_data(kind, cfg, batch * (warmup + steps))
    n_params = sum(v.numel() for ws in ff.params.values()
                   for v in ws.values())
    log(f"{label}: {len(ff._layers)} layers, {n_params} params, inputs "
        f"{[tuple(t.dims) for t in ff._input_tensors]}, built in "
        f"{time.perf_counter() - t:.1f} s")
    if kind == "nmt":
        per = cfg.tgt_len
        batches = [([torch.from_numpy(a[i * batch:(i + 1) * batch]).to(device)
                     for a in xs],
                    torch.from_numpy(ff._prep_label(
                        y[i * batch * per:(i + 1) * batch * per])).to(device))
                   for i in range(warmup + steps)]
        run_steps = train_step_steps(ff, batches)
        unit, per_step = "target tokens/s", batch * per
    else:
        run_steps = fit_steps(ff, xs, y, batch)
        unit, per_step = "samples/s", batch
    res = eager_and_captured(ff, run_steps, steps, warmup, label)
    flops = train_flops_per_step(ff)
    for mode in ("eager", "captured"):
        r = res[mode]
        s = r["p50_ms"] / 1e3
        log(f"{label} {mode}: losses {[round(v, 4) for v in r['losses']]}, "
            f"{per_step / s:.2f} {unit}, {flops / s / 1e12:.2f} TFLOP/s = "
            f"MFU {flops / s / FP32_FLOPS:.4f} of 67 TF/s; "
            f"{mode_line(r, steps, warmup)}; flash launches a step "
            f"{r['counts']} [{card}]")
    e, c = res["eager"], res["captured"]
    ltol, ptol = GRAPH_TOL["fp32"]
    log(f"{label}: after {warmup + steps} steps, captured vs eager: max "
        f"relative loss difference {res['loss_rel_diff']:.3g} (tol {ltol}), "
        f"param relative norm difference {res['param_rel_diff']:.3g} (tol "
        f"{ptol}); p50 {e['p50_ms']:.3f} -> {c['p50_ms']:.3f} ms "
        f"({e['p50_ms'] / c['p50_ms']:.2f}x); {flops / 1e9:.1f} GFLOP a "
        f"step [{card}]")
    if not (res["loss_rel_diff"] <= ltol and res["param_rel_diff"] <= ptol):
        fail(f"{label}: captured and eager steps disagree")
    want = ({"flash_fwd": cfg.num_layers, "flash_bwd_fused": cfg.num_layers}
            if kind == "transformer" else {})
    for mode in ("eager", "captured"):
        if res[mode]["counts"] != want:
            fail(f"{label} {mode}: flash launches a step "
                 f"{res[mode]['counts']}, want {want}")
    if profile:
        if kind == "nmt":
            xs0, lab0 = batches[0]
            step = ff.executor.make_train_step()
            run = lambda: step(ff.params, ff.opt_state, xs0, lab0,  # noqa
                               None)
        else:
            run = lambda: ff.fit([a[:batch] for a in xs], y[:batch],  # noqa
                                 epochs=1)
        profile_classes(run, f"seq {kind} fp32", c["p50_ms"] / 1e3,
                        SEQ_KERNEL_CLASSES)
    del ff
    torch.cuda.empty_cache()
    return dict(res, flops=flops)


def seq_serve(device, card: str, prompt_set: dict) -> dict:
    """The proxy's causal decoder (``build_transformer_decoder`` at
    ``TransformerConfig()``'s widths with its layer norms on, the
    builder's vocabulary of 256, fp32, 8 slots) serves the e2e prompts
    through ``FFModel.generate``, eager, captured and captured async
    (:func:`graph_serve`: streams token-identical, 12 flash-decode
    launches a decode step, ``decode_compiles == 1``, no capture after
    warm-up); then request 0's teacher-forced prefill and
    decode logits against the whole-sequence plain forward within
    ``E2E_ATOL``. Layer norm keeps the logits of order 1: without it the
    block stack shrinks its activations about 25x a layer at random
    weights and the logits fall to ~1e-17, where an absolute bound of
    1e-4 would pass any attention output. The check fails if the logits
    are not at least ``DECODER_MIN_LOGIT`` large."""
    import torch

    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models import (TransformerConfig,
                                           build_transformer_decoder)

    cfg = TransformerConfig(use_layernorm=True)
    config = FFConfig()
    config.batch_size, config.seed = cfg.batch_size, SEED
    config.max_decode_len = prompt_set["max_len"]
    config.max_inflight = 8
    t = time.perf_counter()
    ff = FFModel(config, device=device)
    build_transformer_decoder(ff, cfg)
    ff.compile()
    label = "seq serve decoder fp32"
    log(f"{label}: hidden {cfg.hidden} heads {cfg.num_heads} layers "
        f"{cfg.num_layers}, layer norm, built in "
        f"{time.perf_counter() - t:.1f} s")
    res = graph_serve(device, card, cfg, "native", **prompt_set, model=ff,
                      label=label)
    seq, plen = res.pop("stream0")
    err, logits = decode_vs_forward(ff, seq, plen, 8, prompt_set["max_len"],
                                    ff.config.kv_block_size)
    scale = logits.abs().max().item()
    log(f"{label}: prefill + decode logits vs whole-sequence plain forward "
        f"max |diff| {err:.3g} (atol {E2E_ATOL['fp32']}), largest |logit| "
        f"{scale:.4g} (at least {DECODER_MIN_LOGIT}) [{card}]")
    if not scale >= DECODER_MIN_LOGIT:
        fail(f"{label}: logits of at most {scale} leave the check blind")
    if not err <= E2E_ATOL["fp32"]:
        fail(f"{label}: serving logits differ from the plain forward by "
             f"{err}")
    del ff
    torch.cuda.empty_cache()
    return dict(res, forward_err=err, logit_scale=scale)


def seq_phase(device, card: str, prompt_set: dict,
              profile: bool = False) -> dict:
    """Gate (a) for each model, the timed runs of ``SEQ_RUNS``, then the
    decoder's serving."""
    gates = {kind: seq_card_vs_cpu(device, card, kind) for kind in SEQ_RUNS}
    runs = {kind: seq_train(device, card, kind, profile=profile)
            for kind in SEQ_RUNS}
    return dict(gates=gates, runs=runs,
                serve=seq_serve(device, card, prompt_set))


# ------------------------------------------------------- resilient train
# phase 10: the BERT-Large proxy (bf16, Adam 1e-4, float input) trains 12
# steps over 2 epochs of 6 batches through the resilient fit
RES_BATCHES = 6
RES_EPOCHS = 2
# a resumed, rolled-back or manual run against an uninterrupted one: both
# replay the same batches through the same kernels, so they differ only as
# uninterrupted runs of this call do (the 16-bit B2 sums dQ by bulk
# reduce-adds in no fixed order, so a BERT step is not bitwise repeatable,
# and twelve Adam steps on the saturated proxy loss amplify that to a few
# percent of the params' change; which batches a run fed is checked
# exactly, by their digests, since an order fault hides inside that band).
# Held to BAND_FACTOR times that spread, in the norm of the params' change
# over the run (or of the grads), and never below BAND_FLOOR, one bf16
# rounding (accumulation order may differ too: remat's recompute feeds a
# tensor's grads back in another grouping); a wrong batch or a lost step
# moves the params by a sizeable share of their change
BAND_FACTOR = 4.0
BAND_FLOOR = 2.0 ** -8
# how many uninterrupted runs the spread is taken over, as the largest
# difference of any two: a pair sometimes comes out all but bitwise equal
# (5e-6 of the change, against 0.009-0.020 for most pairs, twelve steps on
# an H100), and a band from such a pair alone is narrower than the
# difference a correct resume shows most of the time
SPREAD_RUNS = 4


def band_of(spread: float) -> float:
    return BAND_FACTOR * max(spread, BAND_FLOOR)


# the reduced copy for remat under dropout: BERT-Large's widths, 2 layers,
# attention dropout 0.1
REMAT_DROPOUT = dict(num_layers=2, dropout=0.1)


def update_rel(got, want, init) -> float:
    """||got - want|| over ||want - init||: the difference of two runs'
    params in units of the change of ``want`` over its run."""
    num = sum(float((a - b).float().norm()) ** 2 for a, b in zip(got, want))
    den = sum(float((b - c).float().norm()) ** 2
              for b, c in zip(want, init))
    return (num / max(den, 1e-30)) ** 0.5


def pair_diffs(finals: list, init: list) -> list:
    """``update_rel`` of every two runs' final params."""
    return [update_rel(a, b, init)
            for i, b in enumerate(finals) for a in finals[i + 1:]]


def param_list(ff) -> list:
    return [t.detach().clone() for ws in ff.params.values()
            for t in ws.values()]


class ResilientRun:
    """The phase's one BERT-Large model, its data, and its initial state,
    to which every run is reset in place (so the captured programs keep
    their tensors and no run captures anew)."""

    def __init__(self, device):
        import torch

        t = time.perf_counter()
        self.ff, self.cfg = train_model("bert", "bf16", device)
        self.ff.config.print_freq = 10 ** 9  # walls kept, no step lines
        self.batch = self.cfg.batch_size
        self.x, self.y = train_data("bert", self.cfg,
                                    self.batch * RES_BATCHES)
        self.init = [t.clone() for t in state_tensors(self.ff)]
        self.init_params = param_list(self.ff)
        self.built_s = time.perf_counter() - t
        self.device = device
        torch.cuda.synchronize()

    def reset(self, **config) -> None:
        """Initial state, rng counter 0, and the resilience and remat
        fields of the config set to ``config`` (the rest off)."""
        import torch

        for t, v in zip(state_tensors(self.ff), self.init):
            t.copy_(v)
        self.ff._rng_counter = 0
        c = self.ff.config
        c.checkpoint_dir, c.checkpoint_every, c.keep_checkpoints = "", 0, 2
        c.max_bad_steps, c.resume, c.remat = 0, "", ""
        for k, v in config.items():
            setattr(c, k, v)
        torch.cuda.synchronize()

    def fit(self, n_batches: int = RES_BATCHES, epochs: int = RES_EPOCHS,
            **kw):
        n = self.batch * n_batches
        return self.ff.fit(self.x[:n], self.y[:n], epochs=epochs, **kw)

    def device_batch(self, i: int, poison: bool = False):
        import torch

        sl = slice(i * self.batch, (i + 1) * self.batch)
        x = torch.from_numpy(self.x[sl]).to(self.device)
        if poison:
            x = x * float("nan")
        return [x], torch.from_numpy(self.ff._prep_label(
            self.y[sl])).to(self.device)

    def batch_digests(self) -> list:
        """The digest (a float64 sum on the card) of each batch an
        uninterrupted fit feeds, in step order: ``batch_iterator``'s
        shuffled epochs, as ``fit`` draws them."""
        import torch

        from flexflow_tpu_torch.data.dataloader import batch_iterator

        seed = self.ff.config.numpy_seed()
        return [float(torch.from_numpy(b[0]).to(self.device).double().sum())
                for e in range(RES_EPOCHS)
                for b in batch_iterator([self.x], self.batch, shuffle=True,
                                        seed=seed + e)]

    def record_batches(self) -> list:
        """Wrap the executor's cached plain and guarded steps so that each
        call appends its batch's digest to the returned list (a sync a
        step: for the checks, not for timing); ``unrecord`` undoes it."""
        ex = self.ff.executor
        fed: list = []
        self._wrapped = (ex._train_step, ex._guarded_train_step)

        def wrap(fn):
            def step(params, opt_state, xs, labels, rng):
                fed.append(float(xs[0].double().sum()))
                return fn(params, opt_state, xs, labels, rng)
            step.program = fn.program
            return step

        ex._train_step, ex._guarded_train_step = map(wrap, self._wrapped)
        return fed

    def unrecord(self) -> None:
        ex = self.ff.executor
        ex._train_step, ex._guarded_train_step = self._wrapped

    def state_equal(self) -> bool:
        import torch

        return all(torch.equal(t, v)
                   for t, v in zip(state_tensors(self.ff), self.init))


def resilient_guard(run: "ResilientRun", card: str) -> dict:
    """Gates (a) and (b): the guarded captured step against the plain one
    from the initial state, and the guarded step on a poisoned batch."""
    import torch

    from flexflow_tpu_torch.execution.graphs import HostTransfer

    ff = run.ff
    label = "resilient train guard"
    ex = ff.executor
    plain, guarded = ex.make_train_step(), ex.make_train_step(guard=True)

    def call(fn, i, k, poison=False):
        xs, lab = run.device_batch(i, poison)
        outs = fn(ff.params, ff.opt_state, xs, lab,
                  torch.Generator().manual_seed(k))
        torch.cuda.synchronize()
        return outs

    for fn in (plain, guarded):  # the eager first call, then the capture
        run.reset()
        call(fn, 0, 0)
        call(fn, 1, 1)
    if (plain.program.captures, guarded.program.captures) != (1, 1):
        fail(f"{label}: captures {plain.program.captures}, "
             f"{guarded.program.captures}, want 1 each")
    run.reset()
    loss_p = float(call(plain, 2, 2)[2])
    params_p = param_list(ff)
    run.reset()
    *_rest, loss_g, _m, ok = call(guarded, 2, 2)
    ok = bool(HostTransfer(ok).wait())
    params_g = param_list(ff)
    dl = abs(float(loss_g) - loss_p) / max(abs(loss_p), 1e-30)
    dp = rel_norm(params_g, params_p)
    ltol, ptol = GRAPH_TOL["bf16"]
    log(f"{label} (a): clean batch, guarded vs plain captured step from one "
        f"state: ok {ok}, relative loss difference {dl:.3g} (tol {ltol}), "
        f"param relative norm difference {dp:.3g} (tol {ptol}) [{card}]")
    if not (ok and dl <= ltol and dp <= ptol):
        fail(f"{label}: the guarded step disagrees with the plain one on a "
             "clean batch")
    run.reset()
    *_rest, loss_n, _m, ok_n = call(guarded, 2, 2, poison=True)
    ok_n = bool(HostTransfer(ok_n).wait())
    same = run.state_equal()
    log(f"{label} (b): poisoned batch: ok {ok_n}, loss {float(loss_n)!r}, "
        f"params, m, v and the step count bitwise unchanged: {same} "
        f"[{card}]")
    if ok_n or not same:
        fail(f"{label}: a poisoned batch reached the state")
    return dict(loss_rel_diff=dl, param_rel_diff=dp)


def save_lines(mgr, label: str, card: str) -> list:
    """One line per commit of a checkpoint manager: GB, seconds, GB/s, and
    the seconds ``save_async`` blocked on the queue."""
    out = []
    for i, (step, nbytes, secs) in enumerate(mgr.saves):
        blocked = mgr.blocked_s[i] if i < len(mgr.blocked_s) else 0.0
        out.append(dict(step=step, gb=nbytes / 1e9, s=secs,
                        gbps=nbytes / 1e9 / secs, blocked_s=blocked))
        log(f"{label}: save step_{step}: {nbytes / 1e9:.3f} GB in "
            f"{secs:.3f} s = {nbytes / 1e9 / secs:.3f} GB/s (snapshot to "
            f"commit, the worker thread); the step loop blocked "
            f"{blocked:.4f} s on the queue [{card}]")
    return out


def resilient_recovery(run: "ResilientRun", card: str, root: str) -> dict:
    """Gates (c), (d) and (e): a preempted run resumed with ``--resume
    auto``, a NaN run rolled back, each against ``SPREAD_RUNS``
    uninterrupted runs of this call (the band), and no capture across
    them."""
    import os
    import shutil

    import torch

    from flexflow_tpu_torch.execution.checkpoint import list_checkpoints
    from flexflow_tpu_torch.resilience import ChaosPlan

    ff = run.ff
    ex = ff.executor
    label = "resilient train"
    programs = (ex.make_train_step().program,
                ex.make_train_step(guard=True).program)
    captures = [p.captures for p in programs]
    finals = []
    for _ in range(SPREAD_RUNS):
        run.reset()
        run.fit()
        finals.append(param_list(ff))
    pairs = pair_diffs(finals, run.init_params)
    spread = max(pairs)
    band = band_of(spread)
    log(f"{label}: {SPREAD_RUNS} uninterrupted runs of "
        f"{RES_EPOCHS * RES_BATCHES} steps differ pairwise by "
        f"{', '.join(f'{x:.3g}' for x in pairs)} of the params' change over "
        f"the run (spread {spread:.3g}, band {band:.3g}); the change is "
        f"{rel_norm(finals[0], run.init_params):.3g} of the params' norm "
        f"[{card}]")
    del finals[1:]
    want = run.batch_digests()
    # an order fault the band cannot see (the same 12 batches with epoch 1
    # in epoch 0's order, as a resume taking the wrong epoch's shuffle
    # would feed them); the batch digests do
    run.reset()
    fed = run.record_batches()
    run.fit(epochs=1)
    run.fit(epochs=1)
    run.unrecord()
    planted = update_rel(param_list(ff), finals[0], run.init_params)
    log(f"{label}: planted fault (epoch 1's batches in epoch 0's order): "
        f"params {planted:.3g} against the band {band:.3g}; batches fed as "
        f"an uninterrupted run's: {fed == want} [{card}]")
    if fed == want:
        fail(f"{label}: the batch digests cannot tell batches out of order")
    res = dict(spread=spread, band=band, planted=planted)

    # (c) preemption at step 7, resume
    d = os.path.join(root, "preempt")
    run.reset(checkpoint_dir=d, checkpoint_every=4)
    fed = run.record_batches()
    t = time.perf_counter()
    run.fit(chaos=ChaosPlan(preempt_at_step=7))
    stop_s = time.perf_counter() - t
    session = ff.resilience
    stopped = ff._preempted_at_step
    steps = [s for s, _p in list_checkpoints(d)]
    saves = save_lines(session.manager, f"{label} (c) preempted run", card)
    if stopped != 8 or steps[-1:] != [8]:
        fail(f"{label} (c): stopped at {stopped} with checkpoints {steps}, "
             "want step 8 and a committed step_8")
    run.unrecord()
    res["roundtrip"] = resilient_roundtrip(run, card,
                                           os.path.join(d, "step_8"))
    ff.config.resume = "auto"
    fed_resumed = run.record_batches()
    t = time.perf_counter()
    run.fit()
    resume_s = time.perf_counter() - t
    run.unrecord()
    fed += fed_resumed
    resumed = ff.resilience
    saves += save_lines(resumed.manager, f"{label} (c) resumed run", card)
    diff = update_rel(param_list(ff), finals[0], run.init_params)
    count = int(ff.opt_state["step"])
    log(f"{label} (c): preempted by SIGTERM before step 7, stopped at step "
        f"{stopped} ({stop_s:.2f} s), resumed from step "
        f"{resumed.last_resume_step} and finished ({resume_s:.2f} s, "
        f"{len(ff.fit_history.loss)} steps, step count {count}); batches "
        f"fed as an uninterrupted run's: {fed == want}; final params vs an "
        f"uninterrupted run {diff:.3g} (band {band:.3g}) [{card}]")
    if resumed.last_resume_step != 8 or len(ff.fit_history.loss) != 4 \
            or count != 12 or fed != want or diff > band:
        fail(f"{label} (c): the resumed run is not the uninterrupted one: "
             f"resumed from {resumed.last_resume_step} (want 8), "
             f"{len(ff.fit_history.loss)} steps after it (want 4), step "
             f"count {count} (want 12), batches fed as an uninterrupted "
             f"run's {fed == want}, final params {diff:.3g} (band "
             f"{band:.3g})")
    shutil.rmtree(d)
    res.update(preempt=dict(diff=diff, stop_s=stop_s, resume_s=resume_s))

    # (d) NaN at step 10, rollback to step_8
    d = os.path.join(root, "rollback")
    run.reset(checkpoint_dir=d, checkpoint_every=4, max_bad_steps=1)
    fed = run.record_batches()
    t = time.perf_counter()
    run.fit(chaos=ChaosPlan(nan_at_steps={10}))
    roll_s = time.perf_counter() - t
    run.unrecord()
    # steps 0-9, the poisoned step 10, then 8-11 again from step_8
    replayed = (fed[:10] == want[:10] and np.isnan(fed[10])
                and fed[11:] == want[8:])
    session = ff.resilience
    saves += save_lines(session.manager, f"{label} (d) rollback run", card)
    summary = session.summary()
    diff = update_rel(param_list(ff), finals[0], run.init_params)
    counters = {"fault_events": 1, "recovery_events": 1,
                "skipped_steps": 1, "checkpoints_saved": 3,
                "last_resume_step": 8}
    count = int(ff.opt_state["step"])
    log(f"{label} (d): NaN batch at step 10, rolled back to step_8 and "
        f"replayed ({roll_s:.2f} s): counters {summary}, learning rate "
        f"{ff.optimizer.alpha!r}, step count {count}; batches fed: 0-9, "
        f"the poisoned one, 8-11 again: {replayed}; final params vs an "
        f"uninterrupted run {diff:.3g} (band {band:.3g}) [{card}]")
    if summary != counters or ff.optimizer.alpha != 1e-4 or count != 12 \
            or not replayed or diff > band:
        fail(f"{label} (d): counters {summary} (want {counters}), "
             f"learning rate {ff.optimizer.alpha!r} (want 0.0001), step "
             f"count {count} (want 12), batches fed 0-9, the poisoned one, "
             f"8-11 again {replayed}, final params {diff:.3g} (band "
             f"{band:.3g})")
    res.update(rollback=dict(diff=diff, s=roll_s, summary=summary))

    # (e) no capture across (c) and (d); one after a set_learning_rate
    now = (ex.make_train_step().program, ex.make_train_step(
        guard=True).program)
    after = [p.captures for p in now]
    log(f"{label} (e): captures of the plain and guarded programs before "
        f"(c) {captures}, after (d) {after}, the same programs "
        f"{now == programs} [{card}]")
    if now != programs or after != captures:
        fail(f"{label} (e): a resume or rollback captured anew")
    run.reset()
    ff.optimizer.set_learning_rate(5e-5)
    run.fit(n_batches=3, epochs=1)
    fresh = ex.make_train_step().program
    log(f"{label} (e): after set_learning_rate(5e-5) the next fit made a "
        f"new program (the old one dropped: {fresh is not programs[0]}) "
        f"that captured {fresh.captures} time [{card}]")
    if fresh is programs[0] or fresh.captures != 1:
        fail(f"{label} (e): a learning-rate change must cost exactly one "
             "capture")
    ff.optimizer.set_learning_rate(1e-4)
    ex.invalidate_jit_cache()
    res.update(saves=saves, captures=after)
    return res


def resilient_roundtrip(run: "ResilientRun", card: str, path: str) -> dict:
    """Gate (f), between (c)'s preempted run and its resume: the model
    holds step 8's state, which the async save of ``path`` snapshotted;
    one more step moves it on, and restoring ``path`` gives every state
    tensor back bit for bit, in place."""
    import torch

    from flexflow_tpu_torch.execution.checkpoint import (restore_checkpoint,
                                                         tree_bytes)

    ff = run.ff
    want = [t.clone() for t in state_tensors(ff)]
    ptrs = [t.data_ptr() for t in state_tensors(ff)]
    nbytes = tree_bytes([ff.params, ff.opt_state])
    run.fit(n_batches=1, epochs=1)  # the state moves on
    moved = not all(torch.equal(a, b)
                    for a, b in zip(state_tensors(ff), want))
    t = time.perf_counter()
    restore_checkpoint(ff, path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    same = all(torch.equal(a, b) for a, b in zip(state_tensors(ff), want))
    in_place = ptrs == [t.data_ptr() for t in state_tensors(ff)]
    log(f"resilient train roundtrip (f): step_8, {nbytes / 1e9:.3f} GB "
        f"(params, m, v, step), saved by the async writer of (c); after "
        f"one more step (the state moved: {moved}) the restore (checksums, "
        f"load, copy into the live tensors) took {restore_s:.3f} s = "
        f"{nbytes / 1e9 / restore_s:.3f} GB/s; bitwise {same}, in place "
        f"{in_place} [{card}]")
    if not (moved and same and in_place):
        fail("resilient train roundtrip: save -> restore is not bitwise")
    return dict(gb=nbytes / 1e9, restore_s=restore_s)


def remat_grads(ff, xs, lab, seed):
    """Loss and grads of one eager step at the reset state (a fixed
    generator for dropout)."""
    import torch

    loss, _l, grads = ff.executor.loss_and_grads(
        ff.params, xs, lab, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    return float(loss), [g.clone() for ws in grads.values()
                         for g in ws.values()]


def resilient_remat(run: "ResilientRun", card: str) -> dict:
    """Gate (g): ``--remat none|selective|full``, each from the initial
    state: one eager step's peak allocated and reserved memory (nothing
    else held between the levels) and flash launches, then 2 warm-up steps
    and 4 replays through ``fit`` (p50 step ms, flash launches a step);
    then each level's loss and grads of one eager step against none's,
    within the band of two none steps; then the same on a reduced copy
    with attention dropout 0.1."""
    import gc

    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    ff = run.ff
    label = "resilient train remat"
    layers = run.cfg.num_layers
    levels = ("none", "selective", "full")
    want_fwd = {"none": layers, "selective": layers, "full": 2 * layers}
    xs, lab = run.device_batch(0)
    res = {}
    for level in levels:
        run.reset(remat="" if level == "none" else level)
        ff.executor.invalidate_jit_cache()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_count()
        ff.executor.make_train_step(capture=False)(ff.params, ff.opt_state,
                                                   xs, lab, None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.max_memory_reserved()
        eager_counts = {n: c for n in fa.KERNELS if (c := fa.launch_count(n))}
        run.reset(remat="" if level == "none" else level)
        run.fit(n_batches=2, epochs=1)  # the eager first step, the capture
        fa.reset_launch_count()
        run.fit(n_batches=4, epochs=1)
        counts = {n: c // 4 for n in fa.KERNELS if (c := fa.launch_count(n))}
        p50 = float(np.median(ff.fit_history.step_s)) * 1e3
        res[level] = dict(p50_ms=p50, peak_gb=(peak - base) / 2 ** 30,
                          reserved_gb=reserved / 2 ** 30,
                          base_gb=base / 2 ** 30, counts=counts,
                          eager_counts=eager_counts,
                          totals={n: fa.launch_count(n) for n in fa.KERNELS})
        log(f"{label} {level}: p50 step {p50:.3f} ms over 4 replays; one "
            f"eager step: peak {(peak - base) / 2 ** 30:.3f} GiB allocated "
            f"above the {base / 2 ** 30:.3f} GiB held before it (params, "
            f"moments, the phase's snapshots), {reserved / 2 ** 30:.3f} GiB "
            f"reserved; flash launches {eager_counts} eager, {counts} a "
            f"captured step [{card}]")
        want = {"flash_fwd": want_fwd[level], "flash_bwd_fused": layers}
        if counts != want or eager_counts != want:
            fail(f"{label} {level}: flash launches {counts} / "
                 f"{eager_counts}, want {want}")
    peaks = {level: res[level]["peak_gb"] for level in levels}
    if not (peaks["full"] < peaks["none"]
            and peaks["selective"] <= peaks["none"]):
        fail(f"{label}: peak memory above the state {peaks} GiB: want full "
             "< none and selective <= none")
    out = {}
    for level in ("none", "none", "selective", "full"):
        run.reset(remat="" if level == "none" else level)
        out.setdefault(level, []).append(remat_grads(ff, xs, lab, 0))
    (l0, g0), (l1, g1) = out["none"]
    spread, lspread = rel_norm(g1, g0), abs(l1 - l0) / abs(l0)
    for level in ("selective", "full"):
        (loss, grads), = out[level]
        dl, dg = abs(loss - l0) / abs(l0), rel_norm(grads, g0)
        res[level].update(loss_diff=dl, grad_diff=dg)
        log(f"{label} {level} vs none, one eager step from the same state: "
            f"relative loss difference {dl:.3g}, grad relative norm "
            f"difference {dg:.3g} (two none steps: {lspread:.3g}, "
            f"{spread:.3g}; bands {band_of(lspread):.3g}, "
            f"{band_of(spread):.3g}) [{card}]")
        if not (dl <= band_of(lspread) and dg <= band_of(spread)):
            fail(f"{label} {level}: loss or grads outside the band of "
                 "none's")
    del out, g0, g1, grads
    run.reset()
    ff.executor.invalidate_jit_cache()
    res["dropout"] = remat_dropout(run.device, card)
    return res


def remat_dropout(device, card: str) -> dict:
    """The accuracy gate of (g) under attention dropout 0.1, on a reduced
    copy (``REMAT_DROPOUT``, bf16): one eager step's loss and grads at each
    level against none's from the same generator, within the band of two
    none steps; the recompute replays the block's seeds."""
    import torch

    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    config = FFConfig()
    config.batch_size, config.seed = 8, SEED
    config.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(config, device=device)
    cfg = BertConfig(**REMAT_DROPOUT)
    build_bert(ff, cfg)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = train_data("bert", cfg, cfg.batch_size)
    xs = [torch.from_numpy(x).to(device)]
    lab = torch.from_numpy(ff._prep_label(y)).to(device)
    out = {}
    for level in ("none", "none", "selective", "full"):
        config.remat = "" if level == "none" else level
        loss, grads = remat_grads(ff, xs, lab, 3)
        out.setdefault(level, []).append((loss, grads))
    (l0, g0), (l1, g1) = out["none"]
    spread, lspread = rel_norm(g1, g0), abs(l1 - l0) / abs(l0)
    res = {}
    for level in ("selective", "full"):
        (loss, grads), = out[level]
        res[level] = (abs(loss - l0) / abs(l0), rel_norm(grads, g0))
    log(f"resilient train remat dropout 0.1 (BERT-Large widths, 2 layers, "
        f"bf16): vs none from the same generator: selective {res['selective']}"
        f", full {res['full']} (relative loss, grad relative norm "
        f"differences; two none steps {lspread:.3g}, {spread:.3g}) [{card}]")
    for level, (dl, dg) in res.items():
        if not (dl <= band_of(lspread) and dg <= band_of(spread)):
            fail(f"resilient train remat dropout: {level} is outside the "
                 "band of none")
    del ff
    torch.cuda.empty_cache()
    return res


def resilient_manual(run: "ResilientRun", card: str) -> dict:
    """Gate (h): three manual steps (``set_batch``, ``forward``,
    ``zero_gradients``, ``backward``, ``update``) against three ``fit``
    steps over the same batches, within the band of ``SPREAD_RUNS`` such
    fits."""
    ff = run.ff
    label = "resilient train manual"
    fits = []
    for _ in range(SPREAD_RUNS):
        run.reset()
        run.fit(n_batches=3, epochs=1, shuffle=False)
        fits.append(param_list(ff))
    spread = max(pair_diffs(fits, run.init_params))
    del fits[1:]
    run.reset()
    for i in range(3):
        sl = slice(i * run.batch, (i + 1) * run.batch)
        ff.set_batch(run.x[sl], run.y[sl])
        ff.forward()
        ff.zero_gradients()
        ff.backward()
        ff.update()
    diff = update_rel(param_list(ff), fits[0], run.init_params)
    log(f"{label} (h): three manual steps vs three fit steps: "
        f"{diff:.3g} of the params' change ({SPREAD_RUNS} fits: spread "
        f"{spread:.3g}, band {band_of(spread):.3g}); step count "
        f"{int(ff.opt_state['step'])} [{card}]")
    if diff > band_of(spread) or int(ff.opt_state["step"]) != 3:
        fail(f"{label}: the manual loop is not fit's: {diff:.3g} of the "
             f"params' change (band {band_of(spread):.3g}), step count "
             f"{int(ff.opt_state['step'])} (want 3)")
    return dict(diff=diff, spread=spread)


def resilient_cost(run: "ResilientRun", card: str) -> dict:
    """(i): the plain and the guarded fit, 12 steps each from the initial
    state: p50 step ms over the steps after 2 and the idle share against
    one replay's device time by CUDA events."""
    ff = run.ff
    res = {}
    for mode, cfg in (("plain", {}), ("guarded", dict(max_bad_steps=1))):
        run.reset(**cfg)
        run.fit()
        p50 = float(np.median(ff.fit_history.step_s[2:])) * 1e3
        program = ff.executor.make_train_step(
            guard=mode == "guarded").program
        rep = replay_ms(program)
        res[mode] = dict(p50_ms=p50, replay_ms=rep,
                         idle=1 - rep / p50)
        log(f"resilient train cost (i) {mode}: p50 step {p50:.3f} ms over "
            f"10 steps after 2; one replay {rep:.3f} ms by CUDA events "
            f"(idle share {1 - rep / p50:.4f}) [{card}]")
    return res


def resilient_phase(device, card: str) -> dict:
    """Phase 10 (module doc): gates (a)-(h) and (i)'s figures on one
    BERT-Large model, its checkpoints in a temporary directory removed at
    the end."""
    import shutil
    import tempfile

    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    import os

    from flexflow_tpu_torch.execution.checkpoint import tree_bytes

    run = ResilientRun(device)
    # at most --keep-checkpoints 2 committed checkpoints and one being
    # staged lie on disk at once (each run's directory goes when it ends):
    # the temporary directory or, if it has less room, the checkout's
    need = 3 * tree_bytes([run.ff.params, run.ff.opt_state])
    where = max((tempfile.gettempdir(), os.getcwd()),
                key=lambda d: shutil.disk_usage(d).free)
    free = shutil.disk_usage(where).free
    if free < need:
        fail(f"resilient train: {free / 1e9:.1f} GB free under {where}, "
             f"the checkpoints need {need / 1e9:.1f} GB")
    root = tempfile.mkdtemp(prefix="ff_resilient_", dir=where)
    try:
        log(f"resilient train: BERT-Large proxy bf16, Adam 1e-4, "
            f"{RES_EPOCHS} epochs of {RES_BATCHES} batches of "
            f"{run.batch}, built in {run.built_s:.1f} s; checkpoints in a "
            f"temporary directory with {free / 1e9:.1f} GB free (they need "
            f"{need / 1e9:.1f}) [{card}]")
        fa.reset_launch_count()
        res = dict(guard=resilient_guard(run, card))
        res.update(resilient_recovery(run, card, root))
        res["remat"] = resilient_remat(run, card)
        res["manual"] = resilient_manual(run, card)
        res["cost"] = resilient_cost(run, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del run
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------------ phase 11: obs
OBS_STEPS = 6
# regions of --fusion on the BERT-Large proxy: the count the JAX pass gives
# on the same graph (tests/test_torch_fusion.py, BERT_LARGE_REGIONS)
FUSION_REGIONS = 48
FUSION_STEPS = 4
# gate (c)'s sampling: the sampler's top-k (B7) at k = 8
OBS_SERVE_SAMPLING = dict(temperature=0.8, top_k=8, seed=SEED)


def chrome_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def graph_replay_kernels(events: list) -> tuple:
    """The ``cudaGraphLaunch`` calls of a Chrome trace (by host start) and
    the names of the kernels those replays ran, each kernel tied to its
    launch by the CUPTI correlation id that both events carry (a graph's
    kernels carry their ``cudaGraphLaunch``'s): not by timestamp, since
    the host's and the card's clocks are aligned only approximately, and
    a replay's first kernels may read as earlier than its launch call."""
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "GraphLaunch" in e.get("name", "")),
                      key=lambda e: e["ts"])
    ids = {e.get("args", {}).get("correlation") for e in launches} - {None}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in ids]
    return launches, kernels


def obs_fusion(device, card: str, ff, cfg, x, y) -> dict:
    """Gate (b): the BERT-Large proxy compiled with ``--fusion`` against
    ``ff`` (the same proxy unfused, at its initial weights: both from the
    seed, whose draws the regions keep in order)."""
    import torch

    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.kernels import flash_attention as fa

    label = "obs fusion"
    t = time.perf_counter()
    fused, _cfg = train_model("bert", "bf16", device, fusion=True)
    built = time.perf_counter() - t
    regions = [n for n in fused.pcg.compute_nodes()
               if n.op.op_type == OperatorType.OP_FUSED]
    if len(regions) != FUSION_REGIONS or \
            len(fused.pcg.compute_nodes()) != FUSION_REGIONS:
        fail(f"{label}: {len(regions)} regions of "
             f"{len(fused.pcg.compute_nodes())} nodes, want "
             f"{FUSION_REGIONS} of {FUSION_REGIONS}")
    n = cfg.batch_size * FUSION_STEPS
    res = {}
    for name, model in (("unfused", ff), ("fused", fused)):
        model.config.print_freq = 10 ** 9
        fa.reset_launch_count()
        model.fit(x[:n], y[:n], epochs=1)
        torch.cuda.synchronize()
        totals = {k: fa.launch_count(k) for k in fa.KERNELS
                  if fa.launch_count(k)}
        params = {}
        for region, ws in model.params.items():
            for w, v in ws.items():
                # a fused weight sub{i}:{op}:{w} under its op's own name
                key = tuple(w.split(":")[1:]) if ":" in w else (region, w)
                params[key] = v.detach().clone()
        res[name] = dict(losses=list(model.fit_history.loss),
                         totals=totals, params=params)
    for name, model in (("unfused", ff), ("fused", fused)):
        model.fit(x, y, epochs=1)  # replays only
        res[name]["p50_ms"] = float(np.median(model.fit_history.step_s)) * 1e3
    u, f = res["unfused"], res["fused"]
    want = {"flash_fwd": cfg.num_layers * FUSION_STEPS,
            "flash_bwd_fused": cfg.num_layers * FUSION_STEPS}
    keys = sorted(u["params"])
    if sorted(f["params"]) != keys:
        fail(f"{label}: the fused model's weights are not the unfused ones "
             "under region names")
    prel = rel_norm([f["params"][k] for k in keys],
                    [u["params"][k] for k in keys])
    log(f"{label}: {len(regions)} regions (the JAX pass's count on this "
        f"graph), built in {built:.1f} s; flash launches over "
        f"{FUSION_STEPS} steps {f['totals']} fused, {u['totals']} unfused; "
        f"first-step loss "
        f"{f['losses'][0]!r} fused, {u['losses'][0]!r} unfused; params "
        f"after {FUSION_STEPS} steps relative norm difference {prel:.3g} "
        f"(tol {GRAPH_TOL['bf16'][1]}); p50 step {f['p50_ms']:.3f} ms "
        f"fused, {u['p50_ms']:.3f} ms unfused over {OBS_STEPS} replays "
        f"[{card}]")
    if f["totals"] != want or u["totals"] != want:
        fail(f"{label}: flash launches over {FUSION_STEPS} steps "
             f"{f['totals']} / {u['totals']}, want {want}")
    if f["losses"][0] != u["losses"][0]:
        fail(f"{label}: first-step loss {f['losses'][0]} fused vs "
             f"{u['losses'][0]} unfused, want bitwise equal")
    if not prel <= GRAPH_TOL["bf16"][1]:
        fail(f"{label}: params after {FUSION_STEPS} steps {prel} apart")
    for r in res.values():
        del r["params"]
    del fused
    torch.cuda.empty_cache()
    return dict(res, regions=len(regions), param_rel_diff=prel)


def obs_bert(device, card: str, tmp: str) -> dict:
    """Gates (a) and (b): the BERT-Large proxy (bf16, Adam) — first (b)
    from its initial weights, then ``fit`` with ``--telemetry-file``,
    ``--trace-file`` and, on a fresh capture, ``--profiler-trace-dir``."""
    import collections
    import os

    import torch

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import train_flops_per_step
    from flexflow_tpu_torch.ops.base import hookless_flops

    label = "obs bert"
    tracer = obs.enable()  # records compile's span from the build on
    t = time.perf_counter()
    ff, cfg = train_model("bert", "bf16", device)
    built = time.perf_counter() - t
    obs.set_tracer(obs.NoopTracer())  # no sink until the telemetry run
    layers, batch = cfg.num_layers, cfg.batch_size
    x, y = train_data("bert", cfg, batch * OBS_STEPS)
    res = {"fusion": obs_fusion(device, card, ff, cfg, x, y)}

    # the per-step sync telemetry costs: a fit's marginal step (the wall
    # of 2 * OBS_STEPS replays less that of OBS_STEPS, so fit's own start
    # and end, and the files telemetry writes, cancel) without a sink (one
    # sync at the end of fit) and with one
    ff.config.profiling = False
    x2, y2 = np.concatenate([x, x]), np.concatenate([y, y])
    walls = {}
    for mode in ("plain", "telemetry"):
        if mode == "telemetry":
            obs.set_tracer(tracer)
            ff.config.telemetry_file = os.path.join(tmp, "telemetry.json")
            ff.config.trace_file = os.path.join(tmp, "trace.json")
        fit_s = []
        for xs, ys in ((x2, y2), (x, y)):  # the run gated last
            fa.reset_launch_count()
            torch.cuda.synchronize()
            t = time.perf_counter()
            ff.fit(xs, ys, epochs=1)
            torch.cuda.synchronize()
            fit_s.append(time.perf_counter() - t)
        walls[mode] = (fit_s[0] - fit_s[1]) / OBS_STEPS * 1e3
        totals = {k: fa.launch_count(k) for k in fa.KERNELS
                  if fa.launch_count(k)}
    tel_path, trace_path = ff.config.telemetry_file, ff.config.trace_file
    ff.config.telemetry_file = ff.config.trace_file = ""
    obs.disable()
    with open(tel_path) as f:
        tel = json.load(f)
    names = collections.Counter(e["name"] for e in chrome_events(trace_path)
                                if e["ph"] == "X")
    flops = obs.model_flops_per_step(ff.pcg)
    matmul = train_flops_per_step(ff)
    rest = 3 * hookless_flops(ff.pcg)
    peak = obs.detect_peak_flops()
    mem = tel.get("device_memory") or {}
    steady = tel.get("steady_step_s")
    log(f"{label}: BERT-Large proxy bf16 built in {built:.1f} s; "
        f"a fit's marginal step (the wall of {2 * OBS_STEPS} replays less "
        f"that of {OBS_STEPS}, over {OBS_STEPS}): {walls['plain']:.3f} ms "
        f"without telemetry (one sync at the end of fit), "
        f"{walls['telemetry']:.3f} ms with it (each step waits for its "
        f"loss); telemetry p50 steady_step_s "
        f"{steady * 1e3 if steady else float('nan'):.3f} ms, "
        f"samples_per_sec {tel.get('samples_per_sec')}, estimated_mfu "
        f"{tel.get('estimated_mfu')} against {tel.get('peak_flops')} "
        f"FLOP/s; model_flops_per_step {tel.get('model_flops_per_step')} = "
        f"train_flops_per_step {matmul} + {rest} (3 x one FLOP an output "
        f"element of the ops without a cost hook: norms, adds, pooling, "
        f"softmax); device_memory {mem}; flash launches {totals}; trace "
        f"events {dict(names)} [{card}]")
    if not (steady and tel.get("samples_per_sec") and
            tel.get("estimated_mfu") and peak is not None and
            tel.get("peak_flops") == peak):
        fail(f"{label}: telemetry lacks a figure: {tel}")
    if tel.get("model_flops_per_step") != flops or flops != matmul + rest:
        fail(f"{label}: model_flops_per_step {tel.get('model_flops_per_step')}"
             f", obs {flops}, matmul {matmul} + hookless {rest}")
    if not (mem.get("peak_memory_in_bytes", 0) >
            mem.get("argument_size_in_bytes", 0) > 0):
        fail(f"{label}: device_memory {mem}")
    if tel.get("steps") != OBS_STEPS or \
            names.get("train_step") != 3 * OBS_STEPS or \
            names.get("compile") != 1 or names.get("epoch") != 2:
        fail(f"{label}: {tel.get('steps')} telemetry steps, trace events "
             f"{dict(names)}")
    want = {"flash_fwd": layers * OBS_STEPS,
            "flash_bwd_fused": layers * OBS_STEPS}
    if totals != want:
        fail(f"{label}: flash launches {totals}, want {want}")
    res["telemetry"] = dict(walls, tel=tel, totals=totals, flops=flops,
                            matmul=matmul)

    # the profiler trace, from a fresh capture: an eager step names the
    # nodes; the replays hold the kernels
    prof_dir = os.path.join(tmp, "profile")
    ff.executor.invalidate_jit_cache()
    ff.config.profiler_trace_dir = prof_dir
    t = time.perf_counter()
    ff.fit(x[:3 * batch], y[:3 * batch], epochs=1)
    prof_s = time.perf_counter() - t
    ff.config.profiler_trace_dir = ""
    (path,) = os.listdir(prof_dir)
    events = chrome_events(os.path.join(prof_dir, path))
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    nodes = {n.name for n in ff.pcg.compute_nodes()}
    launches, kernels = graph_replay_kernels(events)
    fwd = sum("flash_fwd_sm90" in k for k in kernels)
    bwd = sum("flash_bwd_fused_sm90" in k for k in kernels)
    # the whole trace's: the eager step's and the replays'
    every = [e["name"] for e in events if e.get("cat") == "kernel"]
    all_fwd = sum("flash_fwd_sm90" in k for k in every)
    all_bwd = sum("flash_bwd_fused_sm90" in k for k in every)
    size = os.path.getsize(os.path.join(prof_dir, path))
    log(f"{label} profiler: 3 steps (eager, capture, replay) in "
        f"{prof_s:.1f} s, a {size / 2 ** 20:.1f} MiB Chrome trace; "
        f"{len(nodes & ranges)} of {len(nodes)} nodes named by "
        f"record_function ranges; {len(launches)} graph launches, whose "
        f"replays ran {fwd} flash_fwd_sm90 and {bwd} flash_bwd_fused_sm90 "
        f"kernels (by correlation id; {all_fwd} and {all_bwd} in the whole "
        f"trace) [{card}]")
    if not nodes <= ranges:
        fail(f"{label}: nodes without a range in the profiler trace: "
             f"{sorted(nodes - ranges)[:8]}")
    if not launches or fwd != layers * len(launches) or \
            bwd != layers * len(launches):
        fail(f"{label}: {fwd} / {bwd} flash kernels in {len(launches)} "
             f"replays, want {layers} each a replay")
    res["profile"] = dict(seconds=prof_s, mib=size / 2 ** 20,
                          replays=len(launches))
    del ff
    torch.cuda.empty_cache()
    return res


def obs_serve(device, card: str, prompt_set: dict, tmp: str) -> dict:
    """Gate (c): GPT-2 small (fp32, vocab 50304) serves the e2e prompts
    with int8 KV and top-k 8 sampling under ``--serve-loop async``,
    captured, once untraced and once with ``obs.enable_reqtrace()`` and
    ``--telemetry-file``, each on a fresh warmed engine."""
    import os

    import torch

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.kernels import topk as tk
    from flexflow_tpu_torch.models.gpt2 import GPT2Config

    label = "obs serve int8 top8 async"
    cfg = GPT2Config(vocab_size=VOCAB_PADDED)
    shapes = {k: prompt_set[k] for k in ("lengths", "shared_len",
                                         "n_shared", "new_tokens",
                                         "max_len")}
    ff = build_model(cfg, "fp32", device, shapes["max_len"])
    ff.config.kv_dtype, ff.config.serve_loop = "int8", "async"
    prompts = make_prompts(cfg.vocab_size, shapes["lengths"],
                           shapes["shared_len"], shapes["n_shared"])
    prof_prompts = make_prompts(cfg.vocab_size, shapes["lengths"],
                                shapes["shared_len"], shapes["n_shared"],
                                PROFILE_PROMPT_SEED)

    def generate(ps):
        outs = ff.generate(ps, max_new_tokens=shapes["new_tokens"],
                           max_decode_len=shapes["max_len"],
                           **OBS_SERVE_SAMPLING)
        torch.cuda.synchronize()
        return outs

    res = {}
    for mode in ("untraced", "traced"):
        # a fresh engine for each (an empty prefix cache: the second run
        # of the same prompts would hit it and admit other chunk shapes),
        # warmed up on prompts of the same shapes
        ff._serving_engine = None
        warm_serving(ff, **shapes, **OBS_SERVE_SAMPLING)
        eng = ff._serving_engine
        rt = None
        if mode == "traced":
            rt = obs.enable_reqtrace()
            ff.config.telemetry_file = os.path.join(tmp, "serving.json")
        before = serving_captures(eng)
        fd.reset_launch_count()
        tk.reset_launch_count()
        outs = generate(prompts)
        counts = {"flash_decode_int8": fd.launch_count("flash_decode_int8"),
                  "topk": tk.launch_count()}
        st = eng.stats
        r = res[mode] = dict(
            outs=outs, counts=counts, tokens_per_s=st.tokens_per_s(),
            tokens_generated=st.tokens_generated,
            decode_steps=st.decode_steps, prefills=st.prefills,
            host_bookkeep_s=st.host_bookkeep_s,
            host_overhead_fraction=st.host_overhead_fraction())
        if rt is not None:
            r["records"] = sorted(rt.records(), key=lambda e: e["rid"])
            with open(ff.config.telemetry_file) as f:
                r["tel"] = json.load(f)
        # the same generate on prompts of these shapes under the profiler
        # (still traced in the traced mode)
        prof = profiled(lambda: generate(prof_prompts))
        per_action = prof["kernel_launch_calls"] / max(eng.stats.host_ticks,
                                                       1)
        r.update(captures=serving_captures(eng) - before,
                 launch_calls_per_action=per_action)
        if rt is not None:
            obs.disable_reqtrace()
            ff.config.telemetry_file = ""
        log(f"{label} {mode}: {r['tokens_generated']} tokens, "
            f"{r['tokens_per_s']:.1f} tokens/s, host_bookkeep_s "
            f"{r['host_bookkeep_s']:.6f}, host_overhead_fraction "
            f"{r['host_overhead_fraction']:.4f}, {r['decode_steps']} decode "
            f"steps, {r['prefills']} prefills, launches {counts}, captures "
            f"{r['captures']} in this and the profiled run, "
            f"{per_action:.2f} kernel launch calls a scheduler action "
            f"[{card}]")
    u, t = res["untraced"], res["traced"]
    recs, tel = t["records"], t["tel"]
    if t["outs"] != u["outs"]:
        fail(f"{label}: the traced streams differ from the untraced ones")
    bad = [i for i, (rec, out) in enumerate(zip(recs, t["outs"]))
           if rec["outcome"] != "ok" or rec["decode_ticks"] != len(out)
           or rec["new_tokens"] != len(out)]
    if len(recs) != len(prompts) or bad:
        fail(f"{label}: {len(recs)} records for {len(prompts)} requests, "
             f"wrong ones {bad}")
    if tel["serving"]["tokens_generated"] != t["tokens_generated"]:
        fail(f"{label}: telemetry tokens {tel['serving']} vs ServingStats "
             f"{t['tokens_generated']}")
    for mode, r in res.items():
        if r["captures"]:
            fail(f"{label} {mode}: {r['captures']} captures after warm-up")
        if r["launch_calls_per_action"] > MAX_LAUNCH_CALLS_PER_ACTION:
            fail(f"{label} {mode}: {r['launch_calls_per_action']:.2f} kernel "
                 "launch calls a scheduler action")
        c = r["counts"]
        if c["flash_decode_int8"] != cfg.num_layers * r["decode_steps"] or \
                c["topk"] != r["prefills"] + r["decode_steps"]:
            fail(f"{label} {mode}: launches {c} over {r['decode_steps']} "
                 f"decode steps and {r['prefills']} prefills")
    log(f"{label}: streams equal traced and untraced, {len(recs)} records "
        f"all ok with their tokens, telemetry serving block "
        f"{tel['serving']}; tokens/s {u['tokens_per_s']:.1f} untraced, "
        f"{t['tokens_per_s']:.1f} traced [{card}]")
    for r in res.values():
        r.pop("outs", None)
        r.pop("records", None)
    del ff, eng
    torch.cuda.empty_cache()
    return res


def obs_cache(device, card: str) -> dict:
    """Gate (d): ``tests/test_cache_op.py:11-30``'s MoE model on the card,
    its top-k assignment cached, trained with a ``RecompileState`` whose
    trigger fires once the routing's score passes 0.5."""
    import torch

    from flexflow_tpu_torch import (ActiMode, AdamOptimizer, FFConfig,
                                    FFModel, LossType, OperatorType)
    from flexflow_tpu_torch.execution.recompile import (RecompileState,
                                                        recompile)

    label = "obs cache recompile"
    batch, num_exp = 32, 4
    config = FFConfig()
    config.batch_size, config.seed = batch, SEED
    ff = FFModel(config, device=device)
    x = ff.create_tensor((batch, 64), name="in")
    gate = ff.softmax(ff.dense(x, num_exp, name="gate"))
    vals, assign = ff.top_k(gate, 2)
    assign = ff.cache(assign, num_batches=2, name="assign_cache",
                      score_fn=lambda a, b: float((a == b).mean()))
    grouped = ff.group_by(x, assign, num_exp, alpha=2.0)
    experts = [ff.dense(g, 32, activation=ActiMode.AC_MODE_RELU,
                        name=f"exp_{i}") for i, g in enumerate(grouped)]
    out = ff.aggregate(vals, assign, assign, gate, experts, num_exp,
                       lambda_bal=0.01)
    ff.softmax(ff.dense(out, 4, name="cls"))
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-3),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(SEED)
    xs = rng.normal(size=(batch, 64)).astype(np.float32)
    ys = np.argmax(xs @ rng.normal(size=(64, 4)), axis=1)[:, None] \
        .astype(np.int32)

    def trigger(rs):
        scores = list(rs.ffmodel.cache_scores.values())
        return rs.recompilations == 0 and bool(scores) and scores[0] > 0.5

    def alter(rs):
        for layer in rs.ffmodel._layers:
            if layer.op_type == OperatorType.OP_GROUP_BY:
                layer.attrs["alpha"] = 1.0

    old = ff.executor.make_train_step().program
    rs = RecompileState(trigger, alter, ff)
    ff.fit(xs, ys, epochs=6, recompile_state=rs, shuffle=False)
    new = ff.executor.make_train_step().program
    after_fit = (old.captures, new.captures)
    ff.fit(xs, ys, epochs=3, shuffle=False)  # never again
    scores = dict(ff.cache_scores)
    losses = list(ff.fit_history.loss)
    # the recompile's cost alone: compile anew, then the eager first step
    # and the capture
    t = time.perf_counter()
    recompile(ff)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t
    step = ff.executor.make_train_step()
    bx, by = [torch.from_numpy(xs).to(device)], torch.from_numpy(ys).to(
        device)
    cache = ff.executor.init_cache()
    walls = []
    for _ in range(3):  # eager, capture, replay
        t = time.perf_counter()
        step(ff.params, ff.opt_state, bx, by, None, cache)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    log(f"{label}: the trigger fired {rs.recompilations} time(s); cache "
        f"scores {scores}; captures old/new program after the fit "
        f"{after_fit}, new after 3 more epochs {new.captures}; losses "
        f"{['%.4f' % v for v in losses]}; a recompile alone: compile "
        f"{compile_s:.3f} s, then eager step {walls[0]:.3f} s, capture "
        f"step {walls[1]:.3f} s, replay {walls[2] * 1e3:.3f} ms [{card}]")
    if rs.recompilations != 1:
        fail(f"{label}: {rs.recompilations} recompilations, want 1")
    if not scores or not all(0.0 <= v <= 1.0 for v in scores.values()):
        fail(f"{label}: cache scores {scores}")
    if after_fit != (1, 1) or new.captures != 1 or old._entries:
        fail(f"{label}: captures {after_fit} then {new.captures}, old "
             f"program entries {len(old._entries)}")
    if not np.isfinite(losses).all():
        fail(f"{label}: losses {losses}")
    return dict(recompilations=rs.recompilations, scores=scores,
                compile_s=compile_s, eager_s=walls[0], capture_s=walls[1],
                replay_ms=walls[2] * 1e3)


def obs_phase(device, card: str, prompt_set: dict) -> dict:
    """Phase 11 (module doc): (a) and (b) on the BERT-Large proxy, (c) on
    GPT-2 small serving, (d) on the MoE cache model; their files in a
    temporary directory removed at the end."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="ff_obs_")
    try:
        res = obs_bert(device, card, tmp)
        res["serve"] = obs_serve(device, card, prompt_set, tmp)
        res["cache"] = obs_cache(device, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# ----------------------------------------------- phase 12: serving chaos
# GPT-2 small serves the e2e prompt lengths without a shared prefix (a
# victim's table row then maps no block another slot shares, as in the
# JAX package's isolation tests) on 8 slots. The victim is slot 1, the
# 96-token prompt, poisoned before decode step 4: its quarantine retry
# re-prefills 96 + 5 tokens, inside the 128 bucket the warm-up captured.
CHAOS_POISON = {4: 1}
CHAOS_POISON_TWICE = {4: 1, 8: 1}
CHAOS_VICTIM = 1
# a retried stream off the exact path (B5) may turn on a top-2 tie of the
# clean run's logits this close (the sampler gate's margin)
CHAOS_TIE_MARGIN = SAMPLER_TIE_MARGIN
# ring against paged B5 decode: summation order only, fp32
RING_ATOL = 1e-4


class ScriptedClock:
    """A deterministic ms clock for the deadline gate: a fixed step a
    call, so every deadline decision is a function of the call
    sequence."""

    def __init__(self, step_ms: float):
        self.t, self.step_ms = 0.0, step_ms

    def __call__(self) -> float:
        self.t += self.step_ms
        return self.t


def chaos_prompts(vocab: int, prompt_set: dict, seed: int = SEED + 1):
    return make_prompts(vocab, prompt_set["lengths"], 0, 0, seed)


def chaos_engine(ff, prompt_set: dict, **kw):
    """A fresh engine of ``ff`` at the phase's widths, warmed up by two
    guarded generates with ``CHAOS_POISON`` on prompts of the phase's
    shapes and other tokens: every program a poisoned serve runs (the
    retry's prefill and the scrub of the quarantined blocks included)
    takes its eager call and its capture. Its prefix cache is off: the
    gates run the same prompts several times on one engine, and a trie
    hit would take the chunk path (other programs, other rows)."""
    from flexflow_tpu_torch.resilience import ChaosPlan
    from flexflow_tpu_torch.serving import ServingEngine

    sampling = kw.pop("sampling", {})
    eng = ServingEngine(ff, n_slots=8, max_decode_len=prompt_set["max_len"],
                        prefix_cache="off", **kw)
    for seed in WARM_SEEDS:
        eng.generate(chaos_prompts(ff_vocab(ff), prompt_set, seed),
                     max_new_tokens=prompt_set["new_tokens"],
                     chaos=ChaosPlan(poison_decode_at=CHAOS_POISON),
                     **sampling)
    return eng


def record_decode_logits(eng) -> list:
    """Keep a device copy of every decode step's logits the engine
    dispatches (the checks' view of the neighbours' rows; no sync)."""
    rows = []
    real = eng._dispatch_decode

    def dispatch(params, guard):
        logits, ok = real(params, guard)
        rows.append(logits.clone())
        return logits, ok

    eng._dispatch_decode = dispatch
    return rows


def top2_gap(row) -> float:
    top = row.float().topk(2).values
    return float(top[0] - top[1])


def chaos_poison(device, card: str, ff, kv: str, loop: str,
                 prompt_set: dict, sampling: dict) -> dict:
    """Gate (a) for one (KV layout, serve loop): on a fresh warmed
    engine, an unpoisoned guarded run, the run with ``CHAOS_POISON`` and
    the one with ``CHAOS_POISON_TWICE``."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.kernels import topk as tk
    from flexflow_tpu_torch.resilience import ChaosPlan

    label = f"chaos poison {kv} {loop}"
    eng = chaos_engine(ff, prompt_set, kv_dtype=kv, serve_loop=loop,
                       sampling=sampling)
    prompts = chaos_prompts(ff_vocab(ff), prompt_set)
    new = prompt_set["new_tokens"]
    before = serving_captures(eng)
    b5 = "flash_decode_int8" if kv == "int8" else "flash_decode"
    runs, counts = {}, {b5: 0, "topk": 0}
    for name, script in (("clean", {}), ("poisoned", CHAOS_POISON),
                         ("twice", CHAOS_POISON_TWICE)):
        rows = record_decode_logits(eng)
        chaos = ChaosPlan(poison_decode_at=script)
        fd.reset_launch_count()
        tk.reset_launch_count()
        outs = eng.generate(prompts, max_new_tokens=new, chaos=chaos,
                            **sampling)
        torch.cuda.synchronize()
        del eng._dispatch_decode
        st = eng.stats
        counts[b5] += fd.launch_count(b5)
        counts["topk"] += tk.launch_count()
        runs[name] = dict(outs=outs, rows=rows, steps=st.decode_steps,
                          prefills=st.prefills, syncs=st.host_syncs,
                          outcomes=dict(st.outcomes),
                          quarantines=st.quarantines,
                          retries=st.decode_retries,
                          b5=fd.launch_count(b5), topk=tk.launch_count(),
                          poisoned=chaos.poisoned_decode_steps)
    n_layers = attention_layers(ff)
    clean, pois, twice = runs["clean"], runs["poisoned"], runs["twice"]
    want = {"clean": ({"ok": 8}, 0, 0), "poisoned": ({"ok": 8}, 1, 1),
            "twice": ({"ok": 7, "decode_fault": 1}, 2, 1)}
    for name, r in runs.items():
        if (r["outcomes"], r["quarantines"], r["retries"]) != want[name]:
            fail(f"{label} {name}: outcomes {r['outcomes']}, quarantines "
                 f"{r['quarantines']}, retries {r['retries']}; want "
                 f"{want[name]}")
        if r["syncs"] != r["steps"]:
            fail(f"{label} {name}: host_syncs {r['syncs']} != decode steps "
                 f"{r['steps']}")
        if r["b5"] != n_layers * r["steps"]:
            fail(f"{label} {name}: {r['b5']} {b5} launches over "
                 f"{r['steps']} decode steps, want {n_layers} a step")
        if sampling and r["topk"] != r["prefills"] + r["steps"]:
            fail(f"{label} {name}: {r['topk']} topk launches over "
                 f"{r['prefills']} prefills and {r['steps']} decode steps")
        if name != "clean" and r["poisoned"] != sorted(
                (CHAOS_POISON_TWICE if name == "twice" else
                 CHAOS_POISON)):
            fail(f"{label} {name}: poisoned at {r['poisoned']}")
    # the neighbours: streams and every common decode step's logits rows
    nb = [s for s in range(8) if s != CHAOS_VICTIM]
    for name in ("poisoned", "twice"):
        r = runs[name]
        for i in nb:
            if r["outs"][i] != clean["outs"][i]:
                fail(f"{label} {name}: neighbour {i}'s stream changed")
        common = min(len(r["rows"]), len(clean["rows"]))
        for s in range(common):
            if not torch.equal(r["rows"][s][nb], clean["rows"][s][nb]):
                fail(f"{label} {name}: neighbours' logits rows differ at "
                     f"decode step {s}")
    # the retried stream
    got, ref = pois["outs"][CHAOS_VICTIM], clean["outs"][CHAOS_VICTIM]
    diverge = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
                   None)
    gap = None
    if diverge is not None and not sampling:
        # token j came from decode step j - 1 of the clean run (all
        # prompts prefill before the first decode step)
        gap = top2_gap(clean["rows"][diverge - 1][CHAOS_VICTIM])
        if kv == "native" and not gap <= CHAOS_TIE_MARGIN:
            fail(f"{label}: the retried stream diverges at token "
                 f"{diverge} where the clean logits' top-2 gap is {gap}")
    if len(got) != len(ref):
        fail(f"{label}: the retried stream has {len(got)} tokens")
    captured = serving_captures(eng) - before
    if captured:
        fail(f"{label}: {captured} captures after warm-up")
    log(f"{label}: quarantines 1 / retries 1 / outcomes {pois['outcomes']}"
        f" and, poisoned twice, {twice['outcomes']}; neighbours' streams "
        f"and logits rows over {min(len(pois['rows']), len(clean['rows']))}"
        f" common decode steps bitwise the clean guarded run's; retried "
        f"stream {'identical' if diverge is None else f'diverges at token {diverge} (top-2 gap {gap})'}"
        f"; host_syncs = decode steps ({clean['steps']}, {pois['steps']}, "
        f"{twice['steps']}); {b5} {n_layers} a step"
        f"{'; topk one a sampler call' if sampling else ''}; captures 0 "
        f"[{card}]")
    del eng
    return dict(counts=counts, retried_identical=diverge is None)


def chaos_exact(device, card: str, ff, prompt_set: dict) -> None:
    """Gate (a), exact decode: the poisoned run's streams, the retried one
    included, token-identical to the clean run's."""
    from flexflow_tpu_torch.resilience import ChaosPlan
    from flexflow_tpu_torch.serving import ServingEngine

    eng = ServingEngine(ff, n_slots=8, max_decode_len=prompt_set["max_len"],
                        exact_decode=True)
    prompts = chaos_prompts(ff_vocab(ff), prompt_set)
    outs = {}
    for name, script in (("clean", {}), ("poisoned", CHAOS_POISON)):
        outs[name] = eng.generate(prompts,
                                  max_new_tokens=prompt_set["new_tokens"],
                                  chaos=ChaosPlan(poison_decode_at=script))
    st = eng.stats
    if outs["poisoned"] != outs["clean"] or st.quarantines != 1:
        fail(f"chaos exact: poisoned streams differ from the clean run's "
             f"(quarantines {st.quarantines})")
    log(f"chaos exact native sync: under exact_decode the poisoned run's 8 "
        f"streams, the retried one included, equal the clean run's; "
        f"outcomes {st.outcomes} [{card}]")


def attention_layers(ff) -> int:
    from flexflow_tpu_torch.ffconst import OperatorType

    return sum(1 for n in ff.executor.pcg.compute_nodes()
               if n.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION)


def ff_vocab(ff) -> int:
    return ff.pcg.nodes[ff.executor.final_guid].out_shapes[
        ff.executor.final_out_idx][-1]


def settle_host() -> None:
    """Before a timed run: collect garbage (a dropped engine's programs
    hold CUDA graphs, whose destruction inside a timed run would cost it
    tenths of a second) and let the card finish."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()


def chaos_guard_cost(device, card: str, ff, prompt_set: dict) -> int:
    """Gate (b): the guarded and the unguarded decode program on one fresh
    engine (native, sync, greedy), both warmed: streams bitwise equal, B5
    12 a decode step each way, ``decode_compiles`` 1 for each, then
    tokens/s and p50 / p99 ms a token over the runs unguarded, guarded,
    guarded, unguarded, and the host's kernel / graph launch calls of one
    profiled generate each way."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.resilience import ChaosPlan

    eng = chaos_engine(ff, prompt_set)
    vocab = ff_vocab(ff)
    for seed in WARM_SEEDS:  # the unguarded program's warm-up
        eng.generate(chaos_prompts(vocab, prompt_set, seed),
                     max_new_tokens=prompt_set["new_tokens"])
    prompts = chaos_prompts(vocab, prompt_set)
    before = serving_captures(eng)
    res = {False: [], True: []}
    outs = {}
    launches = 0
    for guarded in (False, True, True, False):
        settle_host()
        fd.reset_launch_count()
        outs[guarded] = eng.generate(
            prompts, max_new_tokens=prompt_set["new_tokens"],
            chaos=ChaosPlan() if guarded else None)
        torch.cuda.synchronize()
        st = eng.stats
        if guarded:
            launches += fd.launch_count()
        if eng._last_guard is not guarded or eng.decode_compiles != 1:
            fail(f"chaos guard: guard {eng._last_guard}, decode_compiles "
                 f"{eng.decode_compiles}")
        per_step = fd.launch_count() / st.decode_steps
        if per_step != attention_layers(ff) or \
                st.host_syncs != st.decode_steps:
            fail(f"chaos guard {guarded}: B5 {per_step} a step, host_syncs "
                 f"{st.host_syncs} over {st.decode_steps} steps")
        res[guarded].append((st.tokens_per_s(), st.p50_token_ms(),
                             st.p99_token_ms()))
    if outs[True] != outs[False]:
        fail("chaos guard: guarded streams differ from unguarded ones")
    prof = {g: profiled(lambda g=g: eng.generate(
        prompts, max_new_tokens=prompt_set["new_tokens"],
        chaos=ChaosPlan() if g else None)) for g in (False, True)}
    captured = serving_captures(eng) - before
    if captured:
        fail(f"chaos guard: {captured} captures after warm-up")
    fmt = "; ".join(f"{t:.1f} tokens/s, p50 {p50:.3f} / p99 {p99:.3f} ms"
                    for t, p50, p99 in [res[False][0], res[True][0],
                                        res[True][1], res[False][1]])
    log(f"chaos guard native sync (unguarded, guarded, guarded, "
        f"unguarded): {fmt}; streams bitwise equal, B5 "
        f"{attention_layers(ff)} a decode step, "
        f"decode_compiles 1 each way, captures 0; launch calls kernel / "
        f"graph a generate: unguarded {prof[False]['kernel_launch_calls']}"
        f" / {prof[False]['graph_launch_calls']}, guarded "
        f"{prof[True]['kernel_launch_calls']} / "
        f"{prof[True]['graph_launch_calls']} [{card}]")
    del eng
    return launches


def chaos_paths(device, card: str, ff, prompt_set: dict) -> None:
    """Gate (c): deadlines on a scripted clock (twice, the same outcomes
    and streams; the evicted requests' slots serve the queued ones), a
    real-clock run under ``--request-timeout-ms`` (counts only), the
    ``queue`` shed policy under a storm (the same shed / accept counts in
    two calls), and a real SIGTERM drain (in-flight requests finish,
    queued ones come back and complete when resubmitted, the handler
    restored)."""
    import signal

    import torch

    from flexflow_tpu_torch.resilience import ChaosPlan
    from flexflow_tpu_torch.serving import (ContinuousBatchScheduler,
                                            Request, ServingEngine)

    vocab, new = ff_vocab(ff), prompt_set["new_tokens"]
    max_len = prompt_set["max_len"]
    prompts = chaos_prompts(vocab, prompt_set) + \
        chaos_prompts(vocab, prompt_set, SEED + 7)[:2]

    def deadlines():
        eng = ServingEngine(ff, n_slots=8, max_decode_len=max_len)
        eng.resilience_clock = ScriptedClock(1.0)
        res = eng._make_resilience(None)
        sched = ContinuousBatchScheduler(n_slots=8, max_queue=16,
                                         buckets=eng.buckets,
                                         max_len=max_len, clock=res.clock)
        reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=new,
                        rng_tag=i, deadline_ms=40.0 if i in (0, 3) else None)
                for i, p in enumerate(prompts)]
        for r in reqs:
            res.admit(sched, r)
        eng.serve(sched, resilience=res)
        return ([(r.outcome, list(r.generated)) for r in reqs],
                dict(eng.stats.outcomes), sched.evicted)

    a, b = deadlines(), deadlines()
    if a != b:
        fail("chaos deadlines: two scripted-clock runs differ")
    outcomes = [o for o, _ in a[0]]
    if a[1] != {"ok": 8, "deadline_exceeded": 2} or \
            outcomes[8:] != ["ok", "ok"] or a[2] != 2:
        fail(f"chaos deadlines: outcomes {a[1]} {outcomes}, evicted {a[2]}")
    ff.config.request_timeout_ms = 60.0
    try:
        eng = ServingEngine(ff, n_slots=8, max_decode_len=max_len)
        eng.generate(prompts, max_new_tokens=new)
        real = dict(eng.stats.outcomes)
    finally:
        ff.config.request_timeout_ms = 0.0
    ff.config.shed_policy = "queue"
    try:
        def storm():
            # high-water 8: the 8 prompts queue before the serve, then
            # the storm finds the queue empty and 8 of its 12 enter
            eng = ServingEngine(ff, n_slots=8, max_decode_len=max_len,
                                max_queue=16)
            chaos = ChaosPlan(storm_queue={2: [prompts[3][:12]] * 12},
                              storm_max_new_tokens=4)
            outs = eng.generate(prompts[:8], max_new_tokens=new,
                                chaos=chaos)
            return outs, dict(eng.stats.outcomes), eng.stats.sheds
        s1, s2 = storm(), storm()
    finally:
        ff.config.shed_policy = "off"
    if s1 != s2 or s1[2] != 4 or s1[1] != {"ok": 16, "shed": 4}:
        fail(f"chaos shed: {s1[1:]} then {s2[1:]}")
    prev = signal.getsignal(signal.SIGTERM)
    eng = ServingEngine(ff, n_slots=8, max_decode_len=max_len)
    chaos = ChaosPlan(preempt_serving_at=1)
    outs = eng.generate(prompts, max_new_tokens=new, chaos=chaos)
    drained = eng.drained_requests
    st = eng.stats
    if signal.getsignal(signal.SIGTERM) is not prev:
        fail("chaos drain: the SIGTERM handler was not restored")
    if chaos.serving_preempted_at != 1 or \
            [r.rng_tag for r in drained] != [8, 9] or \
            st.outcomes != {"ok": 8, "preempted": 2} or \
            any(len(o) != new for o in outs[:8]):
        fail(f"chaos drain: outcomes {st.outcomes}, drained "
             f"{[r.rng_tag for r in drained]}")
    res = eng._make_resilience(None)
    sched = ContinuousBatchScheduler(n_slots=8, max_queue=8,
                                     max_len=max_len, clock=res.clock)
    for r in drained:
        r.outcome = None
        res.admit(sched, r)
    eng.serve(sched, resilience=res)
    if any(len(r.generated) != new or r.outcome != "ok" for r in drained):
        fail("chaos drain: the resubmitted requests did not complete")
    torch.cuda.synchronize()
    log(f"chaos paths: scripted-clock deadlines twice alike, outcomes "
        f"{a[1]} (requests 0 and 3 evicted at "
        f"{[len(a[0][i][1]) for i in (0, 3)]} tokens, 8 and 9 served in "
        f"their slots); real clock, --request-timeout-ms 60: {real}; "
        f"--shed-policy queue under a storm of 12: {s1[1]} twice "
        f"({s1[2]} shed); SIGTERM before decode step 1: 8 finished, "
        f"drained {[r.rng_tag for r in drained]} completed when "
        f"resubmitted, handler restored [{card}]")


def teacher_forced_engine(ff, tokens, prompt_len: int, steps: int,
                          max_len: int, **engine_kw):
    """Teacher-forced decode through a one-slot engine's own state and
    decode program (any layout): the logits of ``steps`` decode steps."""
    import torch

    from flexflow_tpu_torch.serving import ServingEngine

    eng = ServingEngine(ff, n_slots=1, max_decode_len=max_len, **engine_kw)
    dev = ff.device
    bucket = next(b for b in eng.buckets if b >= prompt_len)
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt_len] = tokens[:prompt_len]
    _lg, _last, cache = eng._prefill_fn(bucket)(
        ff.params, [torch.tensor(ids, device=dev)],
        torch.tensor([prompt_len], dtype=torch.int32, device=dev))
    eng._ensure_state(cache)
    row = None
    if eng._paged:
        blocks = eng.block_allocator.alloc(
            eng.block_allocator.blocks_needed(prompt_len + steps + 1))
        row = np.zeros((eng.max_blocks_per_slot,), np.int32)
        row[:len(blocks)] = blocks
    eng._write_slot(cache, 0, prompt_len, int(tokens[prompt_len - 1]), row)
    dec = eng._decode_fn()
    state, rows = eng.state, []
    for s in range(steps):
        tok = torch.tensor([[tokens[prompt_len + s]]], dtype=torch.int32,
                           device=dev)
        logits, state = dec(ff.params, [tok], state)
        rows.append(logits[0].clone())
    return torch.stack(rows)


def chaos_ring(device, card: str, ff, prompt_set: dict) -> None:
    """Gate (d): the ring layout (max_decode_len 512, a multiple of the
    16-token block). Teacher-forced logits of ring and paged-exact
    decode bitwise equal; ring against paged B5 within ``RING_ATOL``;
    greedy streams of warmed ring and paged engines equal (a divergence
    only at a top-2 gap of the ring's logits under ``CHAOS_TIE_MARGIN``);
    ring / paged ``kv_bytes_per_token`` the analytic ratio; tokens/s each
    way."""
    import math

    import torch

    from flexflow_tpu_torch.serving import ServingEngine

    max_len, new = prompt_set["max_len"], prompt_set["new_tokens"]
    vocab = ff_vocab(ff)
    prompts = chaos_prompts(vocab, prompt_set)
    # 96 prompt tokens and 48 decode steps at 512 positions
    plen, steps = max_len * 3 // 16, max_len * 3 // 32
    tokens = make_prompts(vocab, (plen + steps,), 0, 0, SEED + 9)[0]
    ring = teacher_forced_engine(ff, tokens, plen, steps, max_len,
                                 kv_cache="ring", exact_decode=True)
    exact = teacher_forced_engine(ff, tokens, plen, steps, max_len,
                                  exact_decode=True)
    fast = teacher_forced_engine(ff, tokens, plen, steps, max_len)
    if not torch.equal(ring, exact):
        fail(f"chaos ring: ring and paged-exact logits differ by "
             f"{(ring - exact).abs().max().item()}")
    err = (ring - fast).abs().max().item()
    if not err <= RING_ATOL:
        fail(f"chaos ring: ring vs paged B5 logits differ by {err}")
    engines, runs = {}, {"ring": [], "paged": []}
    for layout in ("ring", "paged"):
        eng = engines[layout] = ServingEngine(
            ff, n_slots=8, max_decode_len=max_len, kv_cache=layout,
            prefix_cache="off")
        for seed in WARM_SEEDS:
            eng.generate(chaos_prompts(vocab, prompt_set, seed),
                         max_new_tokens=new)
    before = {k: serving_captures(e) for k, e in engines.items()}
    for layout in ("ring", "paged", "paged", "ring"):
        eng = engines[layout]
        settle_host()
        outs = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        st = eng.stats
        runs[layout].append((outs, st.tokens_per_s(), st.p50_token_ms(),
                             st.p99_token_ms(), st.kv_bytes_per_token(),
                             st.decode_steps))
    captured = {k: serving_captures(e) - before[k]
                for k, e in engines.items()}
    del engines, eng
    if any(captured.values()):
        fail(f"chaos ring: captures in the timed runs {captured}")
    timed = {k: [r[1:4] for r in v] for k, v in runs.items()}
    runs = {k: v[0][:1] + v[0][1:3] + v[0][4:] for k, v in runs.items()}
    bs, n = 16, runs["paged"][4]
    paged_keys = sum(math.ceil((len(p) + 2 + i) / bs) * bs
                     for p in prompts for i in range(n))
    want = n * 8 * max_len / paged_keys
    ratio = runs["ring"][3] / runs["paged"][3]
    if abs(ratio - want) > 1e-9 * want:
        fail(f"chaos ring: kv_bytes_per_token ratio {ratio}, analytic "
             f"{want}")
    for i, (a, b) in enumerate(zip(runs["ring"][0], runs["paged"][0])):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        row = teacher_forced_engine(ff, prompts[i] + b, len(prompts[i]),
                                    max(j, 1), max_len,
                                    kv_cache="ring")[max(j, 1) - 1]
        if j == 0 or top2_gap(row) > CHAOS_TIE_MARGIN:
            fail(f"chaos ring: request {i}'s ring stream diverges from "
                 f"paged at token {j}")
    fmt = {k: "; ".join(f"{t:.1f} tokens/s, p50 {p50:.3f} / p99 {p99:.3f}"
                        f" ms" for t, p50, p99 in v)
           for k, v in timed.items()}
    log(f"chaos ring: teacher-forced {steps} steps ring == paged-exact "
        f"bitwise, ring vs paged B5 max |diff| {err:.3g} (atol "
        f"{RING_ATOL}); greedy streams equal; timed ring, paged, paged, "
        f"ring on warmed engines, no capture: ring {fmt['ring']}; paged "
        f"{fmt['paged']}; kv_bytes_per_token {runs['ring'][3]:.1f} vs "
        f"{runs['paged'][3]:.1f} = {ratio:.4f}, the analytic {want:.4f} "
        f"[{card}]")


def chaos_kernel_checks(device, card: str) -> dict:
    """B5 and B7 on non-finite rows at the phase's shapes (not counted as
    main-path launches): a slot whose occupied blocks are NaN (native and
    int8, the scales carrying it) leaves the other slots equal to the
    plain version and its own row NaN; a top-k over 8 rows of 50304 with
    a NaN row, a half-NaN row and a +inf row returns healthy rows equal to
    the plain sweeps' and in-range, distinct indices for the NaN rows."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.kernels import topk as tk
    from flexflow_tpu_torch.serving.kvcache import quantize_kv

    per_layer, tables, n_keys = decode_inputs(torch.float32, device, 1)
    q, k, v = per_layer[0]
    victim = 3
    used = -(-int(n_keys[victim]) // BLOCK)
    blocks = tables[victim, :used].long()
    healthy = [s for s in range(SLOTS) if s != victim]
    out = {}
    for int8 in (False, True):
        if int8:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            args = (q, kq, vq, tables, n_keys)
            kw = dict(kscale=ks.clone().index_fill_(0, blocks, float("nan")),
                      vscale=vs.clone().index_fill_(0, blocks, float("nan")))
        else:
            args = (q, k.clone().index_fill_(0, blocks, float("nan")),
                    v.clone().index_fill_(0, blocks, float("nan")),
                    tables, n_keys)
            kw = {}
        got = fd.flash_decode(*args, **kw)
        want = fd.flash_decode_plain(*args, **kw)
        err = (got[healthy] - want[healthy]).abs().max().item()
        if not (err <= KERNEL_ATOL["fp32"] and torch.isnan(got[victim]).all()
                and torch.isnan(want[victim]).all()):
            fail(f"chaos B5 {'int8' if int8 else 'native'} on a NaN slot: "
                 f"healthy max |diff| {err}, victim all NaN "
                 f"{bool(torch.isnan(got[victim]).all())}")
        out["flash_decode_int8" if int8 else "flash_decode"] = err
    x = topk_inputs(device, 1)[0]
    x[1] = float("nan")
    x[3, ::2] = float("nan")
    x[5, [10, 20]] = float("inf")
    vals, idx = tk.topk(x, 8)
    want_v, want_i = tk.topk_plain(x, 8)
    nan_rows = torch.isnan(x).any(dim=-1)
    ok_rows = ~nan_rows
    if not (torch.equal(idx[ok_rows], want_i[ok_rows])
            and torch.equal(vals[ok_rows], want_v[ok_rows])):
        fail("chaos B7 on NaN rows: a healthy row differs from the plain")
    for r in torch.nonzero(nan_rows)[:, 0].tolist():
        got = idx[r].tolist()
        if not (all(0 <= i < VOCAB_PADDED for i in got)
                and len(set(got)) == 8):
            fail(f"chaos B7 on NaN rows: row {r}'s indices {got}")
    torch.cuda.synchronize()
    out["topk"] = 0.0
    log(f"chaos kernels: B5 on a NaN slot, healthy slots max |diff| "
        f"native {out['flash_decode']:.3g}, int8 "
        f"{out['flash_decode_int8']:.3g}, the slot NaN in kernel and plain; "
        f"B7 k=8 on 2 NaN rows and an inf row: the other rows equal the "
        f"plain sweeps', the NaN rows' indices in range and distinct "
        f"[{card}]")
    return out


def chaos_phase(device, card: str, prompt_set: dict) -> dict:
    """Phase 12 (module doc): serving under failure on GPT-2 small."""
    import torch

    from flexflow_tpu_torch.models.gpt2 import GPT2Config

    t0 = time.perf_counter()
    errs = chaos_kernel_checks(device, card)
    shapes = dict(prompt_set)
    native = build_model(GPT2Config.small(), "fp32", device,
                         shapes["max_len"])
    counts = {"flash_decode": 0, "flash_decode_int8": 0, "topk": 0}
    retried = {}
    for loop in ("sync", "async"):
        r = chaos_poison(device, card, native, "native", loop, shapes, {})
        counts["flash_decode"] += r["counts"]["flash_decode"]
        retried[("native", loop)] = r["retried_identical"]
    chaos_exact(device, card, native, shapes)
    counts["flash_decode"] += chaos_guard_cost(device, card, native, shapes)
    chaos_paths(device, card, native, shapes)
    chaos_ring(device, card, native, shapes)
    del native
    torch.cuda.empty_cache()
    padded = build_model(GPT2Config(vocab_size=VOCAB_PADDED), "fp32", device,
                         shapes["max_len"])
    for loop in ("sync", "async"):
        r = chaos_poison(device, card, padded, "int8", loop, shapes,
                         OBS_SERVE_SAMPLING)
        counts["flash_decode_int8"] += r["counts"]["flash_decode_int8"]
        counts["topk"] += r["counts"]["topk"]
        retried[("int8", loop)] = r["retried_identical"]
    del padded
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"chaos phase: {wall:.1f} s; main-path launches in the guarded "
        f"runs {counts}; retried streams identical {retried} [{card}]")
    return dict(counts=counts, errs=errs)


# ------------------------- phase 13: speculative decoding, LSTM, spans
# (a) GPT-2 small (fp32, vocab 50257) verifies the proposals of a drafter
# GPT-2 of the same vocabulary at hidden 256 / 4 heads / 2 layers, from its
# own seed: eight prompts of 16-64 tokens, 32 new tokens, gamma 4, a
# scoring context of 128 (buckets 16 / 32 / 64 / 128)
SPEC_LENGTHS = (16, 24, 32, 40, 48, 56, 64, 20)
SPEC_GAMMA = 4
SPEC_MAX_LEN = 128
SPEC_DRAFTER = dict(hidden=256, num_heads=4, num_layers=2, intermediate=1024)
SPEC_DRAFTER_SEED = SEED + 7
# two greedy streams may part only at a position whose top-2 logit gap
# (of the target's whole-sequence forward on their common prefix) is
# under this: the port's prefill, exact decode and B5 decode differ in
# summation order only
SPEC_TIE = 1e-4
# (b) an LSTM language model at NMTConfig()'s published widths (rnn.h:
# vocab 32000, embed 1024, two stacked LSTMs of hidden 1024) with a dense
# head: the decoder half of models/nmt.py as an LM, fp32, 8 slots
LSTM_LM = dict(vocab=32000, embed=1024, hidden=1024, layers=2)
LSTM_LENGTHS = (8, 13, 40, 21, 32, 9, 27, 16)
LSTM_MAX_LEN = 128
# teacher-forced decode logits against the card's whole-sequence forward
LSTM_ATOL = 1e-4
# (c) the traced serve: the e2e prompt lengths and a ninth prompt that
# shares the first one's 72-token prefix (4.5 blocks of 16); it waits for
# a free slot, so the first's blocks are in the trie by then. The prefix
# cache on and 64-token chunks
SPANS_LENGTHS = (200, 96, 150, 32, 120, 180, 72, 48)
SPANS_SHARED = 72
SPANS_PAIR_TAIL = 40
SPANS_CHUNK_TOKENS = 64
SPANS_FIELDS = {"prefill": {"rid", "bucket", "slot", "prompt_len"},
                "prefill_chunk": {"rid", "slot", "start", "tokens", "hit",
                                  "done"},
                "decode_step": {"step", "live_slots"},
                "prefix_cow_clone": {"rid", "slot", "src", "dst"}}


def stream_gaps(ff, prompt, stream):
    """The top-2 logit gap of ``ff``'s whole-sequence forward at each token
    of ``stream`` (the distribution it was taken from), as numpy."""
    import torch

    seq = list(prompt) + list(stream)
    full = ff.executor.forward(ff.params, [torch.tensor(
        [seq], dtype=torch.int32, device=ff.device)])[0]
    top = full[len(prompt) - 1:len(seq) - 1].float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def equal_outside_ties(label: str, ff, prompts, want, got) -> tuple:
    """Fail unless ``got`` equals ``want`` stream by stream, except after a
    position whose top-2 gap (on ``ff``'s forward) is under SPEC_TIE.
    Returns (tokens excluded by that rule, the smallest gap over every
    compared token)."""
    excluded, smallest = 0, float("inf")
    for i, (p, a, b) in enumerate(zip(prompts, want, got)):
        if len(a) != len(b):
            fail(f"{label}: stream {i} has {len(b)} tokens, want {len(a)}")
        gaps = stream_gaps(ff, p, b)
        part = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                    None)
        upto = len(b) if part is None else part + 1
        smallest = min(smallest, float(gaps[:upto].min()))
        if part is None:
            continue
        if not gaps[part] < SPEC_TIE:
            fail(f"{label}: stream {i} parts at token {part} where the "
                 f"top-2 gap is {gaps[part]}")
        excluded += len(b) - part
    return excluded, smallest


def program_captures(*models) -> int:
    """Graphs captured so far by every serving program of the models'
    executors (the prefill per bucket among them)."""
    seen, total = set(), 0
    for m in models:
        for fn in m.executor._serving_fns.values():
            prog = getattr(fn, "program", None)
            if prog is not None and id(prog) not in seen:
                seen.add(id(prog))
                total += prog.captures
    return total


def held_decode_err(eng, seed: int = SEED) -> float:
    """B5 against its plain version on ``eng``'s pools after its run (the
    main path's shapes: its slots, heads, blocks and extent), under
    shuffled tables and key counts 1..max_len. Not counted as main-path
    launches: the caller reads the counts first."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd

    dev = eng.device
    n, mb = eng.n_slots, eng.max_blocks_per_slot
    rng = np.random.default_rng(seed)
    first = next(iter(eng.state.caches.values()))[0]
    blocks, heads, _bs, d = first.shape
    tables = torch.tensor(rng.permutation(np.arange(1, blocks))[:n * mb]
                          .reshape(n, mb), dtype=torch.int32, device=dev)
    keys = rng.integers(1, eng.max_decode_len + 1, n)
    keys[0], keys[-1] = 1, eng.max_decode_len
    n_keys = torch.tensor(keys, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((n, heads, d), generator=gen, device=dev)
    err = 0.0
    for kp, vp in eng.state.caches.values():
        got = fd.flash_decode(q, kp, vp, tables, n_keys)
        want = fd.flash_decode_plain(q, kp, vp, tables, n_keys)
        err = max(err, (got - want).abs().max().item())
    if not err <= KERNEL_ATOL["fp32"]:
        fail(f"flash_decode on the engine's pools: max |kernel - plain| = "
             f"{err}")
    return err


def spec_phase(device, card: str, target) -> dict:
    """Gate (a): the baselines, then the random and the perfect drafter."""
    import torch

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.models.gpt2 import GPT2Config
    from flexflow_tpu_torch.serving import ServingEngine, SpeculativeDecoder

    label = "spec gpt2-small fp32"
    vocab, new = ff_vocab(target), E2E_NEW_TOKENS
    prompts = make_prompts(vocab, SPEC_LENGTHS, 0, 0)
    warm = [make_prompts(vocab, SPEC_LENGTHS, 0, 0, s) for s in WARM_SEEDS]
    base, err = {}, None
    for mode, exact in (("exact", True), ("b5", False)):
        eng = ServingEngine(target, n_slots=8, max_decode_len=SPEC_MAX_LEN,
                            exact_decode=exact, prefix_cache="off")
        for w in warm:
            eng.generate(w, max_new_tokens=new)
        settle_host()
        before = serving_captures(eng)
        fd.reset_launch_count()
        outs = eng.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        st = eng.stats
        r = base[mode] = dict(
            outs=outs, tokens_per_s=st.tokens_per_s(), steps=st.decode_steps,
            p50=st.p50_token_ms(), b5=fd.launch_count("flash_decode"),
            captures=serving_captures(eng) - before,
            compiles=eng.decode_compiles)
        want_b5 = 0 if exact else attention_layers(target) * r["steps"]
        if r["b5"] != want_b5 or r["captures"] or r["compiles"] != 1:
            fail(f"{label} baseline {mode}: {r['b5']} B5 launches over "
                 f"{r['steps']} decode steps (want {want_b5}), captures "
                 f"{r['captures']}, decode_compiles {r['compiles']}")
        if not exact:
            err = held_decode_err(eng)
        log(f"{label} baseline {mode}: {r['tokens_per_s']:.1f} tokens/s, "
            f"p50 {r['p50']:.3f} ms a token, {r['steps']} decode steps, "
            f"B5 launches {r['b5']}, captures 0, decode_compiles 1 [{card}]")
        del eng
    x, g = equal_outside_ties(f"{label} exact vs b5", target, prompts,
                              base["exact"]["outs"], base["b5"]["outs"])
    drafter = build_model(GPT2Config(**SPEC_DRAFTER), "fp32", device,
                          SPEC_MAX_LEN, seed=SPEC_DRAFTER_SEED)
    res = {}
    for which, d in (("random", drafter), ("perfect", target)):
        for w in warm:
            SpeculativeDecoder(target, d, gamma=SPEC_GAMMA,
                               max_context=SPEC_MAX_LEN).generate(
                w, max_new_tokens=new)
        settle_host()
        before = program_captures(target, d)
        spec = SpeculativeDecoder(target, d, gamma=SPEC_GAMMA,
                                  max_context=SPEC_MAX_LEN)
        outs = spec.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        st = spec.stats
        captured = program_captures(target, d) - before
        cmp = {}
        for mode in ("exact", "b5"):
            cmp[mode] = equal_outside_ties(f"{label} {which} vs {mode}",
                                           target, prompts,
                                           base[mode]["outs"], outs)
        r = res[which] = dict(
            rounds=st.spec_rounds, proposed=st.spec_proposed,
            accepted=st.spec_accepted, acceptance=st.acceptance_rate(),
            tokens=st.tokens_generated, tokens_per_s=st.tokens_per_s(),
            p50=st.p50_token_ms(), captures=captured, cmp=cmp)
        if captured:
            fail(f"{label} {which}: {captured} prefill captures after "
                 "warm-up")
        if which == "perfect":
            # a rejection of the target's own proposal can come only from
            # a near-tie read at two buckets
            ties = sum(int((stream_gaps(target, p, o) < SPEC_TIE).sum())
                       for p, o in zip(prompts, outs))
            if st.spec_proposed - st.spec_accepted > ties or \
                    not st.spec_rounds < st.tokens_generated:
                fail(f"{label} perfect: acceptance {st.acceptance_rate()} "
                     f"({st.spec_proposed - st.spec_accepted} rejections, "
                     f"{ties} tied positions), {st.spec_rounds} rounds for "
                     f"{st.tokens_generated} tokens")
        log(f"{label} {which} drafter gamma {SPEC_GAMMA}: rounds "
            f"{r['rounds']}, proposed {r['proposed']}, accepted "
            f"{r['accepted']}, acceptance {r['acceptance']:.4f}, "
            f"{r['tokens']} tokens, {r['tokens_per_s']:.1f} tokens/s, p50 "
            f"{r['p50']:.3f} ms a token (baseline exact "
            f"{base['exact']['tokens_per_s']:.1f}, B5 "
            f"{base['b5']['tokens_per_s']:.1f} tokens/s); streams equal "
            f"both baselines outside ties (excluded tokens / smallest gap: "
            f"exact {cmp['exact'][0]} / {cmp['exact'][1]:.3g}, B5 "
            f"{cmp['b5'][0]} / {cmp['b5'][1]:.3g}); prefill captures after "
            f"warm-up 0 [{card}]")
    log(f"{label}: exact and B5 baselines equal outside ties (excluded "
        f"{x}, smallest gap {g:.3g}) [{card}]")
    del drafter
    torch.cuda.empty_cache()
    return dict(b5=base["b5"]["b5"], err=err, base=base, runs=res)


def lstm_lm(device, seed: int = SEED):
    """The LSTM language model at LSTM_LM's widths, compiled on ``device``
    with random weights from ``seed``."""
    from flexflow_tpu_torch import DataType, FFConfig, FFModel

    w = LSTM_LM
    config = FFConfig()
    config.batch_size, config.seed = 8, seed
    config.max_decode_len, config.max_inflight = LSTM_MAX_LEN, 8
    ff = FFModel(config, device=device)
    ids = ff.create_tensor((8, LSTM_MAX_LEN), dtype=DataType.DT_INT32,
                           name="lm_ids")
    t = ff.embedding(ids, w["vocab"], w["embed"], name="lm_embed")
    for i in range(w["layers"]):
        t, _state = ff.lstm(t, w["hidden"], name=f"lm_lstm{i}")
    ff.dense(t, w["vocab"], name="lm_head")
    ff.compile()
    return ff


def lstm_teacher_forced(ff, tokens, prompt_len: int):
    """Prefill ``tokens[:prompt_len]``, then decode the rest fed the true
    tokens through the captured decode program; the serving logits (the
    prefill's last row, then one row a decode step)."""
    import torch

    from flexflow_tpu_torch.serving.kvcache import DecodeState
    from flexflow_tpu_torch.serving.scheduler import (bucket_for,
                                                      default_buckets)

    ex, dev = ff.executor, ff.device
    bucket = bucket_for(prompt_len, default_buckets(LSTM_MAX_LEN))
    ids = np.zeros((1, bucket), np.int32)
    ids[0, :prompt_len] = tokens[:prompt_len]
    _lg, last, cache = ex.make_prefill_step(bucket, LSTM_MAX_LEN)(
        ff.params, [torch.tensor(ids, device=dev)],
        torch.tensor([prompt_len], dtype=torch.int32, device=dev))
    state = DecodeState(caches=dict(cache), lengths=torch.tensor(
        [prompt_len], dtype=torch.int32, device=dev))
    decode = ex.make_decode_step(LSTM_MAX_LEN)
    rows = [last[0]]
    for t in range(prompt_len, len(tokens)):
        logits, state = decode(ff.params, [torch.tensor(
            [[tokens[t]]], dtype=torch.int32, device=dev)], state)
        rows.append(logits[0])
    return torch.stack(rows)


def lstm_phase(device, card: str) -> dict:
    """Gate (b): the LSTM language model served at NMT's widths."""
    import torch

    from flexflow_tpu_torch.serving import ServingEngine

    label = "lstm lm nmt-widths fp32"
    ff = lstm_lm(device)
    vocab = LSTM_LM["vocab"]
    # the refusals: prefix cache by name, chunked prefill
    for kw in (dict(prefix_cache="on"),
               dict(prefill_chunk_tokens=32, kv_block_size=16)):
        try:
            ServingEngine(ff, n_slots=8, max_decode_len=LSTM_MAX_LEN, **kw)
        except ValueError as e:
            if "LSTM" not in str(e):
                fail(f"{label}: {kw} raised {e}")
        else:
            fail(f"{label}: {kw} did not raise ValueError")
    # teacher-forced decode against the card's whole-sequence forward
    rng = np.random.default_rng(SEED + 5)
    worst, ties, scale, rows = 0.0, 0, 0.0, 0
    for prompt_len in (24, 5):
        tokens = rng.integers(0, vocab, 64).tolist()
        serving = lstm_teacher_forced(ff, tokens, prompt_len)
        full = ff.executor.forward(ff.params, [torch.tensor(
            [tokens], dtype=torch.int32, device=device)])[0]
        want = full[prompt_len - 1:]
        if not bool(torch.isfinite(serving).all()):
            fail(f"{label}: non-finite serving logits")
        worst = max(worst, (serving - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        rows += want.shape[0]
        top = want.topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1])
        differ = serving.argmax(-1) != want.argmax(-1)
        if bool((differ & (gap >= SPEC_TIE)).any()):
            fail(f"{label}: teacher-forced greedy argmax differs from the "
                 "forward's outside a tie")
        ties += int((gap < SPEC_TIE).sum())
    if not worst <= LSTM_ATOL:
        fail(f"{label}: teacher-forced decode logits {worst} from the "
             f"forward (> {LSTM_ATOL})")
    log(f"{label}: teacher-forced decode logits within {worst:.3g} of the "
        f"card's whole-sequence forward (limit {LSTM_ATOL}; the logits "
        f"reach {scale:.3g} at random weights), greedy argmax equal "
        f"({ties} of {rows} positions under the {SPEC_TIE} tie rule) "
        f"[{card}]")
    prompts = make_prompts(vocab, LSTM_LENGTHS, 0, 0)
    warm = [make_prompts(vocab, LSTM_LENGTHS, 0, 0, s) for s in WARM_SEEDS]
    new = E2E_NEW_TOKENS
    runs = {}
    for kv in ("paged", "ring"):
        for loop in ("sync", "async"):
            eng = ServingEngine(ff, n_slots=8, max_decode_len=LSTM_MAX_LEN,
                                kv_cache=kv, serve_loop=loop)
            if eng._prefix is not None:
                fail(f"{label}: the prefix cache is on")
            for w in warm:
                eng.generate(w, max_new_tokens=new)
            settle_host()
            before = serving_captures(eng)
            outs = eng.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            st = eng.stats
            r = runs[(kv, loop)] = dict(
                outs=outs, tokens_per_s=st.tokens_per_s(),
                p50=st.p50_token_ms(), steps=st.decode_steps,
                captures=serving_captures(eng) - before,
                compiles=eng.decode_compiles)
            if r["captures"] or r["compiles"] != 1:
                fail(f"{label} {kv} {loop}: captures {r['captures']}, "
                     f"decode_compiles {r['compiles']}")
            log(f"{label} {kv} {loop}: {r['tokens_per_s']:.1f} tokens/s, "
                f"p50 {r['p50']:.3f} ms a token, {r['steps']} decode steps,"
                f" decode_compiles 1, captures 0 after warm-up [{card}]")
            del eng
    first = runs[("paged", "sync")]["outs"]
    for key, r in runs.items():
        if r["outs"] != first:
            fail(f"{label}: {key} streams differ from paged sync's")
    # the port's CPU path from the same weights
    cpu = lstm_lm("cpu")
    cpu.set_params_numpy(ff.get_params_numpy())
    t0 = time.perf_counter()
    want = ServingEngine(cpu, n_slots=8,
                         max_decode_len=LSTM_MAX_LEN).generate(
        prompts, max_new_tokens=new)
    cpu_s = time.perf_counter() - t0
    x, g = equal_outside_ties(f"{label} card vs cpu", ff, prompts, want,
                              first)
    log(f"{label}: streams equal on paged / ring, sync / async, and the "
        f"port's CPU path's outside ties (excluded {x}, smallest gap "
        f"{g:.3g}; the CPU generate took {cpu_s:.1f} s) [{card}]")
    del ff, cpu
    torch.cuda.empty_cache()
    return {f"{kv} {loop}": dict(tokens_per_s=r["tokens_per_s"],
                                 p50=r["p50"])
            for (kv, loop), r in runs.items()}


def spans_prompts(vocab: int, seed: int) -> list:
    """SPANS_LENGTHS' prompts, then one sharing the first's SPANS_SHARED
    tokens."""
    prompts = make_prompts(vocab, SPANS_LENGTHS, 0, 0, seed)
    tail = np.random.default_rng(seed + 1000).integers(0, vocab,
                                                       SPANS_PAIR_TAIL)
    return prompts + [prompts[0][:SPANS_SHARED] + tail.tolist()]


def spans_phase(device, card: str, target) -> dict:
    """Gate (c): a traced serve's spans against its ServingStats."""
    import os
    import shutil
    import tempfile

    import torch

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.serving import ServingEngine

    label = "spans gpt2-small fp32"
    vocab, new = ff_vocab(target), E2E_NEW_TOKENS
    prompts, *warm = (spans_prompts(vocab, s)
                      for s in (SEED + 1,) + WARM_SEEDS)
    tmp = tempfile.mkdtemp(prefix="ff_spans_")
    res, err = {}, None
    try:
        for mode in ("untraced", "traced"):
            eng = ServingEngine(target, n_slots=8,
                                max_decode_len=E2E_MAX_DECODE_LEN,
                                prefix_cache="on",
                                prefill_chunk_tokens=SPANS_CHUNK_TOKENS)
            for w in warm:
                eng.generate(w, max_new_tokens=new)
            settle_host()
            obs.disable()
            path = os.path.join(tmp, "trace.json")
            if mode == "traced":
                target.config.trace_file = path
            before = serving_captures(eng)
            fd.reset_launch_count()
            try:
                outs = eng.generate(prompts, max_new_tokens=new)
                torch.cuda.synchronize()
            finally:
                target.config.trace_file = ""
                obs.disable()
            st = eng.stats
            r = res[mode] = dict(
                outs=outs, tokens_per_s=st.tokens_per_s(),
                steps=st.decode_steps, prefills=st.prefills,
                chunks=st.chunked_prefills, hits=st.prefix_hits,
                b5=fd.launch_count("flash_decode"),
                captures=serving_captures(eng) - before)
            if r["b5"] != attention_layers(target) * r["steps"] or \
                    r["captures"] or not r["chunks"] or not r["hits"]:
                fail(f"{label} {mode}: B5 {r['b5']} over {r['steps']} "
                     f"decode steps, captures {r['captures']}, chunks "
                     f"{r['chunks']}, prefix hits {r['hits']}")
            if mode == "traced":
                r["events"] = [e for e in chrome_events(path)
                               if e["name"] in SPANS_FIELDS]
                err = held_decode_err(eng)
            del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    u, t = res["untraced"], res["traced"]
    ev = t["events"]
    count = {n: sum(e["name"] == n for e in ev) for n in SPANS_FIELDS}
    done = sum(e["name"] == "prefill_chunk" and e["args"]["done"]
               for e in ev)
    if t["outs"] != u["outs"]:
        fail(f"{label}: the traced streams differ from the untraced ones")
    if count["prefill"] + done != t["prefills"] or \
            count["prefill_chunk"] != t["chunks"] or \
            count["decode_step"] != t["steps"]:
        fail(f"{label}: spans {count} ({done} chunks done) against "
             f"prefills {t['prefills']}, chunked_prefills {t['chunks']}, "
             f"decode steps {t['steps']}")
    for e in ev:
        if set(e["args"]) != SPANS_FIELDS[e["name"]]:
            fail(f"{label}: {e['name']} fields {sorted(e['args'])}")
    log(f"{label}: spans {count} ({done} of the chunks finish a prefill;"
        f" prefix_cow_clone events {count['prefix_cow_clone']}) "
        f"= prefills {t['prefills']} / chunked_prefills {t['chunks']} / "
        f"decode steps {t['steps']}, with the JAX fields; streams equal "
        f"untraced; prefix hits {t['hits']}; B5 12 a decode step, captures "
        f"0; tokens/s traced {t['tokens_per_s']:.1f} / untraced "
        f"{u['tokens_per_s']:.1f} = {t['tokens_per_s'] / u['tokens_per_s']:.3f}"
        f" [{card}]")
    return dict(b5=u["b5"] + t["b5"], err=err)


def serving13_phase(device, card: str) -> dict:
    """Phase 13 (module doc): speculative decoding, LSTM serving and the
    serving spans."""
    import torch

    from flexflow_tpu_torch.models.gpt2 import GPT2Config

    t0 = time.perf_counter()
    target = build_model(GPT2Config.small(), "fp32", device,
                         E2E_MAX_DECODE_LEN)
    spec = spec_phase(device, card, target)
    spans = spans_phase(device, card, target)
    del target
    torch.cuda.empty_cache()
    lstm = lstm_phase(device, card)
    log(f"phase 13: {time.perf_counter() - t0:.1f} s [{card}]")
    return dict(spec=spec, spans=spans, lstm=lstm)


# ------------------------------------------------------- mesh (phase 14)
# phase 14: strategies on a device mesh. (a) the BERT-Large proxy (bf16,
# Adam) under hybrid_data_tensor_strategy(dp=1, tp=1) on a (1, 1) mesh over
# a real NCCL group of one, synchronous and with --collective-overlap on,
# against the one-device path: the loss and the params after the same
# steps within phase 10's band (BAND_FACTOR times the spread of
# uninterrupted one-device runs of this call); (b) tp = 2 x dp = 2 on the
# one card through torch's threaded process group, a test harness whose
# collectives are copies, never the main path (BERT-Large's widths, depth
# cut to MESH_THREADED_LAYERS); (c) four gloo ranks on the host's CPU, the
# tiny BERT under dp = 2 x tp = 2 against the one-device port. The phase's
# stated wall: MESH_WALL_S.
MESH_STEPS, MESH_WARMUP = 6, 2
MESH_SPREAD_RUNS = 3
MESH_THREADED_LAYERS = 2
MESH_WALL_S = 60.0
# (b): the loss and the grads' relative norm error against the one-device
# port on the card: bf16 B2 sums dQ in no fixed order, and the shards'
# GEMMs sum in another order than the whole one's (the sums that cross
# ranks are fp32, rounded once)
MESH_THREADED_TOL = 2e-2
# (c): fp32 on the CPU, the two sides differ in summation order only
MESH_GLOO_TOL = 1e-5


def flash_heads(heads: list):
    """A context in which every B1 / B2 launch appends the number of heads
    it saw to ``heads`` (the mesh runs' check that the kernels ran on a
    rank's local heads; safe under the threaded ranks)."""
    import contextlib
    import threading

    from flexflow_tpu_torch.kernels import flash_attention as fa

    @contextlib.contextmanager
    def ctx():
        lock = threading.Lock()
        orig = fa._launch_fwd, fa._launch_bwd_kv

        def seen(fn):
            def wrapped(qs, *a, **kw):
                with lock:
                    heads.append(qs.shape[1])
                return fn(qs, *a, **kw)
            return wrapped

        fa._launch_fwd, fa._launch_bwd_kv = seen(orig[0]), seen(orig[1])
        try:
            yield heads
        finally:
            fa._launch_fwd, fa._launch_bwd_kv = orig

    return ctx()


def mesh_run(ff, x, y, snap, measure: bool) -> dict:
    """One fit of ``ff`` over (x, y) from the state ``snap`` (in place, so
    the captured program keeps its tensors): the losses, p50 step ms after
    the warm-up, peak memory above what was allocated before the fit
    (warm-up and capture included; the phase keeps clones of earlier
    runs' params), B1/B2 launches a step, the params after the run, the
    program's captures and (``measure``) one more step (a replay) under
    the profiler with its own peak above the state, and the collectives
    one eager step issues (``CommDebugMode``; on a mesh, the NCCL group's
    backend)."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    for t, v in zip(state_tensors(ff), snap):
        t.copy_(v)
    ff._rng_counter = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_launch_count()
    ff.fit([x], y, epochs=1)
    torch.cuda.synchronize()
    n = len(ff.fit_history.loss)
    res = dict(losses=list(ff.fit_history.loss),
               p50_ms=float(np.median(ff.fit_history.step_s[MESH_WARMUP:]))
               * 1e3,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               totals={k: fa.launch_count(k) for k in
                       ("flash_fwd", "flash_bwd_fused")},
               params=param_list(ff))
    res["counts"] = {k: c // n for k, c in res["totals"].items()}
    if measure:
        from torch.distributed.tensor.debug import CommDebugMode

        b = ff.config.batch_size
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res.update(profiled(lambda: ff.fit([x[:b]], y[:b], epochs=1)))
        res["replay_peak_gb"] = (torch.cuda.max_memory_allocated()
                                 - base) / 2 ** 30
        step = ff.executor.make_train_step(capture=False)
        xs, lab = ff.executor.local_batch([x[:b], ff._prep_label(y[:b])])
        with CommDebugMode() as comm:
            step(ff.params, ff.opt_state,
                 [torch.from_numpy(xs).to(ff.device)],
                 torch.from_numpy(lab).to(ff.device), None)
        torch.cuda.synchronize()
        res["collectives"] = {str(k): int(v) for k, v in
                              comm.get_comm_counts().items()}
        if ff.mesh is not None:
            import torch.distributed as dist

            res["backend"] = str(dist.get_backend(ff.mesh.groups[0]))
    res["captures"] = ff.executor.make_train_step().program.captures
    return res


def mesh_nccl(device, card: str) -> dict:
    """(a): the mesh path at full width over NCCL, world size 1."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy

    tmp = tempfile.mkdtemp(prefix="ff_mesh_")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        ff, cfg = train_model("bert", "bf16", device)
        ff.config.print_freq = 10 ** 9
        x, y = train_data("bert", cfg,
                          cfg.batch_size * (MESH_WARMUP + MESH_STEPS))
        init = param_list(ff)
        snap = [t.clone() for t in state_tensors(ff)]
        plain = [mesh_run(ff, x, y, snap, measure=i == 0)
                 for i in range(MESH_SPREAD_RUNS)]
        del ff, snap
        torch.cuda.empty_cache()
        ff, _ = train_model(
            "bert", "bf16", device, strategy_fn=lambda pcg:
            hybrid_data_tensor_strategy(pcg, dp=1, tp=1))
        ff.config.print_freq = 10 ** 9
        if ff.mesh is None or tuple(ff.mesh.sizes) != (1, 1):
            fail("mesh bert: compile under hybrid(1, 1) built no (1, 1) "
                 "mesh")
        if not all(torch.equal(a, b) for a, b in zip(param_list(ff), init)):
            fail("mesh bert: the mesh path's initial weights differ from "
                 "the one-device path's (same seed)")
        snap = [t.clone() for t in state_tensors(ff)]
        runs = {"sync": mesh_run(ff, x, y, snap, measure=True)}
        ff.config.collective_overlap = "on"
        ff.executor.invalidate_jit_cache()
        runs["overlap"] = mesh_run(ff, x, y, snap, measure=True)
        del ff, snap
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    finals = [r["params"] for r in plain]
    spread = max(pair_diffs(finals, init))
    band = band_of(spread)
    loss_spread = max(abs(a - b) for i, r in enumerate(plain)
                      for q in plain[i + 1:]
                      for a, b in zip(r["losses"], q["losses"]))
    top = max(abs(v) for v in plain[0]["losses"])
    loss_band = BAND_FACTOR * max(loss_spread, BAND_FLOOR * top)
    p = plain[0]
    log(f"mesh bert plain: p50 {p['p50_ms']:.3f} ms over {MESH_STEPS} "
        f"steps after {MESH_WARMUP}, idle share "
        f"{1 - p['busy_ms'] / p['p50_ms']:.4f}, host launch calls "
        f"{p['kernel_launch_calls']} kernel / {p['graph_launch_calls']} "
        f"graph, peak {p['peak_gb']:.3f} GiB above the state; "
        f"{MESH_SPREAD_RUNS} runs: "
        f"spread {spread:.3g} of the params' change, band {band:.3g}; "
        f"loss spread {loss_spread:.3g}, band {loss_band:.3g} [{card}]")
    res = dict(plain=p, band=band, spread=spread)
    for name, r in runs.items():
        dparams = update_rel(r["params"], finals[0], init)
        dloss = max(abs(a - b) for a, b in zip(r["losses"], p["losses"]))
        log(f"mesh bert nccl {name} (hybrid dp=1 tp=1, mesh (1, 1)): p50 "
            f"{r['p50_ms']:.3f} ms (plain {p['p50_ms']:.3f}), idle share "
            f"{1 - r['busy_ms'] / r['p50_ms']:.4f}, host launch calls "
            f"{r['kernel_launch_calls']} kernel / {r['graph_launch_calls']}"
            f" graph, peak {r['peak_gb']:.3f} GiB above the state over "
            f"the fit (plain {p['peak_gb']:.3f}), {r['replay_peak_gb']:.3f} "
            f"GiB a replay (plain {p['replay_peak_gb']:.3f}), captures "
            f"{r['captures']}, flash launches a step {r['counts']}; an eager "
            f"step's collectives {r['collectives']} on {r['backend']}, NCCL "
            f"kernels in the profiled replay {r['nccl_kernels']} (a "
            f"one-rank in-place sum runs none); vs plain after "
            f"{len(r['losses'])} steps: params {dparams:.3g} (band "
            f"{band:.3g}), loss {dloss:.3g} (band {loss_band:.3g}) "
            f"[{card}]")
        if r["counts"] != {"flash_fwd": 24, "flash_bwd_fused": 24}:
            fail(f"mesh bert {name}: flash launches a step {r['counts']}, "
                 "want 24 B1 + 24 B2")
        if r["captures"] != 1:
            fail(f"mesh bert {name}: {r['captures']} captures, want 1 (no "
                 "capture after warm-up)")
        if r["backend"] != "nccl" or \
                r["collectives"].get("c10d.allreduce_", 0) < 1:
            fail(f"mesh bert {name}: the step issued no NCCL all-reduce "
                 f"({r['collectives']} on {r['backend']})")
        if not (dparams <= band and dloss <= loss_band):
            fail(f"mesh bert {name}: outside the band of the plain path")
        res[name] = dict(r, dparams=dparams, dloss=dloss)
        del res[name]["params"]
    del res["plain"]["params"]
    return res


def mesh_threaded(device, card: str) -> dict:
    """(b): tp = 2 x dp = 2, four ranks as threads on the one card, one
    train step against the one-device port on the same weights and batch;
    every B1 / B2 launch must see the rank's 8 local heads."""
    import threading

    import torch
    import torch.distributed as dist
    import torch.testing._internal.distributed.multi_threaded_pg as mtpg

    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy

    t0 = time.perf_counter()
    ref, cfg = train_model("bert", "bf16", device,
                           num_layers=MESH_THREADED_LAYERS)
    x, y = train_data("bert", cfg, cfg.batch_size)
    weights = ref.get_params_numpy()
    lab = torch.from_numpy(ref._prep_label(y)).to(device)
    loss, _l, grads = ref.executor.loss_and_grads(
        ref.params, [torch.from_numpy(x).to(device)], lab)
    want = (float(loss), [g for ws in grads.values() for g in ws.values()])
    del ref, grads
    heads = []
    mtpg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    out, errs = {}, []
    card_index = torch.cuda.current_device()

    def rank(r):
        try:
            torch.cuda.set_device(card_index)
            dist.init_process_group("threaded", rank=r, world_size=4,
                                    store=store)
            ff, _ = train_model(
                "bert", "bf16", device, num_layers=MESH_THREADED_LAYERS,
                strategy_fn=lambda pcg: hybrid_data_tensor_strategy(
                    pcg, dp=2, tp=2))
            ff.set_params_numpy(weights)
            ex = ff.executor
            xs, ys = ex.local_batch([x, ff._prep_label(y)])
            loss, _l, grads = ex.loss_and_grads(
                ff.params, [torch.from_numpy(xs).to(device)],
                torch.from_numpy(ys).to(device))
            full = [ex.gather_param(n, w, g) for n, ws in grads.items()
                    for w, g in ws.items()]
            torch.cuda.synchronize()
            out[r] = (float(loss), full)
        except BaseException as e:  # reaches the phase, which fails
            errs.append(f"rank {r}: {e!r}")
            raise

    try:
        with flash_heads(heads):
            threads = [threading.Thread(target=rank, args=(r,))
                       for r in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errs or len(out) != 4:
        fail(f"mesh threaded: {errs or 'a rank did not finish'}")
    launches = len(heads)
    losses = [out[r][0] for r in range(4)]
    dloss = max(abs(v - want[0]) / max(abs(want[0]), 1e-30) for v in losses)
    derr = max(rel_norm(out[r][1], want[1]) for r in range(4))
    wall = time.perf_counter() - t0
    log(f"mesh threaded bert (BERT-Large widths, {MESH_THREADED_LAYERS} "
        f"layers, hybrid dp=2 tp=2, 4 ranks as threads on one card; a "
        f"harness, its times are not multi-GPU speed): loss {losses[0]:.6f}"
        f" vs one device {want[0]:.6f} (rel {dloss:.3g}), grads rel norm "
        f"err {derr:.3g} (tol {MESH_THREADED_TOL}); {launches} B1/B2 "
        f"launches, local heads {sorted(set(heads))}; {wall:.1f} s "
        f"[{card}]")
    if set(heads) != {8} or launches != 4 * MESH_THREADED_LAYERS * 2:
        fail(f"mesh threaded: B1/B2 launches saw heads {set(heads)} "
             f"({launches} launches), want 8 local heads in each of "
             f"{4 * MESH_THREADED_LAYERS * 2}")
    if not (dloss <= MESH_THREADED_TOL and derr <= MESH_THREADED_TOL):
        fail("mesh threaded: tp=2 x dp=2 step disagrees with one device")
    return dict(launches=launches, dloss=dloss, grad_err=derr)


def gloo_model(strategy_fn=None):
    """(c): the tiny BERT proxy on the CPU, fp32, Adam."""
    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    LossType)
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    config = FFConfig()
    config.batch_size, config.seed = 8, SEED
    ff = FFModel(config, device="cpu")
    build_bert(ff, BertConfig.tiny(batch_size=8))
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-3),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=strategy_fn)
    return ff


def gloo_step(ff, x, y) -> dict:
    """One train step's loss, full grads and full params after it."""
    import torch

    ex = ff.executor
    xs, ys = ex.local_batch([x, ff._prep_label(y)])
    loss, _l, grads = ex.loss_and_grads(ff.params, [torch.from_numpy(xs)],
                                        torch.from_numpy(ys))
    out = {f"g/{n}/{w}": ex.gather_param(n, w, g).numpy().copy()
           for n, ws in grads.items() for w, g in ws.items()}
    ff.params, ff.opt_state = ff.optimizer.update(ff.params, grads,
                                                  ff.opt_state)
    out.update({f"p/{n}/{w}": a for n, ws in ff.get_params_numpy().items()
                for w, a in ws.items()})
    out["loss"] = np.float64(float(loss))
    return out


def _gloo_rank(rank: int, world: int, root: str) -> None:
    """A spawned rank of (c) (a process of its own, on the CPU)."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        io = dict(np.load(os.path.join(root, "in.npz")))
        ff = gloo_model(lambda pcg: hybrid_data_tensor_strategy(pcg, dp=2,
                                                                tp=2))
        ff.set_params_numpy({n: {w: io[f"w/{n}/{w}"] for w in ws}
                             for n, ws in ff.get_params_numpy().items()})
        np.savez(os.path.join(root, f"out_{rank}.npz"),
                 **gloo_step(ff, io["x"], io["y"]))
    finally:
        dist.destroy_process_group()


def mesh_gloo(card: str) -> dict:
    """(c): four gloo ranks spawned on the host's CPU, one step of the
    tiny BERT under hybrid dp = 2 x tp = 2 against the one-device port."""
    import multiprocessing as mp
    import shutil
    import tempfile

    import torch

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_gloo_")
    try:
        ref = gloo_model()
        rng = np.random.default_rng(SEED)
        x = rng.standard_normal((8, 16, 64)).astype(np.float32)
        y = rng.integers(0, 2, (8, 1)).astype(np.int32)
        np.savez(os.path.join(root, "in.npz"), x=x, y=y,
                 **{f"w/{n}/{w}": a for n, ws in
                    ref.get_params_numpy().items() for w, a in ws.items()})
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_gloo_rank, args=(r, 4, root))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0, 0, 0]:
            fail(f"mesh gloo: rank exit codes {codes}")
        want = gloo_step(ref, x, y)
        err = 0.0
        for r in range(4):
            got = dict(np.load(os.path.join(root, f"out_{r}.npz")))
            err = max(err, max(float(np.abs(got[k] - want[k]).max())
                               for k in want))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"mesh gloo (4 CPU ranks, tiny BERT, hybrid dp=2 tp=2, torch "
        f"{torch.__version__}): loss, grads and params after one Adam step "
        f"vs one device: max abs err {err:.3g} (tol {MESH_GLOO_TOL}); "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    if not err <= MESH_GLOO_TOL:
        fail("mesh gloo: dp=2 x tp=2 disagrees with one device")
    return dict(err=err)


def mesh_kernels(device, card: str) -> dict:
    """B1-B4 on shards: with dropout 0.1, a call on a rank's (batch,
    head) block with its offsets gives the unsharded call's output and
    grads at that block (so the same mask), and the same block without
    offsets does not. Then B1-B4 timed at the tp = 2 shard shape."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    shape = FA_SHAPES["bert"]
    q, k, v, do = fa_inputs(shape, torch.bfloat16, device)
    rate, seed, blk = 0.1, 0x5EED, 128
    o, lse = fa._flash_forward(q, k, v, False, blk, blk, rate, seed)
    full = {f: fa._flash_backward(q, k, v, o, lse, do, False, blk, blk,
                                  rate, seed, fused=f) for f in (True, False)}
    _out_tol, grad_tol = FA_TOL["bf16"]
    worst = 0.0
    for b0, b1, h0, h1 in ((0, 8, 8, 16), (4, 8, 0, 16), (4, 8, 8, 16)):
        sl = (slice(b0, b1), slice(h0, h1))
        qs, ks, vs, ds = (t[sl].contiguous() for t in (q, k, v, do))
        shard = (b0, h0, shape["h"])
        so, slse = fa._flash_forward(qs, ks, vs, False, blk, blk, rate,
                                     seed, shard)
        bare, _ = fa._flash_forward(qs, ks, vs, False, blk, blk, rate, seed)
        errs = [abs_err(so, o[sl]), abs_err(slse, lse[sl])]
        for fused, grads in full.items():
            got = fa._flash_backward(qs, ks, vs, so, slse, ds, False, blk,
                                     blk, rate, seed, fused=fused,
                                     shard=shard)
            errs += [rel_err(g, w[sl]) for g, w in zip(got, grads)]
        worst = max(worst, *errs)
        if not (errs[0] == 0.0 and errs[1] == 0.0
                and max(errs[2:]) <= grad_tol):
            fail(f"kernel flash shard b{b0}:{b1} h{h0}:{h1}: the sharded "
                 f"call differs from the unsharded one's block: {errs}")
        if abs_err(bare, o[sl]) == 0.0:
            fail("kernel flash shard: the block without its offsets draws "
                 "the same mask (the check cannot see a wrong offset)")
    torch.cuda.synchronize()
    log(f"kernel flash shard (bf16 b8 h16 s512 d64, dropout 0.1): B1 output "
        f"and lse of a tp, a dp and a dp x tp rank's block bitwise the "
        f"unsharded call's, B2 and B3+B4 grads within {grad_tol} (max "
        f"{worst:.3g}) [{card}]")
    return fa_case(device, card, "bert_tp2", "bf16")


def mesh_phase(device, card: str) -> dict:
    t0 = time.perf_counter()
    gloo = mesh_gloo(card)
    threaded = mesh_threaded(device, card)
    kern = mesh_kernels(device, card)
    nccl = mesh_nccl(device, card)
    wall = time.perf_counter() - t0
    log(f"mesh phase wall {wall:.1f} s (stated {MESH_WALL_S:.0f} s) "
        f"[{card}]")
    return dict(gloo=gloo, threaded=threaded, kern=kern, nccl=nccl)


# --------------------------------------------------- pipeline (phase 15)
# phase 15: pipeline parallelism. (a) the BERT-Large proxy at full width in
# fp32 (a pipeline stage runs in its params' dtype whatever the compute
# dtype, as the JAX package's stages do), Adam 1e-4, as four ranks in
# threads on the one card through a harness group (torch's threaded test
# group with point-to-point added as copies between threads, never the
# main path): pp 4 x dp 1 with PIPE_MICRO microbatches under gpipe, 1f1b
# and interleaved (v 2), then pp 2 x dp 2 under 1f1b, each PIPE_STEPS
# steps through ``PipelineTrainer``; the losses and the params after them
# within phase 10's band of PIPE_SPREAD_RUNS uninterrupted one-device runs
# of the same batches, and each rank's B1 / B2 launches the count its
# chunks' attention layers, the microbatches and stage remat ``full``
# give (B1 twice a microbatch and layer: the forward and its recompute);
# (b) four gloo ranks on the host's CPU, the tiny BERT under pp 2 x dp 2,
# the three schedules' losses and params bitwise equal. The phase's stated
# wall: PIPE_WALL_S.
PIPE_STEPS = 2
PIPE_SPREAD_RUNS = 3
PIPE_MICRO = 4
PIPE_WALL_S = 90.0
# (schedule, pp, dp, virtual stages)
PIPE_RUNS = (("gpipe", 4, 1, 1), ("1f1b", 4, 1, 1), ("interleaved", 4, 1, 2),
             ("1f1b", 2, 2, 1))
# the run phase 16 (d) repeats with captured stages
PIPE_CAPTURED = ("1f1b", 4, 1, 1)
_P2P_BACKEND = []


def threaded_p2p_backend() -> str:
    """The harness's backend name, registered once: torch's threaded test
    group (``multi_threaded_pg``: collectives as copies between the threads
    of one process) with ``send`` / ``recv`` added: a send leaves a copy in
    the (group, src, dst) mailbox, a receive takes the oldest one, or
    waits for it through a future. FIFO a pair and direction, as NCCL and
    gloo match. Several ranks on one card only; never the main path."""
    if _P2P_BACKEND:
        return _P2P_BACKEND[0]
    import collections
    import threading

    import torch.distributed as dist
    import torch.testing._internal.distributed.multi_threaded_pg as mtpg
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.distributed.distributed_c10d import _store_based_barrier
    from torch.futures import Future

    lock = threading.Lock()
    boxes = collections.defaultdict(collections.deque)
    waiting = collections.defaultdict(collections.deque)

    class P2PGroup(mtpg.ProcessLocalGroup):
        def send(self, tensors, dst, tag=0):
            (t,) = tensors
            key = (self.pg_name, self._rank, int(dst))
            msg = t.detach().clone()
            with lock:
                w = waiting[key].popleft() if waiting[key] else None
                if w is None:
                    boxes[key].append(msg)
            if w is not None:
                w[0].copy_(msg)
                w[1].set_result([w[0]])
            return mtpg.ret_work(tensors)

        def recv(self, tensors, src, tag=0):
            (buf,) = tensors
            key = (self.pg_name, int(src), self._rank)
            fut = Future()
            with lock:
                msg = boxes[key].popleft() if boxes[key] else None
                if msg is None:
                    waiting[key].append((buf, fut))
            if msg is not None:
                buf.copy_(msg)
                fut.set_result([buf])
            return _create_work_from_future(fut)

    def create(prefix_store, rank, world_size, timeout):
        pg = P2PGroup(rank, world_size)
        _store_based_barrier(rank, prefix_store, "", world_size, timeout)
        return pg

    dist.Backend.register_backend("threaded_p2p", create,
                                  devices=["cpu", "cuda"])
    _P2P_BACKEND.append("threaded_p2p")
    return "threaded_p2p"


def pipe_cfg(layers: int = 0, tiny: bool = False):
    """The proxy's config: BERT-Large (depth cut to ``layers``) or tiny."""
    from flexflow_tpu_torch.models.bert import BertConfig

    cfg = BertConfig.tiny(batch_size=8) if tiny else BertConfig.large()
    if layers:
        cfg.num_layers = layers
    return cfg


def pipe_bert(device, layers: int = 0, tiny: bool = False):
    """The proxy's graph (uncompiled: ``PipelineTrainer`` takes it as it
    is) and its config."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.models.bert import build_bert

    cfg = pipe_cfg(layers, tiny)
    config = FFConfig()
    config.batch_size, config.seed = cfg.batch_size, SEED
    ff = FFModel(config, device=device)
    build_bert(ff, cfg)
    return ff, cfg


def pipe_launch_counter(per_rank: dict):
    """A context in which every B1 / B2 launch adds one to
    ``per_rank[(thread name, kernel)]`` (threads name their rank)."""
    import contextlib
    import threading

    from flexflow_tpu_torch.kernels import flash_attention as fa

    @contextlib.contextmanager
    def ctx():
        lock = threading.Lock()
        orig = fa._launch_fwd, fa._launch_bwd_kv

        def counted(fn, kernel):
            def wrapped(*a, **kw):
                key = (threading.current_thread().name, kernel)
                with lock:
                    per_rank[key] = per_rank.get(key, 0) + 1
                return fn(*a, **kw)
            return wrapped

        fa._launch_fwd = counted(orig[0], "flash_fwd")
        fa._launch_bwd_kv = counted(orig[1], "flash_bwd_fused")
        try:
            yield
        finally:
            fa._launch_fwd, fa._launch_bwd_kv = orig

    return ctx()


def pipe_reference(device, cfg, x, y, layers: int, tiny: bool):
    """PIPE_SPREAD_RUNS uninterrupted one-device fits (``FFModel.fit``,
    Adam 1e-4, fp32, no shuffle) from the seed's weights over (x, y): the
    weights, the initial and final params by name, the losses."""
    import torch

    from flexflow_tpu_torch import AdamOptimizer, LossType

    ff, _ = pipe_bert(device, layers, tiny)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    names = [(n, w) for n, ws in ff.params.items() for w in ws]
    weights = {n: {w: t.detach().clone() for w, t in ws.items()}
               for n, ws in ff.params.items()}
    snap = [t.clone() for t in state_tensors(ff)]
    finals, losses = [], []
    for _ in range(PIPE_SPREAD_RUNS):
        for t, v in zip(state_tensors(ff), snap):
            t.copy_(v)
        ff._rng_counter = 0
        ff.fit([x], y, epochs=1, shuffle=False)
        finals.append(dict(zip(names, param_list(ff))))
        losses.append(list(ff.fit_history.loss))
    del ff, snap
    if device.type == "cuda":
        torch.cuda.empty_cache()
    init = {(n, w): t for n, ws in weights.items() for w, t in ws.items()}
    return weights, init, finals, losses


def pipe_run(device, weights, x, y, sched: str, pp: int, dp: int, v: int,
             layers: int, tiny: bool, capture: bool = False,
             steps: int = PIPE_STEPS) -> dict:
    """One pipeline run on four ranks as threads: each builds the graph,
    a ``PipelineTrainer`` on the (pp, dp) grid loaded with ``weights`` and
    takes ``steps`` steps; per rank its losses, its chunks' params by name
    (data index 0) after PIPE_STEPS steps, its attention layers, and its
    B1 / B2 launches. ``capture``: the stages' step programs are
    captured (phase 16), else run uncaptured (phase 15); the programs'
    captures after each step."""
    import threading

    import torch
    import torch.distributed as dist
    import torch.testing._internal.distributed.multi_threaded_pg as mtpg

    from flexflow_tpu_torch import AdamOptimizer, OperatorType
    from flexflow_tpu_torch.parallel.pipeline import PipelineTrainer

    backend = threaded_p2p_backend()
    cuda = device.type == "cuda"
    card_index = torch.cuda.current_device() if cuda else None
    b = 8
    per_rank, out, errs = {}, {}, []
    mtpg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()

    def rank(r):
        try:
            if cuda:
                torch.cuda.set_device(card_index)
            dist.init_process_group(backend, rank=r, world_size=4,
                                    store=store)
            ff, _ = pipe_bert(device, layers, tiny)
            tr = PipelineTrainer(ff, pp=pp, dp=dp, n_micro=PIPE_MICRO,
                                 optimizer=AdamOptimizer(ff, alpha=1e-4),
                                 schedule=sched, virtual_stages=v,
                                 init_params=False, capture=capture)
            tr.load_params(weights)
            t0 = time.perf_counter()
            losses, captures, params = [], [], {}
            d, j = tr.grid.coord
            for i in range(steps):
                k = i % PIPE_STEPS
                losses.append(tr.train_step([x[k * b:(k + 1) * b]],
                                            y[k * b:(k + 1) * b],
                                            rng_seed=i))
                captures.append(tr.captures)
                if i == PIPE_STEPS - 1 and not j:
                    params = {(n, w): t.detach().clone() for c in tr._mine
                              for n, ws in tr.params[c].items()
                              for w, t in ws.items()}
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            att = sum(1 for c in tr._mine
                      for node in tr.specs[c].sub_pcg.compute_nodes()
                      if node.op.op_type ==
                      OperatorType.OP_MULTIHEAD_ATTENTION)
            out[r] = dict(losses=losses, params=params, att=att, wall=wall,
                          chunks=list(tr._mine), remat=tr.remat,
                          captures=captures)
        except BaseException as e:  # reaches the phase, which fails
            errs.append(f"rank {r}: {e!r}")
            raise

    try:
        with pipe_launch_counter(per_rank):
            threads = [threading.Thread(target=rank, args=(r,),
                                        name=f"rank{r}") for r in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errs or len(out) != 4:
        fail(f"pipeline {sched} pp={pp} dp={dp}: "
             f"{errs or 'a rank did not finish'}")
    for r in range(4):
        out[r]["launches"] = {k: per_rank.get((f"rank{r}", k), 0)
                              for k in ("flash_fwd", "flash_bwd_fused")}
    return out


def pipe_threaded(device, card: str, layers: int = 0,
                  tiny: bool = False) -> dict:
    """(a): the one-device band, then every run of PIPE_RUNS against it."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    cfg = pipe_cfg(layers, tiny)
    x, y = train_data("bert", cfg, cfg.batch_size * PIPE_STEPS)
    weights, init, finals, ref_losses = pipe_reference(device, cfg, x, y,
                                                       layers, tiny)
    names = list(init)

    def as_list(named):
        return [named[k] for k in names]

    spread = max(pair_diffs([as_list(f) for f in finals], as_list(init)))
    band = band_of(spread)
    loss_spread = max(abs(a - b) for i, r in enumerate(ref_losses)
                      for q in ref_losses[i + 1:] for a, b in zip(r, q))
    top = max(abs(v) for v in ref_losses[0])
    loss_band = BAND_FACTOR * max(loss_spread, BAND_FLOOR * top)
    log(f"pipeline bert (BERT-Large {cfg.num_layers} layers, fp32, batch "
        f"{cfg.batch_size}, Adam 1e-4) one device: {PIPE_SPREAD_RUNS} runs "
        f"of {PIPE_STEPS} steps, spread {spread:.3g} of the params' change, "
        f"band {band:.3g}; loss spread {loss_spread:.3g}, band "
        f"{loss_band:.3g} [{card}]")
    fa.reset_launch_count()
    runs = {}
    for sched, pp, dp, v in PIPE_RUNS:
        label = f"{sched}{f'(v={v})' if v > 1 else ''} pp={pp} dp={dp}"
        out = pipe_run(device, weights, x, y, sched, pp, dp, v, layers,
                       tiny)
        got = {}
        for r in range(4):
            got.update(out[r]["params"])
        if set(got) != set(names):
            fail(f"pipeline {label}: the ranks' chunks hold "
                 f"{len(got)} of {len(names)} params")
        dparams = update_rel(as_list(got), as_list(finals[0]),
                             as_list(init))
        losses = out[0]["losses"]
        if any(out[r]["losses"] != losses for r in range(4)):
            fail(f"pipeline {label}: the ranks' losses differ")
        dloss = max(abs(a - b) for a, b in zip(losses, ref_losses[0]))
        bad = []
        for r in range(4):
            att, got_l = out[r]["att"], out[r]["launches"]
            # stage remat full: B1 in the forward and in its recompute
            want = {"flash_fwd": 2 * att * PIPE_MICRO * PIPE_STEPS,
                    "flash_bwd_fused": att * PIPE_MICRO * PIPE_STEPS}
            if cuda and got_l != want:
                bad.append(f"rank {r}: {got_l}, want {want}")
        wall = max(out[r]["wall"] for r in range(4))
        log(f"pipeline {label} (4 ranks as threads on one card; a "
            f"harness, its times are not multi-GPU speed): losses "
            f"{[round(v, 6) for v in losses]} vs one device "
            f"{[round(v, 6) for v in ref_losses[0]]} (diff {dloss:.3g}, "
            f"band {loss_band:.3g}), params {dparams:.3g} (band "
            f"{band:.3g}); chunks {[out[r]['chunks'] for r in range(4)]}, "
            f"B1/B2 a rank {[tuple(out[r]['launches'].values()) for r in range(4)]}"
            f" over {PIPE_STEPS} steps x {PIPE_MICRO} microbatches, stage "
            f"remat {out[0]['remat']}; {wall:.2f} s for {PIPE_STEPS} steps "
            f"[{card}]")
        if bad:
            fail(f"pipeline {label}: B1/B2 launches {bad}")
        if not (dparams <= band and dloss <= loss_band):
            fail(f"pipeline {label}: outside the band of the one-device "
                 "runs")
        runs[label] = dict(dparams=dparams, dloss=dloss, wall=wall,
                           launches=[out[r]["launches"] for r in range(4)])
        if (sched, pp, dp, v) == PIPE_CAPTURED:
            # phase 16 (d) holds its captured stages against these
            runs[label].update(params=got, losses=losses)
    totals = {k: fa.launch_count(k) for k in ("flash_fwd", "flash_bwd_fused")}
    counted = {k: sum(r["launches"][i][k] for r in runs.values()
                      for i in range(4)) for k in totals}
    if cuda and (totals != counted or not all(totals.values())):
        fail(f"pipeline: launch counts {totals} against the ranks' "
             f"{counted}")
    if cuda:
        torch.cuda.empty_cache()
    log(f"pipeline threaded: {time.perf_counter() - t0:.1f} s, B1/B2 "
        f"launches over the runs {totals} [{card}]")
    return dict(runs=runs, totals=totals, band=band, loss_band=loss_band,
                weights=weights, init=init, names=names, x=x, y=y)


def _pipe_gloo_rank(rank: int, world: int, root: str) -> None:
    """A spawned rank of (b): the tiny BERT at pp 2 x dp 2 under each
    schedule, two steps from the seed's weights."""
    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch import AdamOptimizer
    from flexflow_tpu_torch.parallel.pipeline import PipelineTrainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/pg",
                            rank=rank, world_size=world)
    try:
        io = dict(np.load(os.path.join(root, "in.npz")))
        out = {}
        for sched, v in (("gpipe", 1), ("1f1b", 1), ("interleaved", 2)):
            ff, _ = pipe_bert(torch.device("cpu"), tiny=True)
            tr = PipelineTrainer(ff, pp=2, dp=2, n_micro=PIPE_MICRO,
                                 optimizer=AdamOptimizer(ff, alpha=1e-3),
                                 schedule=sched, virtual_stages=v)
            for i in range(2):
                out[f"{sched}/loss{i}"] = np.float64(tr.train_step(
                    [io["x"]], io["y"], rng_seed=i))
            out.update({f"{sched}/{n}/{w}": a for n, ws in
                        tr.export_params().items() for w, a in ws.items()})
        np.savez(os.path.join(root, f"out_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def pipe_gloo_start():
    """(b): four gloo ranks spawned on the host's CPU, left running (the
    phase's card work goes on meanwhile); :func:`pipe_gloo` joins them."""
    import multiprocessing as mp
    import tempfile

    root = tempfile.mkdtemp(prefix="ff_pipe_gloo_")
    rng = np.random.default_rng(SEED)
    np.savez(os.path.join(root, "in.npz"),
             x=rng.standard_normal((8, 16, 64)).astype(np.float32),
             y=rng.integers(0, 2, (8, 1)).astype(np.int32))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pipe_gloo_rank, args=(r, 4, root),
                         daemon=True) for r in range(4)]
    for p in procs:
        p.start()
    return procs, root, time.perf_counter()


def pipe_gloo(card: str, started) -> dict:
    """(b): the ranks of :func:`pipe_gloo_start` joined and compared."""
    import shutil

    import torch

    procs, root, t0 = started
    try:
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0, 0, 0, 0]:
            fail(f"pipeline gloo: rank exit codes {codes}")
        outs = [dict(np.load(os.path.join(root, f"out_{r}.npz")))
                for r in range(4)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    unequal = [(r, k) for r, o in enumerate(outs) for k in o
               if not k.startswith("gpipe/") and not np.array_equal(
                   o[k], o["gpipe/" + k.split("/", 1)[1]])]
    same_ranks = all(np.array_equal(o[k], outs[0][k]) for o in outs[1:]
                     for k in outs[0])
    losses = [float(outs[0][f"gpipe/loss{i}"]) for i in range(2)]
    log(f"pipeline gloo (4 CPU ranks, tiny BERT, pp=2 dp=2, {PIPE_MICRO} "
        f"microbatches, Adam, torch {torch.__version__}): gpipe, 1f1b and "
        f"interleaved(v=2) losses {[round(v, 6) for v in losses]}, "
        f"{len(unequal)} values not bitwise the gpipe run's, every rank "
        f"the same: {same_ranks}; {time.perf_counter() - t0:.1f} s beside "
        f"the card's runs [{card}]")
    if unequal or not same_ranks:
        fail(f"pipeline gloo: schedules or ranks disagree ({unequal[:4]})")
    return dict(losses=losses)


def pipeline_phase(device, card: str) -> dict:
    t0 = time.perf_counter()
    started = pipe_gloo_start()
    try:
        threaded = pipe_threaded(device, card)
        kern = fa_case(device, card, "bert_micro", "fp32")
    except BaseException:
        for p in started[0]:
            p.kill()
        raise
    gloo = pipe_gloo(card, started)
    wall = time.perf_counter() - t0
    log(f"pipeline phase wall {wall:.1f} s (stated {PIPE_WALL_S:.0f} s) "
        f"[{card}]")
    return dict(gloo=gloo, threaded=threaded, kern=kern)


# ------------------------------------------- A.5's third part (phase 16)
# phase 16: what the mesh and pipeline paths once refused. (a) resilience
# on threaded dp 2 ranks (the BERT-Large proxy, bf16, Adam, widths full
# and depth cut to MESH16_LAYERS, torch's threaded test group, a harness):
# with
# --checkpoint-dir, --checkpoint-every MESH16_EVERY and --max-bad-steps 1,
# a NaN on rank 0's chaos plan alone is skipped on both ranks and rolled
# back once, and a preemption on rank 1's plan alone stops both after the
# same step; the NaN run and the resumed one end within phase 10's band of
# MESH16_SPREAD_RUNS uninterrupted runs; the sharded checkpoint's bytes per
# rank and save seconds; (b) every weight of two or more dims split over
# the data axis (ZeRO-3 / FSDP) on the same threaded dp 2: a rank's stored
# bytes against plain dp 2's, the params in the band, B1 / B2 counted on
# their b4 shard (held against their plain versions there), then the same
# strategy on a (1,) NCCL mesh of one card, where the step and its
# collectives are captured once; (c) --fusion on the (1, 1) NCCL mesh
# under hybrid(dp=1, tp=1): its regions, the flash launches of the
# unfused run, the params in the band; (d) phase 15's fp32 1f1b pp 4 with
# the stages' step programs: captures, none after the warm-up, params
# within phase 15's band of the eager run, B1 / B2 counted inside the
# replays. The phase's stated wall: MESH16_WALL_S.
MESH16_LAYERS = 2
MESH16_STEPS = 8
MESH16_EVERY = 4
MESH16_SPREAD_RUNS = 3
MESH16_NAN_STEP = 6
MESH16_PREEMPT_STEP = 5
MESH16_WALL_S = 90.0
# (d): a third step after the band's two, in which nothing may capture
PIPE16_STEPS = PIPE_STEPS + 1
FA_SHAPES["bert_dp2"] = dict(b=4, h=16, sq=512, sk=512, d=64, causal=False)


def fsdp16_strategy(dp: int):
    """strategy_fn: data parallelism at ``dp`` with every weight of two or
    more dims whose first dim ``dp`` divides split over the data axis on
    it (biases and norms replicated)."""
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    def fn(pcg):
        s = data_parallel_strategy(pcg, dp)
        for node in pcg.compute_nodes():
            ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
            for w, (shape, _d, _i) in node.op.weight_specs(ins).items():
                if len(shape) >= 2 and shape[0] % dp == 0:
                    s.for_node(node.guid).weight_specs[w] = \
                        ("data",) + (None,) * (len(shape) - 1)
        return s
    return fn


def threaded_ranks(world: int, body, label: str) -> dict:
    """``body(rank)`` on ``world`` threads named ``rank<r>`` of torch's
    threaded test group on the one card (a harness: its collectives are
    copies between threads, never captured); {rank: result}."""
    import threading

    import torch
    import torch.distributed as dist
    import torch.testing._internal.distributed.multi_threaded_pg as mtpg

    card_index = torch.cuda.current_device()
    mtpg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    out, errs = {}, []

    def rank(r):
        try:
            torch.cuda.set_device(card_index)
            dist.init_process_group("threaded", rank=r, world_size=world,
                                    store=store)
            out[r] = body(r)
            torch.cuda.synchronize()
        except BaseException as e:  # reaches the phase, which fails
            errs.append(f"rank {r}: {e!r}")
            raise

    try:
        threads = [threading.Thread(target=rank, args=(r,), name=f"rank{r}")
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        mtpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errs or len(out) != world:
        fail(f"{label}: {errs or 'a rank did not finish'}")
    return out


def mesh16_fit(device, weights, x, y, strategy_fn, label: str,
               ckpt: str = "", chaos=None, resume: bool = False,
               layers: int = MESH16_LAYERS) -> dict:
    """One fit of the proxy on threaded dp 2 ranks from ``weights``
    (eager steps: the harness's collectives cannot be captured): per rank
    the params after it (whole), its stored bytes (params and optimizer
    state), its preemption step, the session's counters and the sharded
    checkpoint saves (step, bytes, seconds)."""
    import torch

    from flexflow_tpu_torch.execution.graphs import _tensors_of
    from flexflow_tpu_torch.resilience import ChaosPlan

    def body(r):
        ff, _ = train_model("bert", "bf16", device, num_layers=layers,
                            strategy_fn=strategy_fn)
        ff._capture_steps = False
        ff.config.print_freq = 10 ** 9
        if ckpt:
            ff.config.checkpoint_dir = ckpt
            ff.config.checkpoint_every = MESH16_EVERY
            ff.config.max_bad_steps = 1
            ff.config.resume = "auto" if resume else ""
        ff.set_params_numpy(weights)
        plan = (chaos or {}).get(r)
        ff.fit([x], y, epochs=1, shuffle=False,
               chaos=ChaosPlan(**plan) if plan is not None else None)
        session = ff.resilience
        full = ff.get_params_numpy()
        return dict(
            params=[torch.from_numpy(full[n][w]) for n, ws in
                    ff.params.items() for w in ws],
            stored=sum(t.numel() * t.element_size()
                       for t in _tensors_of([ff.params, ff.opt_state])),
            preempted=ff._preempted_at_step,
            summary=session.summary() if session is not None else {},
            saves=list(session.manager.saves)
            if session is not None and session.manager is not None else [])
    return threaded_ranks(2, body, label)


def mesh16_resilience(device, card: str, root: str) -> dict:
    """(a)."""
    import torch

    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    t0 = time.perf_counter()
    ref, cfg = train_model("bert", "bf16", device, num_layers=MESH16_LAYERS)
    weights = ref.get_params_numpy()
    init = [torch.from_numpy(weights[n][w]) for n, ws in ref.params.items()
            for w in ws]
    del ref
    x, y = train_data("bert", cfg, cfg.batch_size * MESH16_STEPS)
    dp2 = lambda pcg: data_parallel_strategy(pcg, 2)  # noqa: E731
    plain = [mesh16_fit(device, weights, x, y, dp2, "mesh16 plain")
             for _ in range(MESH16_SPREAD_RUNS)]
    finals = [p[0]["params"] for p in plain]
    spread = max(pair_diffs(finals, init))
    band = band_of(spread)
    nan = mesh16_fit(device, weights, x, y, dp2, "mesh16 nan",
                     ckpt=os.path.join(root, "nan"),
                     chaos={0: dict(nan_at_steps={MESH16_NAN_STEP})})
    stop = mesh16_fit(device, weights, x, y, dp2, "mesh16 preempt",
                      ckpt=os.path.join(root, "preempt"),
                      chaos={1: dict(preempt_at_step=MESH16_PREEMPT_STEP,
                                     preempt_signal=None)})
    resumed = mesh16_fit(device, weights, x, y, dp2, "mesh16 resume",
                         ckpt=os.path.join(root, "preempt"), resume=True)
    res = dict(band=band, spread=spread, init=init, weights=weights, x=x,
               y=y, plain=plain[0][0])
    for name, run, want in (
            ("nan", nan, dict(skipped_steps=1, recovery_events=1,
                              last_resume_step=MESH16_EVERY)),
            ("resume", resumed, dict(last_resume_step=MESH16_PREEMPT_STEP
                                     + 1))):
        summaries = [run[r]["summary"] for r in range(2)]
        if any(summaries[r].get(k) != v for r in range(2)
               for k, v in want.items()):
            fail(f"mesh16 {name}: the ranks' counters {summaries}, want "
                 f"{want} on both")
        d = update_rel(run[0]["params"], finals[0], init)
        if not d <= band:
            fail(f"mesh16 {name}: params {d:.3g} from the uninterrupted "
                 f"run, band {band:.3g}")
        res[name] = dict(dparams=d, summary=summaries[0])
    stops = [stop[r]["preempted"] for r in range(2)]
    if stops != [MESH16_PREEMPT_STEP + 1] * 2:
        fail(f"mesh16 preempt: the ranks stopped after steps {stops}, want "
             f"{MESH16_PREEMPT_STEP + 1} on both")
    saves = {r: nan[r]["saves"] for r in range(2)}
    per_rank = [max(b for _s, b, _t in saves[r]) for r in range(2)]
    secs = [max(t for _s, _b, t in saves[r]) for r in range(2)]
    log(f"mesh16 resilience (BERT-Large widths, {MESH16_LAYERS} layers, "
        f"bf16, threaded dp=2 ranks on one card; a harness): "
        f"{MESH16_SPREAD_RUNS} uninterrupted runs of {MESH16_STEPS} steps, "
        f"spread {spread:.3g}, band {band:.3g}; NaN on rank 0's plan at "
        f"step {MESH16_NAN_STEP}: counters {res['nan']['summary']} on both "
        f"ranks, params {res['nan']['dparams']:.3g} from the uninterrupted "
        f"run; preemption on rank 1's plan at step {MESH16_PREEMPT_STEP}: "
        f"both stopped after step {stops[0]}, --resume auto params "
        f"{res['resume']['dparams']:.3g}; sharded checkpoint bytes a rank "
        f"{per_rank} (rank 0 writes the replicas), save seconds a rank "
        f"{[round(v, 3) for v in secs]}; {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    res.update(bytes_per_rank=per_rank, save_s=secs)
    return res


def mesh16_fsdp(device, card: str, base: dict) -> dict:
    """(b), threaded: FSDP dp 2 against plain dp 2, B1 / B2 counted."""
    t0 = time.perf_counter()
    per_rank = {}
    with pipe_launch_counter(per_rank):
        run = mesh16_fit(device, base["weights"], base["x"], base["y"],
                         fsdp16_strategy(2), "mesh16 fsdp")
    plain = base["plain"]
    d = update_rel(run[0]["params"], plain["params"], base["init"])
    stored = [run[r]["stored"] for r in range(2)]
    ratio = stored[0] / plain["stored"]
    launches = {k: sum(per_rank.get((f"rank{r}", k), 0) for r in range(2))
                for k in ("flash_fwd", "flash_bwd_fused")}
    want = MESH16_LAYERS * MESH16_STEPS * 2
    log(f"mesh16 fsdp (every weight of 2+ dims split over the data axis, "
        f"threaded dp=2): stored bytes a rank {stored} vs plain dp=2 "
        f"{plain['stored']} (ratio {ratio:.4f}), params {d:.3g} from plain "
        f"dp=2 (band {base['band']:.3g}), B1/B2 launches {launches} on the "
        f"ranks' b4 halves; {time.perf_counter() - t0:.1f} s [{card}]")
    if not 0.5 <= ratio < 0.52:
        fail(f"mesh16 fsdp: a rank stores {ratio:.4f} of plain dp's bytes, "
             "want 1/2 and the replicated biases")
    if not d <= base["band"]:
        fail("mesh16 fsdp: outside the band of plain dp=2")
    if launches != {"flash_fwd": want, "flash_bwd_fused": want}:
        fail(f"mesh16 fsdp: B1/B2 launches {launches}, want {want} each")
    return dict(dparams=d, stored=stored, ratio=ratio, launches=launches)


def mesh16_nccl(device, card: str, base: dict) -> dict:
    """(b) captured and (c): the (1,) FSDP mesh and the (1, 1) fused mesh
    over a NCCL group of one, each against the one-device path."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch import OperatorType
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy

    tmp = tempfile.mkdtemp(prefix="ff_mesh16_")
    dist.init_process_group(
        "nccl", init_method=f"file://{tmp}/pg", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    x, y, init = base["x"], base["y"], base["init"]
    runs = {}
    try:
        for name, fn, fusion in (
                ("one", None, False),
                ("fsdp", fsdp16_strategy(1), False),
                ("hybrid", lambda pcg: hybrid_data_tensor_strategy(
                    pcg, dp=1, tp=1), False),
                ("fused", lambda pcg: hybrid_data_tensor_strategy(
                    pcg, dp=1, tp=1), True)):
            ff, _ = train_model("bert", "bf16", device,
                                num_layers=MESH16_LAYERS, fusion=fusion,
                                strategy_fn=fn)
            ff.config.print_freq = 10 ** 9
            ff.set_params_numpy(base["weights"]) if not fusion else \
                ff.set_params_numpy(fused_weights(ff, base["weights"]))
            fa.reset_launch_count()
            ff.fit([x], y, epochs=1, shuffle=False)
            torch.cuda.synchronize()
            totals = {k: fa.launch_count(k)
                      for k in ("flash_fwd", "flash_bwd_fused")}
            step = ff.executor.make_train_step(capture=False)
            b = ff.config.batch_size
            xs, lab = ff.executor.local_batch([x[:b], ff._prep_label(y[:b])])
            with CommDebugMode() as comm:
                step(ff.params, ff.opt_state,
                     [torch.from_numpy(xs).to(device)],
                     torch.from_numpy(lab).to(device), None)
            torch.cuda.synchronize()
            full = ff.get_params_numpy()
            if fusion:
                full = unfused_params(full)
            names = [(n, w) for n, ws in base["weights"].items() for w in ws]
            runs[name] = dict(
                params=[torch.from_numpy(full[n][w]) for n, w in names],
                captures=ff.executor.make_train_step().program.captures,
                totals=totals,
                collectives={str(k): int(v) for k, v in
                             comm.get_comm_counts().items()},
                regions=sum(1 for n in ff.pcg.compute_nodes()
                            if n.op.op_type == OperatorType.OP_FUSED),
                p50_ms=float(np.median(ff.fit_history.step_s[2:])) * 1e3)
            del ff, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    band = base["band"]
    one = runs["one"]
    res = {}
    for name in ("fsdp", "hybrid", "fused"):
        r = runs[name]
        d = update_rel(r["params"], one["params"], init)
        log(f"mesh16 nccl {name} (BERT-Large widths, {MESH16_LAYERS} "
            f"layers, bf16, a NCCL group of one): captures {r['captures']}, "
            f"an eager step's collectives {r['collectives']}, flash "
            f"launches {r['totals']} (one device {one['totals']}), fused "
            f"regions {r['regions']}, p50 {r['p50_ms']:.3f} ms (one device "
            f"{one['p50_ms']:.3f}), params {d:.3g} from one device (band "
            f"{band:.3g}) [{card}]")
        if r["captures"] != 1:
            fail(f"mesh16 nccl {name}: {r['captures']} captures, want 1")
        if r["totals"] != one["totals"]:
            fail(f"mesh16 nccl {name}: flash launches {r['totals']}, the "
                 f"one-device run's {one['totals']}")
        if not d <= band:
            fail(f"mesh16 nccl {name}: outside the band of one device")
        res[name] = dict(r, dparams=d)
        del res[name]["params"]
    c = runs["fsdp"]["collectives"]
    if c.get("c10d._allgather_base_", 0) < 1 or \
            c.get("c10d._reduce_scatter_base_", 0) < 1:
        fail(f"mesh16 nccl fsdp: the step issued {c}, want the weights' "
             "all-gathers and their grads' reduce-scatters")
    if runs["fused"]["regions"] < 1:
        fail("mesh16 nccl fused: --fusion built no region under the "
             "strategy")
    return res


def fused_weights(ff, weights: dict) -> dict:
    """``weights`` (unfused names) under a fused model's names."""
    out = {}
    for n, ws in ff.params.items():
        for w in ws:
            if n.startswith("fused_"):
                _pos, node, wname = w.split(":")
                out.setdefault(n, {})[w] = weights[node][wname]
            else:
                out.setdefault(n, {})[w] = weights[n][w]
    return out


def unfused_params(params: dict) -> dict:
    """A fused model's params under the unfused names."""
    out = {}
    for n, ws in params.items():
        for w, a in ws.items():
            if n.startswith("fused_"):
                _pos, node, wname = w.split(":")
                out.setdefault(node, {})[wname] = a
            else:
                out.setdefault(n, {})[w] = a
    return out


def pipe16_captured(device, card: str, pipe: dict, layers: int = 0) -> dict:
    """(d): phase 15's 1f1b pp 4 with the stages' step programs."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    th = pipe["threaded"]
    sched, pp, dp, v = PIPE_CAPTURED
    label = f"{sched} pp={pp} dp={dp}"
    eager = th["runs"][label]
    fa.reset_launch_count()
    out = pipe_run(device, th["weights"], th["x"], th["y"], sched, pp, dp,
                   v, layers, False, capture=True, steps=PIPE16_STEPS)
    totals = {k: fa.launch_count(k) for k in ("flash_fwd", "flash_bwd_fused")}
    got = {}
    for r in range(4):
        got.update(out[r]["params"])
    names = th["names"]
    d = update_rel([got[k] for k in names], [eager["params"][k]
                                             for k in names],
                   [th["init"][k] for k in names])
    caps = [out[r]["captures"] for r in range(4)]
    att = sum(out[r]["att"] for r in range(4))
    b2 = att * PIPE_MICRO * PIPE16_STEPS
    want = {"flash_fwd": 2 * b2, "flash_bwd_fused": b2}
    dloss = max(abs(a - b) for a, b in zip(out[0]["losses"][:PIPE_STEPS],
                                           eager["losses"]))
    wall = max(out[r]["wall"] for r in range(4))
    log(f"pipeline16 captured {label} (BERT-Large fp32, 4 ranks as "
        f"threads on one card; a harness): captures a rank after each of "
        f"{PIPE16_STEPS} steps {caps}, B1/B2 {totals} (want {want}, "
        f"replays counted), losses {[round(v, 6) for v in out[0]['losses']]}"
        f" vs eager {[round(v, 6) for v in eager['losses']]} (diff "
        f"{dloss:.3g}, band {th['loss_band']:.3g}), params after "
        f"{PIPE_STEPS} steps {d:.3g} from the eager run (band "
        f"{th['band']:.3g}); {wall:.2f} s for {PIPE16_STEPS} steps "
        f"[{card}]")
    for r in range(4):
        c = caps[r]
        if not c[0] > 0 or c[-1] != c[-2]:
            fail(f"pipeline16 captured: rank {r} captures {c}, want some "
                 "in the warm-up and none after")
    if totals != want:
        fail(f"pipeline16 captured: B1/B2 {totals}, want {want}")
    if not (d <= th["band"] and dloss <= th["loss_band"]):
        fail("pipeline16 captured: outside the band of the eager run")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(dparams=d, dloss=dloss, captures=caps, totals=totals,
                wall=wall)


def mesh16_phase(device, card: str, pipe: dict) -> dict:
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ff_mesh16_ckpt_")
    try:
        res = mesh16_resilience(device, card, root)
        fsdp = mesh16_fsdp(device, card, res)
        pipe16 = pipe16_captured(device, card, pipe)
        nccl = mesh16_nccl(device, card, res)
        kern = fa_case(device, card, "bert_dp2", "bf16")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"mesh16 phase wall {wall:.1f} s (stated {MESH16_WALL_S:.0f} s) "
        f"[{card}]")
    return dict(fsdp=fsdp, pipe=pipe16, nccl=nccl, kern=kern,
                resilience={k: res[k] for k in ("nan", "resume", "band",
                                                 "bytes_per_rank",
                                                 "save_s")})


# ------------------------------------------------------- phase 17: search
# (a) the machine model's three efficiencies, measured on the card: a large
# GEMM against the dense peak of its dtype, an elementwise pass and the
# port's Adam update against the HBM rate (search/machine_model.py keeps
# the measured fractions in MEASURED_EFFICIENCY)
EFF_GEMM_N = 8192
EFF_ELEMENTS = 1 << 28
EFF_ADAM_TENSORS, EFF_ADAM_ELEMENTS = 24, 1 << 22


def search_efficiency(device, card: str) -> dict:
    """Time an ``EFF_GEMM_N``^3 GEMM in bf16 and in fp32 (TF32 off), ``z =
    x + y`` over ``EFF_ELEMENTS`` fp32 elements and one Adam update of
    ``EFF_ADAM_TENSORS`` fp32 tensors (``AdamOptimizer.update``, 7 streams
    of 4 bytes a parameter); each as a fraction of the machine model's
    peak or HBM rate from ``GPUMachineModel.detect``. Also checks that
    ``detect`` reads the card: name, capacity, the telemetry's peak."""
    import torch

    from flexflow_tpu_torch.execution.optimizers import AdamOptimizer
    from flexflow_tpu_torch.obs.telemetry import detect_peak_flops
    from flexflow_tpu_torch.search.machine_model import (GPUMachineModel,
                                                         detect_generation)

    m = GPUMachineModel.detect(1, device=device)
    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    if m.generation != detect_generation(name) or \
            m.hbm_capacity != total or m.peak_flops != detect_peak_flops():
        fail(f"search machine: detect() gave {m.generation} "
             f"{m.hbm_capacity} B {m.peak_flops:.4g} FLOP/s for {name!r} "
             f"({total} B, peak {detect_peak_flops()})")
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {}
    n = EFF_GEMM_N
    for dname, dt, peak in (("bf16", torch.bfloat16, m.peak_flops),
                            ("fp32", torch.float32, m.peak_flops_f32)):
        a = torch.randn(n, n, device=device, dtype=dt, generator=gen)
        b = torch.randn(n, n, device=device, dtype=dt, generator=gen)
        c = torch.empty(n, n, device=device, dtype=dt)
        ms = time_ms(lambda i: torch.mm(a, b, out=c), 10, device)
        out[f"gemm_{dname}"] = 2 * n ** 3 / (ms * 1e-3) / peak
        out[f"gemm_{dname}_ms"] = ms
        del a, b, c
    x = torch.randn(EFF_ELEMENTS, device=device, generator=gen)
    y = torch.randn(EFF_ELEMENTS, device=device, generator=gen)
    z = torch.empty_like(x)
    ms = time_ms(lambda i: torch.add(x, y, out=z), 10, device)
    out["elementwise"] = 3 * 4 * EFF_ELEMENTS / (ms * 1e-3) / m.hbm_bandwidth
    out["elementwise_ms"] = ms
    del x, y, z
    shape = (EFF_ADAM_ELEMENTS,)
    params = {f"w{i}": {"kernel": torch.randn(shape, device=device,
                                             generator=gen)}
              for i in range(EFF_ADAM_TENSORS)}
    grads = {k: {"kernel": torch.randn(shape, device=device, generator=gen)}
             for k in params}
    opt = AdamOptimizer(alpha=1e-4)
    state = opt.init_state(params)
    ms = time_ms(lambda i: opt.update(params, grads, state), 10, device)
    nbytes = 7 * 4 * EFF_ADAM_TENSORS * EFF_ADAM_ELEMENTS
    out["adam"] = nbytes / (ms * 1e-3) / m.hbm_bandwidth
    out["adam_ms"] = ms
    log(f"search machine ({m.generation}, detect: {name}, "
        f"{m.hbm_capacity / 2 ** 30:.2f} GiB, peak {m.peak_flops:.4g} / "
        f"fp32 {m.peak_flops_f32:.4g} FLOP/s, HBM {m.hbm_bandwidth:.4g} B/s):"
        f" GEMM {n}^3 bf16 {out['gemm_bf16_ms']:.4f} ms = "
        f"{out['gemm_bf16']:.4f} of peak, fp32 {out['gemm_fp32_ms']:.4f} ms"
        f" = {out['gemm_fp32']:.4f}; x+y over {EFF_ELEMENTS} fp32 "
        f"{out['elementwise_ms']:.4f} ms = {out['elementwise']:.4f} of HBM; "
        f"Adam over {EFF_ADAM_TENSORS} x {EFF_ADAM_ELEMENTS} fp32 "
        f"{out['adam_ms']:.4f} ms = {out['adam']:.4f} of HBM; model "
        f"matmul {m.matmul_efficiency} hbm {m.hbm_efficiency} update "
        f"{m.update_hbm_efficiency} [{card}]")
    return out


# (b) the cost model against the card: the BERT-Large proxy at full width
# (bf16, batch 8, seq 512, 24 layers) on one card; (c) its search for four
# GPUs; (d) the winner of the same search at a cut depth (2 layers, fp32,
# no pipeline candidates) on four threaded ranks. The phase's stated wall:
# SEARCH_WALL_S.
SEARCH_WALL_S = 60.0
SEARCH_WORLD = 4
SEARCH_THREADED_LAYERS = 2
SEARCH_PER_OP = 8
# (d): fp32 on both sides, the shards' sums in another order only
SEARCH_THREADED_TOL = TRAIN_TOL["fp32"]
# the plans the search chooses between on four GPUs: (dp, tp); and the
# pipeline it picked while it priced a stage's fp32 matmuls at the 16-bit
# rate: (schedule, pp, dp, virtual stages, microbatches)
SEARCH_MESHES = {"dp4": (4, 1), "hybrid2x2": (2, 2), "tp4": (1, 4)}
SEARCH_PIPELINE = ("interleaved", 4, 1, 2, 8)


def search_plans(pcg, sim, batch: int) -> dict:
    """The simulated step (ms) on ``sim``'s machine of the best plan the
    search's DP finds on each mesh of ``SEARCH_MESHES``, and of the
    ``SEARCH_PIPELINE`` grid (``pp4_interleaved``, stage remat full)."""
    from flexflow_tpu_torch.search.unity import dp_assign, simulate_pipeline

    plans = {name: dp_assign(pcg, sim, dp, tp, batch)[2] * 1e3
             for name, (dp, tp) in SEARCH_MESHES.items()}
    sched, pp, dp, v, micro = SEARCH_PIPELINE
    plans["pp4_interleaved"] = simulate_pipeline(
        sim, pcg, pp, dp, micro, remat="full", schedule=sched, v=v)[0] * 1e3
    return plans


def flash_counts() -> dict:
    from flexflow_tpu_torch.kernels import flash_attention as fa

    return {k: fa._launches[k] for k in ("flash_fwd", "flash_bwd_fused")}


def search_cost(device, card: str, measured_step_ms: float) -> dict:
    """(b): ``FFModel.profile_operators`` on the proxy (the
    ``SEARCH_PER_OP`` heaviest op shapes, each timed by CUDA events around
    a captured graph of its op, in bf16) against ``op_cost``; the
    attention op's ``"grad"`` measurement; the simulated step against
    phase 6's measured captured p50 of the same model. B1 / B2 counted
    inside the measurements."""
    import torch

    from flexflow_tpu_torch.search.machine_model import GPUMachineModel
    from flexflow_tpu_torch.search.simulator import OpSharding, Simulator

    ff, _cfg = train_model("bert", "bf16", device, per_op=True)
    pcg = ff.pcg
    before = flash_counts()
    ff.profile_operators(SEARCH_PER_OP)
    sim = Simulator(GPUMachineModel.detect(1, device=device),
                    dtype_label="bf16")
    attn = [n for n in pcg.compute_nodes()
            if n.op.op_type.name == "OP_MULTIHEAD_ATTENTION"][0]
    ins = [pcg.nodes[g].out_shapes[i] for g, i in attn.inputs]
    dts = [pcg.nodes[g].out_dtypes[i] for g, i in attn.inputs]
    grad_s = sim.measure_operator_cost(attn, ins, compute_dtype=torch.bfloat16,
                                       direction="grad", in_dtypes=dts,
                                       device=device)
    after = flash_counts()
    launches = {k: after[k] - before[k] for k in after}
    est = sim.op_cost(attn, ins, OpSharding())
    rows = [dict(name=n, op_type=t, measured_us=m * 1e6, analytic_us=a * 1e6,
                 ratio=a / m) for n, t, m, a in ff.per_op_profile]
    for r in rows:
        log(f"search per-op {r['name']} {r['op_type']}: measured "
            f"{r['measured_us']:.2f} us, analytic {r['analytic_us']:.2f} us "
            f"(analytic / measured {r['ratio']:.3f}) [{card}]")
    if len(rows) != SEARCH_PER_OP or not all(
            np.isfinite(r["measured_us"]) and r["measured_us"] > 0
            for r in rows):
        fail(f"search cost: profile_operators measured {len(rows)} of "
             f"{SEARCH_PER_OP} ops")
    if not (launches["flash_fwd"] > 0 and launches["flash_bwd_fused"] > 0):
        fail(f"search cost: the measurements launched B1/B2 {launches}")
    sim.activation_el = 2  # bf16 activations
    t_sim, mem = sim.simulate(pcg, {n.guid: OpSharding()
                                    for n in pcg.compute_nodes()})
    ratio = t_sim * 1e3 / measured_step_ms
    log(f"search step bert-large bf16 b8 s512 24 layers, one card: "
        f"simulated {t_sim * 1e3:.3f} ms ({mem / 2 ** 30:.2f} GiB) vs "
        f"measured captured p50 {measured_step_ms:.3f} ms (phase 6): "
        f"simulated / measured {ratio:.3f}; attention fwd+bwd measured "
        f"{grad_s * 1e6:.1f} us vs analytic "
        f"{(est.forward_time + est.backward_time) * 1e6:.1f} us; B1/B2 "
        f"launched {launches} inside the measurements [{card}]")
    del ff
    torch.cuda.empty_cache()
    return dict(per_op=rows, step_sim_ms=t_sim * 1e3,
                step_measured_ms=measured_step_ms, step_ratio=ratio,
                attn_grad_us=grad_s * 1e6, launches=launches)


def search_target(device, card: str, tmp: str, layers: int = 0,
                  compute: str = "bf16") -> dict:
    """(c): the proxy compiled with ``--search-num-workers 4
    --export-strategy`` on one card (the search for four GPUs on the
    detected H100 model; the compile then trains on the one card), and the
    same search's result on a copy of the graph: the winner, its wall,
    its candidates and simulated step beside the plans of
    :func:`search_plans`."""
    import torch

    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType)
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert
    from flexflow_tpu_torch.search.calibration import dtype_label
    from flexflow_tpu_torch.search.machine_model import GPUMachineModel
    from flexflow_tpu_torch.search.simulator import Simulator
    from flexflow_tpu_torch.search.unity import unity_search

    path = os.path.join(tmp, f"search_l{layers or 24}_{compute}.json")
    c = FFConfig()
    c.batch_size, c.seed = 8, SEED
    c.search_num_workers, c.export_strategy_file = SEARCH_WORLD, path
    if compute == "bf16":
        c.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(c, device=device)
    cfg = BertConfig.large()
    if layers:
        cfg.num_layers = layers
    build_bert(ff, cfg)
    t0 = time.perf_counter()
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    compile_s = time.perf_counter() - t0
    if ff.mesh is not None or not os.path.exists(path):
        fail("search target: --search-num-workers 4 did not export and "
             "train on the one card")
    with open(path) as f:
        exported = json.load(f)
    pcg = ff.create_pcg()
    machine = GPUMachineModel.detect(SEARCH_WORLD, device=device)
    res = unity_search(pcg.copy(), c, SEARCH_WORLD, machine=machine,
                       return_result=True, insert_ir_nodes=False,
                       protected_guids=(ff.final_guid,), device=device)
    if list(res.strategy.mesh_shape) != list(exported["mesh_shape"]):
        fail(f"search target: the export's mesh {exported['mesh_shape']} is "
             f"not the search's {res.strategy.mesh_shape}")
    plans = search_plans(pcg, Simulator(machine,
                                        dtype_label=dtype_label(c)),
                         c.batch_size)
    win = res.strategy.describe() if hasattr(res.strategy, "describe") \
        else str(res.strategy.mesh_shape)
    log(f"search target bert-large {compute} b8 s512 {cfg.num_layers} layers "
        f"for {SEARCH_WORLD} GPUs ({machine.generation}, NVLink "
        f"{machine.ici_bandwidth * machine.ici_links_per_chip / 1e9:.0f} "
        f"GB/s a direction): winner {win} mesh {list(res.mesh_shape)} "
        f"remat {res.remat} pipeline {res.strategy.pipeline}, simulated "
        f"{res.sim_time * 1e3:.3f} ms; search wall {res.search_wall_s:.3f} "
        f"s, {res.candidates} candidates, {res.pruned_static} pruned; "
        f"simulated "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in plans.items())
        + f"; compile with the export {compile_s:.2f} s [{card}]")
    del ff
    torch.cuda.empty_cache()
    return dict(path=path, mesh=list(res.mesh_shape), winner=win,
                sim_ms=res.sim_time * 1e3, wall_s=res.search_wall_s,
                candidates=res.candidates, pruned=res.pruned_static,
                plans=plans, pipeline=res.strategy.pipeline)


def search_threaded(device, card: str, target: dict) -> dict:
    """(d): the strategy ``target`` exported (the cut-depth proxy, fp32)
    imported onto ``SEARCH_WORLD`` threaded ranks on the card (eager: the
    harness's collectives cannot be captured): one train step's loss and
    grads against the one-device port from the same weights and batch,
    B1 / B2 counted per rank and the (batch, heads) each launch saw."""
    import torch

    from flexflow_tpu_torch.kernels import flash_attention as fa

    ref, cfg = train_model("bert", "fp32", device,
                           num_layers=SEARCH_THREADED_LAYERS)
    x, y = train_data("bert", cfg, cfg.batch_size)
    weights = ref.get_params_numpy()
    lab = torch.from_numpy(ref._prep_label(y)).to(device)
    loss, _l, grads = ref.executor.loss_and_grads(
        ref.params, [torch.from_numpy(x).to(device)], lab)
    want = (float(loss), [g for ws in grads.values() for g in ws.values()])
    del ref, grads
    shapes, per_rank = [], {}
    orig = fa._launch_fwd

    def seen(qs, *a, **kw):
        shapes.append(tuple(qs.shape[:2]))
        return orig(qs, *a, **kw)

    def body(r):
        from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                        LossType)
        from flexflow_tpu_torch.models.bert import BertConfig, build_bert

        c = FFConfig()
        c.batch_size, c.seed = 8, SEED
        c.import_strategy_file = target["path"]
        ff = FFModel(c, device=device)
        bc = BertConfig.large()
        bc.num_layers = SEARCH_THREADED_LAYERS
        build_bert(ff, bc)
        ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
                   loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        ff._capture_steps = False
        ff.set_params_numpy(weights)
        ex = ff.executor
        xs, ys = ex.local_batch([x, ff._prep_label(y)])
        loss, _l, grads = ex.loss_and_grads(
            ff.params, [torch.from_numpy(xs).to(device)],
            torch.from_numpy(ys).to(device))
        full = [ex.gather_param(n, w, g) for n, ws in grads.items()
                for w, g in ws.items()]
        return float(loss), full, tuple(ff.mesh.sizes)

    t0 = time.perf_counter()
    fa._launch_fwd = seen
    try:
        with pipe_launch_counter(per_rank):
            out = threaded_ranks(SEARCH_WORLD, body, "search threaded")
    finally:
        fa._launch_fwd = orig
    losses = [out[r][0] for r in range(SEARCH_WORLD)]
    dloss = max(abs(v - want[0]) / max(abs(want[0]), 1e-30) for v in losses)
    derr = max(rel_norm(out[r][1], want[1]) for r in range(SEARCH_WORLD))
    launches = {k: sum(per_rank.get((f"rank{r}", k), 0)
                       for r in range(SEARCH_WORLD))
                for k in ("flash_fwd", "flash_bwd_fused")}
    rank_shapes = sorted(set(shapes))
    log(f"search threaded bert (BERT-Large widths, "
        f"{SEARCH_THREADED_LAYERS} layers, fp32, the searched "
        f"{target['winner']} mesh {out[0][2]} imported on "
        f"{SEARCH_WORLD} ranks as threads on one card; a harness, its "
        f"times are not multi-GPU speed): loss {losses[0]:.6f} vs one "
        f"device {want[0]:.6f} (rel {dloss:.3g}), grads rel norm err "
        f"{derr:.3g} (tol {SEARCH_THREADED_TOL}); B1/B2 launches "
        f"{launches}, (batch, heads) a launch {rank_shapes}; "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    want_n = SEARCH_WORLD * SEARCH_THREADED_LAYERS
    if len(rank_shapes) != 1 or launches["flash_fwd"] < want_n or \
            launches["flash_bwd_fused"] < want_n:
        fail(f"search threaded: B1/B2 launches {launches} at {rank_shapes},"
             f" want at least {want_n} each at one rank shape")
    if not (dloss <= SEARCH_THREADED_TOL[0]
            and derr <= SEARCH_THREADED_TOL[1]):
        fail("search threaded: the searched plan's step disagrees with one "
             "device")
    return dict(launches=launches, shape=rank_shapes[0], dloss=dloss,
                grad_err=derr)


def search_phase(device, card: str, measured_step_ms: float) -> dict:
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ff_search_")
    try:
        eff = search_efficiency(device, card)
        cost = search_cost(device, card, measured_step_ms)
        full = search_target(device, card, tmp)
        cut = search_target(device, card, tmp,
                            layers=SEARCH_THREADED_LAYERS, compute="fp32")
        if cut["pipeline"]:
            # (d) holds one step of an SPMD plan against one device; a
            # pipeline winner would need phase 15's harness instead
            fail(f"search: the cut-depth search picked the pipeline "
                 f"{cut['winner']}, which (d) does not train")
        threaded = search_threaded(device, card, cut)
        b, h = threaded["shape"]
        FA_SHAPES["search_rank"] = dict(b=b, h=h, sq=512, sk=512, d=64,
                                        causal=False)
        kern = fa_case(device, card, "search_rank", "fp32")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"search phase wall {wall:.1f} s (stated {SEARCH_WALL_S:.0f} s) "
        f"[{card}]")
    return dict(eff=eff, cost=cost, full=full, cut=cut, threaded=threaded,
                kern=kern, wall=wall)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        import flexflow_tpu_torch  # noqa: F401
        from flexflow_tpu_torch.models.gpt2 import GPT2Config
    except ImportError as e:
        fail(f"cannot import flexflow_tpu_torch ({e}); run from the root "
             "of a checkout")
    # matmuls in full fp32 (the default; stated because TF32 would move
    # the fp32 comparisons by ~1e-3)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} [{card}]")

    profile = "--profile" in sys.argv[1:]
    wall = time.perf_counter()
    census = build_phase()
    dprops = decode_props()
    kern = kernel_phase(device, card)
    kern_int8 = kernel_phase(device, card, int8=True)
    # B5 at the Transformer decoder's shape (fp32, 8 slots, 16 heads, d64,
    # 16-token blocks, 32 blocks a slot: its engine's at max_decode_len 512)
    kern_dec = kernel_phase(device, card, dtypes=("fp32",),
                            heads=DECODER_HEADS)
    topk_kern = topk_kernel_phase(device, card)
    sm_kern = softmax_kernel_phase(device, card)
    cfg = GPT2Config.small()
    prompt_set = dict(lengths=(200, 96, 150, 32, 120, 180, 72, 48),
                      shared_len=64, n_shared=3, new_tokens=E2E_NEW_TOKENS,
                      max_len=E2E_MAX_DECODE_LEN)
    e2e, int8 = {}, {}
    for compute in ("fp32", "bf16"):
        e2e[compute] = e2e_phase(device, card, cfg, compute, **prompt_set,
                                 profile=profile)
    for compute in ("fp32", "bf16"):
        int8[compute] = int8_serving_phase(device, card, compute,
                                           **prompt_set, profile=profile)
    fa_kern = fa_kernel_phase(device, card)
    train = {
        "bert": train_phase(device, card, "bert", "bf16", steps=6, warmup=2,
                            profile=profile),
        "gpt2": train_phase(device, card, "gpt2", "fp32", steps=3, warmup=1,
                            profile=profile),
        # two warm-up steps where the timed steps should all be replays:
        # a shape's first step runs eagerly, its second is captured
        "long": train_phase(device, card, "gpt2", "fp32", steps=2, warmup=2,
                            seq=LONG_SEQ, batch=1, check_grads=False,
                            profile=profile),
        # the 16-bit two-pass backward's main path: 12 B1 + 12 B3 + 12 B4
        # a step (asserted in train_phase)
        "long_bf16": train_phase(device, card, "gpt2", "bf16", steps=2,
                                 warmup=2, seq=LONG_SEQ, batch=1,
                                 check_grads=False, profile=profile),
        "softmax": train_phase(device, card, "gpt2", "fp32", steps=3,
                               warmup=1, softmax_kernel=True),
    }
    graph_phase(device, card, cfg, prompt_set)
    zoo_phase(device, card, profile=profile)
    seq = seq_phase(device, card, prompt_set, profile=profile)
    resilient = resilient_phase(device, card)
    obs = obs_phase(device, card, prompt_set)
    chaos = chaos_phase(device, card, prompt_set)
    serving13 = serving13_phase(device, card)
    mesh = mesh_phase(device, card)
    pipe = pipeline_phase(device, card)
    mesh16 = mesh16_phase(device, card, pipe)
    search = search_phase(device, card, train["bert"]["p50_ms"])

    kernels = []
    for compute, name in (("fp32", "flash_decode"),
                          ("bf16", "flash_decode_bf16")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
            "replaces": "flexflow_tpu/kernels/flash_decode.py:54",
            "launches": e2e[compute]["launches"],
            **kern[compute],
            **dprops[name],
        })
    # the Transformer decoder's B5: the fp32 instance at 16 heads, timed
    # there, with the captured serving run's launches
    kernels.append({
        "name": "flash_decode_decoder",
        "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
        "replaces": "flexflow_tpu/kernels/flash_decode.py:54",
        "launches": seq["serve"]["captured"]["launches"],
        **kern_dec["fp32"],
        **dprops["flash_decode"],
    })
    # each flash-attention kernel at the shape and dtype of the training
    # path that launched it, one entry a shape, with that path's launches;
    # the BERT bf16 entries add phase 14's mesh runs over NCCL (the
    # synchronous and the overlapped), which launch them at that shape
    mesh_launches = {k: sum(mesh["nccl"][r]["totals"][k]
                            for r in ("sync", "overlap"))
                     for k in ("flash_fwd", "flash_bwd_fused")}
    for name, kernel, shape, dname, paths in (
            ("flash_fwd_bf16", "flash_fwd", "bert", "bf16", ("bert",)),
            ("flash_fwd_bf16_long", "flash_fwd", "long", "bf16",
             ("long_bf16",)),
            ("flash_bwd_fused_bf16", "flash_bwd_fused", "bert", "bf16",
             ("bert",)),
            ("flash_fwd", "flash_fwd", "gpt2", "fp32", ("gpt2",)),
            ("flash_fwd_long", "flash_fwd", "long", "fp32", ("long",)),
            ("flash_bwd_fused", "flash_bwd_fused", "gpt2", "fp32",
             ("gpt2",)),
            ("flash_bwd_dkv", "flash_bwd_dkv", "long", "fp32", ("long",)),
            ("flash_bwd_dq", "flash_bwd_dq", "long", "fp32", ("long",)),
            ("flash_bwd_dkv_bf16", "flash_bwd_dkv", "long", "bf16",
             ("long_bf16",)),
            ("flash_bwd_dq_bf16", "flash_bwd_dq", "long", "bf16",
             ("long_bf16",))):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": sum(train[p]["counts"][kernel] for p in paths)
            + (mesh_launches.get(kernel, 0)
               if (shape, dname) == ("bert", "bf16") else 0),
            **fa_kern[(kernel, shape, dname)],
            # the Hopper instance this shape runs: SASS census, registers,
            # spills, shared memory
            **census.get((kernel, dname, FA_SHAPES[shape]["d"]), {}),
        })
    # the OSDI'22 Transformer proxy's B1 and B2: fp32, b8 h16 s512 d64,
    # non-causal, the fp32 BERT shape of the kernel phase
    for name, kernel in (("flash_fwd_transformer", "flash_fwd"),
                         ("flash_bwd_fused_transformer", "flash_bwd_fused")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": seq["runs"]["transformer"]["captured"]["totals"][
                kernel],
            **fa_kern[(kernel, "bert", "fp32")],
            **census.get((kernel, "fp32", FA_SHAPES["bert"]["d"]), {}),
        })
    # B1 and B2 on the BERT-Large proxy under --remat full (B1 runs again
    # in the backward's recompute), timed at their BERT bf16 shape
    for name, kernel in (("flash_fwd_remat", "flash_fwd"),
                         ("flash_bwd_fused_remat", "flash_bwd_fused")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": resilient["remat"]["full"]["totals"][kernel],
            **fa_kern[(kernel, "bert", "bf16")],
            **census.get((kernel, "bf16", FA_SHAPES["bert"]["d"]), {}),
        })
    # B1 and B2 on phase 11's BERT-Large fits: the telemetry run and the
    # fused one, timed at their BERT bf16 shape
    for name, kernel in (("flash_fwd_obs", "flash_fwd"),
                         ("flash_bwd_fused_obs", "flash_bwd_fused")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": obs["telemetry"]["totals"][kernel]
            + obs["fusion"]["fused"]["totals"][kernel],
            **fa_kern[(kernel, "bert", "bf16")],
            **census.get((kernel, "bf16", FA_SHAPES["bert"]["d"]), {}),
        })
    # B5 (int8) and B7 (k = 8) on phase 11's traced serving run: GPT-2
    # small fp32, the shapes of the kernel phase's fp32 int8 and k = 8 runs
    kernels.append({
        "name": "flash_decode_int8_obs",
        "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
        "replaces": "flexflow_tpu/kernels/flash_decode.py:78",
        "launches": obs["serve"]["traced"]["counts"]["flash_decode_int8"],
        **kern_int8["fp32"],
        **dprops["flash_decode_int8"],
    })
    kernels.append({
        "name": "topk_obs",
        "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/topk.cu",
        "replaces": "flexflow_tpu/kernels/topk.py:34",
        "launches": obs["serve"]["traced"]["counts"]["topk"],
        **topk_kern[8],
    })
    for compute, name in (("fp32", "flash_decode_int8"),
                          ("bf16", "flash_decode_int8_bf16")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
            "replaces": "flexflow_tpu/kernels/flash_decode.py:78",
            "launches": sum(int8[compute][r]["counts"]["flash_decode_int8"]
                            for r in ("greedy", "top8", "top1")),
            **kern_int8[compute],
            **dprops[name],
        })
    # the sampler's top-k: k = 8 in the top_k 8 runs, k = 1 in the top_k 1
    # runs, of both compute dtypes
    for k, name, run in ((8, "topk", "top8"), (1, "topk_k1", "top1")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/topk.cu",
            "replaces": "flexflow_tpu/kernels/topk.py:34",
            "launches": sum(int8[c][run]["counts"]["topk"] for c in int8),
            **topk_kern[k],
        })
    # phase 12: B5 native and int8 inside the guarded decode program, B7
    # inside the sampler on a poisoned slot's NaN row (int8, top-k 8), at
    # the kernel phase's shapes (GPT-2 small, 8 slots, 512 positions;
    # (8, 50304)); max_abs_err is the healthy slots' or rows' on the NaN
    # inputs of chaos_kernel_checks
    for name, kernel, timed, props in (
            ("flash_decode_guarded", "flash_decode", kern["fp32"],
             dprops["flash_decode"]),
            ("flash_decode_int8_guarded", "flash_decode_int8",
             kern_int8["fp32"], dprops["flash_decode_int8"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
            "replaces": "flexflow_tpu/kernels/flash_decode.py:"
                        + ("78" if kernel.endswith("int8") else "54"),
            "launches": chaos["counts"][kernel],
            **timed,
            **props,
            "max_abs_err": chaos["errs"][kernel],
        })
    kernels.append({
        "name": "topk_guarded",
        "route": "cuda",
        "source": "flexflow_tpu_torch/kernels/csrc/topk.cu",
        "replaces": "flexflow_tpu/kernels/topk.py:34",
        "launches": chaos["counts"]["topk"],
        **topk_kern[8],
        "max_abs_err": chaos["errs"]["topk"],
    })
    # phase 13: B5 in the speculative comparison's B5 baseline and in the
    # traced GPT-2 small serve, timed at the kernel phase's fp32 shapes;
    # max_abs_err is held on each engine's own pools after its run
    for name, run in (("flash_decode_spec", serving13["spec"]),
                      ("flash_decode_spans", serving13["spans"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/flash_decode.cu",
            "replaces": "flexflow_tpu/kernels/flash_decode.py:54",
            "launches": run["b5"],
            **kern["fp32"],
            **dprops["flash_decode"],
            "max_abs_err": run["err"],
        })
    # phase 14: B1 and B2 on the threaded tp = 2 x dp = 2 harness's 8
    # local heads, timed at that shard shape (b8 h8 s512 d64)
    for name, kernel in (("flash_fwd_bf16_tp2", "flash_fwd"),
                         ("flash_bwd_fused_bf16_tp2", "flash_bwd_fused")):
        r = dict(mesh["kern"][kernel])
        r.pop("eager_ms", None)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": mesh["threaded"]["launches"] // 2,
            **r,
            **census.get((kernel, "bf16", FA_SHAPES["bert"]["d"]), {}),
        })
    # phase 15: B1 and B2 in the pipeline stages of the threaded runs
    # (BERT-Large fp32; a microbatch of 2 rows at pp 4, 1 row a rank at pp
    # 2 x dp 2), timed at the microbatch shape (b2 h16 s512 d64)
    for name, kernel in (("flash_fwd_pipeline", "flash_fwd"),
                         ("flash_bwd_fused_pipeline", "flash_bwd_fused")):
        r = dict(pipe["kern"][kernel])
        r.pop("eager_ms", None)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": pipe["threaded"]["totals"][kernel],
            **r,
            **census.get((kernel, "fp32", FA_SHAPES["bert"]["d"]), {}),
        })
    # phase 16: B1 and B2 inside the captured pipeline stages (fp32, the
    # microbatch shape b2 h16 s512 d64, timed by phase 15) and on the
    # FSDP path's threaded dp 2 ranks (bf16, a rank's b4 half, timed here)
    for name, kernel, timed, launches in (
            ("flash_fwd_stage_graph", "flash_fwd", pipe["kern"],
             mesh16["pipe"]["totals"]),
            ("flash_bwd_fused_stage_graph", "flash_bwd_fused", pipe["kern"],
             mesh16["pipe"]["totals"]),
            ("flash_fwd_fsdp", "flash_fwd", mesh16["kern"],
             mesh16["fsdp"]["launches"]),
            ("flash_bwd_fused_fsdp", "flash_bwd_fused", mesh16["kern"],
             mesh16["fsdp"]["launches"])):
        r = dict(timed[kernel])
        r.pop("eager_ms", None)
        dname = "fp32" if timed is pipe["kern"] else "bf16"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": launches[kernel],
            **r,
            **census.get((kernel, dname, FA_SHAPES["bert"]["d"]), {}),
        })
    # phase 17: B1 and B2 on the threaded ranks of the searched plan (fp32,
    # timed at the rank's shape, which the winner sets), and inside the
    # cost model's measurements of the BERT-Large attention op (bf16,
    # timed at its BERT shape by the kernel phase)
    for name, kernel in (("flash_fwd_search", "flash_fwd"),
                         ("flash_bwd_fused_search", "flash_bwd_fused")):
        r = dict(search["kern"][kernel])
        r.pop("eager_ms", None)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": search["threaded"]["launches"][kernel],
            **r,
            **census.get((kernel, "fp32", FA_SHAPES["bert"]["d"]), {}),
        })
    for name, kernel in (("flash_fwd_measure", "flash_fwd"),
                         ("flash_bwd_fused_measure", "flash_bwd_fused")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": FA_SOURCE,
            "replaces": FA_KERNELS[kernel][0],
            "launches": search["cost"]["launches"][kernel],
            **fa_kern[(kernel, "bert", "bf16")],
            **census.get((kernel, "bf16", FA_SHAPES["bert"]["d"]), {}),
        })
    for kernel, line in (("softmax_fwd", 29), ("softmax_bwd", 38)):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": "flexflow_tpu_torch/kernels/csrc/softmax.cu",
            "replaces": f"flexflow_tpu/kernels/softmax.py:{line}",
            "launches": train["softmax"]["counts"][kernel],
            **sm_kern[(kernel, "fp32")],
        })
    log(f"wall: {time.perf_counter() - wall:.1f} s from the build to the "
        f"last phase [{card}]")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
