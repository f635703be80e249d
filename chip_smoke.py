#!/usr/bin/env python3
"""Smoke test of flexflow_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--profile]

Run from the root of a checkout, on a host with a CUDA GPU and nvcc. It
drives the PyTorch port only (it imports neither jax nor flexflow_tpu):

1. build — compiles every CUDA kernel of the port from ``csrc/`` (one
   nvcc per source, all started together) and prints the build seconds
   and the compiler's register/spill report;
2. kernels — holds each kernel against its plain-PyTorch version on the
   card at the shapes GPT-2 small's decode gives it (8 slots, 12 heads,
   head_dim 64, block_size 16, 32 blocks per slot, random tables, key
   counts 1..512), in fp32 and bf16, and times kernel, plain version and
   one PyTorch library call computing the same function
   (``F.scaled_dot_product_attention`` over the gathered, masked keys).
   Kernel and library call are timed as CUDA-graph replays cycling over
   12 layers' inputs, so each launch finds its pool cold in L2 as in a
   decode step and Python's launch cost is left out (it is printed
   beside);
3. end to end — per compute dtype (fp32, bf16): GPT-2 small at full width
   (hidden 768, 12 heads, 12 layers, vocab 50257; random weights from a
   seed) serves 8 prompts of 32..200 tokens, three sharing a 64-token
   prefix (prefix-cache hits take the chunk-prefill path), 32 greedy new
   tokens each, through ``FFModel.generate``. Launch counts are reset
   just before and read just after; every decode step must launch the
   flash-decode kernel once per layer. A teacher-forced prefill + decode
   run is then held against a whole-sequence plain forward. With
   ``--profile`` the same generate runs once more under ``torch.profiler``
   and the card's busy share and kernels by time are printed.

It prints one ``{"kernels": [...]}`` line, the card's name and power limit
(nvidia-smi), and as its last line ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero; without CUDA, or without the package, it
exits 1 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

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


def time_ms(fn, iters: int, device, graph: bool = False) -> float:
    """Mean milliseconds per call of ``fn(i)`` (i = 0..iters-1) after two
    warm-up calls: CUDA events around ``iters`` back-to-back calls on the
    card. With ``graph`` the calls are captured once into a CUDA graph and
    the replay is timed, so the figure is device time without Python's
    per-call launch cost (which exceeds a short kernel's run time)."""
    import torch

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
        with torch.cuda.graph(g):
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
def build_phase() -> None:
    from flexflow_tpu_torch.kernels import build_all

    t = time.perf_counter()
    reports = build_all()
    secs = time.perf_counter() - t
    log(f"build: {len(reports)} kernel(s) compiled for sm_90a in "
        f"{secs:.2f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


# ------------------------------------------------------------ kernel phase
def decode_inputs(dtype, device, layers: int, seed: int = SEED):
    """GPT-2 small decode shapes: one random (q, kpool, vpool) per layer,
    shared shuffled block tables and key counts 1..512 (the ends always
    present). Timing cycles through the layers, as a decode step does, so
    a launch finds its pool outside the L2 cache (``layers`` pools of
    25 MB in fp32 exceed its 50 MB)."""
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

    per_layer = [(randn(SLOTS, HEADS, HEAD_DIM),
                  randn(n_blocks, HEADS, BLOCK, HEAD_DIM),
                  randn(n_blocks, HEADS, BLOCK, HEAD_DIM))
                 for _ in range(layers)]
    i = [torch.tensor(a, dtype=torch.int32, device=device)
         for a in (tables, n_keys)]
    return per_layer, i[0], i[1]


def flash_decode_bound(n_keys, el: int):
    """(bound_ms, bound_by): the bytes this call must move — the used K/V
    rows, q, the output, tables and counts, each once — over HBM bandwidth,
    against its fp32 flops (score and PV: 4 * dim per key and head) over
    the fp32 peak."""
    keys = int(np.sum(n_keys))
    kv = keys * HEADS * 2 * HEAD_DIM * el
    io = 2 * SLOTS * HEADS * HEAD_DIM * el + SLOTS * (MAX_BLOCKS + 1) * 4
    t_bytes = (kv + io) / HBM_BYTES_PER_S
    t_ops = keys * HEADS * 4 * HEAD_DIM / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(device, card: str, dtypes=("fp32", "bf16"),
                 iters: int = 240, layers: int = 12):
    import torch
    import torch.nn.functional as F

    from flexflow_tpu_torch.kernels import flash_decode as fd
    from flexflow_tpu_torch.serving.kvcache import gather_paged_kv

    out = {}
    for name in dtypes:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[name]
        per_layer, tables, n_keys = decode_inputs(dtype, device, layers)
        wants = [fd.flash_decode_plain(q, k, v, tables, n_keys)
                 for q, k, v in per_layer]
        err = max((fd.flash_decode(q, k, v, tables, n_keys).float()
                   - want.float()).abs().max().item()
                  for (q, k, v), want in zip(per_layer, wants))
        if not err <= KERNEL_ATOL[name]:
            fail(f"flash_decode {name}: max |kernel - plain| = {err} > "
                 f"{KERNEL_ATOL[name]}")
        # yardstick: one library call on the keys gathered and masked
        gathered = [(q[:, :, None, :], gather_paged_kv(k, tables),
                     gather_paged_kv(v, tables)) for q, k, v in per_layer]
        kpos = torch.arange(gathered[0][1].shape[2], device=device)
        mask = (kpos[None, :] < n_keys[:, None])[:, None, None, :]
        q4, kc, vc = gathered[0]
        lib = F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)
        lib_err = (lib[:, :, 0].float() - wants[0].float()).abs().max().item()

        def kernel(i):
            q, k, v = per_layer[i % layers]
            return fd.flash_decode(q, k, v, tables, n_keys)

        def plain(i):
            q, k, v = per_layer[i % layers]
            return fd.flash_decode_plain(q, k, v, tables, n_keys)

        def library(i):
            q4, kc, vc = gathered[i % layers]
            return F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)

        cuda = device.type == "cuda"
        ms = time_ms(kernel, iters, device, graph=cuda)
        eager_ms = time_ms(kernel, iters, device)
        plain_ms = time_ms(plain, max(iters // 20, 1), device)
        library_ms = time_ms(library, iters, device, graph=cuda)
        bound_ms, bound_by = flash_decode_bound(
            n_keys.cpu().numpy(), per_layer[0][0].element_size())
        log(f"kernel flash_decode {name}: max_abs_err {err:.3g} "
            f"(sdpa vs plain {lib_err:.3g}), {ms * 1e3:.2f} us "
            f"({eager_ms * 1e3:.2f} us a call launched from Python), "
            f"plain {plain_ms * 1e3:.2f} us, sdpa over gathered keys "
            f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}) [{card}]")
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
    return out


# ---------------------------------------------------------- end-to-end phase
def build_model(cfg, compute: str, device, max_decode_len: int):
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.gpt2 import build_gpt2

    config = FFConfig()
    config.batch_size = cfg.batch_size
    config.seed = SEED
    config.max_decode_len = max_decode_len
    config.max_inflight = 8
    if compute == "bf16":
        config.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(config, device=device)
    build_gpt2(ff, cfg)
    ff.compile()
    return ff


def make_prompts(vocab: int, lengths, shared_len: int, n_shared: int):
    rng = np.random.default_rng(SEED + 1)
    shared = rng.integers(0, vocab, shared_len).tolist()
    prompts = []
    for i, n in enumerate(lengths):
        if i < n_shared:
            prompts.append(shared + rng.integers(0, vocab,
                                                 n - shared_len).tolist())
        else:
            prompts.append(rng.integers(0, vocab, n).tolist())
    return prompts


def decode_vs_forward(ff, tokens, prompt_len: int, steps: int,
                      max_len: int, block: int):
    """Teacher-forced serving steps against the whole-sequence plain
    forward: prefill ``tokens[:prompt_len]`` into a paged pool, then
    ``steps`` decode steps fed the true next token. Returns
    (max |serving - forward| over the prefill's last row and every decode
    row, the serving logits). Launch counts include these decodes."""
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
    for name, (kc, vc) in cache.items():
        kp = scatter_prefill_paged(paged_pool_entry(kc, mb + 1, block), kc,
                                   table, block)
        vp = scatter_prefill_paged(paged_pool_entry(vc, mb + 1, block), vc,
                                   table, block)
        caches[name] = (kp, vp)
    state = DecodeState(caches=caches,
                        lengths=torch.tensor([prompt_len], dtype=torch.int32,
                                             device=dev),
                        block_tables=table[None, :].clone())
    decode = ex.make_decode_step(max_len, block_size=block)
    rows = [last[0]]
    for s in range(steps):
        tok = torch.tensor([[tokens[prompt_len + s]]], dtype=torch.int32,
                           device=dev)
        logits, state = decode(ff.params, [tok], state)
        rows.append(logits[0])
    serving = torch.stack(rows)
    full = ex.forward(ff.params, [torch.tensor(
        [tokens[:prompt_len + steps]], dtype=torch.int32, device=dev)])[0]
    want = full[prompt_len - 1:prompt_len + steps]
    if not bool(torch.isfinite(serving).all()):
        fail("non-finite serving logits")
    return (serving - want).abs().max().item(), serving


def profile_generate(ff, compute: str, prompts, new_tokens: int,
                     max_len: int, wall_s: float) -> None:
    """``--profile``: the timed generate once more, on a fresh engine (same
    prefix-cache state, so the same work) under ``torch.profiler``. Prints
    the card's busy time (the sum of kernel times) against the unprofiled
    run's wall and writes the kernels by total time to
    ``chiprun_out/profile_<compute>.txt``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ff._serving_engine = None
    ff.generate([[1, 2, 3]], max_new_tokens=2, max_decode_len=max_len)
    torch.cuda.synchronize()
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
    # warm-up (cuBLAS handles, the kernel library, allocator pools) on a
    # prompt too short to enter the prefix cache
    ff.generate([[1, 2, 3]], max_new_tokens=2, max_decode_len=max_len)
    if device.type == "cuda":
        torch.cuda.synchronize()

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
                         stats.wall_s)

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

    build_phase()
    kern = kernel_phase(device, card)
    cfg = GPT2Config.small()
    e2e = {}
    for compute in ("fp32", "bf16"):
        e2e[compute] = e2e_phase(
            device, card, cfg, compute,
            lengths=(200, 96, 150, 32, 120, 180, 72, 48),
            shared_len=64, n_shared=3, new_tokens=E2E_NEW_TOKENS,
            max_len=E2E_MAX_DECODE_LEN, profile="--profile" in sys.argv[1:])

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
        })
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
