"""Strategies across the GPUs of one host: the BERT-Large proxy (bf16,
Adam 1e-4, random labels, the weights of ``chip_smoke.py``'s seed) trained
under data, tensor and hybrid parallelism, one process per card, against
the one-device path.

Two steps, in one command on a host with four GPUs:

    python3 scripts/mesh_multigpu.py --reference [--compute fp32]
    torchrun --standalone --nproc-per-node 4 scripts/mesh_multigpu.py \
        [--compute fp32]

The first runs the one-device path ``--spread-runs`` times over the same
batches (``chip_smoke.py``'s step loop: a shape's first step eager, the
second captured, then replays) and keeps its initial and final params and
losses in ``--ref-dir``; their spread gives phase 10's band (4 times the
widest difference of two runs in the norm of the params' change, at
least 2^-8). The second trains each strategy of ``STRATEGIES`` over the
same batches and reports, per strategy: the p50 step (every step ends in
a device sync under ``--profiling``), samples/s, the B1 / B2 launches a
step and the heads each launch saw, the captures after warm-up, the NCCL
kernels of one profiled replay, and on rank 0 the loss and param
differences from the first one-device run against the band. It writes
``chiprun_out/mesh_multigpu.json`` (``--out``) and fails if a strategy
launches other than 24 B1 + 24 B2 a step, captures more than once, or
runs no NCCL kernel. The CPU rehearsal of the same code (gloo, the tiny
proxy, the kernels' plain versions):

    python3 scripts/mesh_multigpu.py --reference --device cpu --tiny
    torchrun --standalone --nproc-per-node 4 scripts/mesh_multigpu.py \\
        --device cpu --tiny

``--suite pipeline`` trains the proxy in fp32 (a pipeline stage runs in
its params' dtype) under each grid of ``PIPELINES`` instead, through
``compile(strategy_fn=)`` with a pipeline grid and ``fit`` (point-to-point
over NCCL between the cards): per grid the p50 step, each rank's busy
share of one profiled train step outside and inside NCCL kernels (a receive's
kernel spins while its rank waits on the pipeline), each rank's peak
memory over the fit above the compiled model's state, the B1 / B2 launches
a step against the count the stage split gives, and the params off the
one-device runs (``--reference --compute fp32`` first, same ``--steps``).
``--suite c8`` trains GPT-2 small (fp32, batch 8, seq 512) data-parallel
over the four cards and reports the p50 step and each rank's peak memory
over the fit; ``--package-root DIR`` imports the package from another
checkout (a parent commit), so two trees compare in one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# name -> (schedule, pp, dp, virtual stages); the grid's microbatch count
# (fit re-derives it for the batch)
PIPELINES = {
    "gpipe_pp4": ("gpipe", 4, 1, 1),
    "1f1b_pp4": ("1f1b", 4, 1, 1),
    "interleaved_pp4_v2": ("interleaved", 4, 1, 2),
    "1f1b_pp2_dp2": ("1f1b", 2, 2, 1),
}
N_MICRO = 4
# name -> (kind, a, b, collective overlap)
STRATEGIES = {
    "dp4": ("dp", 4, 1, False),
    "hybrid_dp2_tp2": ("hybrid", 2, 2, False),
    "hybrid_dp2_tp2_overlap": ("hybrid", 2, 2, True),
    "tp4": ("hybrid", 1, 4, False),
}


def args_of():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference", action="store_true",
                   help="run the one-device path and keep its results")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--tiny", action="store_true",
                   help="the tiny proxy (the CPU rehearsal)")
    p.add_argument("--compute", default="bf16", choices=("bf16", "fp32"),
                   help="the compute dtype (fp32 masters either way)")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--spread-runs", type=int, default=3)
    p.add_argument("--ref-dir", default=os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "ff_mesh_multigpu"))
    p.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "mesh_multigpu.json"))
    p.add_argument("--suite", default="strategies",
                   choices=("strategies", "pipeline", "c8"))
    p.add_argument("--package-root", default=None,
                   help="import flexflow_tpu_torch from this checkout")
    args = p.parse_args()
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    return args


def build(args, device, strategy_fn=None, overlap=False):
    """The model of ``chip_smoke.train_model`` (or the tiny proxy) under
    ``strategy_fn``; its batches."""
    import chip_smoke as cs
    from flexflow_tpu_torch import (AdamOptimizer, DataType, FFConfig,
                                    FFModel, LossType, MetricsType)
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert

    if args.tiny:
        cfg = BertConfig(batch_size=8, seq_len=128, hidden=128,
                         num_heads=4, num_layers=2, intermediate=256)
    else:
        cfg = BertConfig.large()
    c = FFConfig()
    c.batch_size, c.seed = cfg.batch_size, cs.SEED
    c.profiling, c.print_freq = True, 10 ** 9
    c.collective_overlap = "on" if overlap else "off"
    if not args.tiny and args.compute == "bf16":
        c.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(c, device=device)
    build_bert(ff, cfg)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY],
               strategy_fn=strategy_fn)
    x, y = cs.train_data("bert", cfg, cfg.batch_size * args.steps)
    return ff, x, y


def run(ff, x, y, args):
    """One fit over (x, y): losses, p50 ms after the warm-up, the
    B1 / B2 launches and the heads each saw, the params after it."""
    import torch

    import chip_smoke as cs
    from flexflow_tpu_torch.kernels import flash_attention as fa

    heads = []
    fa.reset_launch_count()
    with cs.flash_heads(heads):
        ff.fit([x], y, epochs=1)
    if ff.device.type == "cuda":
        torch.cuda.synchronize()
    n = len(ff.fit_history.loss)
    return dict(
        losses=list(ff.fit_history.loss),
        p50_ms=float(np.median(ff.fit_history.step_s[args.warmup:])) * 1e3,
        counts={k: fa.launch_count(k) // n
                for k in ("flash_fwd", "flash_bwd_fused")},
        heads=sorted(set(heads)))


def reference(args) -> None:
    """The one-device runs: their initial and final params and losses."""
    import torch

    import chip_smoke as cs

    device = torch.device(args.device)
    ff, x, y = build(args, device)
    os.makedirs(args.ref_dir, exist_ok=True)
    snap = [t.clone() for t in cs.state_tensors(ff)]
    torch.save([t.cpu() for t in cs.param_list(ff)],
               os.path.join(args.ref_dir, "init.pt"))
    runs = []
    for i in range(args.spread_runs):
        for t, v in zip(cs.state_tensors(ff), snap):
            t.copy_(v)
        ff._rng_counter = 0
        r = run(ff, x, y, args)
        torch.save([t.cpu() for t in cs.param_list(ff)],
                   os.path.join(args.ref_dir, f"final_{i}.pt"))
        runs.append(r)
    with open(os.path.join(args.ref_dir, "runs.json"), "w") as f:
        json.dump(runs, f)
    print(f"one device: p50 {runs[0]['p50_ms']:.3f} ms, losses "
          f"{[round(v, 4) for v in runs[0]['losses']]}", flush=True)


def join(args):
    """This process's rank of the torchrun world: (device, rank, world,
    the card's name and power limit)."""
    import datetime

    import torch
    import torch.distributed as dist

    local = int(os.environ["LOCAL_RANK"])
    if args.device == "cuda":
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
        dist.init_process_group(
            "nccl", device_id=device,
            timeout=datetime.timedelta(seconds=300))
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                timeout=datetime.timedelta(seconds=300))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0] if args.device == "cuda" else "cpu"
    return device, dist.get_rank(), dist.get_world_size(), card


def load_reference(args, card: str):
    """The one-device runs of ``--reference``: (runs, initial params,
    final params of each run, band)."""
    import torch

    import chip_smoke as cs

    with open(os.path.join(args.ref_dir, "runs.json")) as f:
        ref = json.load(f)
    init = torch.load(os.path.join(args.ref_dir, "init.pt"))
    finals = [torch.load(os.path.join(args.ref_dir, f"final_{i}.pt"))
              for i in range(len(ref))]
    spread = max(cs.pair_diffs(finals, init))
    band = cs.band_of(spread)
    loss_spread = max(abs(a - b) for i, r in enumerate(ref)
                      for q in ref[i + 1:]
                      for a, b in zip(r["losses"], q["losses"]))
    print(f"one device: p50 {ref[0]['p50_ms']:.3f} ms, {len(ref)} runs "
          f"spread {spread:.3g} of the params' change, band "
          f"{band:.3g}; loss spread {loss_spread:.3g} [{card}]",
          flush=True)
    return ref, init, finals, band


def finish(args, rank: int, out: dict) -> None:
    import torch.distributed as dist

    if rank == 0:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    dist.barrier()
    sys.stdout.flush()
    # no destroy_process_group: on the four-card host, tearing NCCL down
    # under the captured programs' graphs hung for over 13 minutes
    os._exit(0)


def mesh(args) -> None:
    """Every strategy of ``STRATEGIES`` on the torchrun world."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    device, rank, world, card = join(args)
    ref = init = finals = band = None
    if rank == 0:
        ref, init, finals, band = load_reference(args, card)
    out = {"card": card, "world": world, "strategies": {}}
    for name, (kind, a, b, overlap) in STRATEGIES.items():
        if kind == "dp":
            fn = (lambda pcg, a=a: data_parallel_strategy(pcg, a))
        else:
            fn = (lambda pcg, a=a, b=b: hybrid_data_tensor_strategy(
                pcg, dp=a, tp=b))
        t0 = time.perf_counter()
        ff, x, y = build(args, device, fn, overlap)
        r = run(ff, x, y, args)
        captures = ff.executor.make_train_step().program.captures
        params = ff.get_params_numpy()  # before the profiled extra step
        prof = {}
        if args.device == "cuda":
            b0 = ff.config.batch_size
            prof = cs.profiled(lambda: ff.fit([x[:b0]], y[:b0], epochs=1))
        line = dict(r, captures=captures, mesh=ff.mesh.shape,
                    samples_per_s=ff.config.batch_size / r["p50_ms"] * 1e3,
                    nccl_kernels=prof.get("nccl_kernels", []),
                    busy_ms=prof.get("busy_ms"), wall_s=0.0)
        if rank == 0:
            got = [torch.as_tensor(params[n][w]) for n in params
                   for w in params[n]]
            line["dparams"] = cs.update_rel(got, finals[0], init)
            line["dloss"] = max(abs(p - q) for p, q in
                                zip(r["losses"], ref[0]["losses"]))
            line["band"] = band
            line["in_band"] = bool(line["dparams"] <= band)
        line["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"mesh {name} {ff.mesh.shape}: p50 {r['p50_ms']:.3f} ms "
                  f"(one device {ref[0]['p50_ms']:.3f}), "
                  f"{line['samples_per_s']:.1f} samples/s, busy "
                  f"{line['busy_ms']} ms a replay, B1/B2 a step "
                  f"{r['counts']} on {r['heads']} local heads, captures "
                  f"{captures}, NCCL kernels {line['nccl_kernels'][:3]}; "
                  f"vs one device: params {line['dparams']:.3g} (band "
                  f"{band:.3g}), loss {line['dloss']:.3g} [{card}]",
                  flush=True)
            out["strategies"][name] = line
        fails = []
        if r["counts"] != {"flash_fwd": 24, "flash_bwd_fused": 24} and \
                not args.tiny:
            fails.append(f"launches {r['counts']}")
        if captures != 1 and args.device == "cuda":
            fails.append(f"{captures} captures")
        if args.device == "cuda" and not line["nccl_kernels"]:
            fails.append("no NCCL kernel in a replay")
        if fails:
            raise SystemExit(f"mesh_multigpu {name} rank {rank}: {fails}")
        del ff, params
        if args.device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    finish(args, rank, out)


def pipeline_strategy(sched: str, pp: int, dp: int, v: int, world: int):
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    def fn(pcg):
        s = data_parallel_strategy(pcg, world)
        s.pipeline = (pp, dp, N_MICRO)
        s.schedule, s.virtual_stages = sched, v
        return s
    return fn


def pipeline(args) -> None:
    """Every grid of ``PIPELINES`` on the torchrun world."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from flexflow_tpu_torch import OperatorType

    device, rank, world, card = join(args)
    cuda = args.device == "cuda"
    ref = init = finals = band = None
    if rank == 0:
        ref, init, finals, band = load_reference(args, card)
    out = {"card": card, "world": world, "pipelines": {}}
    for name, (sched, pp, dp, v) in PIPELINES.items():
        t0 = time.perf_counter()
        ff, x, y = build(args, device, pipeline_strategy(sched, pp, dp, v,
                                                         world))
        tr = ff._pipeline_trainer
        if cuda:  # the fit's peak above the compiled model's state
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        r = run(ff, x, y, args)
        peak = ((torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
                if cuda else None)
        att = sum(1 for c in tr._mine
                  for node in tr.specs[c].sub_pcg.compute_nodes()
                  if node.op.op_type == OperatorType.OP_MULTIHEAD_ATTENTION)
        # fit re-derives the microbatch count for the batch (2 pp, pp,
        # 2, 1: the first that splits it), as the JAX package does; stage
        # remat full: B1 in the forward and in its recompute
        n_micro = tr.n_micro
        want = {"flash_fwd": 2 * att * n_micro,
                "flash_bwd_fused": att * n_micro}
        params = ff.get_params_numpy()  # before the profiled extra step
        prof = {}
        if cuda:
            b0 = ff.config.batch_size
            prof = cs.profiled(lambda: tr.train_step([x[:b0]], y[:b0]))
        mine = dict(rank=rank, chunks=list(tr._mine), counts=r["counts"],
                    want=want, busy_ms=prof.get("busy_ms"),
                    nccl_ms=prof.get("nccl_ms"),
                    nccl_kernels=prof.get("nccl_kernels", [])[:4],
                    peak_gib=peak)
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
        line = dict(schedule=sched, pp=pp, dp=dp, v=v, n_micro=n_micro,
                    p50_ms=r["p50_ms"],
                    losses=r["losses"], ranks=ranks,
                    samples_per_s=ff.config.batch_size / r["p50_ms"] * 1e3)
        if cuda:
            # one profiled train step's device time over the p50 step
            line["busy_share"] = [q["busy_ms"] / r["p50_ms"] for q in ranks]
            line["compute_share"] = [(q["busy_ms"] - q["nccl_ms"])
                                     / r["p50_ms"] for q in ranks]
        if rank == 0:
            got = [torch.as_tensor(params[n][w]) for n in params
                   for w in params[n]]
            line["dparams"] = cs.update_rel(got, finals[0], init)
            line["dloss"] = max(abs(p - q) for p, q in
                                zip(r["losses"], ref[0]["losses"]))
            line["band"] = band
            line["in_band"] = bool(line["dparams"] <= band)
        line["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"pipeline {name} ({sched}, pp={pp} dp={dp} v={v}, "
                  f"{n_micro} microbatches): p50 {r['p50_ms']:.3f} ms (one "
                  f"device {ref[0]['p50_ms']:.3f}), "
                  f"{line['samples_per_s']:.1f} samples/s; busy share a "
                  f"rank {[round(q, 4) for q in line.get('busy_share', [])]}"
                  f", outside NCCL "
                  f"{[round(q, 4) for q in line.get('compute_share', [])]}"
                  f"; B1/B2 a step {[q['counts'] for q in ranks]} (want "
                  f"{[q['want'] for q in ranks]}); NCCL kernels "
                  f"{ranks[0]['nccl_kernels']}; fit's peak GiB above the state "
                  f"{[q['peak_gib'] for q in ranks]}; vs one device: "
                  f"params {line['dparams']:.3g} (band {band:.3g}), loss "
                  f"{line['dloss']:.3g} [{card}]", flush=True)
            out["pipelines"][name] = line
        fails = []
        if not args.tiny and r["counts"] != want:
            fails.append(f"launches {r['counts']}, want {want}")
        if cuda and not prof.get("nccl_kernels"):
            fails.append("no NCCL kernel in a profiled step")
        if fails:
            raise SystemExit(f"mesh_multigpu {name} rank {rank}: {fails}")
        del ff, params
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    finish(args, rank, out)


def c8(args) -> None:
    """GPT-2 small data-parallel over the world: p50 step and each rank's
    peak memory over the fit (the loss on sharded logits, ROADMAP C.8,
    against a parent tree through ``--package-root``)."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import flexflow_tpu_torch
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    from flexflow_tpu_torch import (AdamOptimizer, FFConfig, FFModel,
                                    LossType)
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

    device, rank, world, card = join(args)
    cuda = args.device == "cuda"
    t0 = time.perf_counter()
    # chip_smoke.train_model's GPT-2 small (or the tiny LM): softmax head,
    # token-level labels, Adam 1e-4, fp32
    cfg = GPT2Config.tiny(batch_size=8) if args.tiny else \
        GPT2Config(batch_size=8, seq_len=512)
    c = FFConfig()
    c.batch_size, c.seed = cfg.batch_size, cs.SEED
    c.profiling, c.print_freq = True, 10 ** 9
    ff = FFModel(c, device=device)
    _ids, logits = build_gpt2(ff, cfg)
    ff.softmax(logits)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=lambda pcg: data_parallel_strategy(pcg, world))
    x, y = cs.train_data("gpt2", cfg, cfg.batch_size * args.steps)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    ff.fit([x], y, epochs=1)
    mine = dict(rank=rank, peak_gib=(
        (torch.cuda.max_memory_allocated(device) - base) / 2 ** 30
        if cuda else None))
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    p50 = float(np.median(ff.fit_history.step_s[args.warmup:])) * 1e3
    root = os.path.dirname(os.path.dirname(flexflow_tpu_torch.__file__))
    line = dict(package=root, p50_ms=p50, losses=list(ff.fit_history.loss),
                peak_gib_above_state=[q["peak_gib"] for q in ranks],
                wall_s=time.perf_counter() - t0)
    if rank == 0:
        print(f"c8 gpt2 dp={world} fp32 b{cfg.batch_size} s{cfg.seq_len} "
              f"({root}): p50 {p50:.3f} ms over {args.steps} steps after "
              f"{args.warmup}, peak GiB above the state a rank "
              f"{[round(q['peak_gib'], 3) for q in ranks if q['peak_gib']]}"
              f", losses {[round(v, 5) for v in line['losses'][:3]]} "
              f"[{card}]", flush=True)
    finish(args, rank, {"card": card, "world": world, "c8": line})


if __name__ == "__main__":
    a = args_of()
    if a.reference:
        reference(a)
    else:
        {"strategies": mesh, "pipeline": pipeline, "c8": c8}[a.suite](a)
