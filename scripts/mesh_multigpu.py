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

``--suite fsdp`` trains the proxy data-parallel over the world twice:
plain, and with every weight of two or more dims split over the data
axis (ZeRO-3 / FSDP, ``chip_smoke.fsdp16_strategy``); per run the p50
step, each rank's stored bytes (params and optimizer state), its peak
allocation over the fit less those bytes (earlier models collected
first), and the params off the one-device runs.
``--suite ckpt`` saves and restores a sharded checkpoint of the proxy at
dp = 4 and at dp 2 x tp 2 (each rank's bytes, seconds and GB/s, the
restored params bitwise the saved ones) and leaves the dp = 4 one in
``--ref-dir``; ``--suite ckpt_one``, run without torchrun after it,
restores that checkpoint onto one card and checks it bitwise. Under
``--suite pipeline`` the stages run as captured step programs;
``--eager-stages`` runs them eagerly, as before those existed (both in
one call compare the two).

``--suite search`` compiles the proxy with no strategy at the world size,
so every rank runs the Unity search on the detected machine (and agrees
its digest), trains the winner, then dp 4, hybrid 2 x 2, tp 4 and the
pp 4 interleaved pipeline as in the strategies and pipeline suites, all
in one call: per plan the measured p50 beside the search's simulated step
(the winner's own; for the others ``chip_smoke.search_plans``), the
search's wall and candidates, and ``nvidia-smi topo -m`` once. Under
``--compute fp32`` a plan outside the one-device band fails the run.
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
FSDP_STRATEGIES = {
    "dp4": ("dp", 4, 1, False),
    "fsdp_dp4": ("fsdp", 4, 1, False),
}
# the search suite: the searched plan, then the plans of
# chip_smoke.search_plans (the meshes it chose between and the pipeline it
# picked while it priced a stage's fp32 matmuls at the 16-bit rate)
SEARCH_STRATEGIES = {
    "searched": ("search", 0, 0, False),
    "dp4": ("dp", 4, 1, False),
    "hybrid2x2": ("hybrid", 2, 2, False),
    "tp4": ("hybrid", 1, 4, False),
    "pp4_interleaved": ("pipeline", 0, 0, False),
}
# name -> (kind, a, b) of the checkpoint suite
CKPT_STRATEGIES = {"dp4": ("dp", 4, 1), "hybrid_dp2_tp2": ("hybrid", 2, 2)}


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
                   choices=("strategies", "pipeline", "c8", "fsdp", "ckpt",
                            "ckpt_one", "search"))
    p.add_argument("--eager-stages", action="store_true",
                   help="pipeline suite: run the stages eagerly")
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
    ff._capture_steps = not args.eager_stages
    build_bert(ff, cfg)
    ff.compile(optimizer=AdamOptimizer(ff, alpha=1e-4),
               loss_type=LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[MetricsType.METRICS_ACCURACY],
               strategy_fn=strategy_fn)
    ff.profile_operators(0)  # --profiling here is the steps' walls
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


def finish(args, rank: int, out: dict, code: int = 0) -> None:
    import torch.distributed as dist

    if rank == 0:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=str)
    dist.barrier()
    sys.stdout.flush()
    # no destroy_process_group: on the four-card host, tearing NCCL down
    # under the captured programs' graphs hung for over 13 minutes
    os._exit(code)


def memory_base(device) -> int:
    """Start a peak measurement on ``device``: collect what earlier models
    left (their reference cycles hold device memory until the collector
    runs, and would be freed inside the measured fit), return the cached
    blocks, reset the peak. Returns the bytes allocated now."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def strategy_fn(kind: str, a: int, b: int, world: int = 4):
    import chip_smoke as cs
    from flexflow_tpu_torch.parallel.strategies import \
        hybrid_data_tensor_strategy
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    if kind == "dp":
        return lambda pcg: data_parallel_strategy(pcg, a)
    if kind == "fsdp":
        return cs.fsdp16_strategy(a)
    if kind == "search":
        return None  # no strategy at world > 1: compile searches
    if kind == "pipeline":  # fit derives its microbatch count for the batch
        sched, pp, dp, v, _micro = cs.SEARCH_PIPELINE
        return pipeline_strategy(sched, pp, dp, v, world)
    return lambda pcg: hybrid_data_tensor_strategy(pcg, dp=a, tp=b)


def simulated_plans(args, device, world: int) -> dict:
    """``chip_smoke.search_plans`` on the detected machine, in the run's
    compute dtype, for the uncompiled proxy."""
    import chip_smoke as cs
    from flexflow_tpu_torch import DataType, FFConfig, FFModel
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert
    from flexflow_tpu_torch.search.calibration import dtype_label
    from flexflow_tpu_torch.search.machine_model import GPUMachineModel
    from flexflow_tpu_torch.search.simulator import Simulator

    cfg = BertConfig(batch_size=8, seq_len=128, hidden=128, num_heads=4,
                     num_layers=2, intermediate=256) if args.tiny \
        else BertConfig.large()
    c = FFConfig()
    c.batch_size = cfg.batch_size
    if not args.tiny and args.compute == "bf16":
        c.compute_dtype = DataType.DT_BFLOAT16
    ff = FFModel(c, device=device)
    build_bert(ff, cfg)
    sim = Simulator(GPUMachineModel.detect(world, device=device),
                    dtype_label=dtype_label(c))
    return cs.search_plans(ff.create_pcg(), sim, c.batch_size)


def mesh(args, table=None) -> None:
    """Every strategy of ``table`` (``STRATEGIES``) on the torchrun
    world."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs

    device, rank, world, card = join(args)
    cuda = args.device == "cuda"
    ref = init = finals = band = None
    if rank == 0:
        ref, init, finals, band = load_reference(args, card)
    out = {"card": card, "world": world, "strategies": {}}
    for name, (kind, a, b, overlap) in (table or STRATEGIES).items():
        fn = strategy_fn(kind, a, b, world)
        t0 = time.perf_counter()
        ff, x, y = build(args, device, fn, overlap)
        state = sum(t.numel() * t.element_size()
                    for t in cs.state_tensors(ff))
        # the fit's peak above the state (params and optimizer state), and
        # what the card held above the state when the fit began
        start = memory_base(device) if cuda else None
        r = run(ff, x, y, args)
        peak = ((torch.cuda.max_memory_allocated(device) - state) / 2 ** 30
                if cuda else None)
        mem = [None] * world
        dist.all_gather_object(mem, (state, peak, (start - state) / 2 ** 30
                                     if cuda else None))
        captures = ff.executor.make_train_step().program.captures
        params = ff.get_params_numpy()  # before the profiled extra step
        prof = {}
        if args.device == "cuda":
            b0 = ff.config.batch_size
            prof = cs.profiled(lambda: ff.fit([x[:b0]], y[:b0], epochs=1))
        res = getattr(ff, "_search_result", None)
        if res is not None:
            line_search = dict(
                sim_ms=res.sim_time * 1e3, wall_s=res.search_wall_s,
                candidates=res.candidates, winner=ff.strategy.describe(),
                digest=ff._search_digest, pipeline=ff.strategy.pipeline)
        line = dict(r, captures=captures, mesh=ff.mesh.shape,
                    samples_per_s=ff.config.batch_size / r["p50_ms"] * 1e3,
                    nccl_kernels=prof.get("nccl_kernels", []),
                    busy_ms=prof.get("busy_ms"), wall_s=0.0,
                    state_bytes=[m[0] for m in mem],
                    peak_gib_above_state=[m[1] for m in mem],
                    start_gib_above_state=[m[2] for m in mem])
        if rank == 0:
            got = [torch.as_tensor(params[n][w]) for n in params
                   for w in params[n]]
            line["dparams"] = cs.update_rel(got, finals[0], init)
            line["dloss"] = max(abs(p - q) for p, q in
                                zip(r["losses"], ref[0]["losses"]))
            line["band"] = band
            line["in_band"] = bool(line["dparams"] <= band)
        if res is not None:
            line["search"] = line_search
        line["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"mesh {name} {ff.mesh.shape}: p50 {r['p50_ms']:.3f} ms "
                  f"(one device {ref[0]['p50_ms']:.3f}), "
                  f"{line['samples_per_s']:.1f} samples/s, busy "
                  f"{line['busy_ms']} ms a replay, B1/B2 a step "
                  f"{r['counts']} on {r['heads']} local heads, captures "
                  f"{captures}, NCCL kernels {line['nccl_kernels'][:3]}; "
                  f"state bytes a rank {line['state_bytes']}, fit's peak "
                  f"GiB above it {line['peak_gib_above_state']} (held "
                  f"above it at the start {line['start_gib_above_state']}); "
                  f"vs one device: params {line['dparams']:.3g} (band "
                  f"{band:.3g}), loss {line['dloss']:.3g} [{card}]",
                  flush=True)
            out["strategies"][name] = line
        if rank == 0 and res is not None:
            print(f"mesh {name}: the search's winner {ff.strategy.describe()}"
                  f" simulated {res.sim_time * 1e3:.3f} ms, search wall "
                  f"{res.search_wall_s:.3f} s, {res.candidates} candidates, "
                  f"digest {ff._search_digest} agreed [{card}]", flush=True)
        fails = []
        if r["counts"] != {"flash_fwd": 24, "flash_bwd_fused": 24} and \
                not args.tiny and not ff.strategy.pipeline:
            fails.append(f"launches {r['counts']}")
        if captures != 1 and args.device == "cuda" and \
                not ff.strategy.pipeline:  # stages capture on their own
            fails.append(f"{captures} captures")
        if args.device == "cuda" and not line["nccl_kernels"]:
            fails.append("no NCCL kernel in a replay")
        if fails:
            raise SystemExit(f"mesh_multigpu {name} rank {rank}: {fails}")
        del ff, params
        if args.device == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    if table is SEARCH_STRATEGIES and rank == 0:
        sims = simulated_plans(args, device, world)
        for name, ms in sims.items():
            got = out["strategies"][name]
            got["sim_ms"] = ms
            print(f"search {name}: measured p50 {got['p50_ms']:.3f} ms, "
                  f"simulated (the search's best plan on that mesh, or "
                  f"that pipeline grid) {ms:.3f} ms: simulated / measured "
                  f"{ms / got['p50_ms']:.3f} [{card}]", flush=True)
        s = out["strategies"]["searched"]
        print(f"search searched: measured p50 {s['p50_ms']:.3f} ms, "
              f"simulated {s['search']['sim_ms']:.3f} ms: simulated / "
              f"measured {s['search']['sim_ms'] / s['p50_ms']:.3f}; "
              f"measured order "
              f"{sorted(out['strategies'], key=lambda k: out['strategies'][k]['p50_ms'])}"
              f" [{card}]", flush=True)
        if cuda:
            topo = subprocess.run(["nvidia-smi", "topo", "-m"],
                                  capture_output=True, text=True)
            out["topo"] = topo.stdout
            print(topo.stdout, flush=True)
    code = 0
    if table is SEARCH_STRATEGIES and rank == 0 and args.compute == "fp32":
        # in fp32 every plan sums in another order only, so each must train
        # inside the one-device runs' band (bf16 is not gated: its band,
        # from near-bitwise one-device reruns, is narrower than bf16's
        # rounding under another reduction order, and a pipeline stage
        # runs in fp32 there)
        out_of_band = [n for n, line in out["strategies"].items()
                       if not line["in_band"]]
        if out_of_band:
            print(f"mesh_multigpu search: outside the band of one device: "
                  f"{out_of_band}", flush=True)
            code = 1
    finish(args, rank, out, code)


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
        # the fit's peak above the compiled model's state
        base = memory_base(device) if cuda else None
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
                    want=want, captures=tr.captures,
                    busy_ms=prof.get("busy_ms"),
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
        if res is not None:
            line["search"] = line_search
        line["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            print(f"pipeline {name} ({sched}, pp={pp} dp={dp} v={v}, "
                  f"{n_micro} microbatches): p50 {r['p50_ms']:.3f} ms (one "
                  f"device {ref[0]['p50_ms']:.3f}), "
                  f"{line['samples_per_s']:.1f} samples/s; busy share a "
                  f"rank {[round(q, 4) for q in line.get('busy_share', [])]}"
                  f", outside NCCL "
                  f"{[round(q, 4) for q in line.get('compute_share', [])]}"
                  f"; stages {'eager' if args.eager_stages else 'captured'}"
                  f", captures a rank {[q['captures'] for q in ranks]}"
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


def _crcs(params) -> dict:
    import zlib

    return {f"{n}/{w}": zlib.crc32(np.ascontiguousarray(a).tobytes())
            for n, ws in params.items() for w, a in ws.items()}


def ckpt(args) -> None:
    """A sharded save and restore at each layout of ``CKPT_STRATEGIES``:
    each rank's bytes written, seconds and GB/s, the restore's seconds,
    and the restored params bitwise the saved ones. The dp = 4 one stays
    in ``--ref-dir`` with the saved params' crc32s for ``ckpt_one``."""
    import shutil

    import torch
    import torch.distributed as dist

    from flexflow_tpu_torch.execution.checkpoint import (
        TREES, restore_checkpoint, save_checkpoint, written_bytes)

    device, rank, world, card = join(args)
    cuda = args.device == "cuda"
    out = {"card": card, "world": world, "ckpt": {}}
    for name, (kind, a, b) in CKPT_STRATEGIES.items():
        fn = strategy_fn(kind, a, b)
        ff, x, y = build(args, device, fn)
        ff.fit([x[:2 * ff.config.batch_size]], y[:2 * ff.config.batch_size],
               epochs=1)
        saved = ff.get_params_numpy()
        d = os.path.join(args.ref_dir, f"ckpt_{name}")
        if rank == 0 and os.path.isdir(d):
            shutil.rmtree(d)
        dist.barrier()
        nbytes = written_bytes(ff, {t: getattr(ff, t) for t in TREES})
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        path = save_checkpoint(ff, d, step=2)
        save_s = time.perf_counter() - t0
        back, _x, _y = build(args, device, fn)
        dist.barrier()
        t0 = time.perf_counter()
        restore_checkpoint(back, path)
        if cuda:
            torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        got = back.get_params_numpy()
        same = all(np.array_equal(saved[n][w], got[n][w])
                   for n in saved for w in saved[n])
        ranks = [None] * world
        dist.all_gather_object(ranks, dict(
            rank=rank, bytes=nbytes, save_s=save_s, restore_s=restore_s,
            gb_per_s=nbytes / save_s / 1e9 if nbytes else 0.0, same=same))
        total = sum(q["bytes"] for q in ranks)
        if rank == 0:
            print(f"ckpt {name} {ff.mesh.shape}: {total / 1e9:.3f} GB in "
                  f"all; a rank's bytes {[q['bytes'] for q in ranks]}, save "
                  f"s {[round(q['save_s'], 3) for q in ranks]}, GB/s "
                  f"{[round(q['gb_per_s'], 3) for q in ranks]}, restore s "
                  f"{[round(q['restore_s'], 3) for q in ranks]}, restored "
                  f"params bitwise on every rank: "
                  f"{all(q['same'] for q in ranks)} [{card}]", flush=True)
            out["ckpt"][name] = dict(ranks=ranks, total_bytes=total,
                                     path=path)
            if name == "dp4":
                with open(os.path.join(args.ref_dir, "ckpt_dp4.json"),
                          "w") as f:
                    json.dump(dict(path=path, crcs=_crcs(saved)), f)
        if not all(q["same"] for q in ranks):
            raise SystemExit(f"mesh_multigpu ckpt {name}: a restore is not "
                             "bitwise the saved params")
        del ff, back
        if cuda:
            torch.cuda.empty_cache()
        dist.barrier()
    finish(args, rank, out)


def ckpt_one(args) -> None:
    """The dp = 4 checkpoint of ``--suite ckpt`` restored onto one card
    (host-staged): its seconds and the params' crc32s against the saved
    ones."""
    import torch

    from flexflow_tpu_torch.execution.checkpoint import restore_checkpoint

    device = torch.device(args.device)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0] if args.device == "cuda" else "cpu"
    with open(os.path.join(args.ref_dir, "ckpt_dp4.json")) as f:
        ref = json.load(f)
    ff, _x, _y = build(args, device)
    t0 = time.perf_counter()
    restore_checkpoint(ff, ref["path"])
    if args.device == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = _crcs(ff.get_params_numpy()) == ref["crcs"]
    print(f"ckpt dp4 -> one device: restore {secs:.3f} s, params bitwise "
          f"the dp = 4 ranks' saved ones: {same} [{card}]", flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "ckpt_one": dict(restore_s=secs,
                                                  same=same)}, f)
    if not same:
        raise SystemExit("mesh_multigpu ckpt_one: not bitwise")


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
    ff.profile_operators(0)  # --profiling here is the steps' walls
    x, y = cs.train_data("gpt2", cfg, cfg.batch_size * args.steps)
    base = memory_base(device) if cuda else None
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
        {"strategies": mesh, "pipeline": pipeline, "c8": c8,
         "fsdp": lambda a: mesh(a, FSDP_STRATEGIES), "ckpt": ckpt,
         "search": lambda a: mesh(a, SEARCH_STRATEGIES),
         "ckpt_one": ckpt_one}[a.suite](a)
