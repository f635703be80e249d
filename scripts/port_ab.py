#!/usr/bin/env python3
"""Same-call A/B of the PyTorch port's kernels between checkouts.

    python3 scripts/port_ab.py [--step] ROOT [ROOT ...]

Give the parent's checkout (unpacked with ``git archive``) and the change's
in alternation, e.g. ``parent . . parent``: two versions are compared only
inside one run on one card, in turns. Every checkout's kernels are first
built at once (one process a checkout, each into its own
``kernels/_build/``). Then for each ROOT in order, a fresh process imports
that checkout's ``chip_smoke.py`` and ``flexflow_tpu_torch`` and times, on
one NVIDIA GPU, through the smoke's own kernel phases (CUDA-graph
replays, beside the same PyTorch library call):

* flash decode (B5), native and int8 pools, q in fp32 and bf16, at the
  smoke's decode shape (GPT-2 small: 8 slots, 12 heads, d 64, 16-key
  blocks, 32 a slot, keys 1..512), beside SDPA over the gathered keys;
* the row top-k (B7) at (8, 50304) fp32, k = 8 and 1, beside
  ``torch.topk``;
* the row softmax forward and backward (B6) at (4096, 50304), fp32 and
  bf16, beside ``torch.softmax`` and its backward;
* flash attention B1-B4 at the smoke's shapes (BERT-Large bf16 and fp32,
  GPT-2 small causal fp32 and bf16 at seq 512, fp32 and bf16 at seq
  16384), beside SDPA's forward and backward;
* with ``--step``, the p50 of a GPT-2 small training step at seq 16384 in
  fp32 and in bf16 (2 warm-up and 3 timed steps each through
  ``FFModel.fit``: where the step is a captured program, its first step
  runs eagerly and its second is captured, so the timed ones replay).

Each run prints one ``ab <root> {json}`` line (µs; step in ms), and the
last line lists every figure by root in run order. It imports neither jax
nor flexflow_tpu and exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def one(root: str, step: bool) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}

    def put(key: str, r: dict) -> None:
        out[key + "_us"] = r["ms"] * 1e3
        if r.get("library_ms") is not None:
            out[key + "_lib_us"] = r["library_ms"] * 1e3

    for int8 in (False, True):
        for dname, r in cs.kernel_phase(dev, "", int8=int8).items():
            put(f"b5_{'int8' if int8 else 'native'}_{dname}", r)
    for k, r in cs.topk_kernel_phase(dev, "").items():
        put(f"b7_k{k}", r)
    for (kernel, dname), r in cs.softmax_kernel_phase(dev, "").items():
        put(f"b6_{kernel}_{dname}", r)
    for (kernel, shape, dname), r in cs.fa_kernel_phase(dev, "").items():
        put(f"{kernel}_{shape}_{dname}", r)
    if step:
        for dname in ("fp32", "bf16"):
            r = cs.train_phase(dev, "", "gpt2", dname, steps=3, warmup=2,
                               seq=cs.LONG_SEQ, batch=1, check_grads=False)
            out[f"step_s16384_{dname}_p50_ms"] = r["p50_ms"]
    return out


def build(roots) -> None:
    """Build every checkout's kernels at once, one process a checkout."""
    code = "from flexflow_tpu_torch.kernels import build_all; build_all()"
    procs = [(root, subprocess.Popen([sys.executable, "-c", code],
                                     cwd=os.path.abspath(root),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for root in dict.fromkeys(roots)]
    for root, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"port_ab: build of {root} failed:\n{log[-3000:]}")


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        res = one(args[1], "--step" in args[2:])
        print(f"ab {args[1]} {json.dumps(res)}", flush=True)
        return
    step = "--step" in args
    roots = [a for a in args if a != "--step"]
    if not roots:
        sys.exit(__doc__)
    build(roots)
    runs = []
    for root in roots:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        proc = subprocess.run(cmd + (["--step"] if step else []),
                              capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("ab ")]
        if proc.returncode != 0 or not lines:
            sys.exit(f"port_ab: {root} failed (exit {proc.returncode}):\n"
                     f"{proc.stderr[-3000:]}")
        print(lines[-1], flush=True)
        runs.append((root, json.loads(lines[-1].split(" ", 2)[2])))
    table = {k: [[root, round(r[k], 2) if k in r else None]
                 for root, r in runs]
             for k in runs[0][1]}
    print(json.dumps(table), flush=True)


if __name__ == "__main__":
    main()
