#!/usr/bin/env python3
"""Same-call A/B of the PyTorch port's redesigned kernels between checkouts.

    python3 scripts/port_ab.py [--step] ROOT [ROOT ...]

Give the parent's checkout (unpacked with ``git archive``) and the change's
in alternation, e.g. ``parent . . parent``: two versions are compared only
inside one run on one card, in turns. For each ROOT in order, a fresh
process imports that checkout's ``chip_smoke.py`` and
``flexflow_tpu_torch`` (its kernels build from its own sources into its
own ``kernels/_build/``) and times, on one NVIDIA GPU:

* flash decode (B5), native and int8 pools, q in fp32 and bf16, at
  ``chip_smoke.py``'s decode shape (GPT-2 small: 8 slots, 12 heads, d 64,
  16-key blocks, 32 a slot, keys 1..512), as CUDA-graph replays, beside
  SDPA over the gathered keys (``chip_smoke.kernel_phase``);
* the fp32 flash-attention forward (B1) at GPT-2 small's causal shapes,
  b8 h12 s512 and b1 h12 s16384 (d 64), as CUDA-graph replays, beside
  SDPA's forward;
* with ``--step``, the p50 of a GPT-2 small fp32 training step at seq
  16384 (1 warm-up and 3 timed steps through ``FFModel.fit``).

Each run prints one ``ab <root> {json}`` line (µs; step in ms), and the
last line lists every figure by root in run order. It imports neither jax
nor flexflow_tpu and exits 1 without a CUDA device.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys


def one(root: str, step: bool) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from flexflow_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {}
    for int8 in (False, True):
        for dname, r in cs.kernel_phase(dev, "", int8=int8).items():
            key = f"b5_{'int8' if int8 else 'native'}_{dname}"
            out[key + "_us"] = r["ms"] * 1e3
            out[key + "_sdpa_us"] = r["library_ms"] * 1e3
    for name in ("gpt2", "long"):
        sh = cs.FA_SHAPES[name]
        q, k, v, _ = cs.fa_inputs(sh, torch.float32, dev)
        q = q * (1.0 / math.sqrt(sh["d"]))
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], device=dev)
        iters = 3 if sh["sq"] > 4096 else 20
        causal = sh["causal"]
        out[f"b1_fp32_{name}_us"] = 1e3 * cs.time_ms(
            lambda i: fa._launch_fwd(q, k, v, o, lse, causal, 0.0, 0), iters,
            dev, graph=True)
        out[f"b1_fp32_{name}_sdpa_us"] = 1e3 * cs.time_ms(
            lambda i: F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=causal,
                                                     scale=1.0),
            iters, dev, graph=True)
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    if step:
        r = cs.train_phase(dev, "", "gpt2", "fp32", steps=3, warmup=1,
                           seq=cs.LONG_SEQ, batch=1, check_grads=False)
        out["step_s16384_fp32_p50_ms"] = r["p50_ms"]
    return out


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
    table = {k: [[root, round(r[k], 2)] for root, r in runs]
             for k in runs[0][1]}
    print(json.dumps(table), flush=True)


if __name__ == "__main__":
    main()
