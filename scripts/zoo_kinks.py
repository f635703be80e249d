#!/usr/bin/env python3
"""How far two correct fp32 runs of a zoo model's training step can
differ: the port's CPU path in fp32 against the same path in float64.

    python3 scripts/zoo_kinks.py [MODEL ...]

MODEL is one of alexnet, resnet50, inception_v3, resnext50, dlrm (all by
default): the model of ``chip_smoke.py``'s zoo phase at its published
widths, at the batch of its card-against-CPU gate (2; DLRM 64), with the
smoke's weights and batch. For each it prints the ReLU outputs that are 0
in one run and not in the other (a pre-activation within fp32 rounding of
the kink, where that element's grad moves whole), the loss in both, and
the worst per-tensor and the overall relative norm error of the fp32
grads against the float64 ones (the biases of convolutions that feed
batch norms only, whose exact grad is zero, count in the overall figure
alone). It runs on the CPU, imports neither jax nor flexflow_tpu, and
takes a few seconds a model.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def step(ff, xs, y, dtype):
    """(loss, grads, every node's outputs by name) of one training step of
    ``ff``'s graph with its params and inputs in ``dtype``."""
    import torch

    from flexflow_tpu_torch.execution.losses import loss_value
    from flexflow_tpu_torch.ops.base import OpContext

    ex = ff.executor
    params = {n: {w: t.to(dtype).requires_grad_(True)
                  for w, t in ws.items()} for n, ws in ff.params.items()}
    ins = [torch.from_numpy(a).to(dtype) if a.dtype.kind == "f"
           else torch.from_numpy(a) for a in xs]
    values = ex.forward_outputs(params, ex._bind_inputs(ins),
                                OpContext(training=True,
                                          device=torch.device("cpu")))
    loss = loss_value(ex.loss_type, values[ex.final_guid][0],
                      torch.from_numpy(ff._prep_label(y)))
    leaves = [t for ws in params.values() for t in ws.values()]
    grads = iter(torch.autograd.grad(loss, leaves))
    return (float(loss.detach()),
            {n: {w: next(grads) for w in ws} for n, ws in params.items()},
            {ff.pcg.nodes[g].name: [v.detach() for v in vs]
             for g, vs in values.items()})


def main() -> None:
    import torch

    import chip_smoke as cs

    models = sys.argv[1:] or ["alexnet", "resnet50", "inception_v3",
                              "resnext50", "dlrm"]
    for kind in models:
        batch = cs.ZOO_CPU_BATCH.get(kind, 2)
        ff = cs.zoo_model(kind, "fp32", torch.device("cpu"), batch)
        xs, y = cs.zoo_data(ff, batch, seed=cs.SEED + 1)
        l32, g32, v32 = step(ff, xs, y, torch.float32)
        l64, g64, v64 = step(ff, xs, y, torch.float64)
        flips, total = cs.relu_side_flips(v32, v64)
        worst, where, overall = cs.grad_errors(g32, g64,
                                               cs.shift_free_biases(ff))
        print(f"{kind} batch {batch}: ReLU outputs on opposite sides of 0 "
              f"{flips} of {total}; loss fp32 {l32!r}, float64 {l64!r}; "
              f"fp32 grads against float64: worst relative norm error "
              f"{worst:.3g} ({where}), all grads {overall:.3g}", flush=True)


if __name__ == "__main__":
    main()
