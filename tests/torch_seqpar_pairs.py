"""Spawned gloo ranks for the port's sequence-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_long_context.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone
(``torch_dist_pairs`` spawns them and builds the models). Cases:

* ``attn``: ``ring_attention`` or ``ulysses_attention`` on a (data, seq)
  mesh: each rank takes its block of q, k and v (its rows of the batch, its
  positions of the sequence), runs the schedule and its backward against
  its block of a fixed cotangent, and writes its output and grads with its
  mesh coordinates;
* ``step``: one train step of a tiny model under ``long_context_strategy``
  (``torch_dist_pairs.one_step``: loss, grads and params gathered whole);
* ``census``: the collectives of one train step under ``CommDebugMode``,
  the shape of every all-gather's output, and the point-to-point messages
  the ring posts (``batch_isend_irecv``, which the census does not see);
  then the all-gathers of one whole train step
  (``make_train_step(capture=False)``: the loss, the grads, the metrics
  and the optimizer).
"""
import numpy as np

import torch_dist_pairs as tp


def _case_attn(args, io):
    import torch

    from flexflow_tpu_torch.kernels.ring_attention import (SeqGroup,
                                                           ring_attention)
    from flexflow_tpu_torch.kernels.ulysses_attention import \
        ulysses_attention
    from flexflow_tpu_torch.parallel.mesh import build_mesh

    dp, sp = args["dp"], args["sp"]
    mesh = build_mesh(mesh_shape=(dp, sp), axis_names=("data", "seq"),
                      device_type="cpu")
    dc, sc = mesh.coords
    b, h, s, _d = io["q"].shape
    bl, sl = b // dp, s // sp

    def block(name, grad=True):
        t = torch.tensor(io[name][dc * bl:(dc + 1) * bl, :,
                                  sc * sl:(sc + 1) * sl]).contiguous()
        return t.requires_grad_(grad)

    q, k, v = block("q"), block("k"), block("v")
    sg = SeqGroup.of(mesh.groups[1], sp, sc)
    fn = ring_attention if args["mode"] == "ring" else ulysses_attention
    out = fn(q, k, v, sg, args["causal"], dropout=args["dropout"],
             seed=args["seed"], shard=(dc * bl, 0, h))
    out.backward(block("w", grad=False))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy(),
            "coords": np.array([dc, sc])}


def _case_step(args, io):
    ff = tp.build(**args)
    ff.set_params_numpy(tp.unflat("w", io))
    loss, grads, params = tp.one_step(ff, io["x"], io["y"])
    return {"loss": np.float64(loss), **tp.flat("g", grads),
            **tp.flat("p", params),
            "logits_shape": np.array(ff._seen_logits)}


def _case_census(args, io):
    import torch.distributed as dist

    sends = []
    batch = dist.batch_isend_irecv

    def counted(ops):
        sends.extend(op for op in ops if op.op is dist.isend)
        return batch(ops)

    dist.batch_isend_irecv = counted
    try:
        out = tp.CASES["census"](args, io)
    finally:
        dist.batch_isend_irecv = batch
    out["p2p_sends"] = np.int64(len(sends))
    out.update(_step_gathers(args, io))
    return out


def _step_gathers(args, io):
    """The shape of every all-gather's output in one whole train step, and
    the all-gathers ``CommDebugMode`` counts there."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch.parallel import spmd

    ff = tp.build(**args)
    ff.set_params_numpy(tp.unflat("w", io))
    ex = ff.executor
    xs, ys = ex.local_batch([io["x"], ff._prep_label(io["y"])])
    shapes = []
    gather = spmd._gather

    def seen(x, dim, group, n):
        out = gather(x, dim, group, n)
        shapes.append(",".join(str(d) for d in out.shape))
        return out

    spmd._gather = seen
    try:
        with CommDebugMode() as comm:
            ex.make_train_step(capture=False)(
                ff.params, ff.opt_state, [torch.tensor(xs)],
                torch.tensor(ys), torch.Generator().manual_seed(11))
    finally:
        spmd._gather = gather
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return {"step_gathered": np.array(shapes, dtype=str),
            "step_allgathers": np.int64(
                counts.get("c10d._allgather_base_", 0))}


CASES = {"attn": _case_attn, "step": _case_step, "census": _case_census,
         "metrics": tp.CASES["metrics"]}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)
