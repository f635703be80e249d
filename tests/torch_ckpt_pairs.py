"""Spawned gloo ranks for the port's tests of sharded checkpoints, the
guarded step across ranks and weights over the data axis
(tests/test_torch_mesh_checkpoint.py, test_torch_mesh_resilience.py,
test_torch_fsdp.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone; the
test process writes weights and data as ``.npz`` files, runs the JAX
references and spawns the ranks once per module through
``tests/torch_dist_pairs.py``. Cases (``CASES``):

* ``ckpt_rt``: ``fit``, ``save_checkpoint``, a fresh model restored from
  it; both models' params, then both after one more step;
* ``ckpt_restore``: a fresh model restored from ``io["path"]`` (written
  on another topology); its params;
* ``pipe_rt``: the same round trip on a pipeline strategy (pp 2);
* ``pipe_refuse``: a pipeline ``fit`` with each checkpoint flag, which
  raises, naming it;
* ``resilient``: ``fit`` with this rank's chaos plan and the resilience
  flags of ``args``; its params, ``_preempted_at_step``, the session's
  counters, the learning rate, and the error it raised; with ``resume``
  a second model resumes from the checkpoints (``--resume auto``); with
  ``fail_restore`` ({rank: checkpoint name}) that rank's first restore of
  that checkpoint fails with a read error, and each rank counts the
  checksum passes its session made;
* ``fsdp``: ``fit`` under ``io["strategy"]`` (a JSON file with weights
  split over the data axis, through ``--import-strategy``); the losses,
  params, local shapes of params and moments, one eager step's
  collectives with the flat all-reduce's sizes, and how many of that
  step's forward-gathered weights were still alive when its backward
  reduce-scattered the first grad.
"""
import os

import numpy as np

import torch_dist_pairs as tp

BATCH = 8


def small(strategy, **config):
    """``tests/test_resilience.py``'s model (dense 16 -> 32 -> relu -> 10,
    SGD 0.05, batch 8) under ``strategy`` (a torch_dist_pairs name, or a
    pipeline ``pp:<pp>``, whose model has a third dense layer)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    c = ft.FFConfig()
    c.batch_size = BATCH
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    x = ff.create_tensor((BATCH, 16), name="x")
    t = ff.relu(ff.dense(x, 32, name="d1"))
    fn = tp._strategy(strategy) if strategy and \
        not strategy.startswith("pp:") else None
    if strategy and strategy.startswith("pp:"):
        import torch.distributed as dist

        pp = int(strategy.split(":")[1])
        t = ff.relu(ff.dense(t, 32, name="d2"))
        ff.dense(t, 10, name="d3")

        def fn(pcg):
            s = data_parallel_strategy(pcg, dist.get_world_size())
            s.pipeline = (pp, 1, 2)
            return s
    else:
        ff.dense(t, 10, name="d2")
    ff.compile(optimizer=ft.SGDOptimizer(None, lr=0.05),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=fn)
    return ff


def model_of(args):
    """The case's model: ``small`` or a ``torch_dist_pairs.build`` one."""
    args = dict(args)
    if args["model"] == "small":
        del args["model"]
        return small(args.pop("strategy", None), **args)
    return tp.build(**args)


def _case_ckpt_rt(args, io):
    from flexflow_tpu_torch.execution.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)

    a = model_of(args)
    a.set_params_numpy(tp.unflat("w", io))
    a.fit(io["x"], io["y"], shuffle=False)
    path = save_checkpoint(a, str(io["path"]), step=8,
                           train_state={"step": 8, "epoch": 1,
                                        "batch_in_epoch": 0,
                                        "rng_counter": a._rng_counter})
    b = model_of(args)
    step = restore_checkpoint(b, path)
    out = {"step": np.int64(step), **tp.flat("a", a.get_params_numpy()),
           **tp.flat("b", b.get_params_numpy()),
           "local": np.array([f"{n}/{w}:{tuple(t.shape)}"
                              for n, ws in b.params.items()
                              for w, t in ws.items()])}
    for ff in (a, b):
        ff.fit(io["x"][:BATCH], io["y"][:BATCH], shuffle=False)
    out.update(tp.flat("a2", a.get_params_numpy()))
    out.update(tp.flat("b2", b.get_params_numpy()))
    return out


def _case_ckpt_restore(args, io):
    from flexflow_tpu_torch.execution.checkpoint import restore_checkpoint

    ff = model_of(args)
    step = restore_checkpoint(ff, str(io["path"]))
    return {"step": np.int64(step), **tp.flat("p", ff.get_params_numpy())}


def _case_pipe_rt(args, io):
    from flexflow_tpu_torch.execution.checkpoint import (restore_checkpoint,
                                                         save_checkpoint)

    a = model_of(args)
    a.set_params_numpy(tp.unflat("w", io))
    a.fit(io["x"], io["y"], epochs=1, shuffle=False)
    path = save_checkpoint(a, str(io["path"]), step=8)
    saved = a.get_params_numpy()
    b = model_of(args)
    restore_checkpoint(b, path)
    out = {**tp.flat("saved", saved), **tp.flat("b", b.get_params_numpy())}
    for ff in (a, b):
        ff.fit(io["x"], io["y"], epochs=1, shuffle=False)
    out.update(tp.flat("a2", a.get_params_numpy()))
    out.update(tp.flat("b2", b.get_params_numpy()))
    return out


def _case_pipe_refuse(args, io):
    """``fit`` on a pipeline strategy with each checkpoint flag: the
    messages of the refusals (a kept deviation: the JAX package ignores
    the flags there)."""
    out = {}
    # an explicit checkpoint path: ``--resume auto`` with no checkpoint
    # directory is refused at compile (``preflight_config``), before fit
    for field, value in (("checkpoint_dir", "never_written"),
                         ("resume", "never_written/step_1"),
                         ("max_bad_steps", 1)):
        ff = model_of(dict(args, **{field: value}))
        try:
            ff.fit(io["x"], io["y"])
        except NotImplementedError as e:
            out[field] = np.array(str(e))
    return out


def _case_resilient(args, io):
    import torch.distributed as dist

    from flexflow_tpu_torch.resilience import ChaosPlan, corrupt_checkpoint

    args = dict(args)
    rank = dist.get_rank()
    plans = args.pop("chaos", {})
    resume = args.pop("resume", False)
    corrupt = args.pop("corrupt_latest", None)
    fail = args.pop("fail_restore", {}).get(rank)
    epochs = args.pop("epochs", 2)
    ckpt = os.path.join(str(io["root"]), args.pop("dir"))
    keys = ("checkpoint_dir", "checkpoint_every", "max_bad_steps",
            "max_rollbacks")
    flags = {k: args.pop(k) for k in keys if k in args}
    if "checkpoint_every" in flags:
        flags["checkpoint_dir"] = ckpt
    out = {}
    ff = model_of(dict(args, **flags))
    ff.set_params_numpy(tp.unflat("w", io))
    plan = plans.get(rank)
    chaos = ChaosPlan(**plan) if plan is not None else None
    from flexflow_tpu_torch.resilience import session as rs

    orig = rs.restore_checkpoint, rs.verify_checkpoint
    checksums = []

    def restore(model, path, **kw):
        if fail is not None and os.path.basename(path) == fail:
            rs.restore_checkpoint = orig[0]  # once
            raise OSError(5, "Input/output error", path)
        return orig[0](model, path, **kw)

    def verify(path):
        checksums.append(path)
        return orig[1](path)

    rs.restore_checkpoint, rs.verify_checkpoint = restore, verify
    try:
        ff.fit(io["x"], io["y"], epochs=epochs, chaos=chaos)
    except RuntimeError as e:
        out["error"] = np.array(str(e))
    finally:
        rs.restore_checkpoint, rs.verify_checkpoint = orig
    out["checksums"] = np.int64(len(checksums))
    from flexflow_tpu_torch.execution.checkpoint import latest_checkpoint

    out["latest"] = np.array(os.path.basename(latest_checkpoint(ckpt) or ""))
    out["preempted_at"] = np.int64(ff._preempted_at_step or -1)
    out["lr"] = np.float64(ff.optimizer.lr)
    if ff.resilience is not None:
        out.update({f"res/{k}": np.int64(v)
                    for k, v in ff.resilience.summary().items()})
    out.update(tp.flat("p", ff.get_params_numpy()))
    if corrupt is not None:
        if rank == 0:
            corrupt_checkpoint(os.path.join(ckpt, corrupt), mode="flip")
        dist.barrier()
    if resume:
        r = resume if isinstance(resume, dict) else {}
        rflags = dict(flags, checkpoint_dir=ckpt, resume="auto",
                      **r.get("flags", {}))
        ffr = model_of(dict(args, **rflags))
        ffr.set_params_numpy(tp.unflat("w", io))
        rplan = r.get("chaos", {}).get(rank)
        ffr.fit(io["x"], io["y"], epochs=r.get("epochs", epochs),
                chaos=ChaosPlan(**rplan) if rplan is not None else None)
        out.update(tp.flat("r", ffr.get_params_numpy()))
        out.update({f"rres/{k}": np.int64(v)
                    for k, v in ffr.resilience.summary().items()})
    return out


def _case_plain_agreements(args, io):
    """A fit with every resilience feature off: how many host agreements
    and verdict reductions it made (none is the law)."""
    from flexflow_tpu_torch.parallel import mesh as pm

    calls = {"agree": 0, "any_rank": 0}
    orig = pm.agree, pm.any_rank

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    from flexflow_tpu_torch.resilience import session as rs

    pm.agree, pm.any_rank = count("agree", orig[0]), count("any_rank",
                                                           orig[1])
    rs.agree, rs.any_rank = pm.agree, pm.any_rank
    try:
        ff = model_of(args)
        ff.set_params_numpy(tp.unflat("w", io))
        ff.fit(io["x"], io["y"], epochs=1)
    finally:
        pm.agree, pm.any_rank = orig
        rs.agree, rs.any_rank = orig
    return {"agree": np.int64(calls["agree"]),
            "any_rank": np.int64(calls["any_rank"]),
            "session": np.array(ff.resilience is None)}


def _case_fsdp(args, io):
    import weakref

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch.parallel import spmd

    args = dict(args)
    if args.pop("import_strategy", False):
        args["import_strategy_file"] = str(io["strategy"])
    ff = model_of(args)
    ff.set_params_numpy(tp.unflat("w", io))
    ex = ff.executor
    xs, ys = ex.local_batch([io["x"][:BATCH],
                             ff._prep_label(io["y"][:BATCH])])
    sizes = []
    orig = ex._all_reduce_groups

    def seen(buf, axes):
        sizes.append(buf.numel())
        return orig(buf, axes)

    ex._all_reduce_groups = seen
    gathered, alive = [], []
    gather, scatter = spmd.gather_weight, spmd._reduce_scatter

    def gather_seen(*a, **kw):
        out = gather(*a, **kw)
        gathered.append(weakref.ref(out))
        return out

    def scatter_seen(*a, **kw):
        if not alive:  # the backward's first: every forward gather is done
            alive.append(sum(r() is not None for r in gathered))
        return scatter(*a, **kw)

    spmd.gather_weight, spmd._reduce_scatter = gather_seen, scatter_seen
    try:
        with CommDebugMode() as comm:
            ex.loss_and_grads(ff.params, [torch.tensor(xs)],
                              torch.tensor(ys))
    finally:
        del ex._all_reduce_groups
        spmd.gather_weight, spmd._reduce_scatter = gather, scatter
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    local = {f"{n}/{w}": tuple(t.shape) for n, ws in ff.params.items()
             for w, t in ws.items()}
    moments = {f"{n}/{w}": tuple(t.shape)
               for n, ws in ff.opt_state["m"].items()
               for w, t in ws.items()} if "m" in ff.opt_state else {}
    ff.fit(io["x"], io["y"], shuffle=False)
    return {"losses": np.array(ff.fit_history.loss),
            **tp.flat("p", ff.get_params_numpy()),
            "kinds": np.array(sorted(counts)),
            "counts": np.array([counts[k] for k in sorted(counts)]),
            "reduced": np.array(sizes, dtype=np.int64),
            "fwd_gathers": np.int64(len(gathered)),
            "alive_at_backward": np.int64(alive[0] if alive else -1),
            "local": np.array([f"{k}:{v}" for k, v in sorted(local.items())]),
            "moments": np.array([f"{k}:{v}"
                                 for k, v in sorted(moments.items())])}


CASES = {"ckpt_rt": _case_ckpt_rt, "ckpt_restore": _case_ckpt_restore,
         "pipe_rt": _case_pipe_rt, "pipe_refuse": _case_pipe_refuse,
         "resilient": _case_resilient,
         "plain_agreements": _case_plain_agreements, "fsdp": _case_fsdp,
         **tp.CASES}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)


def start(world: int, root: str, cases):
    return tp.start(world, root, cases, main=rank_main)


def fsdp_strategy(pcg, dp: int):
    """Data parallelism at ``dp`` with every weight of two or more dims
    whose first dim ``dp`` divides split over the data axis on that dim
    (ZeRO-3 / FSDP); biases and norms stay replicated. Either package's
    ``data_parallel_strategy`` and PCG (the rule reads shapes only)."""
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    s = data_parallel_strategy(pcg, dp)
    for node in pcg.compute_nodes():
        ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        for w, (shape, _d, _i) in node.op.weight_specs(ins).items():
            if len(shape) >= 2 and shape[0] % dp == 0:
                s.for_node(node.guid).weight_specs[w] = \
                    ("data",) + (None,) * (len(shape) - 1)
    return s
