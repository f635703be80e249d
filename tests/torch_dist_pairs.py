"""Spawned gloo ranks for the port's mesh tests (tests/test_torch_mesh_*.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone. The
test process (which has JAX) writes weights and data as ``.npz`` files,
:func:`spawn` starts ``world`` processes once per test module, each joins
a gloo group through a ``file://`` store under the test's tmp directory
and runs every case in order, and each rank writes its results as
``<case>_r<rank>.npz``. One thread a rank: the suite runs on a few
cores under several pytest-xdist workers.

Cases (``CASES``), each building the model on the CPU (``device="cpu"``):

* ``step``: one train step of a tiny model (the BERT proxy, the MoE MLP,
  two dense pairs, ...) under a strategy —
  loss, the full grads (gathered from the shards), the full params after
  the optimizer, and how ``wq`` is held;
* ``two_steps``: a step on the batch split over the data axis, then one
  on a batch that does not divide by it (run whole on every rank);
* ``fit``: ``fit`` over epochs with shuffling, then ``eval`` and
  ``predict``, on every rank;
* ``linear``: the column- then row-parallel dense pair's ``predict``;
* ``census``: the collectives of one step under ``CommDebugMode``;
* ``metrics``: ``eval`` (the accuracy counts), the eval step's loss and
  ``predict`` on every rank;
* ``refuse``: ``fit`` with a checkpoint directory on a mesh of several
  ranks, which saves (once refused), and a fresh model restored from it;
* ``flow``: no strategy, ``--only-data-parallel`` at the world size, a
  telemetry and a trace file named per rank: ``fit``, then ``eval`` over a
  set whose last batch does not divide by the data axis (it runs whole on
  every rank).
"""
import os
import traceback

import numpy as np


def _strategy(name: str):
    """strategy_fn for a case's strategy name."""
    from flexflow_tpu_torch.parallel.strategies import (
        expert_parallel_strategy, hybrid_data_tensor_strategy)
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    kind, *sizes = name.split(":")
    a, b = ([int(x) for x in sizes] + [1, 1])[:2]
    if kind == "dp":
        return lambda pcg: data_parallel_strategy(pcg, a)
    if kind == "hybrid":
        return lambda pcg: hybrid_data_tensor_strategy(pcg, dp=a, tp=b)
    if kind == "expert":
        return lambda pcg: expert_parallel_strategy(pcg, dp=a, ep=b)
    if kind == "fsdp":  # weights over the data axis (ZeRO-3 / FSDP)
        from torch_ckpt_pairs import fsdp_strategy

        return lambda pcg: fsdp_strategy(pcg, a)
    if kind == "pipe":  # a (pp, dp, 2 microbatches) grid over the world
        import torch.distributed as dist

        def pipe(pcg):
            s = data_parallel_strategy(pcg, dist.get_world_size())
            s.pipeline = (a, b, 2)
            return s
        return pipe
    if kind == "experts_op":  # the batched Experts op split by expert
        def fn(pcg):
            s = expert_parallel_strategy(pcg, dp=a, ep=b)
            for node in pcg.topo_order():
                if node.name.startswith("moe_experts"):
                    s.for_node(node.guid).weight_specs = {
                        "kernel": ("expert", None, None),
                        "bias": ("expert", None)}
            return s
        return fn
    raise ValueError(name)


# the tiny BERT's widths with one head: no head to shard, so a search
# that may shard the sequence does (tests/test_torch_search_gloo.py)
BERT_1HEAD = dict(seq_len=16, hidden=64, num_heads=1, num_layers=2,
                  intermediate=128)


def build(model: str, strategy, batch: int, *, dropout: float = 0.0,
          overlap: bool = False, optimizer: str = "adam", seed: int = 3,
          epochs: int = 1, remat: str = "none", **config):
    """The tiny model of a case in the port, compiled under ``strategy``
    (a strategy name, or None for one device). Both packages' test
    helpers build the same graph (tests/test_torch_mesh_*.py)."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.models.bert import BertConfig, build_bert
    from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2
    from flexflow_tpu_torch.models.transformer import build_moe_mlp

    c = ft.FFConfig()
    c.batch_size, c.seed, c.epochs = batch, seed, epochs
    c.collective_overlap = "on" if overlap else "off"
    c.remat = remat
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    if model == "bert":
        cfg = BertConfig.tiny(batch_size=batch)
        cfg.dropout = dropout
        build_bert(ff, cfg)
    elif model == "bert_1head":  # the tiny BERT with one attention head
        build_bert(ff, BertConfig(batch_size=batch, **BERT_1HEAD))
    elif model == "gpt2":  # the tiny LM, token-level targets
        _ids, logits = build_gpt2(ff, GPT2Config.tiny(batch_size=batch))
        ff.softmax(logits)
    elif model == "moe":
        build_moe_mlp(ff, batch_size=batch, in_dim=32, num_classes=4,
                      num_exp=4, num_select=2, expert_hidden=16)
    elif model == "moe_experts":  # moe through the batched Experts op
        x = ff.create_tensor((batch, 32), name="moe_input")
        t = ff.dense(x, 64, ft.ActiMode.AC_MODE_RELU)
        t = ff.moe_experts(t, num_exp=4, num_select=2,
                           expert_hidden_size=16)
        ff.softmax(ff.dense(t, 4))
    elif model == "linear":
        x = ff.create_tensor((batch, 32), name="lin_in")
        h = ff.dense(x, 64, ft.ActiMode.AC_MODE_RELU, use_bias=False,
                     name="col")
        ff.dense(h, 8, use_bias=False, name="row")
    elif model == "mlp":  # two column-then-row pairs: the second pair's
        # column layer sums its input's grad across the model axis
        t = ff.create_tensor((batch, 32), name="mlp_in")
        for i, (width, act) in enumerate(((64, ft.ActiMode.AC_MODE_RELU),
                                          (32, ft.ActiMode.AC_MODE_NONE),
                                          (64, ft.ActiMode.AC_MODE_RELU),
                                          (4, ft.ActiMode.AC_MODE_NONE))):
            t = ff.dense(t, width, act, name=f"fc{i}")
        ff.softmax(t)
    elif model == "reg":  # L2-regularized kernels, column then row split
        x = ff.create_tensor((batch, 32), name="reg_in")
        h = ff.dense(x, 64, ft.ActiMode.AC_MODE_RELU,
                     kernel_regularizer=("l2", 1e-2))
        ff.softmax(ff.dense(h, 4, kernel_regularizer=("l1", 1e-3)))
    elif model == "cnn":  # channel-out conv, then pooling sees it whole
        x = ff.create_tensor((batch, 3, 8, 8), name="img")
        t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, ft.ActiMode.AC_MODE_RELU)
        t = ff.flat(ff.pool2d(t, 2, 2, 2, 2, 0, 0))
        ff.softmax(ff.dense(t, 4))
    elif model == "emb":  # the vocab-sharded table, then an MLP
        ids = ff.create_tensor((batch, 4), dtype=ft.DataType.DT_INT32,
                               name="ids")
        t = ff.embedding(ids, 64, 16, ft.AggrMode.AGGR_MODE_SUM)
        t = ff.dense(t, 32, ft.ActiMode.AC_MODE_RELU)
        ff.softmax(ff.dense(t, 4))
    else:
        raise ValueError(model)
    opt = (ft.AdamOptimizer(None, alpha=1e-3) if optimizer == "adam"
           else ft.SGDOptimizer(None, lr=0.05))
    loss = (ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE
            if model == "linear"
            else ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    # the metrics read one class a sample, which token-level targets are not
    ff.compile(optimizer=opt, loss_type=loss,
               metrics=[] if model == "gpt2" else
               [ft.MetricsType.METRICS_ACCURACY],
               strategy_fn=_strategy(strategy) if strategy else None)
    return ff


def one_step(ff, x, y, rng_seed: int = 11):
    """(loss, full grads, full params after the update) of one train step
    of ``ff`` on the global batch (x, y): the port's train step body
    (``Executor.loss_and_grads``, then the optimizer) on this rank's slice
    of the batch; on a mesh the grads and params are gathered whole."""
    import torch

    ex = ff.executor
    xs, ys = ex.local_batch([x, ff._prep_label(y)])
    loss, logits, grads = ex.loss_and_grads(
        ff.params, [torch.tensor(xs)], torch.tensor(ys),
        torch.Generator().manual_seed(rng_seed))
    ff._seen_logits = tuple(logits.shape)
    full = {n: {w: ex.gather_param(n, w, g).numpy().copy()
                for w, g in ws.items()} for n, ws in grads.items()}
    ff.params, ff.opt_state = ff.optimizer.update(ff.params, grads,
                                                  ff.opt_state)
    return float(loss), full, ff.get_params_numpy()


def flat(prefix, tree):
    return {f"{prefix}/{n}/{w}": a for n, ws in tree.items()
            for w, a in ws.items()}


def unflat(prefix, d):
    out = {}
    for k, a in d.items():
        if k.startswith(prefix + "/"):
            _, n, w = k.split("/")
            out.setdefault(n, {})[w] = a
    return out


def _case_step(ff_args, io):
    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
    loss, grads, params = one_step(ff, io["x"], io["y"])
    out = {"loss": np.float64(loss), **flat("g", grads),
           **flat("p", params), "logits_shape": np.array(ff._seen_logits)}
    attn = [n for n in ff.params if "attn" in n]
    if attn:
        out["wq_local_shape"] = np.array(ff.params[attn[0]]["wq"].shape)
        out["wq_placement"] = np.array(
            str(ff.executor.param_shardings().get(attn[0], {}).get("wq")))
    return out


def _case_two_steps(ff_args, io):
    """A step on the batch split over the data axis, then one on a batch
    that does not divide by it (whole on every rank): each step's loss,
    grads and params."""
    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
    out = {}
    for i, rows in enumerate((len(io["x"]), len(io["x"]) - 1)):
        loss, grads, params = one_step(ff, io["x"][:rows], io["y"][:rows])
        out.update({f"loss{i}": np.float64(loss), **flat(f"g{i}", grads),
                    **flat(f"p{i}", params)})
    return out


def _case_fit(ff_args, io):
    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
    ff.fit(io["x"], io["y"])
    perf = ff.eval(io["x"], io["y"])
    pred = ff.predict(io["x"])
    return {"losses": np.array(ff.fit_history.loss),
            "train_all": np.int64(perf.train_all),
            "train_correct": np.int64(perf.train_correct),
            "pred": pred, **flat("p", ff.get_params_numpy())}


def _case_linear(ff_args, io):
    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
    return {"pred": ff.predict(io["x"]),
            "col_local": np.array(ff.params["col_0"]["kernel"].shape),
            "row_local": np.array(ff.params["row_1"]["kernel"].shape)}


def _case_census(ff_args, io):
    """The collectives of one train step: counts by kind, and the shapes
    of every all-gather's output."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from flexflow_tpu_torch.parallel import spmd

    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
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
            ex.loss_and_grads(ff.params, [torch.tensor(xs)],
                              torch.tensor(ys))
    finally:
        spmd._gather = gather
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return {"kinds": np.array(sorted(counts)),
            "counts": np.array([counts[k] for k in sorted(counts)]),
            "gathered": np.array(shapes, dtype=str)}


def _case_refuse(ff_args, io):
    """Once refused, now the positive case: ``fit`` with a checkpoint
    directory on the mesh saves sharded checkpoints, and a fresh model
    restored from the newest one holds the fit's params bit for bit."""
    from flexflow_tpu_torch.execution.checkpoint import (latest_checkpoint,
                                                         restore_checkpoint)

    ckpt = os.path.join(io["root"], "refuse_ckpt")
    ff = build(**ff_args, checkpoint_dir=ckpt, checkpoint_every=1)
    ff.set_params_numpy(unflat("w", io))
    ff.fit(io["x"], io["y"])
    path = latest_checkpoint(ckpt)
    back = build(**ff_args)
    step = restore_checkpoint(back, path)
    return {"step": np.int64(step), "saved": np.int64(ff.resilience.summary()
                                                      ["checkpoints_saved"]),
            **flat("a", ff.get_params_numpy()),
            **flat("b", back.get_params_numpy())}


def _case_flow(ff_args, io):
    import torch.distributed as dist

    from flexflow_tpu_torch import obs

    rank = dist.get_rank()
    files = [os.path.join(io["root"], f"{k}_r{rank}.json")
             for k in ("telemetry", "trace")]
    ff = build(**ff_args, only_data_parallel=True, telemetry_file=files[0],
               trace_file=files[1])
    try:
        ff.fit(io["x"], io["y"])
        perf = ff.eval(io["xe"], io["ye"])
    finally:
        obs.disable()
    return {"mesh": np.array(sorted(ff.mesh.shape.items()), dtype=object
                             ).astype(str),
            "losses": np.array(ff.fit_history.loss),
            "train_all": np.int64(perf.train_all),
            "train_correct": np.int64(perf.train_correct),
            "wrote": np.array([os.path.exists(f) for f in files])}


def _case_metrics(ff_args, io):
    """``eval``'s accuracy counts, the eval step's loss on the whole batch
    and ``predict``."""
    import torch

    ff = build(**ff_args)
    ff.set_params_numpy(unflat("w", io))
    perf = ff.eval(io["x"], io["y"])
    ex = ff.executor
    xs, ys = ex.local_batch([io["x"], ff._prep_label(io["y"])])
    loss, _m = ex.make_eval_step()(ff.params, [torch.tensor(xs)],
                                   torch.tensor(ys))
    return {"train_all": np.int64(perf.train_all),
            "train_correct": np.int64(perf.train_correct),
            "loss": np.float64(float(loss)),
            "pred": ff.predict(io["x"])}


CASES = {"step": _case_step, "metrics": _case_metrics,
         "two_steps": _case_two_steps, "flow": _case_flow, "fit": _case_fit, "linear": _case_linear,
         "census": _case_census, "refuse": _case_refuse}


def run_cases(rank: int, world: int, root: str, cases, registry) -> None:
    """A rank's body: join the gloo group, run each case of ``registry``
    in order, write its results; a failure leaves its traceback."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(root, 'pg')}",
            rank=rank, world_size=world)
        for name, kind, ff_args in cases:
            io = dict(np.load(os.path.join(root, f"{name}_in.npz")),
                      root=root)
            out = registry[kind](ff_args, io)
            np.savez(os.path.join(root, f"{name}_r{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(root, f"err_r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _rank_main(rank: int, world: int, root: str, cases) -> None:
    run_cases(rank, world, root, cases, CASES)


def start(world: int, root: str, cases, main=None):
    """Start ``cases`` ([(name, kind, build kwargs)], inputs in
    ``<root>/<name>_in.npz``) on ``world`` gloo ranks; :func:`finish`
    waits for them. The caller may work meanwhile (the references).
    ``main`` is the ranks' entry (another helper module's, with its own
    cases); this module's by default."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=main or _rank_main,
                         args=(r, world, root, cases))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def finish(procs, root: str, timeout: float = 120.0) -> None:
    """Join the ranks of :func:`start`; raise with the failing rank's
    traceback."""
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r, p in enumerate(procs):
        path = os.path.join(root, f"err_r{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errs.append(f"rank {r}:\n{f.read()}")
        elif p.exitcode != 0:
            errs.append(f"rank {r}: exit code {p.exitcode}")
    if errs:
        raise RuntimeError("\n".join(errs))


def spawn(world: int, root: str, cases, timeout: float = 120.0) -> None:
    """:func:`start` then :func:`finish`."""
    finish(start(world, root, cases), root, timeout)


def load(root: str, name: str, rank: int = 0):
    return dict(np.load(os.path.join(root, f"{name}_r{rank}.npz")))
