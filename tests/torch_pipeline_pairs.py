"""Spawned gloo ranks for the port's pipeline tests
(tests/test_torch_pipeline*.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone (the
test process, which has JAX, writes weights and data as ``.npz`` files and
runs the JAX references; ``tests/torch_dist_pairs.py`` spawns the ranks
once per test module). Models, each built on the CPU (``device="cpu"``) by
both packages' twins (:func:`build` here, the tests' ``jax_build``):

* ``mlp``: ``tests/test_pipeline.py``'s three dense layers and softmax;
* ``bert``: the tiny BERT proxy;
* ``gpt2``: the tiny GPT-2 LM with a softmax head (its position ids are
  a constant baked for the whole batch, cut to a microbatch in a stage);
* ``skip``: dense layers with a residual from the first to the fifth, so
  at pp 4 the first stage feeds the third as well as the second.

Cases (``CASES``):

* ``train``: ``PipelineTrainer`` on the grid, the weights loaded, ``steps``
  steps: the losses, the params after each step, the host-to-device
  copies and the most (microbatch, chunk) entries held at once;
* ``compile_fit``: ``compile(strategy_fn=)`` with a pipeline grid, then
  ``eval``, ``fit``, ``eval`` and ``predict``; the params on every rank;
* ``refuse``: ``fit(chaos=)`` and the checkpoint flags on a pipeline
  strategy; the messages;
* ``spans``: one ``train_step`` under the process tracer: each
  ``pipeline_fwd`` / ``pipeline_bwd`` span's (micro, stage, device,
  schedule).
"""
import numpy as np

import torch_dist_pairs as tp

BATCH = 16


def build(model: str, batch: int = BATCH, seed: int = 3, **config):
    """The model of a case in the port, uncompiled."""
    import flexflow_tpu_torch as ft

    c = ft.FFConfig()
    c.batch_size, c.seed = batch, seed
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    if model == "mlp":
        x = ff.create_tensor((batch, 16), name="x")
        t = ff.relu(ff.dense(x, 32, name="d1"))
        t = ff.relu(ff.dense(t, 32, name="d2"))
        ff.softmax(ff.dense(t, 10, name="d3"))
    elif model == "skip":
        x = ff.create_tensor((batch, 16), name="x")
        t1 = t = ff.dense(x, 32, name="s1")
        for i in range(3):
            t = ff.dense(ff.relu(t), 32, name=f"m{i}")
        ff.softmax(ff.dense(ff.add(t, t1), 10, name="out"))
    elif model == "bert":
        from flexflow_tpu_torch.models.bert import BertConfig, build_bert

        build_bert(ff, BertConfig.tiny(batch_size=batch))
    elif model == "gpt2":
        from flexflow_tpu_torch.models.gpt2 import GPT2Config, build_gpt2

        _ids, logits = build_gpt2(ff, GPT2Config.tiny(batch_size=batch))
        ff.softmax(logits)
    else:
        raise ValueError(model)
    return ff


def data(model: str, n: int = BATCH, seed: int = 0):
    """(x, y) of a model: y (n, 1) class ids, or GPT-2's (n, 16) next
    tokens."""
    rng = np.random.default_rng(seed)
    if model in ("mlp", "skip"):
        x = rng.standard_normal((n, 16)).astype(np.float32)
        w = rng.standard_normal((16, 10)).astype(np.float32)
        return x, np.argmax(x @ w, axis=1).astype(np.int32)[:, None]
    if model == "bert":
        return (rng.standard_normal((n, 16, 64)).astype(np.float32),
                rng.integers(0, 2, (n, 1)).astype(np.int32))
    return (rng.integers(0, 100, (n, 16)).astype(np.int32),
            rng.integers(0, 100, (n, 16)).astype(np.int32))


def optimizer(kind: str):
    import flexflow_tpu_torch as ft

    if kind == "adam":
        return ft.AdamOptimizer(None, alpha=1e-3)
    return ft.SGDOptimizer(None, lr=float(kind.split(":")[1]))


def _case_train(args, io):
    from flexflow_tpu_torch.parallel.pipeline import PipelineTrainer

    args = dict(args)
    steps = args.pop("steps", 2)
    ff = build(args.pop("model"), batch=len(io["x"]))
    tr = PipelineTrainer(ff, optimizer=optimizer(args.pop("opt", "sgd:0.1")),
                         init_params=False, **args)
    tr.load_params(tp.unflat("w", io))
    out = {}
    for s in range(steps):
        out[f"loss{s}"] = np.float64(tr.train_step(io["x"], io["y"],
                                                   rng_seed=s))
        out.update(tp.flat(f"p{s}", tr.export_params()))
    out["host_copies"] = np.int64(tr.host_copies)
    out["peak_live"] = np.int64(tr.peak_live)
    out["feeds"] = np.array([f"{c}<{f[1]}" for c, spec in enumerate(tr.specs)
                             for f in spec.feeds if f[0] == "stage"])
    return out


def grid_strategy(pp: int, dp: int, n_micro: int, schedule: str = "1f1b",
                  world: int = 4):
    from flexflow_tpu_torch.parallel.strategy import data_parallel_strategy

    def fn(pcg):
        s = data_parallel_strategy(pcg, world)
        s.pipeline = (pp, dp, n_micro)
        s.schedule = schedule
        return s
    return fn


def compile_model(model: str, pp: int, dp: int, n_micro: int,
                  schedule: str, **config):
    import flexflow_tpu_torch as ft

    ff = build(model, **config)
    ff.compile(optimizer=optimizer("sgd:0.1"),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ft.MetricsType.METRICS_ACCURACY,
                        ft.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY],
               strategy_fn=grid_strategy(pp, dp, n_micro, schedule))
    return ff


def _case_compile_fit(args, io):
    ff = compile_model(**args)
    ff.set_params_numpy(tp.unflat("w", io))
    before = ff.eval(io["x"], io["y"])
    ff.fit(io["x"], io["y"], epochs=int(io["epochs"]))
    after = ff.eval(io["x"], io["y"])
    return {"schedule": np.array(ff._pipeline_trainer.schedule),
            "before": np.float64(before.mean("sparse_cce_loss")),
            "after": np.float64(after.mean("sparse_cce_loss")),
            "accuracy": np.float64(after.accuracy()),
            "losses": np.array(ff.fit_history.loss),
            "pred": ff.predict(io["x"]),
            **tp.flat("p", ff.get_params_numpy())}


def _case_refuse(args, io):
    out = {}
    ff = compile_model(**args)
    try:
        ff.fit(io["x"], io["y"], chaos=object())
    except ValueError as e:
        out["chaos"] = np.array(str(e))
    for field, value in (("checkpoint_dir", "never_written"),
                         ("resume", "latest"), ("max_bad_steps", 2)):
        ff = compile_model(**args, **{field: value})
        try:
            ff.fit(io["x"], io["y"])
        except NotImplementedError as e:
            out[field] = np.array(str(e))
    return out


def _case_spans(args, io):
    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.parallel.pipeline import PipelineTrainer

    args = dict(args)
    ff = build(args.pop("model"), batch=len(io["x"]))
    tr = PipelineTrainer(ff, optimizer=optimizer("sgd:0.1"),
                         init_params=False, **args)
    tr.load_params(tp.unflat("w", io))
    tracer = obs.enable()
    try:
        tr.train_step(io["x"], io["y"])
    finally:
        obs.disable()
    spans = [e for e in tracer.to_chrome_trace()["traceEvents"]
             if e["name"] in ("pipeline_fwd", "pipeline_bwd")]
    return {"spans": np.array([
        f"{e['name']}:{e['args']['micro']}:{e['args']['stage']}:"
        f"{e['args']['device']}:{e['args']['schedule']}" for e in spans])}


CASES = {"train": _case_train, "compile_fit": _case_compile_fit,
         "refuse": _case_refuse, "spans": _case_spans}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)


def start(world: int, root: str, cases):
    return tp.start(world, root, cases, main=rank_main)
