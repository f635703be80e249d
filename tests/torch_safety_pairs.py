"""Spawned gloo ranks for the port's strategy-safety cascade
(tests/test_torch_strategy_safety.py).

Imports neither jax nor flexflow_tpu: the ranks run the port alone
(``torch_dist_pairs`` spawns them). The models are the JAX tests' small
MLPs (``mlp2``: dense 32, relu, dense 10; ``mlp3``: three dense layers
and a softmax head, whose hybrid plan has a row-parallel middle layer);
each case builds one on the CPU, loads the JAX package's weights
(``set_params_numpy``) and returns what the JAX run is held to. Cases:

* ``fit``: ``fit`` for one epoch with a ``ChaosPlan`` and config flags
  that arm the cascade: its counters, the final strategy, the rejected
  plans, the audit reports, the injected defect, the fit's losses;
* ``preverify``: the cascade alone (``StrategyCascade.preverify``) after
  a weight edit: the params, the optimizer's step count and
  ``_rng_counter`` before and after, and the counters;
* ``audit``: ``audit_strategy`` on one batch: the report's four scalars;
* ``save`` / ``elastic``: a sharded checkpoint saved on one world, and
  ``elastic_restore`` onto a smaller one (tests/test_torch_elastic.py).
"""
import numpy as np

import torch_dist_pairs as tp
import torch_search_pairs as sp

BATCH = 8


def build(model: str, strategy=None, **config):
    """The case's MLP in the port on the CPU, compiled under ``strategy``
    (a ``torch_dist_pairs`` strategy name; ``pipe:a:b`` a (a, b, 2) grid)
    or, with none at a world above one, the Unity search."""
    import flexflow_tpu_torch as ft

    c = ft.FFConfig()
    c.batch_size, c.search_budget = BATCH, 8
    c.enable_sequence_parallel = False
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device="cpu")
    if model == "big":
        x = ff.create_tensor((BATCH, 256), name="x")
        t = ff.relu(ff.dense(x, 512, name="d1"))
        t = ff.dense(ff.dense(t, 512, name="d2"), 10, name="d3")
    else:
        x = ff.create_tensor((BATCH, 16), name="x")
        t = ff.relu(ff.dense(x, 32, name="d1"))
        if model == "mlp3":
            t = ff.relu(ff.dense(t, 32, name="d2"))
            ff.softmax(ff.dense(t, 10, name="d3"), name="probs")
        else:
            ff.dense(t, 10, name="d2")
    ff.compile(optimizer=ft.SGDOptimizer(ff, lr=0.05),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=tp._strategy(strategy) if strategy else None)
    return ff


def _built(ff_args, io):
    sp.fresh_guids()
    ff = build(ff_args["model"], ff_args.get("strategy"),
               **ff_args.get("config", {}))
    ff.set_params_numpy(tp.unflat("w", io))
    return ff


def counters(c) -> np.ndarray:
    return np.array([c.static_checks, c.static_rejects, c.compile_probes,
                     c.fallbacks, c.audits, c.audit_failures])


def reports(c) -> np.ndarray:
    return np.array([[r.loss_candidate, r.loss_reference,
                      r.grad_norm_candidate, r.grad_norm_reference,
                      float(r.passed)] for r in c.audit_reports]
                    ).reshape(-1, 5)


def _case_fit(ff_args, io):
    import warnings

    from flexflow_tpu_torch.resilience import ChaosPlan

    ff = _built(ff_args, io)
    chaos = ChaosPlan(**ff_args.get("chaos", {}))
    err = ""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            ff.fit(io["x"], io["y"], epochs=1, chaos=chaos)
        except Exception as e:  # the refusals the case expects
            err = f"{type(e).__name__}: {e}"
    c = ff._last_cascade
    return {"final": np.array(c.final_desc if c else ""),
            "live": np.array(ff.strategy.describe() if ff.strategy
                             else ""),
            "counters": counters(c), "rules": np.array(c.static_rules,
                                                       dtype=str),
            "failed": np.array([d for d, _r in c.failures], dtype=str),
            "reasons": np.array([r for _d, r in c.failures], dtype=str),
            "reports": reports(c), "error": np.array(err),
            "defect": np.array(chaos.injected_defect),
            "mode": np.array(chaos.wrong_reshard_mode),
            "injected": np.int64(chaos.wrong_reshards_injected),
            "warned": np.array([str(w.message) for w in seen], dtype=str),
            "losses": np.array(ff.fit_history.loss)}


def _case_preverify(ff_args, io):
    from flexflow_tpu_torch.resilience import ChaosPlan, StrategyCascade

    ff = _built(ff_args, io)
    if ff_args.get("edit"):
        w = ff.get_params_numpy()
        w["d1_0"]["bias"] = np.full_like(w["d1_0"]["bias"], 0.125)
        ff.set_params_numpy(w)
    before = ff.get_params_numpy()
    step0 = int(ff.opt_state["step"])
    rng0 = ff._rng_counter
    cascade = StrategyCascade.maybe_create(
        ff, ChaosPlan(**ff_args.get("chaos", {})))
    cascade.preverify([io["x"]], ff._prep_label(io["y"]), BATCH)
    return {"counters": counters(cascade),
            "final": np.array(cascade.final_desc),
            "step": np.array([step0, int(ff.opt_state["step"])]),
            "rng": np.array([rng0, ff._rng_counter]),
            "reports": reports(cascade),
            **tp.flat("before", before),
            **tp.flat("after", ff.get_params_numpy())}


def _case_audit(ff_args, io):
    from flexflow_tpu_torch.resilience import audit_strategy

    ff = _built(ff_args, io)
    r = audit_strategy(ff, io["x"][:BATCH], io["y"][:BATCH], tol=0.05)
    return {"report": np.array([r.loss_candidate, r.loss_reference,
                                r.grad_norm_candidate,
                                r.grad_norm_reference, float(r.passed)]),
            "strategy": np.array(r.strategy)}


def _case_save(ff_args, io):
    """Train an epoch under the case's plan and save a sharded checkpoint
    (step 8, the rng counter in its train state)."""
    import os

    from flexflow_tpu_torch.execution.checkpoint import save_checkpoint

    ff = _built(ff_args, io)
    ff.fit(io["x"], io["y"], epochs=1, shuffle=False)
    path = save_checkpoint(
        ff, os.path.join(io["root"], "ckpt"), step=8,
        train_state={"step": 8, "epoch": 1, "batch_in_epoch": 0,
                     "rng_counter": ff._rng_counter})
    return {"path": np.array(path), "rng": np.int64(ff._rng_counter),
            "mesh": np.array(ff.strategy.mesh_shape),
            **tp.flat("p", ff.get_params_numpy())}


def _case_elastic(ff_args, io):
    """A searched model on this (smaller) world restores the checkpoint
    through ``elastic_restore``: the step, the rng counter, the re-searched
    plan, the params; a sub-world target raises, naming ``n_dev``; then
    one step trains."""
    from flexflow_tpu_torch.resilience import elastic_restore

    ff = _built(ff_args, io)
    path = str(io["path"])
    try:
        elastic_restore(ff, path, n_dev=1)
        refused = ""
    except ValueError as e:
        refused = str(e)
    step = elastic_restore(ff, path)
    params = ff.get_params_numpy()
    rng = ff._rng_counter
    ff.fit(io["x"][:BATCH], io["y"][:BATCH], epochs=1)
    return {"step": np.int64(step), "rng": np.int64(rng),
            "strategy": np.array(ff.strategy.describe()),
            "mesh": np.array(ff.strategy.mesh_shape),
            "refused": np.array(refused),
            "loss": np.array(ff.fit_history.loss), **tp.flat("p", params)}


CASES = {"fit": _case_fit, "preverify": _case_preverify,
         "audit": _case_audit, "save": _case_save,
         "elastic": _case_elastic}


def rank_main(rank: int, world: int, root: str, cases) -> None:
    tp.run_cases(rank, world, root, cases, CASES)
