"""The guarded step, rollback, preemption and chaos across two gloo ranks
(spawned processes; ``tests/torch_ckpt_pairs.py`` runs them), on the small
model of ``tests/test_resilience.py`` under dp = 2, held to that file's
laws (:380-434) and to the JAX package's dp = 2 run of it:

* a real SIGTERM to rank 1 alone stops both ranks after the same step,
  with one committed checkpoint; ``--resume auto`` then ends within 1e-6
  of the port's uninterrupted run and within 1e-5 of the JAX package's;
* a NaN on rank 0's plan alone is skipped on both ranks, rolled back once
  and reconverges to the uninterrupted run;
* a NaN that every replay meets cuts the learning rate at the second
  rollback and aborts on both ranks past ``--max-rollbacks``;
* a rollback and a resume pass a corrupt newest checkpoint on both ranks;
* a rollback whose restore fails on rank 1 alone moves both ranks on to
  the older checkpoint, and only rank 0 checksums the candidates;
* with every resilience feature off, ``fit`` makes no host agreement.
"""
import numpy as np
import pytest

import torch_ckpt_pairs as cp
import torch_dist_pairs as tp
from torch_mesh_pairs import assert_trees_close, assert_trees_equal

WORLD = 2
SMALL = dict(model="small", strategy="dp:2")
CKPT = dict(checkpoint_every=2)


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=64).astype(np.int32)
    return x, y


def _jax_uninterrupted(weights, x, y):
    """The JAX package's dp = 2 run of the model over 2 shuffled epochs."""
    import flexflow_tpu as fj
    from flexflow_tpu.parallel.strategy import data_parallel_strategy

    cfg = fj.FFConfig()
    cfg.batch_size = cp.BATCH
    ff = fj.FFModel(cfg)
    t = ff.create_tensor((cp.BATCH, 16), name="x")
    t = ff.relu(ff.dense(t, 32, name="d1"))
    ff.dense(t, 10, name="d2")
    ff.compile(optimizer=fj.SGDOptimizer(ff, lr=0.05),
               loss_type=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               strategy_fn=lambda pcg: data_parallel_strategy(pcg, 2))
    import jax
    import jax.numpy as jnp

    ff.params = {n: {w: jax.device_put(jnp.asarray(a), ff.params[n][w]
                                       .sharding)
                     for w, a in ws.items()} for n, ws in weights.items()}
    ff.opt_state = ff.optimizer.init_state(ff.params)
    ff.fit(x, y, epochs=2)
    return {n: {w: np.asarray(a) for w, a in ws.items()}
            for n, ws in jax.device_get(ff.params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_res"))
    weights = cp.small(None).get_params_numpy()
    x, y = _data()
    cases = [
        ("base", "resilient", dict(SMALL, dir="base")),
        ("sigterm", "resilient", dict(
            **SMALL, **CKPT, dir="sigterm", resume=True,
            chaos={1: dict(preempt_at_step=10)})),
        ("nan", "resilient", dict(
            **SMALL, **CKPT, dir="nan", max_bad_steps=1,
            chaos={0: dict(nan_at_steps={11})})),
        ("persist", "resilient", dict(
            **SMALL, **CKPT, dir="persist", max_bad_steps=1, max_rollbacks=2,
            chaos={0: dict(nan_at_steps={5}, once=False)})),
        ("corrupt", "resilient", dict(
            **SMALL, **CKPT, dir="corrupt", epochs=1, corrupt_latest="step_8",
            resume=dict(flags=dict(checkpoint_every=100, max_bad_steps=1),
                        chaos={1: dict(nan_at_steps={9})}, epochs=2))),
        ("onerank", "resilient", dict(
            **SMALL, **CKPT, dir="onerank", max_bad_steps=1,
            chaos={0: dict(nan_at_steps={11})}, fail_restore={1: "step_10"})),
        ("plain", "plain_agreements", dict(SMALL)),
    ]
    for name, _kind, _args in cases:
        np.savez(f"{root}/{name}_in.npz", x=x, y=y, **tp.flat("w", weights))
    procs = cp.start(WORLD, root, cases)
    jax_final = _jax_uninterrupted(weights, x, y)
    tp.finish(procs, root, timeout=240)
    return root, jax_final


def _both(root, name):
    return [tp.load(root, name, r) for r in range(WORLD)]


def test_sigterm_to_one_rank_stops_every_rank_after_the_same_step(runs):
    root, _jax = runs
    got = _both(root, "sigterm")
    # rank 1's handler ran before step 10 dispatched; both finished it and
    # flushed one checkpoint together
    assert [int(g["preempted_at"]) for g in got] == [11, 11]
    assert [str(g["latest"]) for g in got] == ["step_11", "step_11"]
    assert_trees_equal(tp.unflat("p", got[0]), tp.unflat("p", got[1]))


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_resume_after_one_rank_sigterm_ends_on_the_uninterrupted_run(
        runs, ref):
    root, jax_final = runs
    base = tp.unflat("p", tp.load(root, "base", 0))
    want, tol = (base, 1e-6) if ref == "port" else (jax_final, 1e-5)
    for g in _both(root, "sigterm"):
        assert int(g["rres/last_resume_step"]) == 11
        assert_trees_close(want, tp.unflat("r", g), rtol=tol, atol=tol)


def test_nan_on_one_rank_is_skipped_and_rolled_back_on_both(runs):
    root, _jax = runs
    base = tp.unflat("p", tp.load(root, "base", 0))
    got = _both(root, "nan")
    for g in got:
        assert float(g["lr"]) == pytest.approx(0.05)  # no LR cut yet
        assert int(g["res/skipped_steps"]) == 1
        assert int(g["res/recovery_events"]) == 1
        assert int(g["res/last_resume_step"]) == 10
        assert_trees_close(base, tp.unflat("p", g), rtol=1e-6, atol=1e-6)
    assert_trees_equal(tp.unflat("p", got[0]), tp.unflat("p", got[1]))


def test_persistent_divergence_cuts_the_lr_then_aborts_on_both(runs):
    root, _jax = runs
    for g in _both(root, "persist"):
        assert "divergence persists" in str(g["error"])
        assert float(g["lr"]) == pytest.approx(0.05 * 0.5)


def test_rollback_and_resume_pass_a_corrupt_latest_on_both(runs):
    root, _jax = runs
    for g in _both(root, "corrupt"):
        # resumed past the corrupt step_8 to step_6, and the rollback after
        # rank 1's NaN landed there too
        assert int(g["rres/last_resume_step"]) == 6
        assert int(g["rres/recovery_events"]) >= 2
        assert int(g["rres/fault_events"]) >= 2


def test_a_restore_failing_on_one_rank_moves_both_to_the_older_one(runs):
    root, _jax = runs
    base = tp.unflat("p", tp.load(root, "base", 0))
    got = _both(root, "onerank")
    for g in got:
        assert "error" not in g
        # step_10 failed to read on rank 1: both rolled back to step_8
        assert int(g["res/last_resume_step"]) == 8
        assert int(g["res/recovery_events"]) == 1
        assert int(g["res/fault_events"]) == 2
        assert_trees_close(base, tp.unflat("p", g), rtol=1e-6, atol=1e-6)
    assert_trees_equal(tp.unflat("p", got[0]), tp.unflat("p", got[1]))
    assert [int(g["checksums"]) for g in got][1] == 0
    assert int(got[0]["checksums"]) >= 2


def test_resilience_off_makes_no_host_agreement(runs):
    root, _jax = runs
    for g in _both(root, "plain"):
        assert bool(g["session"])
        assert int(g["agree"]) == 0 and int(g["any_rank"]) == 0
