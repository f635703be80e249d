"""The port's fault-tolerant ``fit`` against the JAX package's
(``tests/test_resilience.py:342-480``), on the small model of
``torch_resilience_pairs``:

* the guarded step equals the plain one bit for bit on a clean batch and
  leaves every param and state tensor bitwise unchanged on a poisoned one,
  for SGD, momentum, nesterov and Adam (and Adam with bf16 moments), eager
  and through the step program;
* a run preempted by SIGTERM and resumed with ``--resume auto`` ends on
  the uninterrupted port run's params bit for bit; the same scenario in
  the JAX package stops at the same step and commits the same
  checkpoints with the same cursors (step, epoch, batch, rng counter);
* a NaN injected at one step is skipped, rolled back and replayed clean:
  the same equalities, with the counters equal to JAX's
  ``summary()["resilience"]``.

Across the packages these runs of 16 steps are held by their cursors and
counters, not their params: ``torch_resilience_pairs.STEP_TOL``'s note.
* a NaN on every replay halves the LR and then aborts, with JAX's LR;
* a rollback past a corrupt newest checkpoint lands on step 6, as in JAX;
* the sentinel without ``--checkpoint-dir`` raises; ``--resume auto`` on an
  empty directory starts fresh.
"""
import os
import signal

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
from flexflow_tpu.resilience import ChaosPlan as JaxChaosPlan
from flexflow_tpu_torch.execution.checkpoint import latest_checkpoint
from flexflow_tpu_torch.resilience import (ChaosPlan, GuardedTrainStep,
                                           corrupt_checkpoint)
from torch_resilience_pairs import (BATCH, assert_params,
                                    checkpoint_cursors, data, fj, params_of,
                                    seed_params, small_model, state_arrays)



@pytest.fixture(scope="module")
def baseline():
    """(init params, the port's final params after 2 uninterrupted
    epochs)."""
    ff = small_model()
    init = params_of(ff)
    x, y = data()
    ff.fit(x, y, epochs=2)
    return init, params_of(ff)


# =========================================================== guarded step
@pytest.mark.parametrize("capture", [False, True])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adam",
                                 "adam_bf16_moments"])
def test_guarded_step_passthrough_and_skip(opt, capture):
    x, y = data()
    xs = [torch.tensor(x[:BATCH])]
    lab = torch.tensor(y[:BATCH].reshape(BATCH, 1))
    plain_ff, guard_ff = small_model(opt=opt), small_model(opt=opt)
    guard_ff.set_params_numpy(params_of(plain_ff))
    plain_ff.set_params_numpy(params_of(plain_ff))
    plain = plain_ff.executor.make_train_step(capture=capture)
    guarded = guard_ff.executor.make_train_step(capture=capture,
                                                guard=True)
    for k in range(2):  # a program's first call and its second
        g = torch.Generator().manual_seed(k)
        _p, _s, loss1, _m = plain(plain_ff.params, plain_ff.opt_state, xs,
                                  lab, g)
        _p, _s, loss2, _m, ok = guarded(guard_ff.params, guard_ff.opt_state,
                                        xs, lab, torch.Generator()
                                        .manual_seed(k))
        assert ok.dtype == torch.bool and bool(ok)
        assert float(loss1) == float(loss2)
        for a, b in zip(state_arrays(plain_ff), state_arrays(guard_ff)):
            np.testing.assert_array_equal(a, b)
    before = state_arrays(guard_ff)
    nan_xs = [xs[0] * float("nan")]
    _p, _s, loss3, _m, ok3 = guarded(guard_ff.params, guard_ff.opt_state,
                                     nan_xs, lab, torch.Generator())
    assert not bool(ok3) and not np.isfinite(float(loss3))
    for a, b in zip(state_arrays(guard_ff), before):
        np.testing.assert_array_equal(a, b)  # the NaN never lands


def test_guarded_step_verdict_matches_jax():
    """On a clean and a poisoned batch the port's ``ok`` is JAX's."""
    import jax

    x, y = data()
    jff, tff = small_model(fj), small_model()
    tff.set_params_numpy(params_of(jff))
    jstep = jff.executor.make_train_step(guard=True)
    tguard = GuardedTrainStep(tff.executor, 1)
    lab = y[:BATCH].reshape(BATCH, 1)
    for poison in (False, True):
        bx = x[:BATCH] * (np.float32("nan") if poison else np.float32(1))
        jouts = jstep(jff.params, jff.opt_state, [jax.device_put(bx)],
                      jax.device_put(lab), jax.random.PRNGKey(0))
        jff.params, jff.opt_state = jouts[0], jouts[1]
        (_p, _s, loss, _m), ok = tguard(tff.params, tff.opt_state,
                                        [torch.tensor(bx)],
                                        torch.tensor(lab), None)
        assert ok == bool(jouts[-1]) == (not poison)
        assert tguard.consecutive_bad == int(poison)
        assert tguard.should_rollback == poison
        np.testing.assert_allclose(float(loss), float(jouts[2]), rtol=1e-5)


# =============================================== chaos acceptance scenarios
def test_sigterm_preemption_resume_equality(tmp_path, baseline):
    init, final = baseline
    x, y = data()
    prev_term = signal.getsignal(signal.SIGTERM)
    cursors = {}
    for pkg, plan in ((ft, ChaosPlan), (fj, JaxChaosPlan)):
        d = str(tmp_path / pkg.__name__)
        ffb = small_model(pkg, checkpoint_dir=d, checkpoint_every=2)
        seed_params(ffb, init)
        chaos = plan(preempt_at_step=10)
        ffb.fit(x, y, epochs=2, chaos=chaos)
        assert chaos.preempted_at == 10
        assert ffb._preempted_at_step == 11  # the step in flight finished
        assert signal.getsignal(signal.SIGTERM) is prev_term
        cursors[pkg] = checkpoint_cursors(d)
        if pkg is ft:
            assert len(ffb.fit_history.loss) == 11
            assert latest_checkpoint(d).endswith("step_11")
            assert ffb.resilience.summary() == {
                "fault_events": 1, "recovery_events": 0, "skipped_steps": 0,
                "checkpoints_saved": 6}
    assert cursors[ft] == cursors[fj]
    assert cursors[ft][11] == {"step": 11, "epoch": 1, "batch_in_epoch": 3,
                               "rng_counter": 11}

    d = str(tmp_path / ft.__name__)
    ffc = small_model(checkpoint_dir=d, checkpoint_every=2, resume="auto")
    ffc.fit(x, y, epochs=2)
    assert len(ffc.fit_history.loss) == 5  # steps 12..16
    assert ffc.resilience.last_resume_step == 11
    assert_params(params_of(ffc), final)


def test_nan_sentinel_rollback_equality(tmp_path, baseline):
    init, final = baseline
    x, y = data()
    runs = {}
    for pkg, plan in ((ft, ChaosPlan), (fj, JaxChaosPlan)):
        ff = small_model(pkg, checkpoint_dir=str(tmp_path / pkg.__name__),
                         checkpoint_every=2, max_bad_steps=1)
        seed_params(ff, init)
        if pkg is fj:
            ff._telemetry_requested = True
        ff.fit(x, y, epochs=2, chaos=plan(nan_at_steps={11}))
        assert ff.optimizer.lr == pytest.approx(0.05)  # no LR change yet
        runs[pkg] = ff
    tff, jff = runs[ft], runs[fj]
    assert_params(params_of(tff), final)
    assert checkpoint_cursors(str(tmp_path / ft.__name__)) == \
        checkpoint_cursors(str(tmp_path / fj.__name__))
    summary = tff.resilience.summary()
    assert summary == jff.get_telemetry().summary()["resilience"]
    assert summary["last_resume_step"] == 10
    assert summary["skipped_steps"] == 1
    # 16 steps, the poisoned one, and the replayed step 11
    losses = tff.fit_history.loss
    assert len(losses) == 18 and np.isnan(losses[11])
    assert np.isfinite(np.delete(losses, 11)).all()


def test_persistent_divergence_reduces_lr_then_aborts(tmp_path):
    x, y = data()
    lrs = []
    for pkg, plan in ((ft, ChaosPlan), (fj, JaxChaosPlan)):
        ff = small_model(pkg, checkpoint_dir=str(tmp_path / pkg.__name__),
                         checkpoint_every=2, max_bad_steps=1,
                         max_rollbacks=2)
        with pytest.raises(RuntimeError, match="divergence persists"):
            ff.fit(x, y, epochs=2, chaos=plan(nan_at_steps={5},
                                              once=False))
        lrs.append(ff.optimizer.lr)
    assert lrs[0] == lrs[1] == pytest.approx(0.05 * 0.5)


def test_rollback_falls_back_past_corrupt_latest(tmp_path):
    x, y = data()
    got = {}
    for pkg, plan in ((ft, ChaosPlan), (fj, JaxChaosPlan)):
        d = str(tmp_path / pkg.__name__)
        ffa = small_model(pkg, checkpoint_dir=d, checkpoint_every=2)
        ffa.fit(x, y, epochs=1)  # commits steps 4, 6, 8 (keep 3)
        corrupt_checkpoint(os.path.join(d, "step_8"), mode="flip")
        ffb = small_model(pkg, checkpoint_dir=d, checkpoint_every=100,
                          resume="auto", max_bad_steps=1)
        if pkg is fj:
            ffb._telemetry_requested = True
        ffb.fit(x, y, epochs=2, chaos=plan(nan_at_steps={9}))
        got[pkg] = (ffb.resilience.summary() if pkg is ft else
                    ffb.get_telemetry().summary()["resilience"])
    assert got[ft]["last_resume_step"] == got[fj]["last_resume_step"] == 6
    assert got[ft]["recovery_events"] >= 2  # resume + rollback
    assert got[ft] == got[fj]


def test_sentinel_without_checkpoint_dir_raises():
    x, y = data()
    ff = small_model(max_bad_steps=1)
    with pytest.raises(RuntimeError, match="checkpoint"):
        ff.fit(x, y, epochs=1, chaos=ChaosPlan(nan_at_steps={2}))


def test_resume_auto_fresh_start(tmp_path):
    x, y = data()
    ff = small_model(checkpoint_dir=str(tmp_path / "c"), checkpoint_every=4,
                     resume="auto")
    ff.fit(x, y, epochs=1)
    assert latest_checkpoint(str(tmp_path / "c")).endswith("step_8")
    assert ff.resilience.last_resume_step is None
    assert ff.resilience.checkpoints_saved == 2


# ================================================================ plumbing
def test_chaos_poison_requires_float_input():
    plan = ChaosPlan(nan_at_steps={0})
    with pytest.raises(ValueError, match="floating-point"):
        plan.poison_batch(0, [torch.ones((4,), dtype=torch.int32)])
    plan2 = ChaosPlan(nan_at_steps={0})
    bx = [torch.ones((4,), dtype=torch.int32),
          torch.ones((4,), dtype=torch.bfloat16)]
    out = plan2.poison_batch(0, bx)
    assert out[0] is bx[0] and out[1].dtype == torch.bfloat16
    assert torch.isnan(out[1]).all()
    again = plan2.poison_batch(0, bx)  # once=True: a replay is clean
    assert torch.isfinite(again[1]).all()


@pytest.mark.parametrize("arg,value", [
    ("fail_compiles", 1), ("wrong_reshard", True),
    ("drop_devices_at", {4: 2})])
def test_chaos_plan_refuses_injections_of_later_slices(arg, value):
    with pytest.raises(NotImplementedError, match="later slice") as e:
        ChaosPlan(**{arg: value})
    assert arg in str(e.value)
    if arg == "drop_devices_at":
        assert "A.8" in str(e.value)
    from flexflow_tpu_torch.resilience.chaos import _LATER_ARGS

    ChaosPlan(**{arg: _LATER_ARGS[arg]})  # the off value is accepted


@pytest.mark.parametrize("arg,value,hook", [
    ("poison_decode_at", {3: 0}, "maybe_poison_decode"),
    ("storm_queue", {1: [[1]]}, "maybe_storm"),
    ("preempt_serving_at", 2, "maybe_preempt_serving")])
def test_chaos_plan_takes_serving_injections(arg, value, hook):
    """The serving injections are in this slice: each is kept as the JAX
    plan keeps it, fires once at its step and never at another."""
    import signal

    plan = ChaosPlan(**{arg: value})
    assert getattr(plan, arg) == value
    if hook == "maybe_storm":
        assert plan.maybe_storm(0) == [] and plan.maybe_storm(1) == [[1]]
        assert plan.maybe_storm(1) == [] and plan.storms_injected == 1
    elif hook == "maybe_preempt_serving":
        got = []
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: got.append(signum))
        try:
            plan.maybe_preempt_serving(1)
            plan.maybe_preempt_serving(2)
            plan.maybe_preempt_serving(2)
        finally:
            signal.signal(signal.SIGTERM, prev)
        assert got == [signal.SIGTERM] and plan.serving_preempted_at == 2
    else:
        from flexflow_tpu_torch.serving.kvcache import DecodeState

        pool = torch.zeros((4, 1, 2, 2))
        state = DecodeState(caches={"a": (pool, pool.clone())},
                            lengths=torch.tensor([3], dtype=torch.int32),
                            block_tables=torch.tensor([[2, 0]]))
        stage = lambda ids: torch.tensor(ids)  # noqa: E731
        assert plan.maybe_poison_decode(2, state, lambda s: [2],
                                        stage) is None
        assert plan.maybe_poison_decode(3, state, lambda s: [2, 0],
                                        stage) == 0
        for leaf in state.caches["a"]:
            assert torch.isnan(leaf[2]).all()  # the victim's block
            assert torch.isfinite(leaf[[0, 1, 3]]).all()  # never GARBAGE
        assert plan.poisoned_decode_steps == [3]
        assert plan.maybe_poison_decode(3, state, lambda s: [2],
                                        stage) is None  # once


def test_config_resilience_flags():
    cfg = ft.FFConfig()
    cfg.parse_args(["--checkpoint-dir", "/tmp/ck", "--checkpoint-every",
                    "25", "--keep-checkpoints", "5", "--max-bad-steps",
                    "2", "--resume", "auto", "--rollback-lr-factor",
                    "0.25", "--max-rollbacks", "4", "--remat", "full",
                    "--remat-segment-size", "3"])
    assert (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.keep_checkpoints,
            cfg.max_bad_steps, cfg.resume, cfg.rollback_lr_factor,
            cfg.max_rollbacks, cfg.remat, cfg.remat_segment_size) == (
        "/tmp/ck", 25, 5, 2, "auto", 0.25, 4, "full", 3)
