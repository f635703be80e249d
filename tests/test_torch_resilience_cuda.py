"""The resilient training path on the card: the guarded step, in-place
restores and ``--remat`` inside captured step programs. Every test here
needs an NVIDIA GPU and skips without one (the CPU tests
``test_torch_resilience.py``, ``test_torch_checkpoint.py`` and
``test_torch_remat.py`` cover the same code through the programs'
uncaptured path).

* a guarded captured step on a poisoned batch returns ``ok`` false and
  leaves every param and optimizer-state tensor bitwise unchanged, for
  SGD with momentum and for Adam, fp32 and bf16;
* a checkpoint restored into the model in place (a resume, a rollback)
  replays the programs it has: no capture;
* ``set_learning_rate`` before a fit costs exactly one capture;
* a remat step captures once and its replays launch what its eager step
  launches (under ``full`` the forward flash kernel twice a layer).

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_resilience_cuda.py
"""
import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.flash_attention as fa
from flexflow_tpu_torch.execution.checkpoint import (restore_checkpoint,
                                                     save_checkpoint)
from flexflow_tpu_torch.execution.graphs import _tensors_of
from flexflow_tpu_torch.models.bert import BertConfig, build_bert
from flexflow_tpu_torch.resilience import ChaosPlan

B, LAYERS = 4, 2

pytestmark = pytest.mark.cuda


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs capture on the card "
                    "only)")
    return torch.device("cuda")


def _bert(dev, compute="fp32", optimizer="adam", **config):
    c = ft.FFConfig()
    c.batch_size, c.seed = B, 3
    if compute == "bf16":
        c.compute_dtype = ft.DataType.DT_BFLOAT16
    for k, v in config.items():
        setattr(c, k, v)
    ff = ft.FFModel(c, device=dev)
    build_bert(ff, BertConfig(batch_size=B, seq_len=128, hidden=128,
                              num_heads=2, num_layers=LAYERS,
                              intermediate=256))
    opt = (ft.AdamOptimizer(ff, alpha=1e-3) if optimizer == "adam" else
           ft.SGDOptimizer(ff, lr=0.01, momentum=0.9))
    ff.compile(optimizer=opt,
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 128, 128)).astype(np.float32),
            rng.integers(0, 2, (n, 1)).astype(np.int32))


def _state(ff):
    return _tensors_of([ff.params, ff.opt_state])


@pytest.mark.parametrize("compute", ["fp32", "bf16"])
@pytest.mark.parametrize("optimizer", ["momentum", "adam"])
def test_guarded_captured_step_skip_is_bitwise(compute, optimizer):
    dev = _cuda()
    ff = _bert(dev, compute, optimizer)
    x, y = _data(3 * B)
    step = ff.executor.make_train_step(guard=True)

    def call(i, poison=False):
        xs = torch.from_numpy(x[i * B:(i + 1) * B]).to(dev)
        if poison:
            xs = xs * float("nan")
        lab = torch.from_numpy(y[i * B:(i + 1) * B]).to(dev)
        out = step(ff.params, ff.opt_state, [xs], lab,
                   torch.Generator().manual_seed(i))
        torch.cuda.synchronize()
        return out

    assert bool(call(0)[-1]) and bool(call(1)[-1])  # eager, then capture
    assert step.program.captures == 1
    before = [t.clone() for t in _state(ff)]
    *_outs, ok = call(2, poison=True)
    assert not bool(ok)
    assert step.program.captures == 1
    for t, b in zip(_state(ff), before):
        assert torch.equal(t, b)
    assert int(ff.opt_state["step"]) == 2


def test_restore_in_place_and_resume_do_not_recapture(tmp_path):
    dev = _cuda()
    d = str(tmp_path / "ckpt")
    ff = _bert(dev, checkpoint_dir=d, checkpoint_every=2, max_bad_steps=1)
    x, y = _data(6 * B)
    ff.fit(x, y, epochs=1, chaos=ChaosPlan(nan_at_steps={4}))
    guarded = ff.executor.make_train_step(guard=True).program
    assert guarded.captures == 1
    assert ff.resilience.summary()["last_resume_step"] == 4
    path = save_checkpoint(ff, str(tmp_path / "one"), step=6)
    want = [t.clone() for t in _state(ff)]
    ptrs = [t.data_ptr() for t in _state(ff)]
    ff.fit(x[:2 * B], y[:2 * B], epochs=1)
    restore_checkpoint(ff, path)
    assert [t.data_ptr() for t in _state(ff)] == ptrs
    for t, w in zip(_state(ff), want):
        assert torch.equal(t, w)
    ff.config.resume = "auto"
    ff.fit(x, y, epochs=2)
    assert ff.executor.make_train_step(guard=True).program is guarded
    assert guarded.captures == 1


def test_set_learning_rate_costs_one_capture():
    dev = _cuda()
    ff = _bert(dev)
    x, y = _data(3 * B)
    ff.fit(x, y, epochs=1)
    first = ff.executor.make_train_step().program
    assert first.captures == 1
    ff.optimizer.set_learning_rate(5e-4)
    ff.fit(x, y, epochs=1)
    second = ff.executor.make_train_step().program
    assert second is not first and second.captures == 1
    ff.fit(x, y, epochs=1)
    assert second.captures == 1


@pytest.mark.parametrize("level", ["selective", "full"])
def test_remat_step_captures_and_replays_its_launches(level):
    dev = _cuda()
    ff = _bert(dev, "bf16", remat=level)
    x, y = _data(4 * B)
    eager = ff.executor.make_train_step(capture=False)
    xs = [torch.from_numpy(x[:B]).to(dev)]
    lab = torch.from_numpy(y[:B]).to(dev)
    fa.reset_launch_count()
    eager(ff.params, ff.opt_state, xs, lab, None)
    torch.cuda.synchronize()
    want = {n: fa.launch_count(n) for n in fa.KERNELS}
    assert want["flash_fwd"] == (2 if level == "full" else 1) * LAYERS
    assert want["flash_bwd_fused"] == LAYERS
    ff.fit(x[:2 * B], y[:2 * B], epochs=1)  # eager first step, capture
    fa.reset_launch_count()
    ff.fit(x, y, epochs=1)
    got = {n: fa.launch_count(n) // 4 for n in fa.KERNELS}
    assert got == want
    assert ff.executor.make_train_step().program.captures == 1
    assert np.isfinite(ff.fit_history.loss).all()
