"""Shared fixtures of the port's resilience, checkpoint and manual-loop
tests (tests/test_torch_checkpoint.py, test_torch_resilience.py,
test_torch_phase_api.py): the small model of ``tests/test_resilience.py``
(dense 16 -> 32 -> relu -> 10, SGD lr 0.05, batch 8, 64 samples: 8 steps
an epoch) built in either package, its data, and host copies of a model's
params. Weights go from one model to another with ``set_params_numpy``.
"""
import numpy as np
import torch

import flexflow_tpu as fj
import flexflow_tpu_torch as ft

torch.set_num_threads(2)

BATCH = 8
N_SAMPLES = 64
# the port's params against the JAX package's after ONE SGD step of this
# model from equal params: summation order only (at most 3e-7 measured).
# Over several steps the model (lr 0.05, loss 7.7 at the init) amplifies
# such differences by orders of magnitude (1.2e-5 after 16 steps against
# JAX on one device, 1.9e-4 on the tests' 8-device CPU mesh), so runs of
# many steps are compared across the packages by their checkpoint
# cursors and counters, and within the port bit for bit
STEP_TOL = dict(rtol=0.0, atol=1e-5)


def optimizer(pkg, kind: str):
    if kind == "sgd":
        return pkg.SGDOptimizer(None, lr=0.05)
    if kind == "momentum":
        return pkg.SGDOptimizer(None, lr=0.05, momentum=0.9,
                                weight_decay=1e-3)
    if kind == "nesterov":
        return pkg.SGDOptimizer(None, lr=0.05, momentum=0.9, nesterov=True)
    if kind == "adam":
        return pkg.AdamOptimizer(None, alpha=1e-3)
    if kind == "adam_bf16_moments":
        return pkg.AdamOptimizer(None, alpha=1e-3,
                                 moment_dtype=torch.bfloat16)
    raise ValueError(kind)


def small_model(pkg=ft, opt: str = "sgd", **cfg_kw):
    """The small model in ``pkg`` (``ft``, on the CPU, or ``fj``)."""
    cfg = pkg.FFConfig()
    cfg.batch_size = BATCH
    if pkg is fj:
        cfg.only_data_parallel = True
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    ff = pkg.FFModel(cfg, device="cpu") if pkg is ft else pkg.FFModel(cfg)
    x = ff.create_tensor((BATCH, 16), name="x")
    t = ff.dense(x, 32, name="d1")
    t = ff.relu(t)
    ff.dense(t, 10, name="d2")
    ff.compile(optimizer=optimizer(pkg, opt),
               loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ff


def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N_SAMPLES, 16)).astype(np.float32)
    y = rng.integers(0, 10, size=N_SAMPLES).astype(np.int32)
    return x, y


def params_of(ff):
    """Host copies of a model's params, either package."""
    if isinstance(ff, ft.FFModel):
        return ff.get_params_numpy()
    return {ln: {wn: np.array(a) for wn, a in ws.items()}
            for ln, ws in ff.params.items()}


def seed_params(ff, host):
    """Load host params into a compiled model of either package."""
    if isinstance(ff, ft.FFModel):
        ff.set_params_numpy(host)
        return
    import jax

    for ln, ws in host.items():
        for wn, a in ws.items():
            cur = ff.params[ln][wn]
            ff.params[ln][wn] = jax.device_put(a, cur.sharding)


def assert_params(got, want, rtol=0.0, atol=0.0):
    assert got.keys() == want.keys()
    for ln in want:
        assert got[ln].keys() == want[ln].keys()
        for wn in want[ln]:
            if rtol == 0.0 and atol == 0.0:
                np.testing.assert_array_equal(got[ln][wn], want[ln][wn],
                                              err_msg=f"{ln}.{wn}")
            else:
                np.testing.assert_allclose(got[ln][wn], want[ln][wn],
                                           rtol=rtol, atol=atol,
                                           err_msg=f"{ln}.{wn}")


def checkpoint_cursors(directory):
    """{step: train_state.json} of every committed checkpoint, read with
    the port's reader (the format is the JAX package's)."""
    from flexflow_tpu_torch.execution.checkpoint import (list_checkpoints,
                                                         read_train_state)

    return {s: read_train_state(p) for s, p in list_checkpoints(directory)}


def state_arrays(ff):
    """Every tensor of a port model's params and optimizer state, as host
    copies in a fixed order."""
    from flexflow_tpu_torch.execution.graphs import _tensors_of

    return [t.detach().float().cpu().numpy().copy()
            if t.dtype == torch.bfloat16 else t.detach().cpu().numpy().copy()
            for t in _tensors_of([ff.params, ff.opt_state])]
