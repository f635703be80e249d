"""The frontends on the card: the gates of ``chip_smoke.py`` phase 22 at a
small size. Every test here needs an NVIDIA GPU and skips without one
(the ``test_torch_frontend_*.py`` files hold the same code against the
JAX package on the CPU).

* a 2-layer encoder written as a plain torch module (head dim 64, seq
  128, so its ``F.scaled_dot_product_attention`` takes the flash
  kernels), traced through ``PyTorchModel`` into an ``FFModel`` on CUDA:
  ``predict`` in fp32 within 1e-4 (relative norm) of the module's own
  forward on the card, B1 launched once a layer; a bf16 ``fit`` launches
  B1 and B2 once a layer a step, its losses finite;
* a keras MLP built with no ``device`` fits on CUDA under a
  ``TelemetryCallback``, which writes one summary an epoch.

It imports neither jax nor flexflow_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_frontend_cuda.py
"""
import json

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ft
import flexflow_tpu_torch.kernels.flash_attention as fa
from flexflow_tpu_torch.frontends import keras as K
from torch_frontend_pairs import Encoder, inputs, seeded, traced

pytestmark = pytest.mark.cuda

B, S, D, HEADS, LAYERS = 4, 128, 128, 2, 2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the flash kernels run on the "
                    "card only)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm())


def test_traced_encoder_forward_on_the_card():
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    module = seeded(Encoder, d=D, heads=HEADS, layers=LAYERS)
    ff = traced(ft, module, [(S, D)], B, device=None)
    assert ff.device.type == "cuda"
    x = inputs((B, S, D))
    fa.reset_launch_count()
    got = ff.predict(x, batch_size=B)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_fwd") == LAYERS
    with torch.no_grad():
        want = module.to(dev)(torch.from_numpy(x).to(dev)).cpu()
    assert _rel(got, want) <= 1e-4


def test_traced_encoder_bf16_fit_launches_b1_b2():
    _cuda()
    module = seeded(Encoder, d=D, heads=HEADS, layers=LAYERS)
    ff = traced(ft, module, [(S, D)], B, device=None, compute_bf16=True,
                optimizer=ft.AdamOptimizer(None, alpha=1e-4),
                loss=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4 * B, S, D)).astype(np.float32)
    y = rng.integers(0, 2, (4 * B, 1)).astype(np.int32)
    ff.fit(x[:2 * B], y[:2 * B], epochs=1)  # eager, then the capture
    torch.cuda.synchronize()
    fa.reset_launch_count()
    ff.fit(x[2 * B:], y[2 * B:], epochs=1)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_fwd") == 2 * LAYERS
    assert fa.launch_count("flash_bwd_fused") == 2 * LAYERS
    assert all(np.isfinite(ff.fit_history.loss))


def test_keras_mlp_fits_on_cuda_with_telemetry(tmp_path):
    _cuda()
    (x, y), _ = K.datasets.mnist.load_data()
    x = (x.reshape(-1, 784).astype("float32") / 255)[:512]
    y = y.astype("int32").reshape(-1, 1)[:512]
    model = K.Sequential([K.Input(shape=(784,)),
                          K.Dense(512, activation="relu"),
                          K.Dense(512, activation="relu"), K.Dense(10),
                          K.Activation("softmax")])
    model.ffconfig.batch_size = 64
    model.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
                  metrics=("accuracy",))
    assert model.ffmodel.device.type == "cuda"
    path = tmp_path / "tel.json"
    perf = model.fit(x, y, epochs=2, callbacks=[
        K.callbacks.TelemetryCallback(telemetry_file=str(path))])
    assert perf.train_all == 512
    rec = json.loads(path.read_text())
    assert [e["epoch"] for e in rec["epochs"]] == [0, 1]
    assert all(np.all(np.isfinite(e["epoch_loss"])) for e in rec["epochs"])
    assert model.ffmodel._telemetry_requested is False
