"""The vision and recommendation model zoo of the port against the JAX
package, on the CPU, at reduced size (InceptionV3 and ResNeXt-50 are in
test_torch_model_zoo_cnn.py). Every builder is the JAX package's, called
the same way in both packages; the cuts:

* AlexNet-CIFAR (bootcamp_demo/ff_alexnet_cifar10.py) as published, at
  batch 2;
* ResNet-50 with one bottleneck per stage (``stages=(1, 1, 1, 1)``,
  published (3, 4, 6, 3)) at image 32 (published 224) and batch 8: its
  last stage runs at 1x1, where batch norm's statistics are over the batch
  alone, and batch 8 keeps them over 8 values (over 2, each normalised
  value is +-1 whatever the input and the input grads are a cancellation
  that fp32 rounding swamps in either package);
* DLRM with eight tables of 100 entries (published 1000 in the builder's
  default; 200000 in the chip run), batch 8, MSE;
* XDL with 2 tables of 100 entries (published 4 of 1000000), batch 8;
* MLP_Unify with 64 inputs and three hidden layers of 128 (published 1024
  and eight of 8192), batch 8;
* CANDLE-Uno with the published feature widths (942, 5270, 2048 and the
  dose) and two layers of 64 in each tower and in the head (published
  eight and four of 4192), batch 8, MSE.

Checked (``torch_zoo_pairs``): the inference output within 1e-5, one
training step's loss within 1e-5 relative and its grads within 1e-4
relative norm (or, where a ReLU output lies on opposite sides of 0 in the
two packages, each conv, dense, norm and batched-matmul node alone within
1e-4). And AlexNet-CIFAR trains through ``fit`` on the CPU: over ten
epochs of 16 seeded images with seeded labels its loss falls to under
half its first epoch's.
"""
import numpy as np
import pytest

from flexflow_tpu.models import dlrm as jd
from flexflow_tpu.models import misc as jm
from flexflow_tpu.models import vision as jv
import flexflow_tpu_torch as ft
from flexflow_tpu_torch.models import dlrm as td
from flexflow_tpu_torch.models import misc as tm
from flexflow_tpu_torch.models import vision as tv
from torch_zoo_pairs import build_pair, check_forward, check_step, data

MSE = "LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE"


def _pick(jax_mod, torch_mod):
    return lambda pkg: jax_mod if pkg == "jax" else torch_mod


VISION, DLRM, MISC = _pick(jv, tv), _pick(jd, td), _pick(jm, tm)

# name -> (builder call, batch, loss, classes, vocab)
CASES = {
    "alexnet_cifar10": (lambda ff, p: VISION(p).build_alexnet_cifar10(ff, 2),
                        2, None, 10, None),
    "resnet50": (lambda ff, p: VISION(p).build_resnet50(
        ff, 8, 32, stages=(1, 1, 1, 1)), 8, None, 1000, None),
    "dlrm": (lambda ff, p: DLRM(p).build_dlrm(ff, 8, (100,) * 8), 8, MSE,
             None, 100),
    "xdl": (lambda ff, p: MISC(p).build_xdl(ff, 8, 2, 100), 8, MSE, None,
            100),
    "mlp_unify": (lambda ff, p: MISC(p).build_mlp_unify(ff, 8, 64,
                                                        (128,) * 3),
                  8, None, 128, None),
    "candle_uno": (lambda ff, p: MISC(p).build_candle_uno(
        ff, 8, (64,) * 2, (64,) * 2), 8, MSE, None, None),
}


@pytest.mark.parametrize("model", sorted(CASES))
def test_forward_and_one_step_match_jax(model):
    build, batch, loss, classes, vocab = CASES[model]
    jff, tff = build_pair(build, batch, **({"loss": loss} if loss else {}))
    xs, y = data(tff, batch, classes=classes or 1000, vocab=vocab)
    check_forward(jff, tff, xs)
    print(model, check_step(jff, tff, xs, y))


def test_vision_train_flops_counts_conv_dense_and_bmm():
    c = ft.FFConfig()
    c.batch_size = 2
    ff = ft.FFModel(c, device="cpu")
    tv.build_alexnet_cifar10(ff, 2)
    ff.compile()
    convs = [(3, 64, 32), (64, 192, 16), (192, 384, 8), (384, 256, 8)]
    want = sum(2 * 2 * co * hw * hw * ci * 9 for ci, co, hw in convs)
    want += 2 * 2 * (256 * 4 * 4 * 512 + 512 * 10)
    assert ft.models.train_flops_per_step(ff) == 3 * want


def test_alexnet_cifar10_loss_falls_through_fit():
    c = ft.FFConfig()
    c.batch_size, c.seed = 8, 0
    ff = ft.FFModel(c, device="cpu")
    tv.build_alexnet_cifar10(ff, 8)
    ff.compile(optimizer=ft.AdamOptimizer(ff, alpha=3e-4),
               loss_type=ft.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               metrics=[ft.MetricsType.METRICS_ACCURACY])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, 10, (16, 1)).astype(np.int32)
    perf = ff.fit(x, y, epochs=10)
    losses = np.asarray(ff.fit_history.loss)
    assert losses.shape == (20,) and np.isfinite(losses).all()
    assert perf.train_all == 16 * 10
    assert losses[-2:].mean() < 0.5 * losses[:2].mean(), losses


def test_conv_and_batch_norm_weights_move_one_to_one():
    """``set_params_numpy`` takes the JAX package's conv kernels (HWIO,
    4-D) and batch-norm scale and bias (1-D) as they are, and
    ``get_params_numpy`` gives them back bitwise."""
    import jax

    import flexflow_tpu as fj

    def build(ff, pkg):
        x = ff.create_tensor((2, 3, 8, 8))
        t = ff.conv2d(x, 6, 3, 3, 1, 1, 1, 1, groups=1)
        t = ff.batch_norm(t)
        t = ff.conv2d(t, 4, 1, 3, 1, 1, 0, 1, groups=2)
        ff.flat(t)

    jc = fj.FFConfig()
    jc.batch_size = 2
    jff = fj.FFModel(jc)
    build(jff, fj)
    jff.compile(loss_type=fj.LossType.LOSS_IDENTITY)
    tc = ft.FFConfig()
    tc.batch_size = 2
    tff = ft.FFModel(tc, device="cpu")
    build(tff, ft)
    tff.compile(loss_type=ft.LossType.LOSS_IDENTITY)
    want = jax.device_get(jff.params)
    tff.set_params_numpy(want)
    got = tff.get_params_numpy()
    assert {n: {w: a.shape for w, a in ws.items()} for n, ws in got.items()} \
        == {"conv2d_0": {"kernel": (3, 3, 3, 6), "bias": (6,)},
            "batchnorm_1": {"scale": (6,), "bias": (6,)},
            "conv2d_2": {"kernel": (1, 3, 3, 4), "bias": (4,)}}
    for n, ws in want.items():
        for w, a in ws.items():
            np.testing.assert_array_equal(got[n][w], np.asarray(a))
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    np.testing.assert_allclose(tff.predict(x), np.asarray(jff.predict(x)),
                               atol=1e-5, rtol=0)
