"""The port's torch.fx frontend against the JAX package's, on the CPU.

The same plain torch module (weights from ``torch.manual_seed``) is traced
through ``PyTorchModel`` by both packages, compiled, and given the module's
weights by ``copy_torch_weights``; inputs come from numpy's
``default_rng``. Checked (fp32; the two sides differ in summation order
only):

* the JAX package's frontend cases (MLP, convnet, T5 norm, ragged split,
  adaptive average pool) and an attention block over
  ``F.scaled_dot_product_attention`` with a bool mask, an additive mask,
  ``is_causal`` and neither: both packages build the same op types and
  layer names, their ``predict`` agree within 1e-5, and the port's is
  within the JAX tests' band of the module's own output;
* a 2-layer, 64-wide, 4-head encoder shaped like the BERT-Large proxy:
  the forward within 1e-5 of JAX's, one step's loss within 1e-5 and grads
  within 1e-5 (relative 1e-4), and the params after one Adam step of
  ``fit`` within 1e-5;
* ``.ff`` files: both packages write the same lines, and a file written by
  either package, read by either, predicts what the direct trace does;
* a step program built before ``copy_torch_weights`` is dropped by it:
  the next ``fit`` trains the copied weights.
"""
import numpy as np
import pytest
import torch

import jax

import flexflow_tpu as fj
import flexflow_tpu_torch as ft
from torch_frontend_pairs import (Encoder, TorchAdaptivePool, TorchConvNet,
                                  TorchMLP, TorchRaggedSplit, TorchSDPA,
                                  TorchT5Block, fx, inputs, seeded, traced)
from torch_training_pairs import (assert_trees_close, jax_loss_and_grads,
                                  port_loss_and_grads)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(module, in_shapes, batch, **kw):
    jff = traced(fj, module, in_shapes, batch, device=None, **kw)
    tff = traced(ft, module, in_shapes, batch, **kw)
    return jff, tff


def _graph(ff):
    """The layer graph the frontend built: names and op types."""
    return [(layer.name, layer.op_type.name) for layer in ff._layers]


CASES = {
    # module, input shape, batch, band to the module's own output
    "mlp": (TorchMLP, (16,), 4, dict(rtol=1e-3, atol=1e-4)),
    "convnet": (TorchConvNet, (3, 8, 8), 4, dict(rtol=1e-3, atol=1e-4)),
    "t5norm": (TorchT5Block, (16,), 4, dict(rtol=1e-3, atol=1e-4)),
    "ragged_split": (TorchRaggedSplit, (10,), 4, dict(rtol=1e-3,
                                                      atol=1e-5)),
    "adaptive_pool": (TorchAdaptivePool, (3, 8, 8), 2, dict(rtol=1e-4,
                                                            atol=1e-5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_frontend_cases_match(case):
    cls, shape, batch, band = CASES[case]
    module = seeded(cls)
    jff, tff = _pair(module, [shape], batch)
    assert _graph(tff) == _graph(jff)
    x = inputs((batch,) + shape)
    got = tff.predict(x, batch_size=batch)
    np.testing.assert_allclose(got, jff.predict(x, batch_size=batch), **TOL)
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **band)


@pytest.mark.parametrize("mode", ["bool", "additive", "causal", "none"])
def test_sdpa_masks_match(mode):
    module = seeded(TorchSDPA, mode)
    jff, tff = _pair(module, [(8, 32)], 2)
    types = [t for _n, t in _graph(tff)]
    assert types == [t for _n, t in _graph(jff)]
    assert types.count("OP_SDPA") == 1
    sdpa = [layer for layer in tff._layers
            if layer.op_type.name == "OP_SDPA"][0]
    assert sdpa.attrs["causal"] == (mode == "causal")
    assert len(sdpa.inputs) == (4 if mode in ("bool", "additive") else 3)
    x = inputs((2, 8, 32), seed=1)
    got = tff.predict(x, batch_size=2)
    np.testing.assert_allclose(got, jff.predict(x, batch_size=2), **TOL)
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


ENC_B, ENC_S, ENC_D = 4, 16, 64


@pytest.fixture(scope="module")
def encoder_pair():
    module = seeded(Encoder, d=ENC_D, heads=4, layers=2)
    kw = dict(loss=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    jff = traced(fj, module, [(ENC_S, ENC_D)], ENC_B, device=None,
                 optimizer=fj.AdamOptimizer(None, alpha=1e-3), **kw)
    tff = traced(ft, module, [(ENC_S, ENC_D)], ENC_B,
                 optimizer=ft.AdamOptimizer(None, alpha=1e-3), **kw)
    return module, jff, tff


def test_encoder_forward_matches(encoder_pair):
    module, jff, tff = encoder_pair
    assert _graph(tff) == _graph(jff)
    assert [t for _n, t in _graph(tff)].count("OP_SDPA") == 2
    x = inputs((ENC_B, ENC_S, ENC_D), seed=2)
    got = tff.predict(x, batch_size=ENC_B)
    np.testing.assert_allclose(got, jff.predict(x, batch_size=ENC_B), **TOL)
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_encoder_one_adam_step_matches(encoder_pair):
    _module, jff, tff = encoder_pair
    x = inputs((ENC_B, ENC_S, ENC_D), seed=3)
    y = np.array([[0], [1], [1], [0]], np.int32)
    # the copied weights are the module's in both packages
    assert_trees_close(jax.device_get(jff.params), tff.get_params_numpy(),
                       rtol=0, atol=0)
    jl, jg = jax_loss_and_grads(jff, x, y)
    tl, tg = port_loss_and_grads(tff, x, y)
    assert abs(tl - jl) <= 1e-5, (tl, jl)
    assert_trees_close(jg, tg, **GRAD_TOL)
    jff.fit(x, y, epochs=1)
    tff.fit(x, y, epochs=1)
    assert abs(tff.fit_history.loss[0] - jl) <= 1e-5
    assert_trees_close(jax.device_get(jff.params), tff.get_params_numpy(),
                       **TOL)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(12, 24)
        self.act = torch.nn.ReLU()
        self.drop = torch.nn.Dropout(0.0)
        self.fc2 = torch.nn.Linear(24, 5)
        self.sm = torch.nn.Softmax(dim=-1)

    def forward(self, x):
        return self.sm(self.fc2(self.drop(self.act(self.fc1(x)))))


def _from_file(pkg, path, direct):
    """A model of ``pkg`` built by ``file_to_ff`` from ``path``, given the
    weights of ``direct`` (the JAX model traced from the module)."""
    config = pkg.FFConfig()
    config.batch_size = 4
    ff = pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")
    outs = fx(pkg).file_to_ff(path, ff, [ff.create_tensor((4, 12))])
    assert len(outs) == 1 and tuple(outs[0].dims) == (4, 5)
    ff.compile(loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    weights = jax.device_get(direct.params)
    if pkg is fj:
        for n, ws in weights.items():
            for w, arr in ws.items():
                cur = ff.params[n][w]
                ff.params[n][w] = jax.device_put(arr, cur.sharding)
    else:
        ff.set_params_numpy(weights)
    return ff


def test_ff_files_roundtrip_within_and_across_packages(tmp_path):
    net = seeded(_Net)
    paths = {}
    for pkg in (fj, ft):
        paths[pkg] = str(tmp_path / f"{pkg.__name__}.ff")
        fx(pkg).PyTorchModel(net).torch_to_file(paths[pkg])
    lines = open(paths[ft]).read().splitlines()
    assert lines == open(paths[fj]).read().splitlines()
    assert lines[0].endswith("INPUT") and lines[-1].endswith("OUTPUT")
    assert any("LINEAR" in ln for ln in lines)
    direct = traced(fj, net, [(12,)], 4, device=None,
                    loss=fj.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x = inputs((4, 12), seed=4)
    want = direct.predict(x, batch_size=4)
    for writer in (fj, ft):
        for reader in (fj, ft):
            ff = _from_file(reader, paths[writer], direct)
            np.testing.assert_allclose(ff.predict(x, batch_size=4), want,
                                       **TOL, err_msg=f"{writer.__name__} "
                                       f"-> {reader.__name__}")


def test_ff_file_conv_ops_match(tmp_path):
    module = seeded(TorchConvNet)
    texts = []
    for pkg in (fj, ft):
        path = str(tmp_path / f"{pkg.__name__}.ff")
        fx(pkg).PyTorchModel(module).torch_to_file(path)
        texts.append(open(path).read())
        config = pkg.FFConfig()
        config.batch_size = 2
        ff = pkg.FFModel(config) if pkg is fj else \
            pkg.FFModel(config, device="cpu")
        outs = fx(pkg).file_to_ff(path, ff, [ff.create_tensor((2, 3, 8, 8))])
        assert tuple(outs[0].dims) == (2, 5)
    assert texts[0] == texts[1]
    assert all(op in texts[1] for op in ("CONV2D", "POOL2D", "FLAT"))


def test_copy_after_a_captured_step_trains_the_copied_weights():
    """A fit before ``copy_torch_weights`` builds the step program on the
    initial weights; the copy drops it, so the next fit starts from the
    module's weights, as a model that was copied before any fit does."""
    module = seeded(TorchMLP, seed=5)
    x = inputs((4, 16), seed=5)
    y = inputs((4, 4), seed=6)

    def model():
        config = ft.FFConfig()
        config.batch_size, config.seed = 4, 3
        ff = ft.FFModel(config, device="cpu")
        fx(ft).PyTorchModel(module).torch_to_ff(
            ff, [ff.create_tensor((4, 16))])
        ff.compile(optimizer=ft.AdamOptimizer(None, alpha=1e-2),
                   loss_type=ft.LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE)
        return ff

    late = model()
    late.fit(x, y, epochs=1)  # the program on the initial weights
    fx(ft).copy_torch_weights(late)
    late.fit(x, y, epochs=1)
    early = model()
    fx(ft).copy_torch_weights(early)
    early.fit(x, y, epochs=1)
    assert late.fit_history.loss == early.fit_history.loss
    assert_trees_close(early.get_params_numpy(), late.get_params_numpy(),
                       rtol=0, atol=0)
    with torch.no_grad():
        want = float(torch.mean((module(torch.from_numpy(x))
                                 - torch.from_numpy(y)) ** 2))
    assert abs(early.fit_history.loss[0] - want) <= 1e-5
