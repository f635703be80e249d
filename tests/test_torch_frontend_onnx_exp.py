"""The port's ONNX and tf.keras (keras_exp) importers against the JAX
package's, on the CPU.

* ONNX: without the ``onnx`` package both packages refuse with the same
  message; ``ONNXModelKeras``' weight-path Transpose alias and bias-add
  promotion (no package needed) act alike in both; the real-ONNX graphs
  need the package (``importorskip("onnx")``) and build the same shapes.
* keras_exp: the DAG walker over a fake ``tensorflow`` module (the JAX
  package's fixture, tests/test_keras_exp.py) builds the same layer graph
  in both packages, and one SGD step from the same weights ends within
  1e-5; a real tf.keras MLP and CNN (``importorskip("tensorflow")``)
  build the same graphs and predict within 1e-5 of JAX with the same
  weights.
"""
import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import flexflow_tpu as fj
import flexflow_tpu_torch as ft

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = [fj, ft]


def _frontend(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.frontends.{name}")


def _ffmodel(pkg, batch):
    config = pkg.FFConfig()
    config.batch_size, config.seed = batch, 3
    return pkg.FFModel(config) if pkg is fj else \
        pkg.FFModel(config, device="cpu")


def _have(name):
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def _layers(ff):
    return [(layer.name, layer.op_type.name) for layer in ff._layers]


def _carry(jff, tff):
    """The JAX params into the port's (same node names)."""
    tff.set_params_numpy({n: {w: np.asarray(a) for w, a in ws.items()}
                          for n, ws in jff.params.items()})


# ------------------------------------------------------------------ ONNX
@pytest.mark.skipif(_have("onnx"), reason="the onnx package is installed")
@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_onnx_gate_message(pkg):
    with pytest.raises(ImportError, match="onnx package is required"):
        _frontend(pkg, "onnx").ONNXModel("nonexistent.onnx")


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_onnx_keras_transpose_weight_alias(pkg):
    cls = _frontend(pkg, "onnx").ONNXModelKeras
    m = cls.__new__(cls)  # skip the onnx load
    m.initializers = {"W": np.arange(12, dtype=np.float32).reshape(3, 4)}
    handler = m._custom_handler("Transpose")
    node = SimpleNamespace(input=["W"], output=["W_t"])
    assert handler(None, node, [None], lambda n, k, d=None: d) is None
    np.testing.assert_array_equal(m.initializers["W_t"],
                                  m.initializers["W"].T)
    calls = {}

    class FF:
        def transpose(self, x, perm):
            calls["perm"] = perm
            return "transposed"

    node2 = SimpleNamespace(input=["act"], output=["act_t"])
    act = SimpleNamespace(dims=(2, 3, 4))
    got = handler(FF(), node2, [act],
                  lambda n, k, d=None: [0, 2, 1] if k == "perm" else d)
    assert got == "transposed" and calls["perm"] == [0, 2, 1]
    handler(FF(), node2, [act], lambda n, k, d=None: d)
    assert calls["perm"] == [2, 1, 0]  # ONNX default: reversed axes


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.__name__)
def test_onnx_keras_bias_add_promotes_initializer(pkg):
    cls = _frontend(pkg, "onnx").ONNXModelKeras
    m = cls.__new__(cls)
    m.initializers = {"b": np.ones(8, dtype=np.float32)}
    calls = {}

    class FF:
        def constant(self, arr):
            calls["const"] = arr
            return "const_tensor"

        def add(self, a, b):
            calls["add"] = (a, b)
            return "sum"

    node = SimpleNamespace(input=["h", "b"], output=["hb"])
    got = m._custom_handler("Add")(FF(), node, ["h_tensor", None],
                                   lambda n, k, d=None: d)
    assert got == "sum"
    np.testing.assert_array_equal(calls["const"], np.ones(8))
    assert calls["add"] == ("h_tensor", "const_tensor")


def test_onnx_split_gap_unsqueeze():
    onnx = pytest.importorskip("onnx")
    from onnx import TensorProto, helper

    nodes = [helper.make_node("GlobalAveragePool", ["x"], ["g"]),
             helper.make_node("Flatten", ["g"], ["f"]),
             helper.make_node("Split", ["f"], ["s0", "s1"], axis=1),
             helper.make_node("Add", ["s0", "s1"], ["y"])]
    graph = helper.make_graph(
        nodes, "t",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, [2, 8, 4, 4])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [2, 4])])
    model = onnx.helper.make_model(graph)
    for pkg in PKGS:
        ff = _ffmodel(pkg, 2)
        outs = _frontend(pkg, "onnx").ONNXModel(model).apply(
            ff, {"x": ff.create_tensor((2, 8, 4, 4))})
        assert tuple(outs[0].dims) == (2, 4)


def test_onnx_keras_full_graph():
    onnx = pytest.importorskip("onnx")
    from onnx import TensorProto, helper, numpy_helper

    w = np.zeros((8, 16), dtype=np.float32)
    b = np.zeros((8,), dtype=np.float32)
    nodes = [helper.make_node("Transpose", ["W"], ["W_t"], perm=[1, 0]),
             helper.make_node("MatMul", ["x", "W_t"], ["h"]),
             helper.make_node("Add", ["h", "b"], ["hb"]),
             helper.make_node("Relu", ["hb"], ["y"])]
    graph = helper.make_graph(
        nodes, "keras_style",
        [helper.make_tensor_value_info("x", TensorProto.FLOAT, [4, 16])],
        [helper.make_tensor_value_info("y", TensorProto.FLOAT, [4, 8])],
        initializer=[numpy_helper.from_array(w, "W"),
                     numpy_helper.from_array(b, "b")])
    model = onnx.helper.make_model(graph)
    graphs = []
    for pkg in PKGS:
        ff = _ffmodel(pkg, 4)
        outs = _frontend(pkg, "onnx").ONNXModelKeras(model).apply(
            ff, {"x": ff.create_tensor((4, 16))})
        assert tuple(outs[0].dims) == (4, 8)
        graphs.append(_layers(ff))
    assert graphs[0] == graphs[1]


# ------------------------------------------------------------- keras_exp
class _Tensor:
    def __init__(self, shape):
        self.shape = shape


class _Node:
    def __init__(self, inputs, outputs):
        self.input_tensors = inputs
        self.output_tensors = outputs


class _LayerBase:
    def __init__(self, name):
        self.name = name
        self._inbound_nodes = []

    def __call__(self, *inputs):
        ins = list(inputs)
        out = _Tensor(self.out_shape([t.shape for t in ins]))
        self._inbound_nodes.append(_Node(ins, [out]))
        return out


def _fake_tf():
    """A module shaped like tensorflow as far as keras_exp walks it (the
    JAX package's fixture, tests/test_keras_exp.py)."""
    import types

    tf = types.ModuleType("tensorflow")
    keras = types.ModuleType("tensorflow.keras")
    layers = types.ModuleType("tensorflow.keras.layers")

    def relu(x):
        return x

    def softmax(x):
        return x

    class InputLayer(_LayerBase):
        pass

    class Dense(_LayerBase):
        def __init__(self, units, activation=None, use_bias=True,
                     name="dense"):
            super().__init__(name)
            self.units, self.activation, self.use_bias = (units, activation,
                                                          use_bias)

        def out_shape(self, shapes):
            return shapes[0][:-1] + (self.units,)

    class Add(_LayerBase):
        def out_shape(self, shapes):
            return shapes[0]

    class Concatenate(_LayerBase):
        def __init__(self, axis=-1, name="concat"):
            super().__init__(name)
            self.axis = axis

        def out_shape(self, shapes):
            out = list(shapes[0])
            out[self.axis] = sum(s[self.axis] for s in shapes)
            return tuple(out)

    class Activation(_LayerBase):
        def __init__(self, activation, name="act"):
            super().__init__(name)
            self.activation = activation

        def out_shape(self, shapes):
            return shapes[0]

    class Dropout(_LayerBase):
        def __init__(self, rate, name="drop"):
            super().__init__(name)
            self.rate = rate

        def out_shape(self, shapes):
            return shapes[0]

    unbuilt = [type(n, (_LayerBase,), {}) for n in (
        "Conv2D", "MaxPooling2D", "AveragePooling2D", "Flatten",
        "BatchNormalization")]
    for cls in [InputLayer, Dense, Add, Concatenate, Activation,
                Dropout] + unbuilt:
        setattr(layers, cls.__name__, cls)
    keras.layers = layers
    tf.keras = keras
    return tf, relu, softmax


def _fake_model(tf, relu, softmax):
    L = tf.keras.layers
    x = _Tensor((8, 64))
    layers = [L.Dense(32, activation=relu, name="fc1"),
              L.Dense(16, name="branch_a"), L.Dense(16, name="branch_b"),
              L.Add(name="merge"), L.Dropout(0.0, name="drop"),
              L.Dense(10, name="head"), L.Activation(softmax, name="probs")]
    d1, b1, b2, add, drop, head, act = layers
    h = d1(x)
    o = act(head(drop(add(b1(h), b2(h)))))
    return SimpleNamespace(inputs=[x], outputs=[o], layers=layers)


def test_keras_exp_fake_tf_dag_matches(monkeypatch):
    tf, relu, softmax = _fake_tf()
    monkeypatch.setitem(sys.modules, "tensorflow", tf)
    model = _fake_model(tf, relu, softmax)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(8, 64)).astype(np.float32)
    ys = rng.integers(0, 10, size=(8, 1)).astype(np.int32)
    ffs = {}
    for pkg in PKGS:
        ff = _ffmodel(pkg, 8)
        outs = _frontend(pkg, "keras_exp").KerasExpModel(model).apply(
            ff, [ff.create_tensor((8, 64), name="x")])
        assert len(outs) == 1 and tuple(outs[0].dims) == (8, 10)
        ff.compile(optimizer=pkg.SGDOptimizer(None, lr=0.01),
                   loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        ffs[pkg] = ff
    jff, tff = ffs[fj], ffs[ft]
    types = [t for _n, t in _layers(tff)]
    assert _layers(tff) == _layers(jff)
    assert types.count("OP_LINEAR") == 4
    assert {"OP_EW_ADD", "OP_DROPOUT", "OP_SOFTMAX"} <= set(types)
    _carry(jff, tff)
    jff.fit(x=[xs], y=ys, epochs=1)
    tff.fit(x=[xs], y=ys, epochs=1)
    for n, ws in jff.params.items():
        for w, a in ws.items():
            np.testing.assert_allclose(tff.get_params_numpy()[n][w],
                                       np.asarray(a), **TOL)


def test_keras_exp_gate_message_without_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for pkg in PKGS:
        mod = _frontend(pkg, "keras_exp")
        with pytest.raises(ImportError, match="keras_exp"):
            mod._require_tf()
        with pytest.raises(ImportError):
            mod.KerasExpModel(None)


def _real_tf():
    return pytest.importorskip("tensorflow", reason="tensorflow not "
                               "installed")


def _trace_real(model, in_shape, batch):
    ffs = {}
    for pkg in PKGS:
        ff = _ffmodel(pkg, batch)
        outs = _frontend(pkg, "keras_exp").KerasExpModel(model).apply(
            ff, [ff.create_tensor((batch,) + in_shape, name="x")])
        assert tuple(outs[0].dims) == (batch, 10)
        ff.compile(optimizer=pkg.SGDOptimizer(None, lr=0.01),
                   loss_type=pkg.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        ffs[pkg] = ff
    jff, tff = ffs[fj], ffs[ft]
    assert _layers(tff) == _layers(jff)
    _carry(jff, tff)
    x = np.random.default_rng(0).normal(size=(batch,) + in_shape).astype(
        np.float32)
    np.testing.assert_allclose(tff.predict(x, batch_size=batch),
                               jff.predict(x, batch_size=batch), **TOL)
    return [t for _n, t in _layers(tff)]


def test_keras_exp_real_tf_mlp_matches():
    tf = _real_tf()
    inp = tf.keras.Input(shape=(64,), batch_size=8)
    h = tf.keras.layers.Dense(32, activation="relu", name="fc1")(inp)
    a = tf.keras.layers.Dense(16, name="branch_a")(h)
    b = tf.keras.layers.Dense(16, name="branch_b")(h)
    m = tf.keras.layers.Add(name="merge")([a, b])
    o = tf.keras.layers.Dense(10, activation="softmax", name="head")(m)
    types = _trace_real(tf.keras.Model(inp, o), (64,), 8)
    assert types.count("OP_LINEAR") == 4
    assert {"OP_EW_ADD", "OP_SOFTMAX"} <= set(types)


def test_keras_exp_real_tf_cnn_matches():
    tf = _real_tf()
    inp = tf.keras.Input(shape=(3, 16, 16), batch_size=4)
    t = tf.keras.layers.Conv2D(8, (3, 3), padding="same",
                               data_format="channels_first",
                               activation="relu", name="c1")(inp)
    t = tf.keras.layers.MaxPooling2D((2, 2), (2, 2),
                                     data_format="channels_first",
                                     name="p1")(t)
    t = tf.keras.layers.Flatten(name="flat")(t)
    o = tf.keras.layers.Dense(10, activation="softmax", name="head")(t)
    types = _trace_real(tf.keras.Model(inp, o), (3, 16, 16), 4)
    assert {"OP_CONV2D", "OP_POOL2D", "OP_FLAT"} <= set(types)
