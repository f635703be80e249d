"""Keras frontend: tf.keras-style Sequential/functional API over FFModel.

A port of ``flexflow_tpu.frontends.keras``, itself a rebuild of the
reference's Keras clone (python/flexflow/keras/: Sequential and
functional Model whose ``compile`` builds an FFModel + optimizer and ``fit``
drives the training loop — models/base_model.py:128,198; layer classes under
keras/layers/). Compact single-module version with the same user surface:
string loss/metric/optimizer names resolve exactly like the reference's
losses.py/metrics.py/optimizers.py. ``Sequential`` and ``Model`` take the
port's explicit ``device`` (``None`` means CUDA, and raises on a host
without a GPU, as ``FFModel`` does).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import FFConfig
from ..ffconst import ActiMode, AggrMode, DataType, LossType, MetricsType, PoolType
from ..model import FFModel
from ..execution.optimizers import AdamOptimizer, SGDOptimizer

_LOSS_MAP = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}
_METRIC_MAP = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}
_ACTI_MAP = {
    None: ActiMode.AC_MODE_NONE, "linear": ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU, "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH, "gelu": ActiMode.AC_MODE_GELU,
}


class Layer:
    name_counter = 0

    def __init__(self, name: Optional[str] = None):
        type(self).name_counter += 1
        self.name = name or f"{type(self).__name__.lower()}_{type(self).name_counter}"

    def __call__(self, prev):
        """Functional composition: returns a _Node. A raw ``Input`` layer is
        accepted where a node is expected (the reference keras examples write
        ``Dense(...)(input0)`` with input0 = Input(shape=...))."""
        def as_node(p):
            return _Node(p, []) if isinstance(p, Input) else p

        if isinstance(prev, (list, tuple)):
            return _Node(self, [as_node(p) for p in prev])
        return _Node(self, [as_node(prev)])

    def apply(self, ff: FFModel, inputs):
        raise NotImplementedError

    # -- weight access for net2net-style transfer (reference:
    #    keras/layers get_weights/set_weights used by the *_net2net
    #    examples). ``_ff_tensor`` is recorded by the model build. --------
    def _ff_params(self, ffmodel):
        ff = ffmodel.ffmodel if hasattr(ffmodel, "ffmodel") else ffmodel
        tensors = getattr(self, "_ff_tensors", [])
        assert tensors, \
            f"{self.name}: layer not built yet (compile the model first)"
        assert len(tensors) == 1, (
            f"{self.name}: applied at {len(tensors)} graph positions — "
            "each call instantiates separate weights here (no keras-style "
            "sharing), so per-layer get/set_weights would be ambiguous")
        return ff, tensors[0].owner_layer.name

    def _weight_tensors(self, ffmodel):
        """(model, {wname: weight Tensor}) of the layer's one graph node, in
        declaration order."""
        ff, lname = self._ff_params(ffmodel)
        layer = self._ff_tensors[0].owner_layer
        return ff, {w.name.split(".")[-1]: w for w in layer.weights
                    if w.name.split(".")[-1] in ff.params[lname]}

    def _keys(self, ws) -> List[str]:
        return [k for k in ("kernel", "bias") if k in ws] or list(ws)

    def get_weights(self, ffmodel):
        """Returns (kernel, bias) — or a 1-tuple for bias-less layers."""
        ff, ws = self._weight_tensors(ffmodel)
        return tuple(ff._get_weight_by_tensor(ws[k]) for k in self._keys(ws))

    def set_weights(self, ffmodel, kernel, bias=None):
        """Positional write mirroring get_weights' order: kernel/bias where
        declared, else the layer's params in declaration order (so e.g.
        BatchNormalization scale/bias round-trip too). Written through the
        model's weight setter, which drops the captured steps."""
        ff, ws = self._weight_tensors(ffmodel)
        keys = self._keys(ws)
        vals = [kernel] + ([] if bias is None else [bias])
        assert len(vals) == len(keys), (
            f"{self.name}: set_weights got {len(vals)} arrays for params "
            f"{keys} — pass every declared weight")
        for k, arr in zip(keys, vals):
            arr = np.asarray(arr)
            want = tuple(ws[k].dims)
            assert arr.shape == want, (self.name, k, arr.shape, want)
            ff._set_weight_by_tensor(ws[k], arr)


class _Node:
    def __init__(self, layer: Layer, inputs: List["_Node"]):
        self.layer = layer
        self.inputs = inputs


class Input(Layer):
    def __init__(self, shape: Sequence[int], dtype: str = "float32",
                 name=None):
        super().__init__(name)
        self.shape = tuple(shape)
        self.dtype = dtype

    def __call__(self, *a, **k):  # Input is a source, already a node
        raise TypeError("Input is not callable")


def InputTensor(shape, dtype="float32", name=None) -> _Node:
    layer = Input(shape, dtype, name)
    return _Node(layer, [])


class Dense(Layer):
    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None, name=None, **kw):
        super().__init__(name)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def apply(self, ff, inputs):
        from . import keras_initializers as KI
        from . import keras_regularizers as KR

        return ff.dense(inputs[0], self.units, _ACTI_MAP[self.activation],
                        self.use_bias,
                        kernel_initializer=KI.resolve(self.kernel_initializer),
                        bias_initializer=KI.resolve(self.bias_initializer),
                        kernel_regularizer=KR.resolve(self.kernel_regularizer),
                        name=self.name)


class Conv2D(Layer):
    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, groups: int = 1,
                 use_bias: bool = True, name=None, **kw):
        super().__init__(name)
        self.filters = filters
        ks = kernel_size if isinstance(kernel_size, (tuple, list)) else \
            (kernel_size, kernel_size)
        st = strides if isinstance(strides, (tuple, list)) else \
            (strides, strides)
        self.kernel_size, self.strides = tuple(ks), tuple(st)
        self.padding = padding
        self.activation = activation
        self.groups = groups
        self.use_bias = use_bias

    def apply(self, ff, inputs):
        kh, kw_ = self.kernel_size
        if self.padding == "same":
            ph, pw = kh // 2, kw_ // 2
        elif self.padding == "valid":
            ph, pw = 0, 0
        else:
            ph, pw = self.padding
        return ff.conv2d(inputs[0], self.filters, kh, kw_, self.strides[0],
                         self.strides[1], ph, pw, _ACTI_MAP[self.activation],
                         self.groups, self.use_bias, name=self.name)


class _Pool2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        super().__init__(name)
        ps = pool_size if isinstance(pool_size, (tuple, list)) else \
            (pool_size, pool_size)
        self.pool_size = tuple(ps)
        self.strides = tuple(strides) if strides else self.pool_size
        self.padding = padding

    def apply(self, ff, inputs):
        ph = self.pool_size[0] // 2 if self.padding == "same" else 0
        pw = self.pool_size[1] // 2 if self.padding == "same" else 0
        return ff.pool2d(inputs[0], self.pool_size[0], self.pool_size[1],
                         self.strides[0], self.strides[1], ph, pw,
                         self.pool_type, name=self.name)


class MaxPooling2D(_Pool2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pool2D):
    pool_type = PoolType.POOL_AVG


class Flatten(Layer):
    def apply(self, ff, inputs):
        return ff.flat(inputs[0], name=self.name)


class Activation(Layer):
    def __init__(self, activation: str, name=None):
        super().__init__(name)
        self.activation = activation

    def apply(self, ff, inputs):
        x = inputs[0]
        if self.activation == "softmax":
            return ff.softmax(x, name=self.name)
        fn = {"relu": ff.relu, "sigmoid": ff.sigmoid, "tanh": ff.tanh,
              "gelu": ff.gelu, "elu": ff.elu}[self.activation]
        return fn(x, name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, name=None):
        super().__init__(name)
        self.rate = rate

    def apply(self, ff, inputs):
        return ff.dropout(inputs[0], self.rate, name=self.name)


class Embedding(Layer):
    def __init__(self, input_dim: int, output_dim: int, name=None, **kw):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim

    def apply(self, ff, inputs):
        return ff.embedding(inputs[0], self.input_dim, self.output_dim,
                            AggrMode.AGGR_MODE_NONE, name=self.name)


class BatchNormalization(Layer):
    def apply(self, ff, inputs):
        return ff.batch_norm(inputs[0], relu=False, name=self.name)


class LayerNormalization(Layer):
    def __init__(self, axis=-1, epsilon=1e-5, name=None):
        super().__init__(name)
        self.axis = axis if isinstance(axis, (list, tuple)) else [axis]
        self.epsilon = epsilon

    def apply(self, ff, inputs):
        return ff.layer_norm(inputs[0], axes=list(self.axis),
                             eps=self.epsilon, name=self.name)


class Concatenate(Layer):
    def __init__(self, axis: int = 1, name=None):
        super().__init__(name)
        self.axis = axis

    def apply(self, ff, inputs):
        return ff.concat(list(inputs), axis=self.axis, name=self.name)


class Add(Layer):
    def apply(self, ff, inputs):
        return ff.add(inputs[0], inputs[1], name=self.name)


class Subtract(Layer):
    def apply(self, ff, inputs):
        return ff.subtract(inputs[0], inputs[1], name=self.name)


class Multiply(Layer):
    def apply(self, ff, inputs):
        return ff.multiply(inputs[0], inputs[1], name=self.name)


class Divide(Layer):
    def apply(self, ff, inputs):
        return ff.divide(inputs[0], inputs[1], name=self.name)


class Maximum(Layer):
    """reference: examples/python/keras/elementwise_max_min.py."""

    def apply(self, ff, inputs):
        return ff.max(inputs[0], inputs[1], name=self.name)


class Minimum(Layer):
    def apply(self, ff, inputs):
        return ff.min(inputs[0], inputs[1], name=self.name)


class Reshape(Layer):
    """target_shape excludes the batch dim (keras contract; reference:
    python/flexflow/keras/layers/core.py Reshape)."""

    def __init__(self, target_shape, name=None):
        super().__init__(name)
        self.target_shape = tuple(int(d) for d in target_shape)

    def apply(self, ff, inputs):
        batch = inputs[0].dims[0]
        return ff.reshape(inputs[0], (batch,) + self.target_shape,
                          name=self.name)


def concatenate(tensors, axis: int = 1, name=None):
    """Functional alias (reference: keras layers concatenate())."""
    return Concatenate(axis=axis, name=name)(tensors)


# --------------------------------------------------------------------- models
class _BaseModel:
    """reference: python/flexflow/keras/models/base_model.py."""

    def __init__(self, name: Optional[str] = None, device=None):
        self.name = name
        self.device = device
        self.ffmodel: Optional[FFModel] = None
        self.ffconfig = FFConfig()

    def _resolve_optimizer(self, optimizer):
        if isinstance(optimizer, str):
            return {"sgd": SGDOptimizer(None, lr=0.01),
                    "adam": AdamOptimizer(None)}[optimizer.lower()]
        if isinstance(optimizer, dict):  # keras config dict
            name = optimizer.get("class_name", "SGD").lower()
            cfg = optimizer.get("config", {})
            if name == "sgd":
                return SGDOptimizer(None, lr=cfg.get("learning_rate", 0.01),
                                    momentum=cfg.get("momentum", 0.0),
                                    nesterov=cfg.get("nesterov", False))
            return AdamOptimizer(None, alpha=cfg.get("learning_rate", 1e-3))
        return optimizer

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics=("accuracy",), **kw):
        """reference: base_model.py:128 — builds FFModel on ``self.device``
        and compiles."""
        ff = FFModel(self.ffconfig, device=self.device)
        self._build(ff)
        ff.compile(optimizer=self._resolve_optimizer(optimizer),
                   loss_type=_LOSS_MAP[loss],
                   metrics=[_METRIC_MAP[m] for m in metrics])
        self.ffmodel = ff

    def fit(self, x, y, batch_size: Optional[int] = None,
            epochs: int = 1, callbacks=None, **kw):
        """reference: base_model.py:198 — drives FFModel.fit one epoch at a
        time so epoch-level callbacks (callbacks.py) fire exactly like the
        reference's loop; EpochVerifyMetrics-style callbacks early-stop by
        returning True from on_epoch_end. A learning rate a callback set
        reaches the steps through ``FFModel.fit``, which drops the captured
        programs after ``Optimizer.set_learning_rate``."""
        assert self.ffmodel is not None, "compile the model first"
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        perf = None
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            perf = self.ffmodel.fit(x, y, batch_size=batch_size, epochs=1)
            if getattr(self.ffmodel, "_preempted_at_step", None) is not None:
                # the inner fit flushed its preemption checkpoint and
                # returned; looping on would burn the grace window
                break
            stop = False
            for cb in callbacks:
                if cb.on_epoch_end(epoch):
                    stop = True
            if stop:
                break
        for cb in callbacks:
            cb.on_train_end()
        return perf

    def evaluate(self, x, y, batch_size: Optional[int] = None):
        return self.ffmodel.eval(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: Optional[int] = None):
        return self.ffmodel.predict(x, batch_size=batch_size)

    def _build(self, ff: FFModel) -> None:
        raise NotImplementedError


class Sequential(_BaseModel):
    def __init__(self, layers: Optional[List[Layer]] = None, name=None,
                 device=None):
        super().__init__(name, device)
        self.layers: List[Layer] = list(layers or [])

    def add(self, layer: Layer) -> None:
        self.layers.append(layer)

    def _build(self, ff: FFModel) -> None:
        assert isinstance(self.layers[0], Input), \
            "first layer must be Input(shape=...)"
        inp = self.layers[0]
        dtype = DataType.DT_INT32 if "int" in inp.dtype else DataType.DT_FLOAT
        t = ff.create_tensor((self.ffconfig.batch_size,) + inp.shape, dtype)
        for layer in self.layers[1:]:
            layer._ff_tensors = []  # recompile starts a fresh record
        for layer in self.layers[1:]:
            t = layer.apply(ff, [t])
            layer._ff_tensors = layer._ff_tensors + \
                [t[0] if isinstance(t, list) else t]


class Model(_BaseModel):
    """Functional API: Model(inputs=[node...], outputs=node)."""

    def __init__(self, inputs, outputs, name=None, device=None):
        super().__init__(name, device)
        self.inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        self.outputs = outputs if isinstance(outputs, (list, tuple)) else \
            [outputs]

    def _build(self, ff: FFModel) -> None:
        built: Dict[int, Any] = {}

        def reset_records(node: _Node):
            if id(node) in seen_reset:
                return
            seen_reset.add(id(node))
            node.layer._ff_tensors = []
            for i in node.inputs:
                reset_records(i)

        seen_reset: set = set()
        for out in self.outputs:
            reset_records(out)

        def build_node(node: _Node):
            # Input tensors key by the LAYER: the same Input may be wrapped
            # in several _Node shells (one per consumer call) and must build
            # exactly one graph input
            key = (id(node.layer) if isinstance(node.layer, Input)
                   else id(node))
            if key in built:
                return built[key]
            if isinstance(node.layer, Input):
                inp = node.layer
                dtype = DataType.DT_INT32 if "int" in inp.dtype else \
                    DataType.DT_FLOAT
                t = ff.create_tensor(
                    (self.ffconfig.batch_size,) + inp.shape, dtype)
            else:
                ins = [build_node(i) for i in node.inputs]
                t = node.layer.apply(ff, ins)
                node.layer._ff_tensors = getattr(
                    node.layer, "_ff_tensors", []) + \
                    [t[0] if isinstance(t, list) else t]
            built[key] = t
            return t

        # declared input order fixes the fit(x=[...]) binding order,
        # independent of output-traversal order
        for inp in self.inputs:
            build_node(inp if isinstance(inp, _Node) else _Node(inp, []))
        for out in self.outputs:
            build_node(out)


# -- reference-parity submodules (python/flexflow/keras/{callbacks,datasets,
# preprocessing}) exposed under the frontend namespace -------------------------
from . import keras_backend as backend  # noqa: E402
from . import keras_callbacks as callbacks  # noqa: E402
from . import keras_datasets as datasets  # noqa: E402
from . import keras_initializers as initializers  # noqa: E402
from . import keras_preprocessing as preprocessing  # noqa: E402
from . import keras_regularizers as regularizers  # noqa: E402
from .keras_callbacks import (Callback, EpochVerifyMetrics,  # noqa: E402
                              LearningRateScheduler, VerifyMetrics)
from .keras_initializers import (GlorotUniform, RandomNormal,  # noqa: E402
                                 RandomUniform, Zeros)
from .keras_regularizers import L1, L2  # noqa: E402
