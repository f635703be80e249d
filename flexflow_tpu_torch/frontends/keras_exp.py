"""keras_exp: trace *real* tf.keras models into FFModel (a port of
``flexflow_tpu.frontends.keras_exp``; reference:
python/flexflow/keras_exp/models/{model,tensor}.py — walks a built tf.keras
model's layer DAG and replays it as FFModel calls).

The module is import-gated on the tensorflow package the same way the ONNX
frontend gates on onnx. ``KerasExpModel(tf_model)`` converts Dense/Conv2D/
Pool/Flatten/BatchNorm/Activation/Add/Concatenate layers via the same
builder mapping as ``frontends.keras``; held against the JAX package on
real tf.keras (Keras 3) functional models and on a fake-tf fixture, so the
walker stays covered on hosts without tensorflow.
"""
from __future__ import annotations

from typing import Dict, List

from ..model import FFModel


def _require_tf():
    try:
        import tensorflow as tf  # noqa: F401

        return tf
    except ImportError as e:
        raise ImportError(
            "tensorflow package is required for the keras_exp frontend "
            "(traces real tf.keras models); install tensorflow or use "
            "flexflow_tpu_torch.frontends.keras, the tf-free Keras-style API"
        ) from e


class KerasExpModel:
    """Trace a built tf.keras model into FFModel builder calls."""

    def __init__(self, tf_model):
        self.tf = _require_tf()
        self.tf_model = tf_model

    def apply(self, ffmodel: FFModel, input_tensors: List) -> List:
        tf = self.tf
        keras = tf.keras
        env: Dict[int, object] = {}
        model = self.tf_model
        for t, inp in zip(model.inputs, input_tensors):
            env[id(t)] = inp

        for layer in model.layers:
            if isinstance(layer, keras.layers.InputLayer):
                continue
            node = layer._inbound_nodes[-1]
            in_ts = node.input_tensors if isinstance(
                node.input_tensors, (list, tuple)) else [node.input_tensors]
            args = [env[id(t)] for t in in_ts]
            out = self._convert(ffmodel, layer, args)
            outs = node.output_tensors if isinstance(
                node.output_tensors, (list, tuple)) else [node.output_tensors]
            env[id(outs[0])] = out
        return [env[id(t)] for t in model.outputs]

    def _convert(self, ff: FFModel, layer, args):
        from ..ffconst import ActiMode, PoolType

        keras = self.tf.keras
        acti = {"relu": ActiMode.AC_MODE_RELU,
                "sigmoid": ActiMode.AC_MODE_SIGMOID,
                "tanh": ActiMode.AC_MODE_TANH,
                "gelu": ActiMode.AC_MODE_GELU,
                None: ActiMode.AC_MODE_NONE,
                "linear": ActiMode.AC_MODE_NONE}
        x = args[0]
        if isinstance(layer, keras.layers.Dense):
            name = getattr(layer.activation, "__name__", None)
            if name == "softmax":
                return ff.softmax(ff.dense(x, layer.units,
                                           use_bias=layer.use_bias,
                                           name=layer.name))
            return ff.dense(x, layer.units, acti.get(name,
                                                     ActiMode.AC_MODE_NONE),
                            use_bias=layer.use_bias, name=layer.name)
        if isinstance(layer, keras.layers.Conv2D):
            kh, kw = layer.kernel_size
            sh, sw = layer.strides
            ph = kh // 2 if layer.padding == "same" else 0
            pw = kw // 2 if layer.padding == "same" else 0
            name = getattr(layer.activation, "__name__", None)
            return ff.conv2d(x, layer.filters, kh, kw, sh, sw, ph, pw,
                             acti.get(name, ActiMode.AC_MODE_NONE),
                             use_bias=layer.use_bias, name=layer.name)
        if isinstance(layer, (keras.layers.MaxPooling2D,
                              keras.layers.AveragePooling2D)):
            # keras 'same' pads to ceil(n/stride) windows:
            # total = max(0, (ceil(n/s)-1)*s + pool - n); pool2d takes
            # symmetric padding, so reject layers needing asymmetric pads
            ph = pw = 0
            if layer.padding == "same":
                in_shape = layer.input.shape  # (batch, C, H, W) or NHWC
                spatial = (in_shape[2], in_shape[3]) if len(in_shape) == 4 \
                    else (None, None)
                pads = []
                for n, p, s in zip(spatial, layer.pool_size, layer.strides):
                    if n is None:
                        pads.append(0)
                        continue
                    total = max(0, (-(-int(n) // s) - 1) * s + p - int(n))
                    if total % 2:
                        raise NotImplementedError(
                            "keras_exp: asymmetric 'same' pooling padding")
                    pads.append(total // 2)
                ph, pw = pads
            pt = (PoolType.POOL_MAX
                  if isinstance(layer, keras.layers.MaxPooling2D)
                  else PoolType.POOL_AVG)
            return ff.pool2d(x, *layer.pool_size, *layer.strides, ph, pw,
                             pt, name=layer.name)
        if isinstance(layer, keras.layers.Flatten):
            return ff.flat(x, name=layer.name)
        if isinstance(layer, keras.layers.BatchNormalization):
            return ff.batch_norm(x, relu=False, name=layer.name)
        if isinstance(layer, keras.layers.Add):
            return ff.add(args[0], args[1], name=layer.name)
        if isinstance(layer, keras.layers.Concatenate):
            return ff.concat(list(args), axis=layer.axis, name=layer.name)
        if isinstance(layer, keras.layers.Activation):
            name = getattr(layer.activation, "__name__", None)
            if name == "softmax":
                return ff.softmax(x, name=layer.name)
            fn = {"relu": ff.relu, "sigmoid": ff.sigmoid,
                  "tanh": ff.tanh, "gelu": ff.gelu}.get(name)
            if fn is None:
                raise NotImplementedError(f"activation {name}")
            return fn(x, name=layer.name)
        if isinstance(layer, keras.layers.Dropout):
            return ff.dropout(x, rate=layer.rate, name=layer.name)
        raise NotImplementedError(
            f"keras_exp: layer {type(layer).__name__}")
