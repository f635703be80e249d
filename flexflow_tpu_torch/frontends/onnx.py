"""ONNX frontend: onnx protobuf graph -> FFModel builder calls.

A port of ``flexflow_tpu.frontends.onnx``, itself a rebuild of the
reference's ONNX importer (python/flexflow/onnx/model.py:57-375,
``ONNXModel.apply`` walking graph.node and dispatching per op_type). Gated on
the ``onnx`` package (not baked into every image); raises a clear error when
absent.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..ffconst import PoolType
from ..model import FFModel
from ..tensor import Tensor


def _require_onnx():
    try:
        import onnx  # noqa: F401

        return onnx
    except ImportError as e:
        raise ImportError(
            "the onnx package is required for the ONNX frontend; "
            "install onnx or use the torch/keras frontends") from e


class ONNXModel:
    """reference: python/flexflow/onnx/model.py:57."""

    def __init__(self, filename_or_model):
        onnx = _require_onnx()
        if isinstance(filename_or_model, str):
            self.model = onnx.load(filename_or_model)
        else:
            self.model = filename_or_model
        self.inputs: Dict[str, Any] = {}
        self.initializers: Dict[str, np.ndarray] = {}

    def apply(self, ffmodel: FFModel, input_tensors: Dict[str, Tensor]):
        onnx = _require_onnx()
        from onnx import numpy_helper

        env: Dict[str, Any] = dict(input_tensors)
        for init in self.model.graph.initializer:
            self.initializers[init.name] = numpy_helper.to_array(init)

        def attr(node, name, default=None):
            for a in node.attribute:
                if a.name == name:
                    if a.type == onnx.AttributeProto.INT:
                        return a.i
                    if a.type == onnx.AttributeProto.INTS:
                        return list(a.ints)
                    if a.type == onnx.AttributeProto.FLOAT:
                        return a.f
                    if a.type == onnx.AttributeProto.STRING:
                        return a.s.decode()
            return default

        for node in self.model.graph.node:
            op = node.op_type
            ins = [env.get(i) for i in node.input]
            custom = self._custom_handler(op)
            if custom is not None:
                env[node.output[0]] = custom(ffmodel, node, ins, attr)
                continue
            if op == "Gemm" or op == "MatMul":
                w = self.initializers[node.input[1]]
                out_dim = w.shape[1] if op == "MatMul" else (
                    w.shape[0] if attr(node, "transB", 0) else w.shape[1])
                use_bias = len(node.input) > 2
                t = ffmodel.dense(ins[0], int(out_dim), use_bias=use_bias)
            elif op == "Conv":
                w = self.initializers[node.input[1]]
                kh, kw = attr(node, "kernel_shape", [w.shape[2], w.shape[3]])
                st = attr(node, "strides", [1, 1])
                pads = attr(node, "pads", [0, 0, 0, 0])
                t = ffmodel.conv2d(ins[0], int(w.shape[0]), kh, kw, st[0],
                                   st[1], pads[0], pads[1],
                                   groups=attr(node, "group", 1),
                                   use_bias=len(node.input) > 2)
            elif op == "MaxPool" or op == "AveragePool":
                k = attr(node, "kernel_shape")
                st = attr(node, "strides", k)
                pads = attr(node, "pads", [0, 0, 0, 0])
                pt = PoolType.POOL_MAX if op == "MaxPool" else PoolType.POOL_AVG
                t = ffmodel.pool2d(ins[0], k[0], k[1], st[0], st[1], pads[0],
                                   pads[1], pt)
            elif op == "Relu":
                t = ffmodel.relu(ins[0])
            elif op == "Sigmoid":
                t = ffmodel.sigmoid(ins[0])
            elif op == "Tanh":
                t = ffmodel.tanh(ins[0])
            elif op == "Softmax":
                t = ffmodel.softmax(ins[0], axis=attr(node, "axis", -1))
            elif op == "Add":
                t = ffmodel.add(ins[0], ins[1])
            elif op == "Sub":
                t = ffmodel.subtract(ins[0], ins[1])
            elif op == "Mul":
                t = ffmodel.multiply(ins[0], ins[1])
            elif op == "Concat":
                t = ffmodel.concat([i for i in ins if i is not None],
                                   axis=attr(node, "axis", 1))
            elif op == "Split":
                # reference: handleSplit (model.py:103) — sizes from the
                # `split` attr (opset <13), the second input initializer
                # (opset >=13), or an even split
                sizes = attr(node, "split")
                if sizes is None and len(node.input) > 1 \
                        and node.input[1] in self.initializers:
                    sizes = self.initializers[node.input[1]].tolist()
                axis = attr(node, "axis", 0)
                if sizes is None:
                    n_out = len(node.output)
                    dim = ins[0].dims[axis]
                    sizes = [dim // n_out] * n_out
                outs = ffmodel.split(ins[0], sizes, axis=axis)
                for name_i, t_i in zip(node.output, outs):
                    env[name_i] = t_i
                continue
            elif op == "GlobalAveragePool":
                # reference: handleGlobalAveragePool (model.py:137) —
                # pool over the full spatial extent
                h, w = ins[0].dims[2], ins[0].dims[3]
                t = ffmodel.pool2d(ins[0], h, w, 1, 1, 0, 0,
                                   PoolType.POOL_AVG)
            elif op == "BatchNormalization":
                t = ffmodel.batch_norm(ins[0], relu=False)
            elif op == "Pad":
                # reference: handlePad (model.py:229) — treated as identity
                # (FlexFlow pads inside conv/pool)
                t = ins[0]
            elif op == "Unsqueeze":
                axes = attr(node, "axes")
                if axes is None and len(node.input) > 1:
                    axes = self.initializers[node.input[1]].tolist()
                shape = list(ins[0].dims)
                for a in sorted(axes or []):
                    shape.insert(a if a >= 0 else len(shape) + a + 1, 1)
                t = ffmodel.reshape(ins[0], shape)
            elif op == "Constant":
                val = None
                for a in node.attribute:
                    if a.name == "value":
                        val = numpy_helper.to_array(a.t)
                env[node.output[0]] = val
                continue
            elif op == "Range":
                # reference: handleRange (model.py:279) — eager host value
                start = env.get(node.input[0], 0)
                limit = env.get(node.input[1])
                delta = env.get(node.input[2], 1)
                env[node.output[0]] = np.arange(start, limit, delta)
                continue
            elif op == "Flatten":
                t = ffmodel.flat(ins[0])
            elif op == "Reshape":
                shape = self.initializers[node.input[1]].tolist()
                t = ffmodel.reshape(ins[0], shape)
            elif op == "Transpose":
                t = ffmodel.transpose(ins[0], attr(node, "perm"))
            elif op == "Dropout":
                t = ffmodel.dropout(ins[0], attr(node, "ratio", 0.5))
            elif op == "ReduceMean":
                t = ffmodel.mean(ins[0], dims=attr(node, "axes", [-1]),
                                 keepdims=bool(attr(node, "keepdims", 1)))
            elif op == "Cast" or op == "Identity":
                t = ins[0]
            else:
                raise NotImplementedError(f"ONNX op {op}")
            env[node.output[0]] = t
        return [env[o.name] for o in self.model.graph.output]

    def _custom_handler(self, op: str):
        """Subclass hook: return a handler(ffmodel, node, ins, attr) to
        override the default dispatch for ``op`` (ONNXModelKeras)."""
        return None


class ONNXModelKeras(ONNXModel):
    """Importer for keras-exported ONNX graphs (reference:
    python/flexflow/onnx/model.py:340 ``ONNXModelKeras``): keras exporters
    put a Transpose on the dense-weight path (the kernel is stored
    transposed) — that Transpose is resolved at import time by aliasing the
    transposed initializer under its output name, so the downstream
    Gemm/MatMul sees the right out_dim; activation-path Transposes stay real
    ops. Reshape flattens like the reference's handleReshape ->
    handleFlatten; Add with a bias-initializer operand (the
    Dense(use_bias=True) export) promotes the bias to a graph constant —
    the reference's ``_create_initializer_tensor`` behavior.
    ``ffconfig``/``ffmodel`` are accepted for reference API compat only."""

    def __init__(self, filename_or_model, ffconfig=None, ffmodel=None):
        super().__init__(filename_or_model)

    def _custom_handler(self, op: str):
        if op == "Transpose":
            def handle_transpose(ffmodel, node, ins, attr):
                src = node.input[0]
                if src in self.initializers:
                    w = self.initializers[src]
                    perm = attr(node, "perm", list(range(w.ndim))[::-1])
                    self.initializers[node.output[0]] = \
                        np.transpose(w, perm)
                    return None  # weight path: no graph op
                # ONNX default perm = reversed axes
                ndim = len(ins[0].dims)
                perm = attr(node, "perm", list(range(ndim))[::-1])
                return ffmodel.transpose(ins[0], perm)

            return handle_transpose
        if op == "Reshape":
            return lambda ffmodel, node, ins, attr: ffmodel.flat(ins[0])
        if op == "Add":
            def handle_add(ffmodel, node, ins, attr):
                # keras Dense(use_bias=True) exports MatMul + Add(h, bias)
                # with the bias as an initializer — promote it to a graph
                # constant (the reference creates constant tensors for this,
                # onnx/model.py ONNXModelKeras._create_initializer_tensor)
                vals = []
                for name, v in zip(node.input, ins):
                    if v is None and name in self.initializers:
                        v = ffmodel.constant(self.initializers[name])
                    vals.append(v)
                return ffmodel.add(vals[0], vals[1])

            return handle_add
        return None
