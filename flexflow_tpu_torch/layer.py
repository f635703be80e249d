"""Layer: an untyped node of the user-facing graph built by FFModel builder calls.

Analog of the reference's ``Layer`` (include/flexflow/layer.h, src/runtime/layer.cc).
A Layer records the op type, attributes, inputs, and declared weight shapes; it is
converted to a typed `Op` in the Parallel Computation Graph by
``FFModel.compile`` (reference: create_operators_from_layers, src/runtime/model.cc:2785).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

from .ffconst import DataType, OperatorType
from .tensor import Tensor

_layer_guid = itertools.count(100)


class Layer:
    def __init__(
        self,
        op_type: OperatorType,
        dtype: DataType,
        name: Optional[str],
        inputs: List[Tensor],
        numWeights: int = 0,
        numOutputs: int = 1,
        attrs: Optional[Dict[str, Any]] = None,
        index: Optional[int] = None,
    ):
        self.guid = next(_layer_guid)
        self.op_type = op_type
        self.data_type = dtype
        base = name or op_type.name.lower().replace("op_", "")
        # deterministic per-model naming (index = position in the model) so
        # checkpoints/strategies transfer between identical models
        self.name = f"{base}_{self.guid if index is None else index}"
        self.inputs: List[Tensor] = list(inputs)
        self.outputs: List[Tensor] = []
        self.num_weights = numWeights
        self.attrs: Dict[str, Any] = dict(attrs or {})
        # weight declarations: name -> (shape, dtype, initializer)
        self.weight_specs: Dict[str, Tuple[Tuple[int, ...], DataType, Any]] = {}
        # weight Tensors surfaced to the user (reference: Layer::weights)
        self.weights: List[Tensor] = []

    def add_weight(self, wname, shape, dtype, initializer) -> Tensor:
        self.weight_specs[wname] = (tuple(int(s) for s in shape), dtype, initializer)
        t = Tensor(shape, dtype, owner_layer=self, owner_idx=-len(self.weight_specs),
                   name=f"{self.name}.{wname}")
        self.weights.append(t)
        return t

    def get_parameter_by_id(self, idx: int) -> Tensor:
        return self.weights[idx]

    # named accessors (reference: flexflow_cffi.py Linear/Conv2D layer
    # wrappers :175-215 — get_weight/bias/input/output_tensor)
    def get_weight_tensor(self) -> Tensor:
        return self.weights[0]

    def get_bias_tensor(self) -> Tensor:
        assert len(self.weights) > 1, f"{self.name} has no bias"
        return self.weights[1]

    def get_input_tensor(self, idx: int = 0) -> Tensor:
        return self.inputs[idx]

    def get_output_tensor(self, idx: int = 0) -> Tensor:
        return self.outputs[idx]

    def __repr__(self) -> str:
        return f"Layer({self.name}, {self.op_type.name}, in={[t.name for t in self.inputs]})"
