"""Op base class: the typed node of the Parallel Computation Graph.

Port of ``flexflow_tpu.ops.base`` (reference: ``class Op``,
include/flexflow/operator.h:51). ``forward(params, inputs, ctx)`` is a plain
function on torch tensors; the serving paths run it under
``torch.inference_mode()``. Backward comes from autograd (the training
step differentiates the whole graph forward). Shape/dtype inference and ``weight_specs`` are unchanged from the
JAX package, so both packages declare the same parameter names and layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

from ..ffconst import DataType, OperatorType


@dataclasses.dataclass
class OpContext:
    """Per-call context threaded through forward."""

    training: bool = False
    # the step's random stream (a CPU ``torch.Generator``, seeded per step
    # by ``FFModel.fit``, or a step program's ``DropoutSeeds`` holding the
    # seeds drawn from it): ops with live dropout take their uint32 seeds
    # from it in graph order. None outside training (JAX threads ``ctx.rng``
    # the same way, flexflow_tpu/execution/executor.py:191-198)
    rng: Any = None
    # torch.device the forward runs on (constants are materialized there)
    device: Any = None
    # a ``serving.kvcache.ServingState`` when this forward is a prefill,
    # chunk or decode step of the serving engine; ops with sequence state
    # (causal attention's KV) read ``cache_in`` and publish ``cache_out``
    serving: Any = None
    # training-loss terms that ops append during a training forward
    # (``kernel_regularizer``'s penalty); the train step adds them to the
    # loss. None outside training, as in flexflow_tpu/ops/base.py:43
    aux_losses: Any = None


# registry: OperatorType -> Op subclass
_OP_REGISTRY: Dict[OperatorType, type] = {}


def register_op(op_type: OperatorType):
    def deco(cls):
        _OP_REGISTRY[op_type] = cls
        cls.op_type = op_type
        return cls

    return deco


def op_class_for(op_type: OperatorType) -> type:
    if op_type not in _OP_REGISTRY:
        raise NotImplementedError(
            f"{op_type.name}: no Op registered in flexflow_tpu_torch; it is "
            "ported in a later slice")
    return _OP_REGISTRY[op_type]


class Op:
    """Base PCG operator."""

    op_type: OperatorType = OperatorType.OP_NOOP

    def __init__(self, name: str, attrs: Dict[str, Any], dtype: DataType,
                 num_inputs: int = 1):
        self.name = name
        self.attrs = dict(attrs)
        self.data_type = dtype
        self.num_inputs = num_inputs

    def infer_output_shapes(
        self, input_shapes: List[Tuple[int, ...]]
    ) -> List[Tuple[int, ...]]:
        raise NotImplementedError(self.op_type.name)

    def output_dtype(self, input_dtypes: List[DataType]) -> DataType:
        return input_dtypes[0] if input_dtypes else self.data_type

    def output_dtypes(self, input_dtypes: List[DataType],
                      num_outputs: int) -> List[DataType]:
        return [self.output_dtype(input_dtypes)] * num_outputs

    def weight_specs(
        self, input_shapes: List[Tuple[int, ...]]
    ) -> Dict[str, Tuple[Tuple[int, ...], DataType, Any]]:
        """name -> (shape, dtype, initializer); empty for stateless ops."""
        return {}

    def forward(self, params: Dict[str, Any], inputs: List[Any],
                ctx: OpContext) -> List[Any]:
        raise NotImplementedError(self.op_type.name)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name})"
