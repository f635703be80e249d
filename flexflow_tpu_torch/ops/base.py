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

import numpy as np

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
    # cache-op state (flexflow_tpu/ops/base.py:44-50): ``cache_in`` =
    # {op_name: cached tensor, "__use_cache__": 0-d bool tensor} fed into
    # the train step, ``cache_out`` the dict the CacheOps fill with their
    # fresh values, which the step returns. None outside a cached step
    cache_in: Any = None
    cache_out: Any = None
    # the ``parallel.mesh.Mesh`` a strategy runs over (None on one device)
    # and, while a node runs on it, that node's ``parallel.spmd.ShardInfo``:
    # its inputs' and weights' layouts and this rank's place in them
    mesh: Any = None
    shard: Any = None


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
        # the view the search assigned (``search.unity.insert_parallel_ops``)
        self.machine_view = None

    def params_key(self) -> Tuple:
        """Hashable params tuple: the search's cost tables key on it
        (flexflow_tpu/ops/base.py:100-103; reference: <op>_params.h)."""
        return (self.op_type, self.data_type,
                tuple(sorted((k, _freeze(v)) for k, v in self.attrs.items())))

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


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, v.dtype.str, v.tobytes())
    if callable(v) and not isinstance(v, type):
        return getattr(v, "__name__", repr(v))
    return v


def profiler_on() -> bool:
    """True while a ``torch.profiler`` (or autograd profiler) records: the
    one check a forward makes before it opens per-op ranges."""
    import torch

    return torch.autograd._profiler_enabled()


def run_op(op, name: str, params, inputs, ctx: OpContext,
           scoped: bool) -> List[Any]:
    """``op.forward``, inside a ``record_function`` range called ``name``
    when ``scoped`` (a profiler runs): the counterpart of the JAX
    package's ``jax.named_scope`` around a node or a fused region's sub-op
    (flexflow_tpu/execution/executor.py:180-208,
    flexflow_tpu/ops/fused.py:95-99). A CUDA graph records the kernels of
    a range but not the range, so a captured step's replays show no
    names."""
    if not scoped:
        return op.forward(params, inputs, ctx)
    import torch

    with torch.profiler.record_function(name):
        return op.forward(params, inputs, ctx)


def op_flops(op, input_shapes, output_shapes, elementwise: bool = True
             ) -> int:
    """Forward FLOPs of ``op`` at these shapes: its own ``flops`` hook,
    the sum over the sub-ops of a fused region, and for an op without a
    hook one FLOP an output element (the JAX package's default,
    flexflow_tpu/ops/base.py:127), or 0 with ``elementwise=False`` (the
    matmul convention of ``models.train_flops_per_step``)."""
    subs = getattr(op, "sub_op_shapes", None)
    if subs is not None:
        return sum(op_flops(sub, ins, outs, elementwise)
                   for sub, ins, outs in subs(input_shapes))
    if hasattr(op, "flops"):
        return int(op.flops(input_shapes, output_shapes))
    if not elementwise:
        return 0
    return sum(int(np.prod(s)) for s in output_shapes)


def hookless_flops(pcg) -> int:
    """Forward FLOPs of the ops (or a region's sub-ops) without a cost
    hook of their own, one an output element: what the JAX count
    (``obs.model_flops_per_step``) adds to the matmul count
    (``models.train_flops_per_step``), a third of the step's share."""
    total = 0
    for node in pcg.compute_nodes():
        ins = [pcg.nodes[g].out_shapes[i] for g, i in node.inputs]
        outs = list(node.out_shapes)
        total += op_flops(node.op, ins, outs) - \
            op_flops(node.op, ins, outs, elementwise=False)
    return total
